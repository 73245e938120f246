"""Synthetic-data pipeline: deterministic, host-sharded, prefetched
(mirrors ``repro.data.pipeline``).

Batch content is a pure function of (seed, step, shard), drawn with
numpy exactly as the JAX package draws it, so both packages train on the
same bytes and a restart resumes bit-identically. ``Prefetcher`` builds
batches on a background thread and places them on the device with
``.to(device, non_blocking=True)``. A vision model's batches carry
``patches`` (B, num_patches, D) and an encoder-decoder's ``frames`` (B,
max(1, S // frame_ratio), D), standard normal fp32 draws from the same
generator, after the tokens, as in the JAX package.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig

@dataclass
class HostShard:
    """This host's slice of the global batch (multi-host data loading)."""
    index: int = 0
    count: int = 1


class SyntheticSource:
    """Markov-chain-flavoured synthetic LM tokens (harder than uniform —
    loss actually decreases, which the training tests rely on)."""

    def __init__(self, run: RunConfig, shard: HostShard = HostShard(),
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.run = run
        self.cfg = run.model
        self.shard = shard
        B = batch_override or run.shape.global_batch
        assert B % shard.count == 0
        self.local_batch = B // shard.count
        self.seq = seq_override or run.shape.seq_len

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (local_batch, seq) int32 numpy arrays,
        with ``patches`` or ``frames`` (fp32) where the model takes them."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (self.run.seed * 1_000_003 + step) * 97 + self.shard.index)
        B, S = self.local_batch, self.seq
        V = cfg.vocab_size
        # structured tokens: noisy arithmetic sequences -> learnable
        start = rng.integers(0, V, (B, 1))
        stride = rng.integers(1, 7, (B, 1))
        base = (start + stride * np.arange(S + 1)[None, :]) % V
        noise = rng.integers(0, V, (B, S + 1))
        mask = rng.random((B, S + 1)) < 0.1
        toks = np.where(mask, noise, base).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend.kind == "vision":
            batch["patches"] = rng.standard_normal(
                (B, cfg.frontend.num_patches, cfg.d_model)).astype(np.float32)
        if cfg.is_encoder_decoder:
            Te = max(1, S // cfg.frontend.frame_ratio)
            batch["frames"] = rng.standard_normal(
                (B, Te, cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch (double buffering host-side) + optional
    device placement."""

    def __init__(self, source: SyntheticSource, depth: int = 2,
                 device=None, start_step: int = 0):
        self.source = source
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            try:
                self.q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        step, batch = self.q.get()
        if self.device is not None:
            batch = to_device(batch, self.device)
        return step, batch

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
