"""Serving engine: continuous batching over decode_step, dense or paged
KV (mirrors ``repro.serve.engine``).

Requests are admitted into slots of a batched decode state and decoded
together; finished slots are recycled without stopping the batch. Two
cache layouts:

  dense (default)   per-slot ring of ``max_len`` KV rows: every slot pays
                    for its worst case and decode walks the whole
                    allocation, through the plain attention with per-slot
                    KV lengths (as the JAX package computes it, outside
                    any Pallas kernel)
  paged             slots borrow fixed-size pages from a shared pool
                    through a ``BlockAllocator``; decode is block-table-
                    indirected (``kernels/csrc/paged_decode.cu``) and
                    costs only the pages a request has written

A recurrent layer (mamba, mLSTM, sLSTM) keeps its state dense per slot
beside either layout; an encoder-decoder's cross KV (xk, xv: the
encoder's memory projected once at prefill, ``max_len // frame_ratio``
rows a slot, attended unmasked as in the JAX engine) lives in the dense
ring only, and an attention-free stack has no pages to borrow.

Prefill is whole-prompt (B=1) through ``kernels/csrc/flash_attention.cu``
and, in mamba layers, ``kernels/csrc/ssm_scan.cu``. A vision model's
prompt follows ``num_patches`` patch rows (zeros, as the JAX engine
passes them), so its logical length is ``num_patches + len(prompt)``; an
encoder-decoder encodes ``max(1, len(prompt) // frame_ratio)`` zero
frames. The engine never pads a prompt, so it rejects at admission a
prompt that breaks a layer's sequence rule: the SSM chunk rule and the
mLSTM chunk rule (at most one chunk, or a multiple of it) and the MoE
group rule (at most 512 tokens, or a multiple of 512); with
``fused_sampling`` the sampler
runs on the device (``kernels/csrc/fused_sample.cu``) and only token ids
come back. Sampling is per-request temperature / top-k with a
counter-seeded RNG — a request's tokens are a pure function of (request,
logits), so a pause or a migration mid-request cannot change its output
(invariant I10).

Prefill is chunked when ``prefill_chunk > 0`` on a token-only
all-attention stack (any other stack, an encoder-decoder and a vision
model turn it off, as the JAX engine does): one prompt chunk
is processed per engine step into a dense staging cache, interleaved
with the running batch's decode, through the plain attention (a chunk's
K is the whole staging cache, as in JAX). Request live migration ships
one in-flight request's KV block chain to another engine
(``extract_request`` -> ``admit_migrated`` -> ``release_request``, driven
by ``SVFFManager.migrate_request``; paged engines only); a frozen slot
goes to the kernels as an inactive one.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, RunConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import check_ssm_chunk
from repro_torch.kernels.sampling import host_gumbel
from repro_torch.models.model import build_model
from repro_torch.models.moe import check_moe_groups
from repro_torch.models.xlstm import check_mlstm_chunk
from repro_torch.serve.paged import (BlockAllocator, CacheExhausted,
                                     RequestRejected, admit_kv,
                                     apply_page_moves, copy_page,
                                     extract_kv, init_paged_cache,
                                     paged_cache_supported,
                                     reset_slot_state)
from repro_torch.train.step import (make_decode_step, make_prefill_chunk,
                                    make_serve_steps)
from repro_torch.tree import tree_to


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stops early
    temperature: float = 0.0           # 0: greedy argmax (<= 0 likewise)
    top_k: int = 0                     # 0: no top-k filter
    seed: int = 0                      # sampling stream (with rid)
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None        # set when admission rejected it
    t_submit: float = 0.0              # set by ServeEngine.submit
    t_tok: list = dataclasses.field(default_factory=list)  # per-token wall

    def __post_init__(self):
        # a positive-but-denormal temperature is always a caller bug: 1/T
        # overflows the f32 logits to inf (temperature <= 0 stays greedy)
        if 0 < self.temperature < 1e-6:
            raise ValueError(
                f"request {self.rid}: temperature {self.temperature} is "
                "positive but below 1e-6; use 0 for greedy or a "
                "temperature >= 1e-6")


class DrainResult(list):
    """``run_until_idle``'s return value: the finished requests, plus
    ``drained`` — False when the engine stopped with work still pending
    (paused with a non-empty queue / live slots, or max_steps ran out)."""

    def __init__(self, items=(), drained: bool = True):
        super().__init__(items)
        self.drained = drained


@dataclasses.dataclass
class _PrefillJob:
    """An in-progress chunked prefill occupying a slot (not yet decoding)."""
    req: Request
    slot: int
    cache: dict                        # dense (B=1) staging cache
    plen: int
    offset: int = 0
    pages: Optional[list] = None       # paged: pages reserved at admission


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class ServeEngine:
    def __init__(self, run: RunConfig, params, *, device="cuda",
                 slots: int = 4, max_len: int = 256, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 0, share_prefix: bool = False,
                 kv_dtype: Optional[str] = None,
                 fused_sampling: bool = False):
        self.device = resolve_device(device)
        # chunked prefill needs per-chunk attention continuation, which
        # only a token-only all-attention stack has; for any other stack
        # the JAX engine turns it off (recurrent blocks would need their
        # chunk-boundary state threaded through), and so does the port
        cfg = run.model
        chunkable = (all(b == ATTN for b in cfg.block_pattern)
                     and not cfg.is_encoder_decoder
                     and cfg.frontend.kind == "none")
        self.prefill_chunk = prefill_chunk if chunkable else 0
        self.run = run
        self.model = build_model(run)
        self._set_params(params)
        self.slots = slots
        self.max_len = max_len
        self.queue: collections.deque[Request] = collections.deque()
        self.active: list[Optional[Request]] = [None] * slots
        self.pos = np.full((slots,), -1, np.int64)      # last written index
        self.last_token = np.zeros((slots,), np.int32)
        self.paused = False
        self._finished: list[Request] = []              # completed requests
        self._jobs: dict[int, _PrefillJob] = {}         # slot -> prefill job
        #: rid -> slot frozen by an in-flight outbound migration. A frozen
        #: slot keeps its Request/pages/KV (extraction copies, never
        #: moves), is skipped by decode, and thaws on release (commit) or
        #: abort — which is why an aborted migration is side-effect-free.
        self._migrating: dict[int, int] = {}
        #: cache-pressure / sharing / migration counters, read by the
        #: fleet's telemetry; cumulative over the engine's lifetime
        self.stats = collections.Counter()
        #: prefill launches (whole prompts and chunks), so a caller can
        #: tell a decode-only step; kept beside ``stats``, which stays
        #: equal to the JAX engine's
        self.prefill_calls = 0
        # per-step dirty set: which export_state keys changed since the
        # last export (params stay the same tensors across exports)
        self._dirty = {"params", "cache", "pos", "last_token"}

        self.paged = paged
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype requires the paged cache layout")
        self.kv_dtype = kv_dtype
        #: fused sampling: temperature/top-k Gumbel sampling runs on the
        #: device after the decode step and only token ids come back to
        #: the host — bit-identical to the host ``_sample`` path (both
        #: draw the same portable counter-hash noise), so I10 holds
        #: across the knob
        self.fused_sampling = bool(fused_sampling)
        if paged:
            ok, why = paged_cache_supported(cfg)
            if not ok:
                raise ValueError(f"paged KV for {cfg.name}: {why}")
            self.page_size = page_size
            maxp = math.ceil(max_len / page_size)
            self.num_pages = (num_pages if num_pages is not None
                              else 1 + slots * maxp)
            self.alloc = BlockAllocator(self.num_pages, page_size)
            self.tables = np.zeros((slots, maxp), np.int32)
            self._dirty.add("tables")
        # prefix sharing keys on prompt tokens alone, so it is gated to
        # token-only frontends (vision patch rows precede the token rows
        # and differ per request)
        self.share_prefix = (paged and bool(share_prefix)
                             and cfg.frontend.kind == "none")
        self.npatch = (cfg.frontend.num_patches
                       if cfg.frontend.kind == "vision" else 0)

        self._prefill, _ = make_serve_steps(run)
        self._decode = make_decode_step(run, paged=paged,
                                        fused=self.fused_sampling)
        self._chunk = make_prefill_chunk(run)
        self._cache = None                    # lazy page pools / dense ring

    # -- cache plumbing -------------------------------------------------------
    def _ensure_cache(self):
        if self._cache is None:
            shape = dataclasses.replace(self.run.shape, seq_len=self.max_len,
                                        global_batch=self.slots)
            if self.paged:
                self._cache = init_paged_cache(self.model, shape,
                                               self.num_pages,
                                               self.page_size,
                                               kv_dtype=self.kv_dtype,
                                               device=self.device)
            else:
                self._cache = self.model.init_cache(shape,
                                                    device=self.device)

    def _insert(self, slot: int, req_cache, dst=None):
        """Write a (1, L, ...) request cache (a prefill's, or a chunked
        prefill's staging cache sliced to its prompt) into the dense
        ring's ``slot``, in place: KV and cross-KV rows [0, L) of the slot
        (later rows keep their bytes, as JAX's dynamic_update_slice
        leaves them), recurrent state whole."""
        dst = self._cache if dst is None else dst
        for name, leaf in req_cache.items():
            if isinstance(leaf, dict):
                self._insert(slot, leaf, dst[name])
            elif name in ("k", "v", "xk", "xv"):
                dst[name][:, slot, :leaf.shape[2]] = leaf[:, 0]
            else:
                dst[name][:, slot] = leaf[:, 0]

    def _set_params(self, params):
        # ``params`` is the master copy export_state hands out; the steps
        # read ``_cparams``, its matrices cast once to the compute dtype
        self.params = tree_to(params, self.device)
        self._cparams = self.model.compute_params(self.params)

    def drop_device_state(self):
        """Let go of every device tensor the engine holds — params, their
        compute-dtype copy and the page pools (a pause or a detach; an
        ``import_state`` brings them back)."""
        self.params = self._cparams = self._cache = None

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request):
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    def pause(self):
        self.paused = True

    def unpause(self):
        self.paused = False

    # -- admission ------------------------------------------------------------
    def _validate(self, req: Request):
        cfg = self.run.model
        plen = len(req.prompt)
        need = self.npatch + plen + req.max_new_tokens
        if plen < 1:
            raise RequestRejected(f"request {req.rid}: empty prompt")
        # the sequence rules of the layers a whole-prompt prefill runs;
        # the engine never pads a prompt, since pad tokens would enter the
        # recurrent state or take MoE capacity from the real ones
        try:
            if MAMBA in cfg.block_pattern:
                check_ssm_chunk(plen, cfg.ssm.chunk)
            if MLSTM in cfg.block_pattern:
                check_mlstm_chunk(plen, cfg.xlstm.chunk)
            if cfg.moe is not None:
                # a chunked prefill routes chunk by chunk
                chunked = self.prefill_chunk and plen > self.prefill_chunk
                check_moe_groups(1, self.prefill_chunk if chunked
                                 else self.npatch + plen)
        except ValueError as e:
            raise RequestRejected(f"request {req.rid}: {e}") from e
        if need > self.max_len:
            raise RequestRejected(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds max_len "
                f"{self.max_len}")
        return need

    def _reject(self, req: Request, err: Exception):
        req.done = True
        req.error = str(err)
        self._finished.append(req)

    def _paged_admit(self, req: Request, need: int) -> list:
        """Reserve pages for admission: only the PROMPT rows up front —
        decode pages grow lazily (``extend`` in ``_ensure_writable``). The
        full need is still validated against pool capacity here: a
        request that could never complete is rejected at admission, not
        discovered mid-decode as an endless preempt/replay cycle."""
        if self.alloc.pages_needed(need) > self.alloc.capacity:
            raise RequestRejected(
                f"request {req.rid} needs {self.alloc.pages_needed(need)} "
                f"pages; pool capacity is {self.alloc.capacity} "
                f"(page_size={self.page_size})")
        tokens = None
        if self.share_prefix:
            tokens = tuple(int(t) for t in req.prompt)
        return self.alloc.allocate(
            req.rid, self.alloc.pages_needed(self.npatch + len(req.prompt)),
            tokens=tokens)

    def _admit(self):
        """Fill free slots from the queue. A request that is rejected or
        finishes at prefill does NOT consume the slot — it is re-offered
        to the next queued request in the same pass."""
        for s in range(self.slots):
            if self.active[s] is not None or s in self._jobs:
                continue
            while self.queue:
                req = self.queue.popleft()
                try:
                    need = self._validate(req)
                    pages = (self._paged_admit(req, need) if self.paged
                             else None)
                except RequestRejected as e:
                    self._reject(req, e)
                    continue                      # slot still free
                except CacheExhausted:
                    # transient: one defragment pass before backing off
                    self.stats["cache_exhausted"] += 1
                    self.defragment()
                    self.stats["defrag_events"] += 1
                    try:
                        pages = self._paged_admit(req, need)
                    except CacheExhausted:
                        self.queue.appendleft(req)    # keep arrival order
                        return
                self._ensure_cache()
                if self.prefill_chunk and len(req.prompt) > \
                        self.prefill_chunk:
                    self._start_job(s, req, pages)
                    break                         # slot taken by the job
                if self._prefill_full(s, req, pages):
                    break                         # slot now decoding
                # finished at prefill: slot re-offered to the next request

    def _prefill_full(self, slot: int, req: Request, pages) -> bool:
        """B=1 whole-prompt prefill. Returns True if the slot is occupied
        (request entered the decode batch), False if it finished at
        prefill (slot stays free — nothing was written into it)."""
        cfg = self.run.model
        plen = len(req.prompt)
        batch = {"tokens": self._tensor(req.prompt, torch.int64)[None]}
        if self.npatch:
            batch["patches"] = torch.zeros(
                (1, self.npatch, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if cfg.is_encoder_decoder:
            Te = max(1, plen // cfg.frontend.frame_ratio)
            batch["frames"] = torch.zeros((1, Te, cfg.d_model),
                                          dtype=torch.bfloat16,
                                          device=self.device)
        req_cache, last_logits = self._prefill(self._cparams, batch)
        self.prefill_calls += 1
        tok = self._emit(req, last_logits[0].cpu().numpy())
        if req.done:
            if pages is not None:
                self.alloc.free(req.rid)
            return False
        self._place(slot, req, req_cache, self.npatch + plen, pages)
        self.last_token[slot] = tok
        return True

    # -- chunked prefill ------------------------------------------------------
    def _start_job(self, slot: int, req: Request, pages):
        C = self.prefill_chunk
        plen = len(req.prompt)
        cap = C * _next_pow2(math.ceil(plen / C))   # bucketed staging len
        shape = dataclasses.replace(self.run.shape, seq_len=cap,
                                    global_batch=1)
        self._jobs[slot] = _PrefillJob(
            req=req, slot=slot,
            cache=self.model.init_cache(shape, device=self.device),
            plen=plen, pages=pages)

    def _advance_prefill(self):
        """Process ONE chunk of the oldest pending prefill job — prefill
        work is batched into the decode schedule instead of stalling it.
        The offset rides in as a 0-d tensor, as JAX's traced offset, so
        every chunk (the first too) takes the plain attention."""
        if not self._jobs:
            return
        slot, job = next(iter(self._jobs.items()))
        C = self.prefill_chunk
        req = job.req
        real = min(C, job.plen - job.offset)
        chunk = np.zeros((C,), np.int64)
        chunk[:real] = np.asarray(req.prompt[job.offset:job.offset + real],
                                  np.int64)
        job.cache, logits = self._chunk(
            self._cparams, job.cache, self._tensor(chunk, torch.int64)[None],
            self._tensor(job.offset, torch.int64))
        self.prefill_calls += 1
        job.offset += real
        if job.offset < job.plen:
            return
        del self._jobs[slot]
        tok = self._emit(req, logits[0, real - 1].cpu().numpy())
        if req.done:                         # finished at prefill
            if job.pages is not None:
                self.alloc.free(req.rid)
            return
        req_cache = self._slice_kv(job.cache, job.plen)
        self._place(slot, req, req_cache, job.plen, job.pages)
        self.last_token[slot] = tok

    @staticmethod
    def _slice_kv(cache: dict, L: int) -> dict:
        """The staging cache's first ``L`` KV rows (the prompt's)."""
        return {blk: {name: (leaf[:, :, :L] if name in ("k", "v") else leaf)
                      for name, leaf in node.items()}
                for blk, node in cache.items()}

    def abort_prefill_jobs(self):
        """Push every in-flight chunked-prefill job back onto the queue
        (front, original arrival order) and release its pages. A job has
        emitted NO tokens yet (the first token is sampled at completion)
        and prefill is deterministic, so restarting it after a pause is
        token-identical — a suspend keeps export_state a COMPLETE device-
        state snapshot without staging half-built staging caches."""
        for slot, job in reversed(list(self._jobs.items())):
            if job.pages is not None:
                self.alloc.free(job.req.rid)
            self.queue.appendleft(job.req)    # dict is admission-ordered
        self._jobs.clear()

    def _place(self, slot: int, req: Request, req_cache, logical_len: int,
               pages):
        """Copy-on-admit: move a prefilled request's cache into the batch
        (paged: into its allocated pages, skipping the trie-shared chain
        head; dense: into its slot ring)."""
        if self.paged:
            shared = self.alloc.shared_count(req.rid)
            self.stats["shared_page_hits"] += shared
            admit_kv(self._cache, req_cache, pages, self.page_size, slot,
                     skip_pages=shared)
            row = self.tables[slot]
            row[:] = 0
            row[:len(pages)] = pages
            self._dirty.add("tables")
            # offer this prompt's pages for sharing only now that their
            # bytes are written
            if self.share_prefix:
                self.alloc.register_prefix(req.rid)
        else:
            self._insert(slot, req_cache)
        self.active[slot] = req
        self.pos[slot] = logical_len - 1
        self._dirty |= {"cache", "pos", "last_token"}

    # -- sampling -------------------------------------------------------------
    def _sample(self, req: Request, logits_row: np.ndarray) -> int:
        """THE sampling oracle (invariant I10): every other path —
        pause replay, preemption-by-recompute, and the fused on-device
        sampler — must reproduce this bit-for-bit. All arithmetic is
        float32 with portably-exact ops: cast, divide, selection
        (partition), and the shared counter-hash Gumbel noise."""
        lg = np.asarray(logits_row, np.float32)
        V = self.run.model.vocab_size
        if lg.size > V:
            lg = lg.copy()
            lg[V:] = -np.inf                 # padded vocab tail
        if req.temperature <= 0:
            return int(np.argmax(lg))
        z = lg / np.float32(req.temperature)
        if 0 < req.top_k < V:
            kth = np.partition(z, -req.top_k)[-req.top_k]
            z = np.where(z >= kth, z, -np.inf)
        return int(np.argmax(z + host_gumbel(req.seed, req.rid,
                                             len(req.out), z.shape[0])))

    def _emit(self, req: Request, logits_row: np.ndarray) -> int:
        return self._finish_token(req, self._sample(req, logits_row))

    def _finish_token(self, req: Request, tok: int) -> int:
        """Record one sampled token (host- or device-sampled) and retire
        the request on EOS / token budget."""
        req.out.append(tok)
        req.t_tok.append(time.perf_counter())
        if tok == req.eos_id or len(req.out) >= req.max_new_tokens:
            req.done = True
            self._finished.append(req)
        return tok

    # -- the decode loop ------------------------------------------------------
    def _table_width(self, pos_new: np.ndarray) -> int:
        """Narrowest pow2 block-table width covering every active slot —
        decode cost follows the tokens actually written (the kernel takes
        the width at run time, so nothing recompiles)."""
        need = int(np.max(pos_new, initial=-1)) // self.page_size + 1
        return min(_next_pow2(max(need, 1)), self.tables.shape[1])

    def step(self) -> int:
        """One engine iteration: admit + one prefill chunk + one batched
        decode over the ACTIVE slots (inactive slots — idle or frozen by
        an in-flight migration — are masked out: their cache bytes stay
        untouched and their attention reads no token). Returns the number
        of active slots (0 = idle). No-op while paused."""
        if self.paused:
            return 0
        self._admit()
        self._advance_prefill()
        frozen = set(self._migrating.values())
        if frozen:
            # a synchronous migration freezes and thaws within one manager
            # op, so this only ticks when a caller holds the freeze across
            # steps (or a crash did): the measured migration stall
            self.stats["migration_stall_ticks"] += sum(
                1 for s in frozen if self.active[s] is not None)
        act = [s for s in range(self.slots)
               if self.active[s] is not None and s not in frozen]
        if not act:
            return 0
        self._ensure_cache()
        if self.paged:
            # every write target must be private and allocated BEFORE the
            # batched call: lazily grow the chain and CoW-split shared
            # pages; a slot the pool cannot serve is preempted
            act = [s for s in act if self._ensure_writable(s)]
            if not act:
                return 0
        act_mask = np.zeros((self.slots,), bool)
        act_mask[act] = True
        pos_new = np.where(act_mask, self.pos + 1, -1).astype(np.int32)
        args = [self._cparams, self._cache,
                self._tensor(np.where(act_mask, self.last_token, 0)[:, None],
                             torch.int64),
                self._tensor(pos_new, torch.int32)]
        if self.paged:
            W = self._table_width(pos_new)
            args.append(self._tensor(np.ascontiguousarray(self.tables[:, :W]),
                                     torch.int32))
        args.append(self._tensor(act_mask, torch.bool))
        if self.fused_sampling:
            # per-slot sampling params ride into the step; only (slots,)
            # int32 token ids come back — the (B, V) logits stay on the
            # device
            temp = np.zeros((self.slots,), np.float32)
            topk = np.zeros((self.slots,), np.int32)
            keys = np.zeros((self.slots, 3), np.int32)
            for s in act:
                req = self.active[s]
                temp[s] = np.float32(req.temperature)
                topk[s] = req.top_k
                keys[s] = (req.seed, req.rid, len(req.out))
            toks, self._cache = self._decode(
                *args, self._tensor(temp, torch.float32),
                self._tensor(topk, torch.int32),
                self._tensor(keys, torch.int32))
            sampled = toks.cpu().numpy()
        else:
            logits, self._cache = self._decode(*args)
            lg = logits.cpu().numpy()
        self._dirty |= {"cache", "pos", "last_token"}
        for s in act:
            req = self.active[s]
            self.pos[s] += 1
            if self.fused_sampling:
                tok = self._finish_token(req, int(sampled[s]))
            else:
                tok = self._emit(req, lg[s])
            self.last_token[s] = tok
            if not req.done and self.pos[s] + 1 >= self.max_len:
                req.done = True
                self._finished.append(req)
            if req.done:
                self.active[s] = None
                self._reset_slot(s, rid=req.rid)
        return len(act)

    def _ensure_writable(self, slot: int) -> bool:
        """Make this step's KV write target (position ``pos+1``) safe for
        the decoding slot: extend the chain when the write crosses into
        an unallocated page (lazy growth), CoW-split when it lands in a
        page with refcount > 1. Exhaustion preempts the slot (False)."""
        req = self.active[slot]
        pi = (int(self.pos[slot]) + 1) // self.page_size
        chain = self.alloc.pages_of(req.rid)
        try:
            if pi >= len(chain):
                (new,) = self.alloc.extend(req.rid, 1)
                self.tables[slot, pi] = new
                self.stats["lazy_extends"] += 1
                self._dirty.add("tables")
            elif self.alloc.refcount(chain[pi]) > 1:
                old, new = self.alloc.cow(req.rid, pi)
                copy_page(self._cache, old, new)
                self.tables[slot, pi] = new
                self.stats["cow_splits"] += 1
                self._dirty |= {"cache", "tables"}
        except CacheExhausted:
            self.stats["cache_exhausted"] += 1
            self._preempt(slot)
            return False
        return True

    def _preempt(self, slot: int):
        """Preemption-by-recompute, the exhaustion safety valve: drop the
        slot's work, release its pages, and requeue the request from
        scratch at the FRONT of the queue. Prefill and sampling are
        deterministic pure functions of the request (I10), so the replay
        emits exactly the tokens the preempted attempt did."""
        req = self.active[slot]
        self.alloc.free(req.rid)
        req.out.clear()
        req.t_tok.clear()
        self.active[slot] = None
        self.tables[slot, :] = 0
        self.pos[slot] = -1
        reset_slot_state(self._cache, slot)
        self.queue.appendleft(req)
        self.stats["preemptions"] += 1
        self._dirty |= {"cache", "pos", "tables"}

    def _reset_slot(self, slot: int, rid: Optional[int] = None):
        """Recycle a finished slot: paged KV pages go back to the
        allocator; dense KV is masked by pos, so it needs no reset; the
        recurrent per-slot state is zeroed either way."""
        if self.paged:
            if rid is not None:
                self.alloc.free(rid)
            self.tables[slot, :] = 0
            self._dirty.add("tables")
        if self._cache is not None:     # a paused engine holds no cache
            reset_slot_state(self._cache, slot)
        self.pos[slot] = -1

    def defragment(self) -> dict:
        """Compact the page pool (allocator + physical pages + tables);
        returns the {old: new} page moves. No-op for dense engines."""
        if not self.paged:
            return {}
        moves = self.alloc.defragment()
        if moves and self._cache is not None:
            apply_page_moves(self._cache, moves)
            self._dirty |= {"cache", "tables"}
        for s, req in enumerate(self.active):
            if req is not None:
                pages = self.alloc.pages_of(req.rid)
                self.tables[s, :] = 0
                self.tables[s, :len(pages)] = pages
        for job in self._jobs.values():
            if job.pages is not None:
                job.pages = self.alloc.pages_of(job.req.rid)
        return moves

    # -- request migration (KV block shipping) --------------------------------
    # Protocol driven by SVFFManager.migrate_request: peek -> journal ->
    # extract (freeze, copy) -> ship -> admit on target -> release here.
    # Everything before release is non-destructive, so any abort (target
    # CacheExhausted, crash rollback) just thaws the frozen slot and the
    # source keeps serving the request.
    def peek_migratable(self, rid: Optional[int] = None) -> Optional[int]:
        """Pure query: the rid ``extract_request`` would pick — first
        active decoding slot in slot order (or ``rid`` if it is one).
        None when nothing is migratable (dense engine, idle, or already
        mid-migration)."""
        if not self.paged:
            return None
        frozen = set(self._migrating.values())
        for s in range(self.slots):
            req = self.active[s]
            if req is None or s in frozen:
                continue
            if rid is None or req.rid == rid:
                return req.rid
        return None

    def extract_request(self, rid: Optional[int] = None) -> Optional[dict]:
        """Freeze one in-flight request and gather everything the target
        needs to resume it: the Request object, its KV block chain as a
        dense strip (``extract_kv``), its slot's recurrent state, decode
        position and last sampled token, and the prompt tokens recorded
        by the allocator (so the target can re-share trie pages). The
        source keeps its pages — nothing destructive happens here."""
        rid = self.peek_migratable(rid)
        if rid is None:
            return None
        slot = next(s for s in range(self.slots)
                    if self.active[s] is not None
                    and self.active[s].rid == rid)
        self._ensure_cache()
        chain = self.alloc.pages_of(rid)
        state = extract_kv(self._cache, chain, self.page_size, slot)
        self._migrating[rid] = slot
        return {"rid": rid, "req": self.active[slot], "slot": slot,
                "chain_len": len(chain), "page_size": self.page_size,
                "tokens": self.alloc.tokens_of(rid),
                "pos": int(self.pos[slot]),
                "last": int(self.last_token[slot]),
                "state": state}

    def admit_migrated(self, payload: dict, state) -> int:
        """Admit a migrated request into a free slot: allocate a same-
        length chain (re-sharing trie pages for FULL prompt pages only —
        the partly-filled last prompt page may already hold this
        request's decode rows, which a sibling's registered page does
        not), scatter the shipped strip via ``admit_kv`` skipping the
        re-shared head (on this engine's device, wherever the strip came
        back from staging), and resume at the shipped pos/last_token.
        Raises ``CacheExhausted`` (clean, side-effect-free) when no slot
        or not enough pages after one defragment. Idempotent: re-
        admitting an owned rid is a no-op (recovery roll-forward
        replays)."""
        rid = payload["rid"]
        if not self.paged:
            raise RequestRejected(
                f"request {rid}: migration target is not a paged engine")
        if self.owns_request(rid):
            return next(s for s, r in enumerate(self.active)
                        if r is not None and r.rid == rid)
        slot = next((s for s in range(self.slots)
                     if self.active[s] is None and s not in self._jobs),
                    None)
        if slot is None:
            raise CacheExhausted(
                f"request {rid}: no free slot on migration target")
        n = payload["chain_len"]
        if n > self.tables.shape[1]:
            raise RequestRejected(
                f"request {rid}: chain of {n} pages exceeds target table "
                f"width {self.tables.shape[1]}")
        if payload["page_size"] != self.page_size:
            raise RequestRejected(
                f"request {rid}: page_size {payload['page_size']} != "
                f"target {self.page_size}")
        tokens = payload.get("tokens")
        share = None
        if self.share_prefix and tokens:
            share = tokens[:self.page_size * (len(tokens)
                                              // self.page_size)] or None
        try:
            pages = self.alloc.allocate(rid, n, tokens=share)
        except CacheExhausted:
            self.stats["cache_exhausted"] += 1
            self.defragment()
            self.stats["defrag_events"] += 1
            pages = self.alloc.allocate(rid, n, tokens=share)
        shared = self.alloc.shared_count(rid)
        self.stats["shared_page_hits"] += shared
        self._ensure_cache()
        admit_kv(self._cache, state, pages, self.page_size, slot,
                 skip_pages=shared)
        row = self.tables[slot]
        row[:] = 0
        row[:len(pages)] = pages
        self.active[slot] = payload["req"]
        self.pos[slot] = payload["pos"]
        self.last_token[slot] = payload["last"]
        if self.share_prefix and share:
            self.alloc.register_prefix(rid)
        self.stats["migrations_in"] += 1
        self.stats["migration_blocks_shipped"] += n - shared
        self._dirty |= {"cache", "pos", "last_token", "tables"}
        return slot

    def release_request(self, rid: int) -> bool:
        """Commit side of an outbound migration: the target owns the
        request now, so free our pages and recycle the frozen slot.
        Idempotent (False when rid is not frozen here) — recovery may
        roll the same release forward twice."""
        slot = self._migrating.pop(rid, None)
        if slot is None:
            return False
        self.active[slot] = None
        self._reset_slot(slot, rid=rid)
        self.stats["migrations_out"] += 1
        self._dirty |= {"cache", "pos", "tables"}
        return True

    def abort_migration(self, rid: int) -> bool:
        """Abort side: thaw the frozen slot. The request never stopped
        being ours (pages, KV, Request object all untouched), so decode
        resumes next step exactly where it froze."""
        return self._migrating.pop(rid, None) is not None

    def abort_incoming(self, rid: int):
        """Target-side rollback: drop any (possibly partial) admission of
        ``rid``. Idempotent no-op when we never admitted it."""
        if not self.paged or rid not in self.alloc.owners():
            return
        for s, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                self.active[s] = None
                self._reset_slot(s, rid=rid)
                return
        self.alloc.free(rid)

    def owns_request(self, rid: int) -> bool:
        """Commit predicate for migration recovery: does this engine hold
        ``rid`` live (an active slot, a prefill job, the queue, or pages
        in its allocator)?"""
        if any(r is not None and r.rid == rid for r in self.active):
            return True
        if any(j.req.rid == rid for j in self._jobs.values()):
            return True
        if any(r.rid == rid for r in self.queue):
            return True
        return self.paged and rid in self.alloc.owners()

    def reset_after_crash(self):
        """Model an engine-process crash: device state (the cache, page
        pools, block tables) is lost, every queued/active request is
        gone. The fleet re-homes the victim's requests onto siblings
        BEFORE calling this (``ServeFleet.recover_engine``). The cache's
        device memory goes back to the allocator; the engine is empty but
        servable again (its cache is rebuilt at the next admission)."""
        self.queue.clear()
        self._jobs.clear()
        self._finished.clear()
        self._migrating.clear()
        self.active = [None] * self.slots
        self.pos = np.full((self.slots,), -1, np.int64)
        self.last_token = np.zeros((self.slots,), np.int32)
        self._cache = None
        if self.paged:
            self.alloc = BlockAllocator(self.num_pages, self.page_size)
            self.tables = np.zeros_like(self.tables)
            self._dirty.add("tables")
        self._dirty |= {"params", "cache", "pos", "last_token"}

    def run_until_idle(self, max_steps: int = 10_000) -> DrainResult:
        """Drive the engine until queue and slots drain; returns every
        request completed during the run (prefill-finished ones included),
        in completion order. On a PAUSED engine this returns immediately;
        check ``.drained`` to see whether work remains."""
        for _ in range(max_steps):
            if self.paused:
                break
            if self.step() == 0 and not self.queue and not self._jobs:
                break
        pending = (bool(self.queue) or bool(self._jobs)
                   or any(r is not None for r in self.active))
        done, self._finished = self._finished, []
        return DrainResult(done, drained=not pending)

    # -- state for SVFF pause (config-space save) ----------------------------
    def dirty_keys(self) -> set:
        """Top-level export_state keys mutated since the last export."""
        return set(self._dirty)

    def export_state(self) -> dict:
        """The engine's device-state snapshot, which a pause stages to the
        host. The cache is updated in place by every later step, so the
        snapshot holds a copy of it (JAX's immutable arrays gave the
        reference engine this for free). Params are never written in
        place and are handed back as they are."""
        cache = (None if self._cache is None else
                 tree_to(self._cache, self.device, copy=True))
        st = {"params": self.params, "cache": cache,
              "pos": self.pos.copy(), "last_token": self.last_token.copy()}
        if self.paged:
            st["tables"] = self.tables.copy()
        self._dirty = set()
        return st

    def import_state(self, st: dict):
        """Restore a snapshot, from host or device memory. The restored
        cache leaves are fresh tensors on the engine's device, so the snapshot
        stays valid after the engine writes into them."""
        if "params" in st:
            self._set_params(st["params"])
        self._cache = (None if st["cache"] is None else
                       tree_to(st["cache"], self.device, copy=True))
        self.pos = np.array(st["pos"], np.int64)
        self.last_token = np.array(st["last_token"], np.int32)
        if self.paged and "tables" in st:
            self.tables = np.array(st["tables"], np.int32)
        self._dirty = set(st)
