"""Serving engine: continuous batching over the paged-KV decode step
(mirrors ``repro.serve.engine``).

Requests are admitted into slots of a batched decode state and decoded
together; finished slots are recycled without stopping the batch. Slots
borrow fixed-size pages from a shared pool through a ``BlockAllocator``;
decode is block-table-indirected (``kernels/csrc/paged_decode.cu``) and
costs only the pages a request has written. A hybrid stack's mamba
layers keep their conv and SSM state dense per slot beside the pages.
Prefill is whole-prompt (B=1) through ``kernels/csrc/flash_attention.cu``
and, in mamba layers, ``kernels/csrc/ssm_scan.cu``, whose chunk rule
rejects a prompt longer than the SSM chunk that is not a multiple of it
(the engine never pads a prompt); with ``fused_sampling`` the sampler
runs on the device (``kernels/csrc/fused_sample.cu``) and only token ids
come back. Sampling is per-request temperature / top-k with a
counter-seeded RNG — a request's tokens are a pure function of (request,
logits), so a pause mid-request cannot change its output (invariant I10).

Not ported yet (ROADMAP, deferred serve-engine parts): the dense
per-slot ring layout, chunked prefill of an all-attention stack (any
other stack turns it off, as the JAX engine does), and request
migration; each raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, RunConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import check_ssm_chunk
from repro_torch.kernels.sampling import host_gumbel
from repro_torch.models.model import build_model
from repro_torch.serve.paged import (BlockAllocator, CacheExhausted,
                                     RequestRejected, admit_kv,
                                     apply_page_moves, copy_page,
                                     init_paged_cache, paged_cache_supported,
                                     reset_slot_state)
from repro_torch.train.step import make_decode_step, make_serve_steps
from repro_torch.tree import tree_to

_DEFERRED = ("is not ported yet (ROADMAP: deferred serve-engine parts — "
             "dense layout, chunked prefill, migration)")


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


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class ServeEngine:
    def __init__(self, run: RunConfig, params, *, device="cuda",
                 slots: int = 4, max_len: int = 256, paged: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 0, share_prefix: bool = False,
                 kv_dtype: Optional[str] = None,
                 fused_sampling: bool = False):
        self.device = resolve_device(device)
        if not paged:
            raise NotImplementedError(f"the dense cache layout {_DEFERRED}")
        # chunked prefill needs per-chunk attention continuation, which
        # only an all-attention stack has; for any other stack the JAX
        # engine turns it off (recurrent blocks would need their
        # chunk-boundary state threaded through), and so does the port
        if prefill_chunk and all(b == ATTN for b in run.model.block_pattern):
            raise NotImplementedError(f"chunked prefill {_DEFERRED}")
        self.prefill_chunk = 0
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
        #: cache-pressure / sharing counters, cumulative over the
        #: engine's lifetime
        self.stats = collections.Counter()
        # per-step dirty set: which export_state keys changed since the
        # last export (params stay the same tensors across exports)
        self._dirty = {"params", "cache", "pos", "last_token", "tables"}

        cfg = run.model
        ok, why = paged_cache_supported(cfg)
        if not ok:
            raise ValueError(f"paged KV for {cfg.name}: {why}")
        self.kv_dtype = kv_dtype
        #: fused sampling: temperature/top-k Gumbel sampling runs on the
        #: device after the decode step and only token ids come back to
        #: the host — bit-identical to the host ``_sample`` path (both
        #: draw the same portable counter-hash noise), so I10 holds
        #: across the knob
        self.fused_sampling = bool(fused_sampling)
        self.page_size = page_size
        maxp = math.ceil(max_len / page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else 1 + slots * maxp)
        self.alloc = BlockAllocator(self.num_pages, page_size)
        self.tables = np.zeros((slots, maxp), np.int32)
        self.share_prefix = bool(share_prefix)

        self._prefill, _ = make_serve_steps(run)
        self._decode = make_decode_step(run, paged=True,
                                        fused=self.fused_sampling)
        self._cache = None                              # lazy page pools

    # -- cache plumbing -------------------------------------------------------
    def _ensure_cache(self):
        if self._cache is None:
            shape = dataclasses.replace(self.run.shape, seq_len=self.max_len,
                                        global_batch=self.slots)
            self._cache = init_paged_cache(self.model, shape, self.num_pages,
                                           self.page_size,
                                           kv_dtype=self.kv_dtype,
                                           device=self.device)

    def _set_params(self, params):
        # ``params`` is the master copy export_state hands out; the steps
        # read ``_cparams``, its matrices cast once to the compute dtype
        self.params = tree_to(params, self.device)
        self._cparams = self.model.compute_params(self.params)

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
        need = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) < 1:
            raise RequestRejected(f"request {req.rid}: empty prompt")
        if MAMBA in self.run.model.block_pattern:
            # the SSD scan's chunk rule; the engine never pads a prompt,
            # since pad tokens would enter the recurrent state
            try:
                check_ssm_chunk(len(req.prompt), self.run.model.ssm.chunk)
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
            req.rid, self.alloc.pages_needed(len(req.prompt)), tokens=tokens)

    def _admit(self):
        """Fill free slots from the queue. A request that is rejected or
        finishes at prefill does NOT consume the slot — it is re-offered
        to the next queued request in the same pass."""
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            while self.queue:
                req = self.queue.popleft()
                try:
                    need = self._validate(req)
                    pages = self._paged_admit(req, need)
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
                if self._prefill_full(s, req, pages):
                    break                         # slot now decoding
                # finished at prefill: slot re-offered to the next request

    def _prefill_full(self, slot: int, req: Request, pages) -> bool:
        """B=1 whole-prompt prefill. Returns True if the slot is occupied
        (request entered the decode batch), False if it finished at
        prefill (slot stays free — nothing was written into it)."""
        tokens = self._tensor(req.prompt, torch.int64)[None]
        req_cache, last_logits = self._prefill(self._cparams,
                                               {"tokens": tokens})
        tok = self._emit(req, last_logits[0].cpu().numpy())
        if req.done:
            self.alloc.free(req.rid)
            return False
        self._place(slot, req, req_cache, len(req.prompt), pages)
        self.last_token[slot] = tok
        return True

    def _place(self, slot: int, req: Request, req_cache, logical_len: int,
               pages):
        """Copy-on-admit: move a prefilled request's KV into its allocated
        pages, skipping the trie-shared chain head."""
        shared = self.alloc.shared_count(req.rid)
        self.stats["shared_page_hits"] += shared
        admit_kv(self._cache, req_cache, pages, self.page_size, slot,
                 skip_pages=shared)
        row = self.tables[slot]
        row[:] = 0
        row[:len(pages)] = pages
        # offer this prompt's pages for sharing only now that their bytes
        # are written
        if self.share_prefix:
            self.alloc.register_prefix(req.rid)
        self.active[slot] = req
        self.pos[slot] = logical_len - 1
        self._dirty |= {"cache", "pos", "last_token", "tables"}

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
        """One engine iteration: admit + one batched decode over the
        ACTIVE slots (inactive slots are masked out: their pages stay
        untouched and they add no attention work). Returns the number of
        active slots (0 = idle). No-op while paused."""
        if self.paused:
            return 0
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        self._ensure_cache()
        # every write target must be private and allocated BEFORE the
        # batched call: lazily grow the chain and CoW-split shared pages;
        # a slot the pool cannot serve is preempted
        act = [s for s in act if self._ensure_writable(s)]
        if not act:
            return 0
        act_mask = np.zeros((self.slots,), bool)
        act_mask[act] = True
        pos_new = np.where(act_mask, self.pos + 1, -1).astype(np.int32)
        W = self._table_width(pos_new)
        args = [self._cparams, self._cache,
                self._tensor(np.where(act_mask, self.last_token, 0)[:, None],
                             torch.int64),
                self._tensor(pos_new, torch.int32),
                self._tensor(np.ascontiguousarray(self.tables[:, :W]),
                             torch.int32),
                self._tensor(act_mask, torch.bool)]
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
        """Recycle a finished slot: its pages go back to the allocator."""
        if rid is not None:
            self.alloc.free(rid)
        self.tables[slot, :] = 0
        self._dirty.add("tables")
        reset_slot_state(self._cache, slot)
        self.pos[slot] = -1

    def defragment(self) -> dict:
        """Compact the page pool (allocator + physical pages + tables);
        returns the {old: new} page moves."""
        moves = self.alloc.defragment()
        if moves and self._cache is not None:
            apply_page_moves(self._cache, moves)
            self._dirty |= {"cache", "tables"}
        for s, req in enumerate(self.active):
            if req is not None:
                pages = self.alloc.pages_of(req.rid)
                self.tables[s, :] = 0
                self.tables[s, :len(pages)] = pages
        return moves

    # -- request migration (not ported yet) -----------------------------------
    def peek_migratable(self, rid: Optional[int] = None):
        raise NotImplementedError(f"request migration {_DEFERRED}")

    extract_request = admit_migrated = release_request = peek_migratable
    abort_migration = abort_incoming = owns_request = peek_migratable
    reset_after_crash = peek_migratable

    def run_until_idle(self, max_steps: int = 10_000) -> DrainResult:
        """Drive the engine until queue and slots drain; returns every
        request completed during the run (prefill-finished ones included),
        in completion order. On a PAUSED engine this returns immediately;
        check ``.drained`` to see whether work remains."""
        for _ in range(max_steps):
            if self.paused:
                break
            if self.step() == 0 and not self.queue:
                break
        pending = (bool(self.queue)
                   or any(r is not None for r in self.active))
        done, self._finished = self._finished, []
        return DrainResult(done, drained=not pending)

    # -- state for SVFF pause (config-space save) ----------------------------
    def dirty_keys(self) -> set:
        """Top-level export_state keys mutated since the last export."""
        return set(self._dirty)

    def export_state(self) -> dict:
        """The engine's device-state snapshot, which a pause stages to the
        host. The page pools are updated in place by every later step, so
        the snapshot holds a copy of them (JAX's immutable arrays gave the
        reference engine this for free). Params are never written in
        place and are handed back as they are."""
        cache = (None if self._cache is None else
                 tree_to(self._cache, self.device, copy=True))
        st = {"params": self.params, "cache": cache,
              "pos": self.pos.copy(), "last_token": self.last_token.copy(),
              "tables": self.tables.copy()}
        self._dirty = set()
        return st

    def import_state(self, st: dict):
        """Restore a snapshot, from host or device memory. The restored
        pools are fresh tensors on the engine's device, so the snapshot
        stays valid after the engine writes into them."""
        if "params" in st:
            self._set_params(st["params"])
        self._cache = (None if st["cache"] is None else
                       tree_to(st["cache"], self.device, copy=True))
        self.pos = np.array(st["pos"], np.int64)
        self.last_token = np.array(st["last_token"], np.int32)
        if "tables" in st:
            self.tables = np.array(st["tables"], np.int32)
        self._dirty = set(st)
