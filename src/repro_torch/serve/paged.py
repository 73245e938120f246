"""Paged KV cache: block-granular allocation for the serve plane (mirrors
``repro.serve.paged``).

The cache carves KV storage into fixed-size *pages* handed out on demand
from a shared pool:

  BlockAllocator     owns the page pool, tracks per-request ownership and
                     per-page refcounts, compacts on ``defragment`` (pure
                     Python, the JAX package's allocator as it is)
  page 0             reserved garbage page — never allocated; inactive batch
                     slots' masked writes are redirected there, which is how
                     an idle slot's pages stay bit-untouched
  copy-on-admit      a request is prefilled into a private dense staging
                     cache (B=1) and its KV is *copied* into its allocated
                     pages on admission (``admit_kv``)
  prefix sharing     requests whose token prefixes match map their block
                     tables onto the SAME physical pages (a prefix trie)
  copy-on-write      a decode write landing in a page with refcount > 1
                     splits exactly that page (``cow`` + ``copy_page``)

The page pools are torch tensors updated in place: ``admit_kv``,
``copy_page``, ``apply_page_moves`` and ``reset_slot_state`` write into
the tensors of the tree they are given and return that same tree.
``extract_kv`` (request migration) gathers a chain into fresh tensors.

The attention-side consumer is ``kernels/csrc/paged_decode.cu``
(block-table indirection, cost proportional to pages actually written).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.errors import (DoubleFreeError,  # noqa: F401
                                     UnknownRequestError)
# symmetric int8 KV rows over the trailing hd axis, scale = max|x| times
# float32(1/127) per (..., head) row (the JAX engine's scale under jit) and
# q = round(x / scale), half to even
from repro_torch.kernels.ref import (kv_dequant_ref as kv_dequantize,  # noqa
                                     kv_quant_ref as kv_quantize)


class RequestRejected(RuntimeError):
    """Typed admission rejection: the request can NEVER be served by this
    engine (over-long prompt, more pages than the pool holds). The engine
    marks the request done-with-error and keeps serving the batch — one
    bad request must not kill the engine (this replaces a bare ``assert``
    that vanished under ``python -O``)."""


class CacheExhausted(RuntimeError):
    """Transient allocation failure: not enough free pages *right now*.
    Admission backs off (the request stays queued) rather than failing."""


class BlockAllocator:
    """Fixed-size page pool with per-request ownership, per-page
    refcounts, and a prefix trie for copy-on-write page sharing.

    Page ids run [0, num_pages); page 0 is reserved (garbage page), so the
    allocatable capacity is ``num_pages - 1``. Free pages are handed out
    lowest-id first, which keeps block tables deterministic (the serving
    analogue of the scheduler's 'ties break in PF table order').

    Sharing model. A page's KV rows are a function of the ENTIRE token
    prefix up to and including the page's own tokens, so the trie keys
    are token-prefix tuples, not per-page token windows:

      full pages     ``tokens[: page_size * (i+1)]`` -> page of chain
                     index i (registered once, first placement wins)
      partial page   a prompt's last, partly-filled page, keyed under its
                     full-page prefix by the leftover token tuple. A later
                     request may share it only when its own leftover
                     tokens are an exact PREFIX of the registered entry's
                     — its rows are then already present at the right
                     offsets, and any longer registered tail (or the
                     registrant's decode rows parked above it) sits past
                     the sharer's position, masked by the decode kernel

    Registration happens at PLACE time (``register_prefix``), after the
    page bytes are actually written — pages reserved by an in-flight
    chunked prefill are never offered for sharing. Trie entries live
    exactly as long as the page has owners: the last ``free`` decref
    unregisters. Every owner of a page counts one refcount; a decode
    write into a page with refcount > 1 must go through ``cow`` first."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = list(range(1, num_pages))     # ascending
        self._owned: dict[int, list[int]] = {}     # rid -> page chain
        self._ref: dict[int, int] = {}             # page -> owner count
        self._shared: dict[int, int] = {}          # rid -> shared chain head
        self._tokens: dict[int, tuple] = {}        # rid -> prompt tokens
        # the trie: full-prefix keys -> page; partial entries grouped
        # under their full-page prefix; _site is the reverse map (one
        # registration per page) used by unregistration and defragment
        self._full: dict[tuple, int] = {}
        self._partial: dict[tuple, list] = {}      # key -> [(rest, page)]
        self._site: dict[int, tuple] = {}

    # -- capacity ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def pages_in_use(self) -> int:
        """Unique physical pages currently owned (the sharing win shows
        up here: N requests on one system prompt count its pages once)."""
        return self.capacity - len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    # -- the prefix trie -----------------------------------------------------
    def _lookup(self, tokens: tuple, n: int) -> list[int]:
        """Longest registered chain prefix for ``tokens``, at most ``n``
        pages: consecutive full-page hits from the root, then (only when
        every full page hit) at most one partial-page hit."""
        P = self.page_size
        shared: list[int] = []
        nfull = len(tokens) // P
        for i in range(min(nfull, n)):
            page = self._full.get(tokens[:P * (i + 1)])
            if page is None:
                return shared
            shared.append(page)
        rest = tokens[P * nfull:]
        if rest and len(shared) == nfull < n:
            for reg_rest, page in self._partial.get(tokens[:P * nfull], ()):
                if rest == reg_rest[:len(rest)]:
                    shared.append(page)
                    break
        return shared

    def register_prefix(self, rid: int) -> int:
        """Offer rid's PROMPT pages (the tokens recorded at allocate) for
        sharing. Idempotent and conflict-safe: a page registers at most
        once, a key keeps its first page. Returns entries added."""
        tokens = self._tokens.get(rid)
        chain = self._owned.get(rid)
        if not tokens or not chain:
            return 0
        P = self.page_size
        added = 0
        nfull = len(tokens) // P
        for i in range(min(nfull, len(chain))):
            key = tokens[:P * (i + 1)]
            page = chain[i]
            if key not in self._full and page not in self._site:
                self._full[key] = page
                self._site[page] = ("full", key)
                added += 1
        rest = tokens[P * nfull:]
        if rest and nfull < len(chain):
            page = chain[nfull]
            key = tokens[:P * nfull]
            node = self._partial.setdefault(key, [])
            if page not in self._site and rest not in [r for r, _ in node]:
                node.append((rest, page))
                self._site[page] = ("partial", key, rest)
                added += 1
        return added

    def _unregister(self, page: int):
        site = self._site.pop(page, None)
        if site is None:
            return
        if site[0] == "full":
            del self._full[site[1]]
        else:
            node = self._partial[site[1]]
            node.remove((site[2], page))
            if not node:
                del self._partial[site[1]]

    # -- allocate / free -----------------------------------------------------
    def allocate(self, rid: int, n: int,
                 tokens: Optional[tuple] = None) -> list[int]:
        """Hand ``rid`` a chain of ``n`` pages. With ``tokens`` (the
        prompt the pages will hold), the chain head reuses registered
        shared pages — only the remainder consumes free pages. The
        exhaustion check runs BEFORE any refcount moves, so a failed
        allocation is side-effect-free."""
        if rid in self._owned:
            raise ValueError(f"request {rid} already holds pages")
        if n > self.capacity:
            raise RequestRejected(
                f"request {rid} needs {n} pages; pool capacity is "
                f"{self.capacity} (page_size={self.page_size})")
        shared = self._lookup(tuple(tokens), n) if tokens else []
        fresh = n - len(shared)
        if fresh > len(self._free):
            raise CacheExhausted(
                f"request {rid} needs {fresh} fresh pages "
                f"({len(shared)} shared), only {len(self._free)} free")
        got, self._free = self._free[:fresh], self._free[fresh:]
        for p in shared:
            self._ref[p] += 1
        for p in got:
            self._ref[p] = 1
        self._owned[rid] = shared + got
        self._shared[rid] = len(shared)
        if tokens is not None:
            self._tokens[rid] = tuple(tokens)
        return list(self._owned[rid])

    def extend(self, rid: int, n: int = 1) -> list[int]:
        """Lazy decode growth: append ``n`` fresh (private) pages to
        rid's chain. Decode-grown pages are never offered for sharing.
        Unknown rid is an ``UnknownRequestError`` — see the class."""
        if rid not in self._owned:
            raise UnknownRequestError(
                f"extend of request {rid}, which holds no pages")
        if n > len(self._free):
            raise CacheExhausted(
                f"request {rid} needs {n} more pages, only "
                f"{len(self._free)} free")
        got, self._free = self._free[:n], self._free[n:]
        for p in got:
            self._ref[p] = 1
        self._owned[rid].extend(got)
        return list(got)

    def shared_count(self, rid: int) -> int:
        """Pages at the head of rid's chain that came from the trie at
        allocate time (the copy-on-admit scatter skips exactly these)."""
        return self._shared.get(rid, 0)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def cow(self, rid: int, idx: int) -> tuple[int, int]:
        """Copy-on-write split: replace the shared page at chain index
        ``idx`` with a fresh private one (caller device-copies the bytes
        via ``copy_page`` and repoints its own table row). Returns
        ``(old_page, new_page)``."""
        if rid not in self._owned:
            raise UnknownRequestError(
                f"cow of request {rid}, which holds no pages")
        chain = self._owned[rid]
        old = chain[idx]
        if self._ref[old] <= 1:
            raise ValueError(
                f"cow of unshared page {old} (rid {rid}, idx {idx})")
        if not self._free:
            raise CacheExhausted(
                f"request {rid} needs 1 page for a CoW split, none free")
        new = self._free.pop(0)
        self._ref[new] = 1
        chain[idx] = new
        self._ref[old] -= 1           # > 0 by the guard above
        return old, new

    def _decref(self, page: int):
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._unregister(page)
            self._free.append(page)
            self._free.sort()

    def free(self, rid: int) -> list[int]:
        """Release rid's references. Pages drop to the free list only
        when their LAST owner lets go (a finished request's shared
        system-prompt pages stay live for its siblings). Unknown rid is a
        ``DoubleFreeError`` — see the class docstring."""
        pages = self._owned.pop(rid, None)
        if pages is None:
            raise DoubleFreeError(
                f"free of request {rid}, which holds no pages "
                "(double free, or never allocated)")
        self._shared.pop(rid, None)
        self._tokens.pop(rid, None)
        for p in pages:
            self._decref(p)
        return pages

    def pages_of(self, rid: int) -> list[int]:
        return list(self._owned.get(rid, []))

    def tokens_of(self, rid: int) -> Optional[tuple]:
        """The prompt tokens recorded at allocate time (what migration
        ships so the target allocator can re-share trie pages)."""
        return self._tokens.get(rid)

    def owners(self) -> dict[int, list[int]]:
        return {rid: list(p) for rid, p in self._owned.items()}

    def check_invariants(self):
        """Mirror of DevicePool._check_invariants, refcount-aware: every
        page's refcount equals its live chain references, free+owned is
        an exact partition, and the trie/site maps agree and only name
        live pages."""
        refs: dict[int, int] = {}
        for rid, pages in self._owned.items():
            seen = set()
            for p in pages:
                assert 1 <= p < self.num_pages, (rid, p)
                assert p not in seen, (
                    f"page {p} twice in request {rid}'s chain")
                seen.add(p)
                refs[p] = refs.get(p, 0) + 1
        assert set(refs) == set(self._ref), (
            f"refcount key drift: owned {sorted(refs)} != "
            f"counted {sorted(self._ref)}")
        for p, want in refs.items():
            assert self._ref[p] == want, (
                f"refcount drift: page {p} counted {self._ref[p]}, "
                f"{want} live chain references")
        assert not (set(self._free) & set(refs))
        assert len(self._free) + len(refs) == self.capacity
        for rid, nsh in self._shared.items():
            assert 0 <= nsh <= len(self._owned.get(rid, ())), (rid, nsh)
        for page, site in self._site.items():
            assert page in refs, f"trie entry for freed page {page}"
            if site[0] == "full":
                assert self._full.get(site[1]) == page, site
            else:
                assert (site[2], page) in self._partial.get(site[1], ()), \
                    site
        for key, page in self._full.items():
            assert self._site.get(page) == ("full", key)
        for key, node in self._partial.items():
            for rest, page in node:
                assert self._site.get(page) == ("partial", key, rest)

    # -- defragment ----------------------------------------------------------
    def defragment(self) -> dict[int, int]:
        """Compact owned pages to the lowest ids (request order, then
        chain order, each UNIQUE page re-id'd once — a shared page moves
        once and every sharer's chain follows). Returns the {old: new}
        moves; the caller must apply the same mapping to the physical
        page arrays and any block tables (``apply_page_moves``)."""
        newid: dict[int, int] = {}
        nxt = 1
        for rid in sorted(self._owned):
            for p in self._owned[rid]:
                if p not in newid:
                    newid[p] = nxt
                    nxt += 1
        moves = {old: new for old, new in newid.items() if old != new}
        self._owned = {rid: [newid[p] for p in pages]
                       for rid, pages in self._owned.items()}
        self._ref = {newid[p]: c for p, c in self._ref.items()}
        self._full = {k: newid[p] for k, p in self._full.items()}
        self._partial = {k: [(r, newid[p]) for r, p in node]
                         for k, node in self._partial.items()}
        self._site = {newid[p]: s for p, s in self._site.items()}
        self._free = list(range(nxt, self.num_pages))
        self.check_invariants()
        return moves


def permutation_of(moves: dict[int, int], num_pages: int) -> np.ndarray:
    """(num_pages,) gather indices g with new_pages = pages[g]. Moves from
    ``defragment`` never swap into a still-live source (targets are always
    compacted below their sources), so a single gather applies them all."""
    g = np.arange(num_pages)
    for old, new in moves.items():
        g[new] = old
    return g


# ---------------------------------------------------------------------------
# the paged cache tree
# ---------------------------------------------------------------------------
_KV = ("k", "v")
_KV_SCALE = ("k_scale", "v_scale")
_CROSS_KV = ("xk", "xv")     # dense caches only: see paged_cache_supported


def paged_cache_supported(cfg) -> tuple[bool, str]:
    if cfg.is_encoder_decoder:
        return False, "encoder-decoder cross-KV is not paged"
    if "attn" not in cfg.block_pattern:
        return False, "attention-free stack has no KV to page"
    return True, ""


def _paged(name: str) -> bool:
    """A page-pool leaf (KV payload or its int8 scales), not dense
    per-slot state."""
    return name in _KV or name in _KV_SCALE


def init_paged_cache(model, shape, num_pages: int, page_size: int,
                     kv_dtype: Optional[str] = None, device="cuda") -> dict:
    """Build the serve cache tree: attention k/v leaves become shared page
    pools (nper, P, page, K, hd) in the compute dtype; every other leaf
    (a mamba layer's conv and SSM state) stays dense per slot, (nper, B,
    ...) zeros, as ``Model.init_cache`` makes it.

    ``kv_dtype='int8'`` stores the pools quantized, with per-(row,head)
    symmetric scales in fp32 ``k_scale``/``v_scale`` siblings of shape
    (nper, P, page, K)."""
    ok, why = paged_cache_supported(model.cfg)
    if not ok:
        raise ValueError(f"paged KV unsupported for {model.cfg.name}: {why}")
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                         "(None or 'int8')")
    specs = model.cache_specs(shape)
    tree = {}
    for blk, node in specs.items():
        tree[blk] = {}
        for name, sd in node.items():
            if not _paged(name):
                tree[blk][name] = torch.zeros(sd.shape, dtype=sd.dtype,
                                              device=device)
                continue
            nper, _, _, K, hd = sd.shape
            pool = (nper, num_pages, page_size, K, hd)
            if kv_dtype == "int8":
                tree[blk][name] = torch.zeros(pool, dtype=torch.int8,
                                              device=device)
                tree[blk][name + "_scale"] = torch.zeros(
                    pool[:-1], dtype=torch.float32, device=device)
            else:
                tree[blk][name] = torch.zeros(pool, dtype=sd.dtype,
                                              device=device)
    return tree


def admit_kv(cache: dict, req_cache: dict, page_ids, page_size: int,
             slot: int, skip_pages: int = 0) -> dict:
    """Copy-on-admit: scatter a prefilled request's (nper, 1, L, K, hd)
    KV into its allocated pages, in place. ``skip_pages`` leading pages of
    the chain are trie-shared and already hold the right rows — writing
    them here would zero-pad over a sibling's live rows, so they are
    excluded from the scatter.

    The pool may be int8 while the request cache is always the fp dense
    staging layout: quantization happens here, and the scale siblings are
    filled from the same (zero-padded) rows. Dense per-slot state (a
    mamba layer's conv and SSM state) is written into batch slot
    ``slot``, also when the whole prompt was shared."""
    skip = int(skip_pages)
    ids = list(page_ids)[skip:]
    n = len(ids)
    for blk, node in cache.items():
        for name, leaf in node.items():
            if not _paged(name):
                leaf[:, slot] = req_cache[blk][name][:, 0].to(leaf.device,
                                                              leaf.dtype)
        if n == 0 or "k" not in node:   # whole prompt shared: no KV rows
            continue
        dev = node["k"].device
        idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        for name in _KV:
            # a shipped strip may come back from staging in host memory:
            # it moves to the pool's device before the scatter
            r = req_cache[blk][name].to(dev)
            nper, _, L, K, hd = r.shape
            rows = torch.zeros((nper, n * page_size, K, hd), dtype=r.dtype,
                               device=r.device)
            rows[:, :L - skip * page_size] = r[:, 0, skip * page_size:]
            rows = rows.reshape(nper, n, page_size, K, hd)
            pooled = node[name]
            if pooled.dtype == torch.int8:
                q, scale = kv_quantize(rows)
                pooled[:, idx] = q
                node[name + "_scale"][:, idx] = scale
            else:
                pooled[:, idx] = rows.to(pooled.dtype)
    return cache


def extract_kv(cache: dict, page_ids, page_size: int, slot: int) -> dict:
    """Gather dual of ``admit_kv``, for request migration: pull a
    request's KV block chain out of the page pools into a dense
    (nper, 1, n*page_size, K, hd) request tree, and slice its batch slot
    out of every dense (recurrent-state) leaf, keeping the slot axis. The
    result has exactly the shape ``admit_kv`` scatters, so target-side
    admission IS ``admit_kv(..., skip_pages=n_reshared)``. Every leaf is
    a fresh tensor on the pools' device: later writes into the pools do
    not reach it.

    int8 pools are DEQUANTIZED to fp32 here and the scale leaves dropped:
    a migration payload is always the fp dense layout, so source and
    target engines may run different ``kv_dtype`` settings; a target that
    re-admits into int8 requantizes the rows (``kv_quantize``)."""
    ids = list(page_ids)
    n = len(ids)
    out = {}
    for blk, node in cache.items():
        out[blk] = {}
        for name, leaf in node.items():
            if name in _KV_SCALE:
                continue
            if name in _KV:
                idx = torch.as_tensor(ids, dtype=torch.int64,
                                      device=leaf.device)
                nper, _, P, K, hd = leaf.shape
                rows = leaf[:, idx]
                if leaf.dtype == torch.int8:
                    rows = kv_dequantize(rows, node[name + "_scale"][:, idx])
                out[blk][name] = rows.reshape(nper, 1, n * P, K, hd)
            else:
                out[blk][name] = leaf[:, slot:slot + 1].clone()
    return out


def copy_page(cache: dict, src: int, dst: int) -> dict:
    """CoW page split, device side: duplicate one physical page across
    every KV pool (and its quantization scales), in place, so the writer's
    fresh private page starts bit-identical to the shared one."""
    for node in cache.values():
        for name, leaf in node.items():
            if _paged(name):
                leaf[:, dst] = leaf[:, src]
    return cache


def apply_page_moves(cache: dict, moves: dict[int, int]) -> dict:
    """Apply a ``defragment`` move map to the physical page pools, in
    place (quantization scales ride along — their axis 1 is the same page
    id)."""
    if not moves:
        return cache
    for node in cache.values():
        for name, leaf in node.items():
            if not _paged(name):
                continue
            g = torch.as_tensor(permutation_of(moves, leaf.shape[1]),
                                device=leaf.device)
            leaf.copy_(leaf[:, g])
    return cache


def reset_slot_state(cache: dict, slot: int) -> dict:
    """Reset a finished slot's dense recurrent state, in place: zeros,
    and the exp-gate stabilizers (leaves named "m") at -1e30, as a fresh
    cache holds them. KV needs no reset: paged KV (and its scales) pages
    return to the allocator, dense KV rows are masked by the slot's
    position, and an encoder-decoder's cross KV is overwritten from row 0
    by the next prefill of the slot."""
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            reset_slot_state(leaf, slot)
        elif not _paged(name) and name not in _CROSS_KV:
            leaf[:, slot] = -1e30 if name == "m" else 0
    return cache
