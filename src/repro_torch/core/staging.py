"""StagingEngine — the Xilinx QDMA analogue (paper §IV-A; mirrors
``repro.core.staging``).

QDMA moves VF memory between device and host through descriptor queues.
Here the engine moves tenant state trees card <-> host through a
pipelined descriptor engine: leaves are split into fixed-size row-chunk
DESCRIPTORS (so one huge leaf does not serialize a single queue), and
each descriptor flows through an overlapped 3-stage pipeline:

  save:     on-device pack (``qdma_pack_rows``: blockwise int8, or a
            row-slice view) -> D2H over ``num_queues`` transfer queues ->
            host assemble (each descriptor lands in its rows of the leaf's
            host buffer)
  restore:  host burst -> H2D per queue -> on-device unpack into the rows
            of the leaf's device buffer

Every pack for descriptor i+1 is dispatched before descriptor i's D2H
completes (kernel launches are asynchronous), which is the double-
buffering of the QDMA descriptor ring.

What differs from the JAX engine, and why:

  host repr  a leaf on the card stages to a CPU tensor (pinned in the
             ``stream`` transport, so its D2H is asynchronous); numpy
             leaves stay numpy copies; ``QuantizedLeaf.q``/``.scale`` are
             CPU tensors. numpy is not used for tensor payloads because
             it has no bfloat16 without ``ml_dtypes``.
  queues     on the card each queue is a CUDA stream that waits on the
             stream that dispatched the packs and slices; the descriptors
             (the source tensors) are held until the queues are
             synchronized, so no source block is reused mid-copy. A save
             or restore ends with a synchronize: ``TransferStats.seconds``
             is the transfer's time, not its dispatch time.
  borrow     JAX borrows immutable CPU buffers zero-copy. A torch tensor
             can be written in place, so the port's ``borrow`` copies each
             CPU leaf whole: a pause snapshot never aliases live state.
  identity   JAX's premise is that an array is immutable, so the same
             object means the same bytes. For a torch tensor the memo
             records the tensor AND its ``_version`` (torch's count of
             in-place writes); a hit needs both to match.

Transports (``transport=``): ``borrow`` (whole-leaf copies, descriptors
only for packed leaves), ``stream`` (every leaf row-chunked into
descriptors), ``auto`` (stream when the leaves, or the restore target,
are on the card; borrow on the CPU).

Dirty tracking (``incremental=True``): ``identity`` skips a leaf that is
the same unmodified tensor as in the previous save; ``digest``
additionally skips mutated-but-equal leaves by their on-device content
fingerprint (``qdma_digest``; crc32 for numpy leaves). The memo is
scoped per tenant (``save(tree, tenant=...)``) and released by
``clear(tenant)``; its updates are published only once a save is
complete (transactional), so a crash mid-save leaves it as it was.

Compression is OFF by default: the paper-faithful pause path is bit-exact.
``pipeline=False`` keeps the PR-1 engine (whole-leaf round-robin over
queues, ``qdma_pack`` per leaf) as the baseline.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.fault import crashpoint
from repro_torch.core.ranks import RankShardings, RankState
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import row_view
from repro_torch.tree import flatten, unflatten

_GLOBAL = "__global__"


@dataclasses.dataclass
class TransferStats:
    bytes_moved: int = 0        # host-repr bytes that crossed the link
    logical_bytes: int = 0      # unpacked logical bytes of the tree
    seconds: float = 0.0
    num_leaves: int = 0
    queues: int = 1
    skipped_bytes: int = 0      # host-repr bytes reused from the memo
    num_descriptors: int = 0
    transport: str = "borrow"

    @property
    def bandwidth_gbps(self) -> float:
        return self.bytes_moved / max(self.seconds, 1e-9) / 1e9


@dataclasses.dataclass
class QuantizedLeaf:
    """Host-side packed leaf: blockwise int8 + per-block scales."""
    q: torch.Tensor                   # int8 CPU tensor, original shape
    scale: torch.Tensor               # fp32 CPU, shape[:-1] + (blocks,)
    dtype: str                        # "float32" | "bfloat16"
    block: int


class _Opaque:
    """Wrapper so a QuantizedLeaf traverses trees as a single leaf."""
    def __init__(self, leaf: QuantizedLeaf):
        self.leaf = leaf


def dtype_name(t: torch.Tensor) -> str:
    """A tensor's dtype as the JAX package spells it ("bfloat16")."""
    return str(t.dtype).removeprefix("torch.")


def _nbytes(x) -> int:
    """Host-representation bytes — the symmetric save/restore unit of
    account: a quantized leaf counts its packed q+scale bytes, once."""
    if isinstance(x, _Opaque):
        x = x.leaf
    if isinstance(x, QuantizedLeaf):
        return _nbytes(x.q) + _nbytes(x.scale)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


@dataclasses.dataclass
class _Memo:
    ref: Any            # the tensor (identity check) or None
    version: int        # ref._version when its host copy was taken
    digest: Any         # content fingerprint tuple or None
    host: Any           # host copy (tensor, ndarray or QuantizedLeaf)


@dataclasses.dataclass
class _Descriptor:
    leaf: int           # flat leaf index
    chunk: int
    lo: int             # row range in the leaf's 2-D (rows, L) view
    rows: int
    nbytes: int         # estimated D2H bytes (queue balancing)
    packed: bool
    dev: Any = None     # source tensor / (q, scale) awaiting D2H


class _Queues:
    """The transfer queues of one save or restore. On the card each queue
    is a CUDA stream, which first waits for the work already queued on
    the current stream (the packs and slices it will copy); on the CPU a
    queue is a plain in-order copy."""

    def __init__(self, engine: "StagingEngine", device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.streams = engine._streams(device) if self.cuda else []
        if self.cuda:
            self.cur = torch.cuda.current_stream(device)
            for s in self.streams:
                s.wait_stream(self.cur)

    def _stream(self, q: int):
        return self.streams[q % len(self.streams)]

    def download(self, q: int, dst: torch.Tensor, src: torch.Tensor):
        """Copy the device tensor ``src`` into the host tensor ``dst`` on
        queue q (the caller keeps ``src`` alive until ``join``)."""
        if not self.cuda:
            dst.copy_(src)
            return
        with torch.cuda.stream(self._stream(q)):
            dst.copy_(src, non_blocking=True)

    def upload(self, q: int, src: torch.Tensor) -> torch.Tensor:
        """A fresh tensor on the target device holding ``src``, copied on
        queue q; the current stream may use it after ``ready(q)``. It is
        allocated on the queue's stream and marked as used by the current
        one, so the allocator never hands its block to a later upload
        while a kernel on the current stream still reads it."""
        if not self.cuda:
            return src.to(self.device, copy=True)
        with torch.cuda.stream(self._stream(q)):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(src, non_blocking=True)
        out.record_stream(self.cur)
        return out

    def ready(self, q: int):
        """Order the current stream after queue q's copies so far."""
        if self.cuda:
            self.cur.wait_stream(self._stream(q))

    def join(self):
        """Wait for every queue: the copies are done, and their sources
        may go."""
        if self.cuda:
            for s in self.streams:
                self.cur.wait_stream(s)
            torch.cuda.synchronize(self.device)


class StagingEngine:
    def __init__(self, num_queues: int = 8, compression: str = "none",
                 block: int = 256, min_quant_size: int = 4096,
                 incremental: bool = False, pipeline: bool = True,
                 chunk_bytes: int = 32 << 20, transport: str = "auto",
                 dirty: str = "identity"):
        if compression not in ("none", "int8"):
            raise ValueError(f"compression {compression!r}")
        if transport not in ("auto", "borrow", "stream"):
            raise ValueError(f"transport {transport!r}")
        if dirty not in ("identity", "digest"):
            raise ValueError(f"dirty {dirty!r}")
        self.num_queues = num_queues
        self.compression = compression
        self.block = block
        self.min_quant_size = min_quant_size
        self.incremental = incremental
        self.pipeline = pipeline
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.transport = transport
        self.dirty = dirty
        self._memos: dict[str, dict[str, _Memo]] = {}
        self._stream_cache: dict[torch.device, list] = {}
        self.last_stats: Optional[TransferStats] = None

    # -- memo (per-tenant incremental state) -----------------------------------
    def _memo_for(self, tenant: Optional[str]) -> dict:
        return self._memos.setdefault(tenant or _GLOBAL, {})

    def memo_size(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return sum(len(m) for m in self._memos.values())
        return len(self._memos.get(tenant or _GLOBAL, {}))

    def clear(self, tenant: Optional[str] = None) -> None:
        """Drop incremental-snapshot state. ``clear(tid)`` releases one
        tenant's memo — and with it the memo's references to the tenant's
        device tensors (called by the manager on detach and after pause);
        ``clear()`` drops everything."""
        if tenant is None:
            self._memos.clear()
        else:
            self._memos.pop(tenant, None)

    def close(self) -> None:
        """A no-op, kept for the reference's API: the JAX engine joins its
        long-lived transfer-queue threads here, while the port opens a
        thread pool per save or restore call (and closes it before the
        call returns), so there is nothing left to join."""

    def _digest_dispatch(self, x):
        """Start a digest: for a tensor the kernel is launched
        asynchronously (the (2,) result is read later by
        ``_digest_finalize``), so many leaves' digests are queued on the
        card before the first is read."""
        if isinstance(x, torch.Tensor):
            return ["dev", tuple(x.shape), dtype_name(x), kops.qdma_digest(x)]
        a = np.ascontiguousarray(np.asarray(x))
        return ("crc", a.shape, str(a.dtype), zlib.crc32(a))

    @staticmethod
    def _digest_finalize(dg):
        if isinstance(dg, list):          # pending device digest
            return ("dev", dg[1], dg[2], tuple(dg[3].tolist()))
        return dg

    @staticmethod
    def _unchanged(e: Optional[_Memo], x) -> bool:
        """The memo entry holds this very tensor, not written since."""
        return (e is not None and isinstance(x, torch.Tensor)
                and e.ref is x and e.version == x._version)

    def _memo_hit(self, memo: dict, key: str, x, incremental: bool,
                  digest=None):
        """(host copy of x if it provably hasn't changed since the last
        save, else None; digest of x if one was computed — callers hand it
        back to ``_memo_put`` so a missed leaf is digested exactly once).
        ``digest`` lets the pipelined save pass a pre-dispatched digest."""
        if not incremental:
            return None, None
        e = memo.get(key)
        if self._unchanged(e, x):
            return e.host, e.digest
        dg = None
        if self.dirty == "digest" and isinstance(x, (torch.Tensor,
                                                     np.ndarray)):
            dg = self._digest_finalize(
                digest if digest is not None else self._digest_dispatch(x))
            if e is not None and e.digest is not None and dg == e.digest:
                # refresh the entry: the next save of this same tensor is
                # a free identity hit, and the superseded tensor is
                # released instead of staying pinned by the stale ref
                memo[key] = self._entry(x, e.host, dg)
                return e.host, dg
        return None, dg

    def _entry(self, x, host, digest, version=None) -> _Memo:
        if isinstance(x, torch.Tensor):
            return _Memo(ref=x, host=host, digest=digest,
                         version=x._version if version is None else version)
        return _Memo(ref=None, version=0, host=host, digest=digest)

    def _memo_put(self, memo, key, x, host, incremental: bool, digest=None,
                  version=None):
        if not incremental:
            return
        if isinstance(x, torch.Tensor) or (self.dirty == "digest" and
                                           isinstance(x, np.ndarray)):
            memo[key] = self._entry(x, host, digest, version)

    # -- execution helpers ------------------------------------------------------
    def _transport_mode(self, on_card: bool) -> str:
        if self.transport != "auto":
            return self.transport
        return "stream" if on_card else "borrow"

    def _streams(self, device: torch.device) -> list:
        if device not in self._stream_cache:
            self._stream_cache[device] = [
                torch.cuda.Stream(device=device)
                for _ in range(max(1, self.num_queues))]
        return self._stream_cache[device]

    def _row_chunks(self, nbytes: int, R: int) -> list[tuple[int, int]]:
        """Split R rows into [lo, hi) descriptor ranges of ~chunk_bytes
        each (single whole-leaf range when chunking can't help)."""
        n = 1
        if R > 1 and nbytes > self.chunk_bytes:
            n = min(R, math.ceil(nbytes / self.chunk_bytes))
        return [(R * c // n, R * (c + 1) // n) for c in range(n)]

    @staticmethod
    def _row_view_dims(x) -> tuple[int, int]:
        """(rows, L) of the 2-D row view of a leaf (scalars: (1, 1))."""
        L = x.shape[-1] if x.dim() else 1
        return ((x.numel() // L) if L else 0), L

    def _balance(self, items, nq, weight):
        """Greedy longest-processing-time split of items over nq queues."""
        queues = [[] for _ in range(nq)]
        load = [0] * nq
        for it in sorted(items, key=weight, reverse=True):
            i = load.index(min(load))
            queues[i].append(it)
            load[i] += weight(it)
        return [q for q in queues if q]

    def _pack_eligible(self, x) -> bool:
        return self._pack_eligible_shape(tuple(x.shape), x.dtype)

    # -- device -> host (pause / checkpoint) -----------------------------------
    def save(self, tree: Any, tenant: Optional[str] = None,
             incremental: Optional[bool] = None) -> Any:
        if isinstance(tree, RankState):
            return self._save_ranks(tree, tenant, incremental)
        if not self.pipeline:
            return self._save_legacy(tree, tenant, incremental)
        incremental = self.incremental if incremental is None else incremental
        t0 = time.perf_counter()
        flat_p, treedef = flatten(tree)
        devices = {x.device for _, x in flat_p if _on_card(x)}
        transport = self._transport_mode(bool(devices))
        memo = self._memo_for(tenant)
        n = len(flat_p)
        host_flat: list = [None] * n
        logical = skipped = 0
        descs: list[_Descriptor] = []
        digests: dict[int, Any] = {}    # leaf idx -> digest computed at miss
        # transactional publication: memo writes are BUFFERED here and
        # committed only once the whole snapshot is assembled — a crash
        # mid-save leaves the memo, and therefore every future incremental
        # save, exactly as before this save
        memo_puts: list = []            # (key, x, host, digest, version)

        # -- stage -1: launch the digest kernels of identity misses first,
        # so they are all queued on the card before the first is read
        pending: dict[int, Any] = {}
        if incremental and self.dirty == "digest":
            for i, (key, x) in enumerate(flat_p):
                if (isinstance(x, torch.Tensor)
                        and not self._unchanged(memo.get(key), x)):
                    pending[i] = self._digest_dispatch(x)

        # -- stage 0: dirty filter + stage 1: descriptor dispatch (async) ----
        for i, (key, x) in enumerate(flat_p):
            logical += _nbytes(x)
            hit, digests[i] = self._memo_hit(memo, key, x, incremental,
                                             digest=pending.get(i))
            if hit is not None:
                host_flat[i] = hit
                skipped += _nbytes(hit)
                continue
            if not isinstance(x, torch.Tensor):
                # a real copy: a pause snapshot is the tenant's ONLY state
                # copy, so it must not alias a buffer the tenant mutates
                host = np.array(x)
                host_flat[i] = host
                memo_puts.append((key, x, host, digests[i], None))
                continue
            host_flat[i], leaf_descs = self._dispatch_leaf(i, x, transport)
            descs.extend(leaf_descs)
            memo_puts.append((key, x, host_flat[i], digests[i], x._version))

        # -- stage 2: D2H descriptor queues -----------------------------------
        nq = max(1, min(self.num_queues, len(descs) or 1))
        bursts = self._balance(descs, nq, lambda d: d.nbytes)

        # crash window: descriptors dispatched (and host leaves staged)
        # but the D2H queues have not drained — the half-built snapshot
        # and its buffered memo updates must never become observable
        crashpoint("mid_pipeline_chunk")

        self._fetch(bursts, host_flat, devices)

        # -- publish: the snapshot is complete, commit the memo updates ------
        for key, x, host, dg, version in memo_puts:
            self._memo_put(memo, key, x, host, incremental, digest=dg,
                           version=version)

        dt = time.perf_counter() - t0
        moved = sum(_nbytes(h) for h in host_flat) - skipped
        self.last_stats = TransferStats(
            bytes_moved=moved, logical_bytes=logical, seconds=dt,
            num_leaves=n, queues=self.num_queues, skipped_bytes=skipped,
            num_descriptors=len(descs), transport=transport)
        return unflatten(treedef, [
            _Opaque(h) if isinstance(h, QuantizedLeaf) else h
            for h in host_flat])

    def _dispatch_leaf(self, i, x, transport):
        """Allocate leaf i's host buffer, split the leaf into descriptors
        and dispatch their device-side stage (pack kernel / row-slice
        view). Returns (host buffer, descriptors whose D2H is pending).
        Launches are asynchronous, so descriptor i+1's pack overlaps
        descriptor i's D2H."""
        x = x.detach().contiguous()
        packed = self._pack_eligible(x)
        R, L = self._row_view_dims(x)
        nbytes = _nbytes(x)
        chunkable = packed or transport == "stream"
        ranges = self._row_chunks(nbytes, R) if chunkable else [(0, R)]
        pin = x.device.type == "cuda"
        if packed:
            host = QuantizedLeaf(
                q=torch.empty(x.shape, dtype=torch.int8, pin_memory=pin),
                scale=torch.empty(x.shape[:-1] + (L // self.block,),
                                  dtype=torch.float32, pin_memory=pin),
                dtype=dtype_name(x), block=self.block)
        else:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
        out = []
        per_chunk = max(1, nbytes // len(ranges))
        for c, (lo, hi) in enumerate(ranges):
            d = _Descriptor(leaf=i, chunk=c, lo=lo, rows=hi - lo,
                            nbytes=per_chunk, packed=packed)
            if packed:
                d.dev = kops.qdma_pack_rows(x, lo, rows=d.rows,
                                            block=self.block)
                d.nbytes = max(1, per_chunk // x.element_size())  # ~int8
            elif len(ranges) > 1:
                d.dev = row_view(x)[lo:hi]
            else:
                d.dev = x          # whole-leaf copy / single stream chunk
            out.append(d)
        return host, out

    def _fetch(self, bursts, host_flat, devices):
        """Stages 2+3: each queue copies its descriptors into their rows
        of the leaves' host buffers."""
        if len(devices) > 1:
            raise ValueError(f"one save stages from one card, not {devices}")
        queues = _Queues(self, next(iter(devices), torch.device("cpu")))
        for qi, burst in enumerate(bursts):
            for d in burst:
                host, rows = host_flat[d.leaf], slice(d.lo, d.lo + d.rows)
                if d.packed:
                    queues.download(qi, row_view(host.q)[rows], d.dev[0])
                    queues.download(qi, row_view(host.scale)[rows], d.dev[1])
                elif host.numel():
                    queues.download(qi, row_view(host)[rows],
                                    row_view(d.dev))
        queues.join()

    # -- host -> device (unpause / restore) -------------------------------------
    def restore(self, staged: Any, device=None) -> Any:
        """Place a staged tree on ``device`` (a torch device or its name;
        the card by default), or on a VF of ranks (``RankShardings``: a
        ``RankState`` comes back). Tensor leaves come back as fresh
        tensors there, numpy leaves as fresh numpy copies, so the
        restored state never aliases the snapshot."""
        if isinstance(device, RankShardings):
            return self._restore_ranks(staged, device)
        if not self.pipeline:
            return self._restore_legacy(staged, device)
        dev = resolve_device("cuda" if device is None else device)
        transport = self._transport_mode(dev.type == "cuda")
        t0 = time.perf_counter()
        flat, treedef = flatten(staged, is_leaf=lambda x: isinstance(
            x, _Opaque))
        leaves = [x for _, x in flat]
        n = len(leaves)
        dev_flat: list = [None] * n
        plain = [(i, x) for i, x in enumerate(leaves)
                 if not isinstance(x, _Opaque)]
        packed = [(i, x) for i, x in enumerate(leaves)
                  if isinstance(x, _Opaque)]
        queues = _Queues(self, dev)

        # packed leaves first: their H2D + on-device unpack is queued
        # asynchronously, overlapping the plain bursts below (stage overlap
        # on restore mirrors the save pipeline in reverse)
        for i, x in packed:
            dev_flat[i] = self._restore_packed(x.leaf, dev, transport,
                                               queues)

        # plain leaves: burst-batched H2D per queue
        nq = max(1, min(self.num_queues, len(plain) or 1))
        for qi, burst in enumerate(self._balance(
                plain, nq, lambda it: _nbytes(it[1]))):
            for i, x in burst:
                dev_flat[i] = (queues.upload(qi, x)
                               if isinstance(x, torch.Tensor) else np.array(x))
        queues.join()
        dt = time.perf_counter() - t0
        self.last_stats = TransferStats(
            bytes_moved=sum(_nbytes(x) for x in leaves),
            logical_bytes=sum(_nbytes(x) for x in dev_flat),
            seconds=dt, num_leaves=n, queues=self.num_queues,
            num_descriptors=len(plain) + len(packed), transport=transport)
        return unflatten(treedef, dev_flat)

    def _restore_packed(self, ql: QuantizedLeaf, dev, transport, queues):
        """H2D + on-device dequantize into the leaf's device buffer,
        chunk-granular in stream mode so the upload of chunk i+1 (on a
        queue) overlaps the unpack of chunk i (on the current stream)."""
        R = self._row_view_dims(ql.q)[0]
        ranges = (self._row_chunks(_nbytes(ql.q), R)
                  if transport == "stream" else [(0, R)])
        out = torch.empty(ql.q.shape, dtype=kops.as_dtype(ql.dtype),
                          device=dev)
        q2, s2 = row_view(ql.q), row_view(ql.scale)
        for c, (lo, hi) in enumerate(ranges):
            qd, sd = queues.upload(c, q2[lo:hi]), queues.upload(c, s2[lo:hi])
            queues.ready(c)
            kops.qdma_unpack(qd, sd, dtype=ql.dtype,
                             out=row_view(out)[lo:hi])
        return out

    # -- a state sharded over a VF of ranks -----------------------------------
    def _save_ranks(self, rs: RankState, tenant: Optional[str],
                    incremental: Optional[bool]) -> Any:
        """The host snapshot of a sharded state: the global leaves, as the
        JAX controller holds them. Each block owner (one rank per distinct
        block) digests its block and copies it to host, or packs it to
        int8 on its card when the block's last dim is a whole number of
        int8 blocks (so the pack is bit-equal to the unsharded leaf's);
        any other packed leaf is gathered to one member and packed whole.
        With ``incremental`` the digests come first, and a leaf whose
        blocks all digest as at the previous save reuses its host copy."""
        from repro_torch.train.step import train_state_shapes
        incremental = self.incremental if incremental is None else incremental
        t0 = time.perf_counter()
        sh = rs.shardings
        owners = sh.owners()
        memo = self._memo_for(tenant)
        host: dict = {}
        skipped = 0
        if incremental:
            dg = rs.digests(owners)
            for path, own in owners.items():
                e = memo.get(path)
                if e is not None and e.digest == tuple(dg[r][path]
                                                       for r in own):
                    host[path] = e.host
                    skipped += _nbytes(e.host)
        plan = {}
        for path, shape, dtype, _ in sh.leaves():
            if path in host:
                continue
            own = owners[path]
            mode = "plain"
            if self._pack_eligible_shape(shape, dtype):
                local_last = max(sl[-1].stop - sl[-1].start
                                 for sl in own.values())
                mode = "pack" if local_last % self.block == 0 else "gather"
            plan[path] = (mode, own, sh.mesh.ranks[0], self.block)
        got = rs.fetch(plan) if plan else {}
        puts = []
        for path, shape, dtype, _ in sh.leaves():
            if path not in plan:
                continue
            mode, own, packer, block = plan[path]
            if mode == "plain":
                buf = torch.empty(shape, dtype=dtype)
                for r, sl in own.items():
                    buf[sl] = got[r][path][1][1]
            else:
                L = shape[-1]
                buf = QuantizedLeaf(
                    q=torch.empty(shape, dtype=torch.int8),
                    scale=torch.empty(shape[:-1] + (L // block,),
                                      dtype=torch.float32),
                    dtype=str(dtype).removeprefix("torch."), block=block)
                parts = ({packer: tuple(slice(0, n) for n in shape)}
                         if mode == "gather" else own)
                for r, sl in parts.items():
                    _, q, scale = got[r][path][1]
                    last = sl[-1]
                    buf.q[sl] = q
                    buf.scale[sl[:-1] + (slice(last.start // block,
                                                last.stop // block),)] = \
                        scale
            host[path] = buf
            if incremental:
                puts.append((path, buf, tuple(got[r][path][0] for r in own)))
        # transactional publication, as in the pipelined save
        for path, buf, digest in puts:
            memo[path] = _Memo(ref=None, version=0, digest=digest, host=buf)
        flat, treedef = flatten(train_state_shapes(sh.run))
        leaves = [host[path] for path, _ in flat]
        dt = time.perf_counter() - t0
        self.last_stats = TransferStats(
            bytes_moved=sum(_nbytes(h) for h in leaves) - skipped,
            logical_bytes=sum(math.prod(s) * torch.empty(
                (), dtype=d).element_size() for _, s, d, _ in sh.leaves()),
            seconds=dt, num_leaves=len(leaves), queues=self.num_queues,
            skipped_bytes=skipped,
            num_descriptors=sum(len(plan[p][1]) for p in plan),
            transport="ranks")
        return unflatten(treedef, [
            _Opaque(h) if isinstance(h, QuantizedLeaf) else h
            for h in leaves])

    def _restore_ranks(self, staged: Any, sh: RankShardings) -> RankState:
        """Place a host snapshot on a VF of ranks: each member receives
        its blocks (int8 blocks unpacked on its card by ``qdma_unpack``)."""
        t0 = time.perf_counter()
        flat, _ = flatten(staged, is_leaf=lambda x: isinstance(x, _Opaque))
        host = {path: (x.leaf if isinstance(x, _Opaque) else x)
                for path, x in flat}
        state = sh.place(host)
        self.last_stats = TransferStats(
            bytes_moved=sum(_nbytes(x) for x in host.values()),
            logical_bytes=sum(math.prod(s) * torch.empty(
                (), dtype=d).element_size() for _, s, d, _ in sh.leaves()),
            seconds=time.perf_counter() - t0, num_leaves=len(host),
            queues=self.num_queues, num_descriptors=len(host),
            transport="ranks")
        return state

    def _pack_eligible_shape(self, shape, dtype) -> bool:
        return (self.compression == "int8" and len(shape) >= 1
                and dtype in (torch.float32, torch.bfloat16)
                and math.prod(shape) >= self.min_quant_size
                and shape[-1] % self.block == 0)

    # -- PR-1 baseline engine (whole-leaf round-robin) --------------------------
    def _save_legacy(self, tree: Any, tenant: Optional[str],
                     incremental: Optional[bool]) -> Any:
        incremental = self.incremental if incremental is None else incremental
        t0 = time.perf_counter()
        flat_p, treedef = flatten(tree)
        memo = self._memo_for(tenant)
        logical = sum(_nbytes(x) for _, x in flat_p)

        def fetch(path_x):
            key, x = path_x
            hit, dg = self._memo_hit(memo, key, x, incremental)
            if hit is not None:
                return hit, None
            crashpoint("mid_pipeline_chunk")
            if not isinstance(x, torch.Tensor):
                host = np.array(x)
                return host, (key, x, host, dg, None)
            xc = x.detach().contiguous()
            if self._pack_eligible(xc):
                q, scale = kops.qdma_pack(xc, block=self.block)
                host = QuantizedLeaf(q=q.cpu(), scale=scale.cpu(),
                                     dtype=dtype_name(xc), block=self.block)
            else:
                host = xc.to("cpu", copy=True)
            return host, (key, x, host, dg, x._version)

        # QDMA-style queues: round-robin leaves over transfer threads
        with cf.ThreadPoolExecutor(max_workers=self.num_queues) as ex:
            fetched = list(ex.map(fetch, flat_p))
        host_flat = [h for h, _ in fetched]
        skipped = sum(_nbytes(h) for h, put in fetched if put is None)
        # transactional publication (see the pipelined save): memo commits
        # only after every leaf crossed the link
        for _, put in fetched:
            if put is not None:
                key, x, host, dg, version = put
                self._memo_put(memo, key, x, host, incremental, digest=dg,
                               version=version)
        dt = time.perf_counter() - t0
        moved = sum(_nbytes(x) for x in host_flat) - skipped
        self.last_stats = TransferStats(
            bytes_moved=moved, logical_bytes=logical, seconds=dt,
            num_leaves=len(host_flat), queues=self.num_queues,
            skipped_bytes=skipped, num_descriptors=len(host_flat),
            transport="legacy")
        return unflatten(treedef, [
            _Opaque(x) if isinstance(x, QuantizedLeaf) else x
            for x in host_flat])

    def _restore_legacy(self, staged: Any, device=None) -> Any:
        dev = resolve_device("cuda" if device is None else device)
        t0 = time.perf_counter()
        flat, treedef = flatten(staged, is_leaf=lambda x: isinstance(
            x, _Opaque))
        leaves = [x for _, x in flat]

        def place(x):
            if isinstance(x, _Opaque):
                ql: QuantizedLeaf = x.leaf
                return kops.qdma_unpack(ql.q.to(dev), ql.scale.to(dev),
                                        dtype=ql.dtype)
            if isinstance(x, torch.Tensor):
                return x.to(dev, copy=True)
            return np.array(x)

        with cf.ThreadPoolExecutor(max_workers=self.num_queues) as ex:
            dev_flat = list(ex.map(place, leaves))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.last_stats = TransferStats(
            bytes_moved=sum(_nbytes(x) for x in leaves),
            logical_bytes=sum(_nbytes(x) for x in dev_flat),
            seconds=dt, num_leaves=len(dev_flat), queues=self.num_queues,
            num_descriptors=len(dev_flat), transport="legacy")
        return unflatten(treedef, dev_flat)
