"""RankPool — a device pool of ranks: N worker processes in one gloo
world, each worker one device of a ``DevicePool`` (the port's
counterpart of the JAX package's ``jax.devices()``).

JAX is single-controller: one process drives every device of a VF, and a
``jax.sharding.Mesh`` spans them. The port mirrors that. The controller
(the process that runs ``SVFFManager``, its journal, the QMP socket and
the ``Supervisor``) takes every decision as before; a tenant on a VF of
ranks sends its ops (init, step, eval, save, place, release) to that
VF's workers, which run the same step closure SPMD on DTensors over a
``DeviceMesh`` of the VF's ranks and hold only their own blocks of the
state. The rejected alternative, every rank running the whole control
plane as ``torchrun`` does, would make every decision read off a clock
or a socket (the ``Supervisor``'s straggler test, QMP) a broadcast.

  ``Rank``       one worker as a pool device (``str``: ``"rank<i>"``)
  ``RankMesh``   a VF's mesh: its ranks, shape and axes; every worker
                 builds the ``DeviceMesh`` (``new_group`` is collective),
                 cached per (shape, axes, ranks), as JAX caches the
                 executable per slice
  ``RankState``  the controller's handle of a tenant's sharded state
  ``RankShardings``  where a restore places a state: a mesh and the
                 train state's specs

Blocks move between the controller and the workers through
``torch.multiprocessing``: on a card as device tensors by CUDA IPC (the
controller copies between host and card itself), on the CPU through
shared memory. A worker that dies, or an op or
collective that raises in one, raises ``RankError`` in the controller;
nothing is retried, and after a failure the pool is closed (its other
workers may be blocked inside a collective). Each worker counts its
kernel launches (``kernels.ops.LAUNCHES``); ``launch_counts`` sums them.

On a card every worker computes on ``cuda:0`` (the ranks of one H100
share it under gloo: NCCL refuses two ranks on one device); tests ask
for ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import tempfile
import time
import traceback
import weakref
from datetime import timedelta
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.partitioning import placements
from repro_torch.tree import flatten


class RankError(RuntimeError):
    """A worker died, or an op (or a collective inside one) raised."""


@dataclasses.dataclass(frozen=True)
class Rank:
    index: int
    pool: "RankPool" = dataclasses.field(compare=False, hash=False,
                                         repr=False)

    def __str__(self):
        return f"rank{self.index}"


def is_rank_slice(devices) -> bool:
    return bool(devices) and isinstance(devices[0], Rank)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A VF's mesh over ranks (the workers hold its ``DeviceMesh``)."""
    pool: "RankPool" = dataclasses.field(compare=False, repr=False)
    ranks: tuple = ()
    shape: tuple = ()
    axes: tuple = ()

    @property
    def key(self) -> tuple:
        return (tuple(self.shape), tuple(self.axes), tuple(self.ranks))

    def coordinate(self, rank: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(
            self.ranks.index(rank), self.shape))


# ---------------------------------------------------------------------------
# block arithmetic (controller side: no DeviceMesh there)
# ---------------------------------------------------------------------------
def block_slices(shape, places, mesh: RankMesh, rank: int) -> tuple:
    """The slices of a ``shape`` leaf that ``rank`` holds under
    ``places``, as ``runtime.partitioning.local_shard`` cuts them."""
    coord = mesh.coordinate(rank)
    lo = [0] * len(shape)
    size = list(shape)
    for i, p in enumerate(places):
        if p.is_shard():
            size[p.dim] //= mesh.shape[i]
            lo[p.dim] += coord[i] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


@dataclasses.dataclass
class RankShardings:
    """Where a state goes: ``mesh`` and the spec tree of the train state
    (the ``shardings_for`` of a tenant on a VF of ranks)."""
    mesh: RankMesh
    run: Any
    specs: dict
    tid: str

    def leaves(self) -> list:
        """[(path, shape, dtype, placements)] in ``flatten`` order."""
        from repro_torch.train.step import train_state_shapes
        shapes = dict(flatten(train_state_shapes(self.run))[0])
        return [(path, tuple(shapes[path].shape), shapes[path].dtype,
                 placements(spec, self.mesh.axes))
                for path, spec in flatten(self.specs, is_leaf=_is_spec)[0]]

    def owners(self) -> dict:
        """path -> {rank: slices} of the ranks that hold a distinct block
        (the first member in mesh order for a replicated one)."""
        out = {}
        for path, shape, _, pl in self.leaves():
            seen, own = set(), {}
            for r in self.mesh.ranks:
                sl = block_slices(shape, pl, self.mesh, r)
                key = tuple((s.start, s.stop) for s in sl)
                if key not in seen:
                    seen.add(key)
                    own[r] = sl
            out[path] = own
        return out

    def local_bytes(self) -> dict:
        """rank -> bytes of its blocks of the state."""
        out = {r: 0 for r in self.mesh.ranks}
        for _, shape, dtype, pl in self.leaves():
            for r in self.mesh.ranks:
                sl = block_slices(shape, pl, self.mesh, r)
                n = math.prod(s.stop - s.start for s in sl)
                out[r] += n * torch.empty((), dtype=dtype).element_size()
        return out

    def place(self, host_flat: dict) -> "RankState":
        """Place a host state ({path: tensor, array, or a staging
        ``QuantizedLeaf``}) on the mesh: each member receives its blocks
        (a packed leaf's int8 rows and scales, unpacked there with
        ``qdma_unpack``) and builds its DTensors."""
        from repro_torch.core.staging import QuantizedLeaf
        # on a card each block goes up here and over by CUDA IPC; the
        # worker copies it before it answers. One member at a time (a
        # place is no collective), so the controller holds one member's
        # blocks at once, not the sum over the mesh
        pool = self.mesh.pool
        cuda = pool.device.type == "cuda"
        up = ((lambda t: t.to(pool.device)) if cuda
              else (lambda t: t.clone()))
        leaves = self.leaves()
        for r in self.mesh.ranks:
            parts = {}
            for path, shape, _, pl in leaves:
                x = host_flat[path]
                if isinstance(x, np.ndarray):
                    x = torch.from_numpy(x)
                sl = block_slices(shape, pl, self.mesh, r)
                if isinstance(x, QuantizedLeaf):
                    parts[path] = _quant_block(x, sl, up)
                else:
                    parts[path] = ("plain", up(x[sl]))
            pool.call([r], "place", self.tid, self.run, self.mesh.key,
                      per_rank={r: parts})
            del parts
            if cuda:
                torch.cuda.ipc_collect()
        return RankState(self)


def _quant_block(ql, sl, up) -> tuple:
    """A packed leaf's part for one rank (each through ``up``): its
    block's int8 values and scales when the block's last dim is a whole
    number of int8 blocks (each scale covers ``ql.block`` values along the
    last dim), else its rows at the full last dim with the slice to keep
    after the unpack."""
    b = ql.block
    last = sl[-1]
    if last.start % b == 0 and (last.stop - last.start) % b == 0:
        ssl = sl[:-1] + (slice(last.start // b, last.stop // b),)
        return ("packed", up(ql.q[sl]), up(ql.scale[ssl]), ql.dtype, None)
    rows = sl[:-1] + (slice(None),)
    return ("packed", up(ql.q[rows]), up(ql.scale[rows]), ql.dtype,
            (last.start, last.stop))


class RankState:
    """The controller's handle of a tenant's state on a VF of ranks: the
    workers hold the DTensors, each its blocks."""

    def __init__(self, shardings: RankShardings):
        self.shardings = shardings
        self.released = False

    @property
    def mesh(self) -> RankMesh:
        return self.shardings.mesh

    def _call(self, op, *args, **kw):
        if self.released:
            raise RankError(f"{self.shardings.tid}: the state was released")
        return self.mesh.pool.call(self.mesh.ranks, op,
                                   self.shardings.tid, *args, **kw)

    def step(self, batches: list) -> list:
        """Run one train step per batch (numpy dicts of the global batch);
        returns [(metrics, seconds)] as the first member saw them."""
        return self._call("step", batches)[0]

    def eval(self, batch: dict) -> dict:
        return self._call("eval", batch)[0]

    def memory(self) -> dict:
        """rank -> (bytes of the tenant's local tensors, the worker's
        allocated device bytes)."""
        return dict(zip(self.mesh.ranks, self._call("memory")))

    def digests(self, owners: dict) -> dict:
        """rank -> {path: digest of its block}, the blocks ``owners``
        names (``qdma_digest`` on each rank's card)."""
        per = {r: {p: True for p, own in owners.items() if r in own}
               for r in self.mesh.ranks}
        return dict(zip(self.mesh.ranks, self._call("digest",
                                                    per_rank={
                                                        r: {"paths": per[r]}
                                                        for r in per})))

    def fetch(self, plan: dict) -> dict:
        """Run a save plan ({path: (mode, block owners, pack owner,
        block)}): returns rank -> {path: (digest of its block, host
        part or None)}."""
        per = {}
        for r in self.mesh.ranks:
            per[r] = {"plan": {p: (mode, r in own, r == packer, blk)
                               for p, (mode, own, packer, blk)
                               in plan.items()}}
        return dict(zip(self.mesh.ranks, self._call("save", per_rank=per)))

    def gather(self) -> dict:
        """{path: full CPU tensor} (tests and checks)."""
        return {p: x.cpu() for p, x in self._call("gather")[0].items()}

    def release(self):
        """Free every member's tensors of this state."""
        if not self.released:
            self._call("release")
            self.released = True


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
class RankPool:
    """N worker processes in one gloo world, each a device of the pool.

    ``RankPool(4, device="cuda")`` starts the workers (each on the card;
    ``device="cpu"`` for tests); ``DevicePool(rank_pool.ranks)`` makes
    them a PF's devices. ``close()`` (or the context manager) stops them.
    """

    def __init__(self, n: int, device="cuda", *, timeout: float = 600.0,
                 threads: int = 1):
        self.device = resolve_device(device)
        self.n = int(n)
        self.timeout = float(timeout)
        if self.device.type == "cuda":
            # every kernel the workers may launch, built once here (one
            # nvcc per source, in parallel) before they start
            from repro_torch.kernels import build
            build.build(["flash_attention", "qdma_pack"])
        import torch.multiprocessing as tmp
        ctx = tmp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="svff_ranks_")
        init = f"file://{os.path.join(self._dir, 'pg')}"
        self._conns, self._procs = [], []
        for i in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main, daemon=True, args=(
                i, self.n, init, child, str(self.device), self.timeout,
                threads))
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.closed = False
        self._finalizer = weakref.finalize(
            self, _stop, self._conns, self._procs, self._dir)
        self.ranks = tuple(Rank(i, self) for i in range(self.n))
        self._meshes: dict = {}
        self._recv_all(range(self.n), "start")

    # -- transport --------------------------------------------------------
    def _recv(self, i: int, op: str, deadline: float):
        conn, proc = self._conns[i], self._procs[i]
        while not conn.poll(0.2):
            if not proc.is_alive():
                raise RankError(f"rank{i} died (exit code {proc.exitcode}) "
                                f"during {op!r}")
            if time.monotonic() > deadline:
                raise RankError(f"rank{i}: {op!r} took more than "
                                f"{self.timeout:.0f} s")
        try:
            return conn.recv()
        except EOFError:
            raise RankError(f"rank{i} died during {op!r}") from None

    def _recv_all(self, idx, op: str) -> list:
        deadline = time.monotonic() + self.timeout
        out, errors = [], []
        try:
            for i in idx:
                kind, value = self._recv(i, op, deadline)
                if kind == "err":
                    errors.append(f"rank{i}: {value}")
                    # the others may be blocked in a collective with it
                    deadline = min(deadline, time.monotonic() + 30.0)
                out.append(value)
        except RankError as e:
            errors.append(str(e))
        if errors:
            self.close()
            raise RankError(f"{op} failed on the rank pool (closed):\n"
                            + "\n".join(errors))
        return out

    def call(self, ranks, op: str, *args, per_rank: Optional[dict] = None
             ) -> list:
        """Run ``op`` on the workers of ``ranks`` (Ranks or indices) and
        return their results in that order. ``per_rank`` maps a rank to
        its own last positional argument (a dict)."""
        if self.closed:
            raise RankError("the rank pool is closed")
        idx = [r.index if isinstance(r, Rank) else int(r) for r in ranks]
        for r, i in zip(ranks, idx):
            extra = ((per_rank[r],) if per_rank is not None else ())
            try:
                self._conns[i].send((op, args + extra))
            except (BrokenPipeError, OSError):
                self.close()
                raise RankError(f"rank{i} is gone ({op!r})") from None
        return self._recv_all(idx, op)

    # -- the pool's services ------------------------------------------------
    @property
    def devices(self) -> tuple:
        return self.ranks

    def probe(self, rank) -> str:
        """A one-element round trip on the worker's device."""
        return self.call([rank], "ping")[0]

    def mesh(self, shape, axes, ranks) -> RankMesh:
        """The mesh of ``ranks`` laid out in ``shape``: built by every
        worker once per (shape, axes, ranks)."""
        m = RankMesh(self, tuple(int(r.index if isinstance(r, Rank) else r)
                                 for r in ranks),
                     tuple(shape), tuple(axes))
        if m.key not in self._meshes:
            self.call(range(self.n), "mesh", m.key)
            self._meshes[m.key] = m
        return self._meshes[m.key]

    def init_state(self, mesh: RankMesh, tid: str, run, seed: int,
                   specs: dict) -> RankState:
        """The train state from ``seed``, bit-equal to the one-device
        init, each member keeping its blocks."""
        self.call(mesh.ranks, "init", tid, run, mesh.key, seed)
        return RankState(RankShardings(mesh, run, specs, tid))

    def run_on(self, ranks, fn, *args) -> list:
        """``fn(worker, *args)`` on each worker of ``ranks`` (a function
        importable by its module path; ``worker.mesh(key)``,
        ``worker.device``, ``worker.rank`` and ``worker.tenants`` are
        there): checks and measurements that need the workers' side."""
        return self.call(ranks, "run", fn, args)

    def launch_counts(self) -> dict:
        """Kernel launches summed over the workers."""
        total: dict = {}
        for counts in self.call(range(self.n), "launches", False):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        return total

    def reset_launch_counts(self):
        self.call(range(self.n), "launches", True)

    def comm_counts(self, on: bool) -> list:
        """Count the collectives of each train step with
        ``CommDebugMode`` from now on (``on``) or not; returns each
        worker's counts of the steps it ran since the last call, one
        {op: calls} a step."""
        return self.call(range(self.n), "comm", on)

    def traffic(self, reset: bool = False) -> list:
        """Each worker's {op: (calls, input bytes)} of the collectives it
        routed through gloo on the card (``gloo_card_traffic``)."""
        return self.call(range(self.n), "traffic", reset)

    def memory(self) -> list:
        """Each worker's allocated device bytes."""
        return self.call(range(self.n), "memory", None)

    def close(self):
        if not self.closed:
            self.closed = True
            self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _stop(conns, procs, directory):
    for c, p in zip(conns, procs):
        try:
            if p.is_alive():
                c.send(("exit", ()))
        except (BrokenPipeError, OSError):
            pass
    deadline = time.monotonic() + 10.0
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(5.0)
    for c in conns:
        c.close()
    shutil.rmtree(directory, ignore_errors=True)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------
def _worker_main(rank, world, init, conn, device, timeout, threads):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout))
        from repro_torch.runtime.partitioning import gloo_card_collectives
        gloo_card_collectives()
        worker = _Worker(rank, dev)
        conn.send(("ok", None))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            op, args = conn.recv()
        except EOFError:
            break
        if op == "exit":
            break
        try:
            if dev.type == "cuda":
                # free the blocks the controller has let go of since they
                # crossed by CUDA IPC (torch holds a sent block until then)
                torch.cuda.ipc_collect()
            out = getattr(worker, f"op_{op}")(*args)
            # let go of the received blocks before the answer, so the
            # controller can free them once it has it
            del args
            conn.send(("ok", out))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def _shared(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` for the trip to the controller: on a card a device
    copy, which the pipe hands over by CUDA IPC (the controller copies it
    to host itself), else a CPU copy in shared memory."""
    if t.is_cuda:
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    out.copy_(t)
    return out


class _WorkerTenant:
    def __init__(self, run, mesh_key, rules, state):
        self.run = run
        self.mesh_key = mesh_key
        self.rules = rules
        self.state = state
        self.steps: dict = {}

    def fns(self):
        """(train step, eval step) of this mesh, built once per mesh."""
        if self.mesh_key not in self.steps:
            from repro_torch.train.step import make_eval_step, make_train_step
            self.steps[self.mesh_key] = (make_train_step(self.run,
                                                         self.rules),
                                         make_eval_step(self.run,
                                                        self.rules))
        return self.steps[self.mesh_key]


class _Worker:
    def __init__(self, rank: int, device: torch.device):
        self.rank = rank
        self.device = device
        self.meshes: dict = {}
        self.tenants: dict[str, _WorkerTenant] = {}
        self.comm: Optional[list] = None   # CommDebugMode counts a step

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- pool ops -----------------------------------------------------------
    def op_ping(self):
        torch.zeros(1, device=self.device).cpu()
        return str(self.device)

    def op_mesh(self, key):
        from torch.distributed.device_mesh import DeviceMesh
        shape, axes, ranks = key
        if key not in self.meshes:
            self.meshes[key] = DeviceMesh(
                self.device.type, torch.tensor(ranks).reshape(shape),
                mesh_dim_names=tuple(axes))

    def op_launches(self, reset):
        from repro_torch.kernels import ops as kops
        counts = kops.launch_counts()
        if reset:
            kops.reset_launch_counts()
        return counts

    def op_comm(self, on):
        counts, self.comm = self.comm, [] if on else None
        return counts or []

    def op_traffic(self, reset):
        from repro_torch.runtime.partitioning import gloo_card_traffic
        return gloo_card_traffic(reset)

    def op_memory(self, tid):
        alloc = (torch.cuda.memory_allocated(self.device)
                 if self.device.type == "cuda" else 0)
        if tid is None:
            return alloc
        wt = self.tenants[tid]
        local = sum(x.to_local().numel() * x.element_size()
                    for _, x in flatten(wt.state)[0])
        return (local, alloc)

    def op_run(self, fn, args):
        return fn(self, *args)

    def mesh(self, key):
        return self.meshes[tuple(key)]

    # -- tenant ops ----------------------------------------------------------
    def _rules(self, run, key):
        from repro_torch.configs.base import MeshConfig
        from repro_torch.runtime.partitioning import ShardingRules
        shape, axes, _ = key
        return ShardingRules(MeshConfig(tuple(shape), tuple(axes)), run,
                             self.meshes[key])

    def op_init(self, tid, run, key, seed):
        from repro_torch.train.step import init_train_state
        rules = self._rules(run, key)
        state = init_train_state(run, seed, self.device, rules)
        self._sync()
        self.tenants[tid] = _WorkerTenant(run, key, rules, state)

    def op_place(self, tid, run, key, parts):
        """Build the state from host blocks ({path: part}); packed parts
        are unpacked on this rank's device with ``qdma_unpack``."""
        from torch.distributed.tensor import DTensor

        from repro_torch.kernels import ops as kops
        from repro_torch.train.step import train_state_specs
        rules = self._rules(run, key)
        mesh = rules.mesh
        flat, treedef = flatten(rules.named(train_state_specs(run, rules)),
                                is_leaf=_is_spec)
        leaves = []
        for path, places in flat:
            part = parts[path]
            if part[0] == "plain":
                local = part[1].to(self.device, copy=True)
            else:
                _, q, scale, dtype, keep = part
                local = kops.qdma_unpack(q.to(self.device).contiguous(),
                                         scale.to(self.device).contiguous(),
                                         dtype=dtype)
                if keep is not None:
                    local = local[..., keep[0]:keep[1]].contiguous()
            leaves.append(DTensor.from_local(local, mesh, places,
                                             run_check=False))
        self._sync()
        from repro_torch.tree import unflatten
        self.tenants[tid] = _WorkerTenant(run, key, rules,
                                          unflatten(treedef, leaves))

    def _batch(self, wt, batch):
        from repro_torch.train.step import place_batch
        return place_batch({k: np.ascontiguousarray(v)
                            for k, v in batch.items()}, wt.rules,
                           self.device)

    @staticmethod
    def _metrics(m) -> dict:
        from repro_torch.runtime.partitioning import is_dtensor
        return {k: float(v.full_tensor() if is_dtensor(v) else v)
                for k, v in m.items()}

    def op_step(self, tid, batches):
        wt = self.tenants[tid]
        train_step, _ = wt.fns()
        out = []
        for b in batches:
            batch = self._batch(wt, b)
            mode = None
            if self.comm is not None:
                from torch.distributed.tensor.debug import CommDebugMode
                mode = CommDebugMode()
            self._sync()
            t0 = time.perf_counter()
            with mode or contextlib.nullcontext():
                wt.state, m = train_step(wt.state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            if mode is not None:
                self.comm.append({str(k): int(v) for k, v in
                                  mode.get_comm_counts().items()})
            out.append((self._metrics(m), dt))
        return out

    def op_eval(self, tid, batch):
        wt = self.tenants[tid]
        _, eval_step = wt.fns()
        m = eval_step(wt.state["params"], self._batch(wt, batch))
        return self._metrics(m)

    def op_digest(self, tid, arg):
        """{path: digest tuple} of this rank's blocks named in ``arg``."""
        from repro_torch.kernels import ops as kops
        wt = self.tenants[tid]
        want = arg["paths"]
        pending = {p: kops.qdma_digest(x.to_local().contiguous())
                   for p, x in flatten(wt.state)[0] if p in want}
        return {p: tuple(d.tolist()) for p, d in pending.items()}

    def op_save(self, tid, arg):
        """This rank's part of a save plan: per path (mode, block owner,
        pack owner, block). A block owner digests its block
        (``qdma_digest``) and, in ``plain`` mode, copies it to host, in
        ``pack`` mode packs it (``qdma_pack_rows``). In ``gather`` mode
        every member gathers the leaf (a collective) and the pack owner
        packs it whole."""
        from repro_torch.kernels import ops as kops
        wt = self.tenants[tid]
        plan = arg["plan"]
        out = {}
        for path, x in flatten(wt.state)[0]:
            if path not in plan:
                continue
            mode, owner, packer, block = plan[path]
            local = x.to_local().contiguous()
            src = x.full_tensor().contiguous() if mode == "gather" else local
            digest = (tuple(kops.qdma_digest(local).tolist()) if owner
                      else None)
            part = None
            if mode == "plain" and owner:
                part = ("plain", _shared(src))
            elif (mode == "pack" and owner) or (mode == "gather" and packer):
                rows = src.numel() // src.shape[-1]
                q, scale = kops.qdma_pack_rows(src, 0, rows=rows,
                                               block=block)
                part = ("packed", _shared(q.reshape(src.shape)),
                        _shared(scale.reshape(src.shape[:-1] + (-1,))))
            if owner or part is not None:
                out[path] = (digest, part)
        self._sync()
        return out

    def op_gather(self, tid):
        from repro_torch.runtime.partitioning import gather_tree
        return {p: _shared(x) for p, x in flatten(gather_tree(
            self.tenants[tid].state))[0]}

    def op_release(self, tid):
        self.tenants.pop(tid, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
