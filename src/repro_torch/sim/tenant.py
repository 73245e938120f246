"""Sim tenants — lightweight tenants that drive the REAL manager stack
(mirrors ``repro.sim.tenant``).

The production ``Tenant`` runs a model, which makes thousands-of-scenarios
property testing impossible (and pointless: the numerics are covered by
the model and kernel tests). ``SimTenant`` implements the same duck-typed
protocol ``SVFFManager`` / ``core.pause`` / ``core.fault`` consume —
``bind``/``suspend``/``resume``/``detach``/``export_state``/
``export_specs``/``shardings_for``/``state_template``/``run_steps``/
``inject_failure`` — over small trees of fp32 tensors on an explicit
``device``, so every scenario exercises the real pool, scheduler, pause,
staging, records and checkpoint code paths, and on the card the staging
engine's device path.

The crucial property: a SimTenant's state is a PURE FUNCTION of
``(seed, steps_done)`` — ``expected_state(seed, k)`` recomputes it from
scratch on the host. The base and the per-step deltas are drawn exactly
as the JAX package draws them (``np.random.default_rng([...])``); a step
copies its delta to the device and adds it there. An fp32 add rounds the
same on the card and in numpy, so the device state stays bit-equal to the
host recomputation and to the JAX tenant's numpy state, and the invariant
checker asserts bit-identity after any pause/unpause/migrate/detach
round-trip without shadow bookkeeping.

``SimServeTenant`` (the toy paged serving engine) keeps its four state
arrays on the device too, so pause and unpause move them through the
staging engine; its request plane stays on the host, as in the JAX
package. ``SimPipelineTenant`` leads a pipeline gang: a serving tenant
with shell members (``pg0.s1``, ``pg0.s2``, ...), one plain ``SimTenant``
each.
"""
from __future__ import annotations

import types
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tenant import DevicePausedError
from repro_torch.core.vf import VirtualFunction
from repro_torch.device import resolve_device
from repro_torch.serve.paged import BlockAllocator, CacheExhausted
from repro_torch.sim.clock import VirtualClock
from repro_torch.tree import tree_map

_LEAVES = ("w0", "w1")        # params leaves
_OPT = ("mu",)                # optimizer leaves



def _tree_shapes(leaf_size: int) -> dict:
    return {"params": {k: (leaf_size,) for k in _LEAVES},
            "opt": {k: (leaf_size,) for k in _OPT}}


def _to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A fresh tensor on ``device`` holding ``x`` (a tensor or a numpy
    array); never an alias of ``x``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype, copy=True)


class SimTenant:
    #: virtual seconds per op, mirroring Table-II's cost asymmetry
    STEP_COST = 1e-3
    COMPILE_COST = 0.25       # "flash the bitstream" on a new slice

    def __init__(self, tid: str, seed: int = 0, *, leaf_size: int = 16,
                 clock: Optional[VirtualClock] = None,
                 placement: str = "first_fit", device="cuda"):
        self.tid = tid
        self.seed = int(seed)
        self.leaf_size = int(leaf_size)
        self.clock = clock
        self.device = resolve_device(device)
        self.status = "created"        # created|running|paused|detached
        self.vf_id: Optional[str] = None
        self.steps_done = 0
        self.workload = "sim"
        self._state = None
        self._exec_cache: dict = {}
        self.step_times: list[float] = []
        self._fail_next = False
        # what SVFFManager reads off tenant.run
        self.run = types.SimpleNamespace(
            model=types.SimpleNamespace(name=f"sim-{tid}"),
            placement=placement, seed=self.seed)

    # ------------------------------------------------------- deterministic state
    @staticmethod
    def _base(seed: int, leaf_size: int) -> dict:
        shapes = _tree_shapes(leaf_size)
        out = {"params": {}, "opt": {}}
        for grp in ("params", "opt"):
            for i, (k, shp) in enumerate(sorted(shapes[grp].items())):
                rng = np.random.default_rng([7001, seed, i, grp == "opt"])
                out[grp][k] = rng.standard_normal(shp).astype(np.float32)
        return out

    @staticmethod
    def _delta(seed: int, step: int, leaf_size: int) -> dict:
        shapes = _tree_shapes(leaf_size)
        out = {"params": {}, "opt": {}}
        for grp in ("params", "opt"):
            for i, (k, shp) in enumerate(sorted(shapes[grp].items())):
                rng = np.random.default_rng(
                    [7002, seed, step, i, grp == "opt"])
                out[grp][k] = (rng.standard_normal(shp) * 1e-2
                               ).astype(np.float32)
        return out

    @classmethod
    def expected_state(cls, seed: int, steps: int,
                       leaf_size: int = 16) -> dict:
        """Recompute the exact state after ``steps`` update steps, as numpy
        arrays on the host."""
        state = cls._base(seed, leaf_size)
        for k in range(steps):
            d = cls._delta(seed, k, leaf_size)
            state = tree_map(lambda a, b: a + b, state, d)
        return state

    def expected_now(self) -> dict:
        return self.expected_state(self.seed, self.steps_done,
                                   self.leaf_size)

    # ------------------------------------------------------------- protocol
    def bind(self, vf: VirtualFunction, state=None, *,
             flash: bool = True) -> float:
        if state is not None:
            self._state = tree_map(lambda x: _to_device(x, self.device),
                                   state)
        elif self._state is None:
            self._state = tree_map(lambda x: _to_device(x, self.device),
                                   self._base(self.seed, self.leaf_size))
        key = (tuple(vf.mesh_shape), tuple(str(d) for d in vf.devices))
        compile_s = 0.0
        if key not in self._exec_cache:
            self._exec_cache[key] = True
            compile_s = self.COMPILE_COST
        if self.clock is not None:
            self.clock.advance(compile_s)
        self._active_key = key
        self.vf_id = vf.vf_id
        self.status = "running"
        vf.emulated.update({"tenant": self.tid, "status": "running",
                            "steps_done": self.steps_done})
        return compile_s

    def run_steps(self, n: int = 1) -> dict:
        if self.status == "paused":
            raise DevicePausedError(
                f"{self.tid}: device {self.vf_id} is paused")
        if self.status != "running":
            raise RuntimeError(f"{self.tid}: no device attached")
        if self._fail_next:
            self._fail_next = False
            raise RuntimeError(f"{self.tid}: injected device failure")
        for _ in range(n):
            d = self._delta(self.seed, self.steps_done, self.leaf_size)
            # each step writes new tensors: the staging engine's identity
            # memo sees every stepped leaf as dirty
            self._state = tree_map(
                lambda a, b: a + torch.from_numpy(b).to(self.device),
                self._state, d)
            self.steps_done += 1
            if self.clock is not None:
                self.clock.advance(self.STEP_COST)
            self.step_times.append(self.STEP_COST)
        return {"loss": float(self._state["params"]["w0"].abs().mean())}

    # -- pause plumbing ------------------------------------------------------
    def export_state(self):
        return self._state

    def export_specs(self):
        return {}                      # sim carries no layout

    def shardings_for(self, vf: VirtualFunction):
        """Where a restore places the state: the tenant's device."""
        return self.device

    def state_template(self):
        """Shape-only tree matching export_state (checkpoint restore)."""
        return tree_map(lambda s: torch.empty(s, dtype=torch.float32,
                                              device="meta"),
                        _tree_shapes(self.leaf_size))

    def suspend(self):
        self._state = None
        self.status = "paused"

    def resume(self, state, vf: VirtualFunction):
        self.status = "running"
        self.bind(vf, state=state)

    def detach(self):
        self._state = None
        self.vf_id = None
        self.status = "detached"

    # -- introspection -------------------------------------------------------
    def query(self) -> dict:
        return {"tenant": self.tid, "status": self.status,
                "vf": self.vf_id, "steps_done": self.steps_done,
                "workload": self.workload,
                "exec_keys": [list(map(str, k)) for k in self._exec_cache]}

    def inject_failure(self):
        self._fail_next = True


#: the serving tenant's device arrays: name -> dtype
_SERVE_ARRAYS = {"pages": torch.int64, "tables": torch.int32,
                 "pos": torch.int64, "last": torch.int64}


class SimServeTenant:
    """A deterministic toy *serving* tenant for the scenario simulator —
    the serve-plane analogue of ``SimTenant``.

    It mirrors the real ``ServeEngine``'s control flow (queue -> paged
    admission through the REAL ``serve.paged.BlockAllocator`` -> batched
    decode over block-table-indirected pages -> slot recycling) over tiny
    integer arrays, so thousands of scenario ops stay cheap while the
    allocator and the pause/staging round-trip get real coverage.

    The four state arrays (``pages``, ``tables``, ``pos``, ``last``) are
    tensors on the tenant's ``device``. ``run_steps`` reads them to the
    host once, runs the engine steps' per-cell Python logic there, and
    writes them back once as new tensors (one transfer each way per
    array, not one host sync per cell).

    The crucial property (invariant I10): every emitted token is a pure
    function of the request identity and the CONTENT of the tenant's
    state arrays — ``expected_output(seed, rid)`` replays the request
    with no engine at all, so any byte the pause/unpause/migrate paths
    corrupt in pages/tables/pos/last shows up as token divergence, and a
    request served across a mid-flight reconfiguration must produce
    exactly the tokens it would have produced without one.

    Request migration (``peek_migratable`` ... ``owns_request``) mirrors
    ``ServeEngine``'s protocol: the shipped state is the chain's page
    cells, read from the device once; the target writes them back as new
    tensors.
    """

    VOCAB = 97
    PAGE = 4
    SLOTS = 2
    MAX_PAGES = 4                         # per-slot table width
    M = (1 << 31) - 1

    def __init__(self, tid: str, seed: int = 0, *,
                 clock: Optional[VirtualClock] = None,
                 placement: str = "first_fit", device="cuda"):
        self.tid = tid
        self.seed = int(seed)
        self.clock = clock
        self.device = resolve_device(device)
        self.status = "created"
        self.vf_id: Optional[str] = None
        self.steps_done = 0
        self.workload = "serve"
        self._exec_cache: dict = {}
        self.step_times: list[float] = []
        self._fail_next = False
        self.run = types.SimpleNamespace(
            model=types.SimpleNamespace(name=f"sim-serve-{tid}"),
            placement=placement, seed=self.seed)
        self.num_pages = 1 + self.SLOTS * self.MAX_PAGES
        self.alloc = BlockAllocator(self.num_pages, self.PAGE)
        # device state (round-trips through the real staging/pause paths)
        arrays = {k: np.zeros(s, np.int64) for k, s in self._shapes().items()}
        arrays["pos"][:] = -1
        self._set_arrays(arrays)
        # host-side request plane (guest RAM: survives pause like a queue
        # in the real engine's process)
        self.queue: "list" = []
        self.active: list = [None] * self.SLOTS
        self.requests: list = []          # every request ever submitted
        self._next_rid = 0
        self.shared_hits = 0              # pages admitted without a copy
        self.cow_splits = 0               # decode writes that split a page
        self.preemptions = 0              # CoW exhaustion -> recompute
        #: rid -> slot frozen by an in-flight outbound migration (mirrors
        #: ServeEngine._migrating): the slot keeps its request/pages, is
        #: skipped by decode, thaws on release (commit) or abort
        self._migrating: dict = {}
        self.migrations_in = 0
        self.migrations_out = 0
        self.migration_stall_ticks = 0
        self._h: Optional[dict] = None    # host copies during a step

    def _shapes(self) -> dict:
        return {"pages": (self.num_pages, self.PAGE),
                "tables": (self.SLOTS, self.MAX_PAGES),
                "pos": (self.SLOTS,), "last": (self.SLOTS,)}

    def _set_arrays(self, arrays: dict):
        """Place host or device arrays on the tenant's device as fresh
        tensors of the arrays' dtypes."""
        for k, x in arrays.items():
            setattr(self, k, _to_device(x, self.device, _SERVE_ARRAYS[k]))

    # ----------------------------------------------------- the toy "model"
    @classmethod
    def _cell(cls, tok: int, i: int) -> int:
        return ((tok + 1) * (2654435761 * (i + 1) % cls.M)) % cls.M

    @classmethod
    def _digest_tok(cls, cells) -> int:
        return int(sum(cells) % cls.M) % cls.VOCAB

    @classmethod
    def make_prompt(cls, seed: int, rid: int) -> tuple:
        """Odd rids draw unique prompts; even rids open with a PAGE+1-token
        seed-only "system prefix" (rid % 4 == 0 requests are the prefix
        verbatim), so scenario traffic naturally exercises the allocator's
        prefix-trie sharing, partial-page hits, and CoW splits."""
        if rid % 2:
            plen = 1 + (rid * 7 + seed) % 5
            return tuple((seed * 31 + rid * 17 + j * 13) % cls.VOCAB
                         for j in range(plen))
        sys_prefix = tuple((seed * 11 + j * 7 + 3) % cls.VOCAB
                           for j in range(cls.PAGE + 1))
        if rid % 4 == 0:
            return sys_prefix
        tail = 1 + (rid // 2 + seed) % 3
        return sys_prefix + tuple(
            (seed * 31 + rid * 17 + j * 13) % cls.VOCAB
            for j in range(tail))

    @classmethod
    def make_max_new(cls, seed: int, rid: int) -> int:
        return 1 + (rid + seed) % 5       # includes prefill-finish (== 1)

    @classmethod
    def expected_output(cls, seed: int, rid: int) -> list:
        """Oracle: the tokens this request produces when served with NO
        mid-flight reconfiguration (pure replay of the recurrence)."""
        prompt = cls.make_prompt(seed, rid)
        max_new = cls.make_max_new(seed, rid)
        cells = [cls._cell(t, i) for i, t in enumerate(prompt)]
        out = [cls._digest_tok(cells)]
        while len(out) < max_new:
            cells.append(cls._cell(out[-1], len(cells)))
            out.append(cls._digest_tok(cells))
        return out

    # ---------------------------------------------------------- traffic
    def submit_burst(self, n: int = 1):
        """n requests arrive (queueing is guest-side: works while paused).
        Each request records the seed its prompt/oracle derive from."""
        for _ in range(n):
            rid = self._next_rid
            self._next_rid += 1
            req = types.SimpleNamespace(
                rid=rid, seed=self.seed,
                prompt=self.make_prompt(self.seed, rid),
                max_new=self.make_max_new(self.seed, rid),
                out=[], done=False)
            self.queue.append(req)
            self.requests.append(req)

    # page-table helpers over the flat logical view (host copies) ----------
    def _cells_of(self, slot: int, upto: int):
        pages, row = self._h["pages"], self._h["tables"][slot]
        return [int(pages[row[i // self.PAGE], i % self.PAGE])
                for i in range(upto + 1)]

    def _write(self, slot: int, i: int, val: int):
        row = self._h["tables"][slot]
        self._h["pages"][row[i // self.PAGE], i % self.PAGE] = val

    def _admit(self):
        h = self._h
        for s in range(self.SLOTS):
            if self.active[s] is not None:
                continue
            while self.queue:
                req = self.queue[0]
                need = self.alloc.pages_needed(len(req.prompt)
                                               + req.max_new)
                try:
                    pages = self.alloc.allocate(req.rid, need,
                                                tokens=req.prompt)
                except CacheExhausted:
                    return                      # back off, keep order
                self.queue.pop(0)
                shared = self.alloc.shared_count(req.rid)
                self.shared_hits += shared
                h["tables"][s, :] = 0
                h["tables"][s, :len(pages)] = pages
                h["pos"][s] = len(req.prompt) - 1
                # shared pages already hold these exact cells (cells are
                # pure functions of token + absolute index); writing them
                # would scribble on pages siblings are reading through
                for i, t in enumerate(req.prompt):
                    if i >= shared * self.PAGE:
                        self._write(s, i, self._cell(t, i))
                tok = self._digest_tok(self._cells_of(s, h["pos"][s]))
                req.out.append(tok)
                if len(req.out) >= req.max_new:    # finished at prefill
                    req.done = True
                    self.alloc.free(req.rid)
                    h["tables"][s, :] = 0
                    h["pos"][s] = -1
                    continue                        # slot re-offered
                self.alloc.register_prefix(req.rid)
                h["last"][s] = tok
                self.active[s] = req
                break

    def _preempt(self, s: int):
        """CoW exhaustion valve: drop the slot's work, free its pages and
        requeue it at the FRONT — tokens are a pure function of request
        identity, so the recompute is token-identical (I10)."""
        req = self.active[s]
        self.alloc.free(req.rid)
        req.out.clear()
        self.active[s] = None
        self._h["tables"][s, :] = 0
        self._h["pos"][s] = -1
        self.queue.insert(0, req)
        self.preemptions += 1

    def _engine_step(self):
        h = self._h
        self._admit()
        frozen = set(self._migrating.values())
        for s in range(self.SLOTS):
            req = self.active[s]
            if req is None:
                continue
            if s in frozen:               # mid-migration: slot is frozen
                self.migration_stall_ticks += 1
                continue
            # copy-on-write: this step's KV cell must land in a PRIVATE
            # page; a shared one is split first (one page, one table row)
            pi = (int(h["pos"][s]) + 1) // self.PAGE
            chain = self.alloc.pages_of(req.rid)
            if self.alloc.refcount(chain[pi]) > 1:
                try:
                    old, new = self.alloc.cow(req.rid, pi)
                except CacheExhausted:
                    self._preempt(s)
                    continue
                h["pages"][new] = h["pages"][old]
                h["tables"][s, pi] = new
                self.cow_splits += 1
            h["pos"][s] += 1
            self._write(s, int(h["pos"][s]),
                        self._cell(int(h["last"][s]), int(h["pos"][s])))
            tok = self._digest_tok(self._cells_of(s, int(h["pos"][s])))
            req.out.append(tok)
            h["last"][s] = tok
            if len(req.out) >= req.max_new:
                req.done = True
                self.alloc.free(req.rid)
                self.active[s] = None
                h["tables"][s, :] = 0
                h["pos"][s] = -1

    # -- request migration (mirrors ServeEngine's protocol) -----------------
    def _host_arrays(self) -> dict:
        """Host copies of the four state arrays (one read each); written
        back with ``_set_arrays`` as new tensors, so the staging memo sees
        them dirty."""
        return {k: getattr(self, k).cpu().numpy().copy()
                for k in _SERVE_ARRAYS}

    def peek_migratable(self, rid=None):
        """Pure query: the rid ``extract_request`` would pick."""
        frozen = set(self._migrating.values())
        for s in range(self.SLOTS):
            req = self.active[s]
            if req is None or s in frozen:
                continue
            if rid is None or req.rid == rid:
                return req.rid
        return None

    def extract_request(self, rid=None):
        """Freeze one in-flight request and copy out everything the
        target needs: page cells of its chain (a fresh tensor on the
        device), pos, last token, prompt tokens (for trie re-sharing).
        Non-destructive — the source keeps its pages until
        ``release_request``."""
        rid = self.peek_migratable(rid)
        if rid is None:
            return None
        slot = next(s for s in range(self.SLOTS)
                    if self.active[s] is not None
                    and self.active[s].rid == rid)
        chain = self.alloc.pages_of(rid)
        self._migrating[rid] = slot
        idx = torch.as_tensor(chain, dtype=torch.int64, device=self.device)
        return {"rid": rid, "req": self.active[slot], "slot": slot,
                "chain_len": len(chain), "page_size": self.PAGE,
                "tokens": self.alloc.tokens_of(rid),
                "pos": int(self.pos[slot]), "last": int(self.last[slot]),
                "state": {"cells": self.pages[idx].clone()}}

    def admit_migrated(self, payload, state):
        """Admit a migrated request into a free slot. Re-shares trie
        pages for FULL prompt pages only — the partly-filled last prompt
        page may already hold this request's decode cells, which a
        sibling's registered page does not. Raises ``CacheExhausted``
        (side-effect-free) when no slot or not enough pages."""
        rid = payload["rid"]
        if self.owns_request(rid):        # idempotent recovery replay
            return
        slot = next((s for s in range(self.SLOTS)
                     if self.active[s] is None), None)
        if slot is None:
            raise CacheExhausted(
                f"request {rid}: no free slot on migration target "
                f"{self.tid}")
        tokens = payload.get("tokens")
        share = None
        if tokens:
            share = tokens[:self.PAGE * (len(tokens) // self.PAGE)] or None
        pages = self.alloc.allocate(rid, payload["chain_len"],
                                    tokens=share)
        shared = self.alloc.shared_count(rid)
        self.shared_hits += shared
        cells = torch.as_tensor(state["cells"]).cpu().numpy()
        h = self._host_arrays()
        for i, p in enumerate(pages):
            if i >= shared:
                h["pages"][p] = cells[i]
        h["tables"][slot, :] = 0
        h["tables"][slot, :len(pages)] = pages
        h["pos"][slot] = payload["pos"]
        h["last"][slot] = payload["last"]
        self._set_arrays(h)
        self.active[slot] = payload["req"]
        if share:
            self.alloc.register_prefix(rid)
        self.migrations_in += 1

    def _clear_slot(self, slot: int):
        """An empty slot's table row and position, on the device."""
        if self.tables is None:           # paused / detached: no arrays
            return
        h = self._host_arrays()
        h["tables"][slot, :] = 0
        h["pos"][slot] = -1
        self._set_arrays(h)

    def release_request(self, rid) -> bool:
        """Commit side of an outbound migration: free our copy. Idempotent
        (recovery may roll the same release forward twice)."""
        slot = self._migrating.pop(rid, None)
        if slot is None:
            return False
        self.alloc.free(rid)
        self.active[slot] = None
        self._clear_slot(slot)
        self.migrations_out += 1
        return True

    def abort_migration(self, rid) -> bool:
        """Thaw the frozen slot — the request never left (side-effect-free
        on the request object)."""
        return self._migrating.pop(rid, None) is not None

    def abort_incoming(self, rid):
        """Target-side rollback of a (possibly partial) admission."""
        if rid not in self.alloc.owners():
            return
        for s, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                self.active[s] = None
                self._clear_slot(s)
                break
        self.alloc.free(rid)

    def owns_request(self, rid) -> bool:
        if any(r is not None and r.rid == rid for r in self.active):
            return True
        if any(r.rid == rid for r in self.queue):
            return True
        return rid in self.alloc.owners()

    # ------------------------------------------------------------- protocol
    def bind(self, vf: VirtualFunction, state=None, *,
             flash: bool = True) -> float:
        if state is not None:
            self._set_arrays({k: state[k] for k in _SERVE_ARRAYS})
        key = (tuple(vf.mesh_shape), tuple(str(d) for d in vf.devices))
        self._exec_cache.setdefault(key, True)
        self.vf_id = vf.vf_id
        self.status = "running"
        vf.emulated.update({"tenant": self.tid, "status": "running",
                            "steps_done": self.steps_done})
        return 0.0

    def run_steps(self, n: int = 1) -> dict:
        if self.status == "paused":
            raise DevicePausedError(
                f"{self.tid}: device {self.vf_id} is paused")
        if self.status != "running":
            raise RuntimeError(f"{self.tid}: no device attached")
        if self._fail_next:
            self._fail_next = False
            raise RuntimeError(f"{self.tid}: injected device failure")
        # one read of the device arrays, the steps on the host copies, one
        # write back as new tensors (the identity memo sees them dirty)
        self._h = {k: getattr(self, k).cpu().numpy().copy()
                   for k in _SERVE_ARRAYS}
        try:
            for _ in range(n):
                self._engine_step()
                self.steps_done += 1
                if self.clock is not None:
                    self.clock.advance(SimTenant.STEP_COST)
                self.step_times.append(SimTenant.STEP_COST)
            self._set_arrays(self._h)
        finally:
            self._h = None
        return {"inflight": sum(r is not None for r in self.active),
                "queued": len(self.queue)}

    def export_state(self):
        return {k: getattr(self, k) for k in _SERVE_ARRAYS}

    def export_specs(self):
        return {}

    def shardings_for(self, vf: VirtualFunction):
        return self.device

    def state_template(self):
        return {k: torch.empty(s, dtype=_SERVE_ARRAYS[k], device="meta")
                for k, s in self._shapes().items()}

    def suspend(self):
        self.pages = self.tables = None
        self.pos = self.last = None
        self.status = "paused"

    def resume(self, state, vf: VirtualFunction):
        self.status = "running"
        self.bind(vf, state=state)

    def detach(self):
        self.pages = self.tables = None
        self.pos = self.last = None
        self.vf_id = None
        self.status = "detached"

    def query(self) -> dict:
        return {"tenant": self.tid, "status": self.status,
                "vf": self.vf_id, "steps_done": self.steps_done,
                "workload": self.workload,
                "queued": len(self.queue),
                "inflight": sum(r is not None for r in self.active),
                "migrating": sorted(self._migrating),
                "exec_keys": [list(map(str, k)) for k in self._exec_cache]}

    def inject_failure(self):
        self._fail_next = True


class SimPipelineTenant(SimServeTenant):
    """A serving tenant that LEADS a pipeline gang — the sim analogue of
    the fleet's ``PipelineServeEngine`` + shell tenants.

    The lead is a full ``SimServeTenant`` (queue, paged KV, I10 oracle)
    that additionally carries ``gang_shells``: one plain ``SimTenant``
    per extra stage, pre-built at MAX width so a grow-reshape attaches an
    existing shell instead of minting one (mirrors the fleet, where
    shells are created up to ``max_stage_width`` for headroom). Shell
    tids use a ``.`` separator (``pg0.s1``) because tids become
    RecordStore file names.

    ``apply_reshape(k)`` only moves the width pointer: the toy model's
    cells are pure functions of absolute indices, so token bit-identity
    across a reshape (I10) holds by construction here — what the sim
    adds on top is the MANAGEMENT-plane story (journaled gang ops, crash
    windows, I14 gang coherence), which is exactly what the real engine
    cannot exercise cheaply at scenario scale. The lead's arrays and the
    shells' state live on ``device``."""

    #: period count the stage templates partition (divisible by 1..3)
    SIM_NPER = 12

    def __init__(self, tid: str, seed: int = 0, *,
                 clock: Optional[VirtualClock] = None,
                 placement: str = "first_fit", width: int = 2,
                 max_width: int = 3, leaf_size: int = 16, device="cuda"):
        super().__init__(tid, seed=seed, clock=clock, placement=placement,
                         device=device)
        if not 1 <= width <= max_width <= self.SIM_NPER:
            raise ValueError(f"{tid}: width {width}, max_width "
                             f"{max_width}, periods {self.SIM_NPER}")
        self._width = int(width)
        self.max_stage_width = int(max_width)
        self.num_periods = self.SIM_NPER
        self.reshape_count = 0
        # disjoint rid space: sv* engines mint rids from 0 and share one
        # request plane (rebalance/migration moves rids between them);
        # the gang lead never exchanges requests with them, but I13
        # keys liveness by rid across ALL serve-shaped tenants
        self._next_rid = 1_000_000
        self.gang_shells = tuple(
            SimTenant(f"{tid}.s{i}", seed=seed * 31 + i,
                      leaf_size=leaf_size, clock=clock,
                      placement=placement, device=self.device)
            for i in range(1, max_width))
        for sh in self.gang_shells:
            sh.lead = self

    # -- template / width protocol (manager gang ops + I14) ----------------
    @property
    def stage_width(self) -> int:
        return self._width

    def has_template(self, k: int) -> bool:
        return 1 <= k <= self.max_stage_width

    def stage_bounds(self) -> tuple:
        base, rem = divmod(self.SIM_NPER, self._width)
        bounds = [0]
        for i in range(self._width):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return tuple(bounds)

    def apply_reshape(self, k: int) -> None:
        """Pure width relayout, idempotent at the current width (the
        manager's crash recovery re-applies it unconditionally)."""
        if k == self._width:
            return
        if not self.has_template(k):
            raise ValueError(f"no sim stage template for K={k}")
        self._width = int(k)
        self.reshape_count += 1


class ServeSimTenant:
    """Serving-shaped pause-protocol stub: big IMMUTABLE params plus a
    small hot cache that every decode step replaces — the exact dirty
    profile ``ServeEngine.dirty_keys`` reports. The pause-path benchmark
    (HC5) uses it; ``params`` and ``cache`` are tensor trees, on the card
    there."""

    def __init__(self, params, cache, tid: str = "serve0"):
        self.tid = tid
        self.steps_done = 0
        self.status = "running"
        self.vf_id: Optional[str] = None
        self._exec_cache: dict = {}
        self.params = params
        self.cache = cache
        self.device = cache.device

    def step(self):
        self.cache = self.cache + 1.0       # a new tensor: ONLY the cache
        self.steps_done += 1

    def export_state(self):
        return {"params": self.params, "cache": self.cache}

    def export_specs(self):
        return {}

    def shardings_for(self, vf):
        return self.device

    def state_template(self):
        return tree_map(torch.zeros_like, self.export_state())

    def suspend(self):
        self.params = None
        self.cache = None
        self.status = "paused"

    def resume(self, state, vf: VirtualFunction):
        self.params, self.cache = state["params"], state["cache"]
        self.status = "running"
