"""Tenant — the VM/guest analogue (mirrors ``repro.core.tenant``).

A tenant owns a *logical* workload (here a training loop) and never
touches the pool's device slots directly: binding is the Manager/VF's
job. Its step code is the same across reconfigurations (the guest
runs unmodified, paper §III). While PAUSED it keeps answering
queries from its emulated view (the guest still sees the device, fig. 2
right panel) but actual work raises DevicePausedError — "can not do any
actual I/O operations until the device is unpaused".

On a VF of ranks (``core.ranks``) the state lives on the VF's workers
as DTensors laid out by ``train_state_specs`` for the VF's mesh, each
rank holding its blocks, as the JAX tenant places it with
``NamedSharding``s: ``bind`` initialises it there (bit-equal to the
one-device init) or adopts a restored one, ``run_steps`` runs the
sharded step on the workers, ``shardings_for`` names the target mesh and
specs, and ``suspend`` / ``detach`` free every worker's tensors. On the
logical slots of one card the tenant computes on its ``device`` whatever
slots its VF holds (as ``serve.fleet.EngineTenant`` does), and a restore
places the state there. The layout it exports into a pause snapshot's
``sharding_desc`` is the JAX tenant's either way. PyTorch runs eagerly:
``bind`` has nothing to compile, and keeps the executable-cache key per
slice so that ``query()`` and a snapshot's ``exec_keys`` read as the JAX
tenant's (the workers build a step per mesh, once). A paused or
detached tenant holds no device tensor: ``suspend`` and ``detach`` drop
its state, and the pause path drops the exported tree and the staging
memo.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import MeshConfig, RunConfig
from repro_torch.core.ranks import RankShardings, RankState, is_rank_slice
from repro_torch.core.vf import VirtualFunction
from repro_torch.data.pipeline import SyntheticSource, to_device
from repro_torch.device import resolve_device
from repro_torch.runtime.partitioning import ShardingRules
from repro_torch.train.step import (init_train_state, make_train_step,
                                    train_state_shapes, train_state_specs)


class DevicePausedError(RuntimeError):
    """I/O attempted on a paused device."""


class Tenant:
    def __init__(self, tid: str, run: RunConfig, *, workload: str = "train",
                 local_batch: int = 4, seq_len: int = 32, seed: int = 0,
                 device="cuda"):
        assert workload in ("train", "serve")
        self.tid = tid
        self.run = run.replace(seed=seed)
        self.workload = workload
        self.device = resolve_device(device)
        self.status = "created"        # created|running|paused|detached
        self.vf_id: Optional[str] = None
        self.steps_done = 0
        self._state = None             # device tree while attached
        self._rules: Optional[ShardingRules] = None
        self._step_fn = None
        self._exec_cache: dict = {}    # (kind, mesh_shape, slots) -> step
        self._source = SyntheticSource(self.run, batch_override=local_batch,
                                       seq_override=seq_len)
        self.step_times: list[float] = []
        self._fail_next = False        # fault-injection hook (tests)

    # ------------------------------------------------------------------ utils
    def _make_rules(self, vf: VirtualFunction) -> ShardingRules:
        mesh_cfg = MeshConfig(tuple(vf.mesh_shape), tuple(vf.mesh_axes))
        return ShardingRules(mesh_cfg, self.run)

    def state_shardings(self, mesh):
        """The train state's specs as DTensor placements on ``mesh``, a
        ``DeviceMesh`` (a worker's: the controller holds none)."""
        mesh_cfg = MeshConfig(tuple(mesh.mesh.shape),
                              tuple(mesh.mesh_dim_names))
        rules = ShardingRules(mesh_cfg, self.run, mesh)
        return rules.named(train_state_specs(self.run, rules))

    # -- manager/pause protocol (duck-typed) --------------------------------
    def shardings_for(self, vf: VirtualFunction):
        """Where a restore places this tenant's state: on a VF of ranks
        the VF's mesh and the train state's specs for it, else the
        tenant's device (one card holds every slot of the pool)."""
        if is_rank_slice(vf.devices):
            return RankShardings(vf.mesh(), self.run, train_state_specs(
                self.run, self._make_rules(vf)), self.tid)
        return self.device

    def state_template(self):
        """Shape-only tree matching export_state (checkpoint restore)."""
        return train_state_shapes(self.run)

    def export_specs(self):
        """Spec tree of the current layout (config-space save)."""
        return train_state_specs(self.run, self._rules)

    # --------------------------------------------------------------- lifecycle
    def bind(self, vf: VirtualFunction, state=None) -> float:
        """Attach to a VF slice: adopt restored state, or initialize it from
        the seed on first bind. Returns the seconds spent building the
        slice's step (the JAX tenant's compile; here a closure)."""
        self._rules = self._make_rules(vf)
        if state is not None:
            self._state = state
        elif self._state is None and is_rank_slice(vf.devices):
            mesh = vf.mesh()
            self._state = mesh.pool.init_state(
                mesh, self.tid, self.run, self.run.seed,
                train_state_specs(self.run, self._rules))
        elif self._state is None:
            self._state = init_train_state(self.run, self.run.seed,
                                           self.device)
        compile_s = 0.0
        key = (self.workload, tuple(vf.mesh_shape),
               tuple(str(d) for d in vf.devices))
        if key not in self._exec_cache:
            t0 = time.perf_counter()
            if self._step_fn is None:
                self._step_fn = make_train_step(self.run)
            self._exec_cache[key] = self._step_fn
            compile_s = time.perf_counter() - t0
        self._active_key = key
        self.vf_id = vf.vf_id
        self.status = "running"
        vf.emulated.update({"tenant": self.tid, "status": "running",
                            "steps_done": self.steps_done})
        return compile_s

    # -- guest-visible work (the unmodified guest code) -----------------------
    def run_steps(self, n: int = 1) -> dict:
        if self.status == "paused":
            raise DevicePausedError(
                f"{self.tid}: device {self.vf_id} is paused")
        if self.status != "running":
            raise RuntimeError(f"{self.tid}: no device attached")
        if self._fail_next:
            self._fail_next = False
            raise RuntimeError(f"{self.tid}: injected device failure")
        if isinstance(self._state, RankState):
            done = self._state.step([self._source.batch_at(self.steps_done
                                                           + i)
                                     for i in range(n)])
            self.steps_done += n
            self.step_times.extend(dt for _, dt in done)
            return done[-1][0] if done else {}
        fn = self._exec_cache[self._active_key]
        metrics = {}
        for _ in range(n):
            t0 = time.perf_counter()
            batch = to_device(self._source.batch_at(self.steps_done),
                              self.device)
            self._state, metrics = fn(self._state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.steps_done += 1
            self.step_times.append(time.perf_counter() - t0)
        return {k: float(v) for k, v in metrics.items()}

    # -- pause plumbing (called by core.pause, not by guests) --------------------
    def export_state(self):
        return self._state

    def suspend(self):
        """Paper step 2: unregister host-side handles; the guest keeps its
        emulated view (status queries still answered). The state's device
        tensors go with this last reference (on ranks: every worker drops
        its blocks)."""
        self._release()
        self.status = "paused"

    def _release(self):
        if isinstance(self._state, RankState):
            self._state.release()
        self._state = None

    def resume(self, state, vf: VirtualFunction):
        self._state = state
        self.status = "running"
        self.bind(vf, state=state)

    def detach(self):
        self._release()
        self.vf_id = None
        self.status = "detached"

    # -- guest-visible introspection (works while paused: emulated view) ---------
    def query(self) -> dict:
        return {"tenant": self.tid, "status": self.status,
                "vf": self.vf_id, "steps_done": self.steps_done,
                "workload": self.workload,
                "exec_keys": [list(map(str, k)) for k in self._exec_cache]}

    def loss(self) -> Optional[float]:
        return None

    def inject_failure(self):
        self._fail_next = True
