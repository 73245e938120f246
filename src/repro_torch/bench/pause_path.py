"""The pause/unpause path itself on the port (the paper's own metric, Table
I; mirrors ``benchmarks/pause_path.py``: the same rows and keys, plus
each row's restore error, which the port asserts, and its GB/s).

  HC1  transfer-queue count (the QDMA queue analogue): 1/2/4/8/16 queues
       round-robining WHOLE leaves (the whole-leaf engine, pipeline=False);
       queues_8 is the baseline every later iteration must beat
  HC2  int8 compression of the snapshot payload (lossy — bytes vs error;
       the whole-leaf engine, so ``qdma_pack`` per leaf, ``qdma_unpack`` on
       restore)
  HC3  incremental snapshots: identical (unmodified) device tensors are
       not re-transferred — a serving tenant's params never change
       between pauses, only its KV cache does
  HC4  pipelined descriptor engine: fixed-size row-chunk descriptors over
       transfer queues (CUDA streams on the card) with an overlapped
       pack->D2H->assemble pipeline; ``int8_pipelined`` packs each
       descriptor with ``qdma_pack_rows``
  HC5  pre-copy live pause: background snapshot rounds while the tenant
       keeps stepping, then a stop-and-copy of only the dirtied leaves —
       tenant-visible stall (stop_ms) vs the stop-the-world pause total

The state is a qwen3-100m-class train state (``qwen3-100m-bench``: fp32
params plus AdamW moments, ~918 MB) built by ``init_train_state`` on
``--device`` (the card by default); ``--smoke`` takes a few-MB twin of
the same family for the CPU. Every non-int8 row must restore bit-equal,
every int8 row within each block's bound (half a quantization step plus
the roundings), else the run raises.

    python -m repro_torch.bench.pause_path --device cuda --repeats 3
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from repro_torch.configs import ModelConfig, make_run_config, register
from repro_torch.core import (DevicePool, StagingEngine, pause_vf,
                              pause_vf_live, unpause_vf)
from repro_torch.core.vf import VFState, VirtualFunction
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import INV127
from repro_torch.sim import ServeSimTenant
from repro_torch.train.step import init_train_state
from repro_torch.tree import flatten, tree_leaves, tree_map

ARCH = "qwen3-100m-bench"
BLOCK = 128                   # the int8 block: divides every trailing dim
# |x - unpack(pack(x))| <= scale * (1/2 + 2**-16): half a step, plus the
# roundings of x / scale and q * scale (each at most 127 * scale * 2**-24)
INT8_SLACK = 2 ** -16
# a bf16 leaf also rounds the restored value to bf16: at most 2**-8 of the
# value before rounding, (1 + 2**-7) times the value after
BF16_HALF_STEP = 2 ** -8 * (1 + 2 ** -7)


def _qwen3_100m() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", num_layers=12, d_model=640, num_heads=10,
        num_kv_heads=2, d_ff=1920, vocab_size=32000, head_dim=64,
        qk_norm=True, tie_embeddings=True)


def _qwen3_100m_smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", num_layers=2, d_model=128, num_heads=2,
        num_kv_heads=1, d_ff=256, vocab_size=512, head_dim=64,
        qk_norm=True, tie_embeddings=True)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8)))


def restore_error(tree, out, engine: StagingEngine) -> tuple[float, float]:
    """(max relative error over the float leaves, the largest share of its
    int8 bound any packed element uses). A leaf the engine does not pack
    must come back bit-equal; a packed one within each block's bound."""
    want, got = flatten(tree)[0], flatten(out)[0]
    if [p for p, _ in want] != [p for p, _ in got]:
        raise AssertionError("the restored tree has another structure")
    err = share = 0.0
    for (path, a), (_, b) in zip(want, got):
        b = b.to(a.device)
        if a.is_floating_point():
            d = (a.float() - b.float()).abs().max()
            s = a.float().abs().max() + 1e-9
            err = max(err, float(d / s))
        if not engine._pack_eligible(a):
            if not _bits_equal(a, b):
                raise AssertionError(f"{path}: not restored bit-equal")
            continue
        ab = a.float().reshape(-1, engine.block)
        bb = b.float().reshape(-1, engine.block)
        lim = ((ab.abs().amax(-1, keepdim=True) * INV127).clamp_min(1e-12)
               * (0.5 + INT8_SLACK))
        if a.dtype == torch.bfloat16:
            lim = lim + bb.abs() * BF16_HALF_STEP
        s = float(((ab - bb).abs() / lim).max())
        if not s <= 1:
            raise AssertionError(f"{path}: restored outside the int8 bound "
                                 f"({s:.3g} of it)")
        share = max(share, s)
    return err, share


def bench_state(device="cuda", smoke: bool = False, seed: int = 0) -> dict:
    """The bench's ``qwen3-100m-bench`` train state on ``device``."""
    dev = resolve_device(device)
    register(ARCH, _qwen3_100m, _qwen3_100m_smoke)
    state = init_train_state(make_run_config(ARCH, "train_4k", smoke=smoke),
                             seed, dev)
    _sync(dev)
    return state


def bench(repeats: int = 3, device="cuda", smoke: bool = False,
          seed: int = 0) -> list:
    dev = resolve_device(device)
    state = bench_state(dev, smoke, seed)
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    rows = []

    def timeit(name, eng, tree, note="", save_stat="median"):
        """save_stat='first' reports the FIRST save: for memo-bearing
        rows whose later repeats identity-hit everything, the median
        would time the all-skip path instead of the labeled workload."""
        saves, restores = [], []
        moved = descriptors = rmoved = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            staged = eng.save(tree)
            saves.append(time.perf_counter() - t0)
            if moved is None:           # first save (memo cold)
                moved = eng.last_stats.bytes_moved
                descriptors = eng.last_stats.num_descriptors
            t0 = time.perf_counter()
            out = eng.restore(staged, dev)
            _sync(dev)
            restores.append(time.perf_counter() - t0)
            if rmoved is None:
                rmoved = eng.last_stats.bytes_moved
            del staged
        err, share = restore_error(tree, out, eng)
        del out
        if eng.compression == "none" and err != 0.0:
            raise AssertionError(f"{name}: restore error {err}, not 0")
        save_ms = (saves[0] if save_stat == "first"
                   else statistics.median(saves)) * 1000
        restore_ms = statistics.median(restores) * 1000
        rows.append({"name": name, "save_ms": save_ms,
                     "restore_ms": restore_ms,
                     "save_plus_restore_ms": save_ms + restore_ms,
                     "bytes_moved": int(moved), "logical_bytes": int(nbytes),
                     "descriptors": descriptors,
                     "save_gbps": moved / max(save_ms, 1e-9) / 1e6,
                     "restore_gbps": rmoved / max(restore_ms, 1e-9) / 1e6,
                     "max_rel_err": err, "int8_bound_share": share,
                     "note": note})
        return rows[-1]

    # HC1: queue sweep (uncompressed, whole-leaf round-robin engine)
    for q in (1, 2, 4, 8, 16):
        timeit(f"queues_{q}", StagingEngine(num_queues=q, pipeline=False),
               state, note="baseline engine" if q == 8 else "")

    # HC2: int8 compression (block 128 divides every trailing dim here)
    timeit("int8", StagingEngine(num_queues=8, compression="int8",
                                 block=BLOCK, pipeline=False), state,
           note="lossy: within each block's bound (asserted)")

    # HC3: incremental — second save of an UNCHANGED tree moves ~0 bytes
    eng = StagingEngine(num_queues=8, incremental=True, pipeline=False)
    eng.save(state)                              # warm the memo
    timeit("incremental_unchanged", eng, state, note="params identical")
    # and a half-changed tree (simulates serving: cache moves, params don't)
    state2 = dict(state)
    state2["params"] = tree_map(lambda x: x * 1.0, state["params"])
    timeit("incremental_half_changed", eng, state2,
           note="params changed, opt identical", save_stat="first")
    del state2, eng

    # HC4: pipelined descriptor engine (chunk descriptors, queues,
    # overlapped pack->D2H->assemble; stream transport on the card)
    timeit("pipelined", StagingEngine(num_queues=8), state,
           note="descriptor engine, auto transport")
    timeit("pipelined_stream",
           StagingEngine(num_queues=8, transport="stream",
                         chunk_bytes=16 << 20), state,
           note="explicit chunked streaming")
    timeit("int8_pipelined",
           StagingEngine(num_queues=8, compression="int8", block=BLOCK),
           state, note="chunk-granular pack overlapped with D2H")

    # HC5: pre-copy live pause vs stop-the-world, serving-shaped tenant
    rows.extend(_bench_live_pause(state, repeats, dev))
    return rows


def _bench_live_pause(state, repeats: int, dev: torch.device) -> list:
    """Stop-the-world pause_vf vs pause_vf_live on a tenant whose params
    (~the full bench state) are clean and only a small cache is hot. The
    unpaused tenant must hold its params bit-equal and its cache at its
    step count."""
    pool = DevicePool(devices=("benchdev0",))

    def mk_tenant(tid):
        params = tree_map(lambda x: x + 0, state)            # private copy
        cache = torch.zeros((64, 1024), dtype=torch.float32,
                            device=dev)                     # ~256KB hot
        _sync(dev)                               # don't time the copy
        return ServeSimTenant(params, cache, tid=tid)

    def mk_vf(vid):
        vf = VirtualFunction(vf_id=vid)
        vf.assign_devices(pool.devices[:1], (1, 1))
        vf.transition(VFState.ATTACHED)
        return vf

    out = []

    def run_one(name, live):
        totals, stops, moved = [], [], []
        for r in range(repeats + 1):     # first iteration = warmup, dropped
            tn = mk_tenant(f"{name}{r}")
            params = tn.params
            vf = mk_vf(f"0000:0b:00.{r}")
            vf.owner = tn.tid
            tn.vf_id = vf.vf_id
            staging = StagingEngine(num_queues=8, incremental=True)
            for _ in range(4):
                tn.step()                        # steady-state serving
            if live:
                snap, t = pause_vf_live(pool, vf, tn, staging, rounds=2,
                                        step_fn=tn.step)
            else:
                snap, t = pause_vf(pool, vf, tn, staging)
            if r > 0:
                totals.append(t.total * 1e3)
                stops.append(t.stop_ms)
                moved.append(snap.stats.bytes_moved)
            vf.assign_devices(pool.devices[:1], (1, 1))
            unpause_vf(pool, vf, tn, snap, staging)
            _sync(dev)
            same = all(_bits_equal(a, b) for (_, a), (_, b) in zip(
                flatten(params)[0], flatten(tn.params)[0]))
            if not same or not bool((tn.cache == tn.steps_done).all()):
                raise AssertionError(f"{name}: the unpaused tenant's state "
                                     "is not the paused one's")
            del params, snap
            tn.params = None
            tn.cache = None
        return {"name": name, "total_ms": statistics.median(totals),
                "stop_ms": statistics.median(stops),
                "stop_bytes_moved": int(statistics.median(moved)),
                "max_rel_err": 0.0}

    world = run_one("pause_stop_world", live=False)
    world["note"] = "tenant stalled for the whole save"
    live = run_one("pause_live_precopy", live=True)
    live["stop_speedup_vs_stop_world"] = (
        world["total_ms"] / max(live["stop_ms"], 1e-9))
    live["note"] = ("pre-copy rounds in background; stop-and-copy moves "
                    "only the dirty cache")
    return [world, live]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state (cuda, or cpu)")
    ap.add_argument("--smoke", action="store_true",
                    help="a few-MB state of the same family (CPU runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = bench(args.repeats, args.device, args.smoke, args.seed)
    for r in rows:
        print(json.dumps(r))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
