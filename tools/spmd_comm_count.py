#!/usr/bin/env python3
"""One reading, no gate: the collectives of one sharded train step of
qwen3-0.6b smoke (batch 4 x 16, fp32 params, AdamW) on a (2, 2) (data,
model) mesh of four CPU gloo ranks, as ``CommDebugMode`` counts them on
each rank, beside ``launch.dryrun.collective_model``'s first-order count
for the same run and mesh. Prints one JSON line.

    PYTHONPATH=src python3 tools/spmd_comm_count.py
"""
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]


def main():
    import spmd_cases
    from repro_torch.configs import MeshConfig, make_run_config
    from repro_torch.core.ranks import RankPool
    from repro_torch.launch.dryrun import collective_model
    from repro_torch.runtime.partitioning import ShardingRules
    from repro_torch.train.step import train_state_specs

    shape, axes = (2, 2), ("data", "model")
    run = make_run_config("qwen3-0.6b", "train_4k", smoke=True)
    run = dataclasses.replace(run, shape=dataclasses.replace(
        run.shape, global_batch=4, seq_len=16))
    rules = ShardingRules(MeshConfig(shape, axes), run)
    with RankPool(4, device="cpu") as rp:
        mesh = rp.mesh(shape, axes, rp.ranks)
        rp.init_state(mesh, "comm", run, 0, train_state_specs(run, rules))
        counts = rp.run_on(rp.ranks, spmd_cases.comm_counts, "comm")
    model = collective_model(run, rules, "train")
    print(json.dumps({
        "mesh": list(shape), "arch": "qwen3-0.6b smoke", "batch": [4, 16],
        "comm_debug_mode_per_rank": counts,
        "collective_model": dict(model.count_by_op),
        "collective_model_bytes": dict(model.bytes_by_op)}))


if __name__ == "__main__":
    main()
