#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a gloo group takes on CUDA
tensors: for each op, two fresh rank processes on card 0 try it once on
the card's tensors and check the result against the exact answer; an op
that errs records its error, one that hangs past ``OP_TIMEOUT_S`` is
recorded as hung and its processes are ended. Writes
``chiprun_out/gloo_cuda_probe.json`` and prints it.

    python3 tools/gloo_cuda_probe.py      # on a machine with a card

What this finds decides what the port stages: gloo takes the card's
tensors for the collectives (torch 2.11 on an H100), so
``runtime/collectives.py`` hands them to it as they are, and refuses
them for point-to-point, so ``pipeline_apply``'s send/recv hops alone go
through pinned host memory."""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N = 1024
OP_TIMEOUT_S = 120.0
OPS = ("all_reduce", "broadcast", "reduce_scatter", "all_gather",
       "batch_isend_irecv")


def run_op(torch, dist, op: str, rank: int):
    """(result on the card, the exact answer on the host)."""
    dev = torch.device("cuda", 0)
    ar = torch.arange(WORLD * N, dtype=torch.float32)
    x = ar.to(dev) + rank
    if op == "all_reduce":
        t = x.clone()
        dist.all_reduce(t)
        return t, 2 * ar + sum(range(WORLD))
    if op == "broadcast":
        t = x.clone()
        dist.broadcast(t, 0)
        return t, ar
    if op == "reduce_scatter":
        out = torch.empty(N, device=dev)
        fn = getattr(dist, "reduce_scatter_single",
                     dist.reduce_scatter_tensor)
        fn(out, x)
        return out, (2 * ar + sum(range(WORLD)))[rank * N:(rank + 1) * N]
    if op == "all_gather":
        out = torch.empty(WORLD * N, device=dev)
        fn = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
        fn(out, x[:N].contiguous())
        return out, torch.cat([ar[:N] + r for r in range(WORLD)])
    box = torch.empty(N, device=dev)
    ops = [dist.P2POp(dist.isend, x[:N].contiguous(), (rank + 1) % WORLD),
           dist.P2POp(dist.irecv, box, (rank - 1) % WORLD)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return box, ar[:N] + (rank - 1) % WORLD


def rank_main(op: str, rank: int, init: str):
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    try:
        got, want = run_op(torch, dist, op, rank)
        torch.cuda.synchronize()
        res = {"accepted": True, "device": str(got.device),
               "correct": bool(torch.equal(got.cpu(), want))}
    except Exception as e:  # noqa: BLE001 — the probe records any refusal
        res = {"accepted": False, "error": f"{type(e).__name__}: {e}"[:400]}
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    procs = {op: [subprocess.Popen(
        [sys.executable, __file__, op, str(r), f"file://{tmp}/{op}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)] for op in OPS}
    deadline = time.perf_counter() + OP_TIMEOUT_S
    out = {}
    for op, pair in procs.items():
        ranks = []
        for p in pair:
            try:
                so, se = p.communicate(
                    timeout=max(1.0, deadline - time.perf_counter()))
                lines = so.strip().splitlines()
                ranks.append(json.loads(lines[-1]) if lines else
                             {"accepted": False, "exit": p.returncode,
                              "stderr": se[-400:]})
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                ranks.append({"accepted": False, "hung": True})
        out[op] = ranks
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "ops": out}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gloo_cuda_probe.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4:
        rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
