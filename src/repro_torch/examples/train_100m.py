"""End-to-end driver: train a ~100M-parameter qwen3-family model with
checkpointing, through the port's ``launch.train`` path (mirrors
``examples/train_100m.py``).

The config is the qwen3-0.6b architecture scaled to ~100M params (same
family: GQA, qk_norm, SwiGLU, tied embeddings). Pass --steps to shorten.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import repro_torch.configs.base as B
from repro_torch.configs import register


def qwen3_100m() -> B.ModelConfig:
    # ~100M params: 12L x 640d, GQA 10H/kv2, d_ff 1920, 32k vocab
    return B.ModelConfig(
        name="qwen3-100m", family="dense",
        num_layers=12, d_model=640, num_heads=10, num_kv_heads=2,
        d_ff=1920, vocab_size=32000, head_dim=64, qk_norm=True,
        tie_embeddings=True,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--workdir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="train100m_")
    register("qwen3-100m", qwen3_100m, qwen3_100m)
    cfg = qwen3_100m()
    print(f"model: {cfg.name}, params={cfg.param_count()/1e6:.1f}M")

    from repro_torch.launch.train import main as train_main
    rc = train_main([
        "--arch", "qwen3-100m", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "1e-3", "--warmup", "20",
        "--workdir", workdir, "--checkpoint-every", "50",
        "--log-every", "10", "--device", args.device,
    ] + (["--resume"] if args.resume else []))
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    print(f"loss: {lines[0]['loss']:.3f} -> {lines[-1]['loss']:.3f} "
          f"over {len(lines)} steps; checkpoints in {workdir}/ckpt")
    return rc


if __name__ == "__main__":
    sys.exit(main())
