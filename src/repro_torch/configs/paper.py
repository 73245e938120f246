"""The paper's own benchmark configuration (SVFF §V; a copy of
``repro.configs.paper``).

The paper's FPGA design exposes 1 PF (memory controller class) with up to
32 VFs; each VF surfaces a fast 512KB memory and a slow 32KB memory. The
analogue used by ``repro_torch.bench.table1`` is a pool partitioned into
up to 32 VF slices, each running a small tenant workload ("svff-bench")
whose state plays the role of the VF's device memory. Reconfiguration
cycles (detach/attach vs pause/unpause) are measured end-to-end exactly
as the paper does (Table I: 1/4/10 VFs, avg of 100 runs).
"""
from repro_torch.configs.base import ModelConfig, register

# SVFF paper constants (Section V-A)
PAPER_MAX_VFS = 32
PAPER_NUM_PFS = 1
PAPER_FAST_MEM_BYTES = 512 * 1024
PAPER_SLOW_MEM_BYTES = 32 * 1024
PAPER_VF_COUNTS = (1, 4, 10)     # Table I rows
PAPER_RUNS = 100                 # Table I: avg of 100 runs


def full() -> ModelConfig:
    # Tenant workload for reconfiguration benchmarks: a small dense LM whose
    # parameter state (~512KB at fp32) mirrors the paper's fast VF memory.
    return ModelConfig(
        name="svff-bench", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512,
        source="SVFF paper §V-A analogue",
    )


register("svff-bench", full, full)
