"""HLO text analysis: collective-byte accounting for the roofline (the
port's own copy of ``repro.runtime.hlo``, equal to it on the same text).

The port lowers no HLO. ``CollectiveStats`` is the type in which its
dry-run's collective model (``launch.dryrun.collective_model``) reports,
under the same op names; ``collective_stats`` and ``scan_op_counts``
read HLO text that XLA wrote, as the JAX package's dry-run does.

``compiled.cost_analysis()`` has no collective term, so we parse the
optimized (post-SPMD-partitioning) HLO and sum operand sizes of every
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute.
Shapes in the partitioned module are PER-DEVICE shard shapes, so the sums
are bytes-per-device; collective time ~ bytes_per_device / link_bw (ring
algorithms move O(shard bytes) per device per hop-step, see
runtime/roofline.py for the axis-size factor).
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# matches e.g.  bf16[16,256,448]{2,1,0}  or  f32[]  (layout part optional)
_SHAPE_RE = re.compile(r"\b(" + "|".join(_DTYPE_BYTES) + r")\[([0-9,]*)\]")
# result side of an HLO instruction: "  %name = <result-type> op-name(...)"
_INSTR_RE = re.compile(
    r"=\s*(?P<rtype>\([^)]*\)|[a-z0-9_\[\],{}\s/]*?)\s*"
    r"(?P<op>" + "|".join(COLLECTIVE_OPS) + r")(?:-start|-done)?\(")


def _shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=lambda: defaultdict(int))
    count_by_op: dict = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def describe(self) -> dict:
        return {"bytes_by_op": dict(self.bytes_by_op),
                "count_by_op": dict(self.count_by_op),
                "total_bytes": self.total_bytes,
                "total_count": self.total_count}


_DEF_RE = re.compile(r"%(?P<name>[\w.\-]+)\s*=\s*(?P<rest>.*)")
_OPERANDS_RE = re.compile(r"\(((?:%[\w.\-]+(?:,\s*)?)*)\)")
_CALLS_RE = re.compile(r"calls=%([\w.\-]+)")
_COMP_SIG_RE = re.compile(r"^%?([\w.\-]+)\s+\(([^)]*)\)\s*->", re.M)


def _build_defs(hlo_text: str) -> dict:
    defs = {}
    for line in hlo_text.splitlines():
        ls = line.strip()
        m = _DEF_RE.match(ls)
        if m:
            defs[m.group("name")] = m.group("rest")
    return defs


def _comp_param_dtypes(hlo_text: str) -> dict:
    out = {}
    for m in _COMP_SIG_RE.finditer(hlo_text):
        out[m.group(1)] = re.findall(
            r":\s*(" + "|".join(_DTYPE_BYTES) + r")\[", m.group(2))
    return out


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Sum result-shape bytes of every collective instruction.

    Result bytes bound what a device receives (gather-like); they equal
    operand bytes for all-reduce / all-to-all / permute. '-start/-done'
    async pairs are counted once.

    CPU-lowering correction: the XLA:CPU SPMD pipeline hoists bf16->f32
    converts ABOVE reshard collectives (TPU keeps them in bf16), doubling
    apparent payloads. An f32 collective whose operand is a convert(-fusion)
    fed by bf16 is charged at bf16 width.
    """
    stats = CollectiveStats()
    defs = _build_defs(hlo_text)
    comp_params = _comp_param_dtypes(hlo_text)
    for line in hlo_text.splitlines():
        if "-done(" in line:      # async completion: already counted
            continue
        m = _INSTR_RE.search(line)
        if not m:
            continue
        op = m.group("op")
        rtype = m.group("rtype")
        nbytes = _shape_bytes(rtype)
        if nbytes == 0:
            nbytes = _shape_bytes(line.split("(")[0])
        # --- convert-hoist correction ---------------------------------
        if "f32[" in rtype:
            om = _OPERANDS_RE.search(line[m.end("op"):])
            ops_ = (om.group(1).replace("%", "").split(", ")
                    if om and om.group(1) else [])
            for opr in ops_:
                d = defs.get(opr.strip(), "")
                if "convert" in opr or "convert" in d[:80]:
                    cm = _CALLS_RE.search(d)
                    fed_bf16 = ("bf16[" in d or (
                        cm and "bf16" in "".join(
                            comp_params.get(cm.group(1), []))))
                    if fed_bf16 or "convert" in opr:
                        nbytes //= 2
                        break
        stats.bytes_by_op[op] += nbytes
        stats.count_by_op[op] += 1
    return stats


def scan_op_counts(hlo_text: str, ops=("fusion", "custom-call", "while",
                                       "copy", "transpose")) -> dict:
    out = {}
    for op in ops:
        out[op] = len(re.findall(rf"\b{op}\(", hlo_text))
    return out
