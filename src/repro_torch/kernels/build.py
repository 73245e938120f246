"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface; no PyTorch
headers are involved, so a build takes seconds. A library is named by a
hash of its source, the shared header and its flags, and lives in
``build/repro_torch_kernels/`` at the repository root (ignored by git),
so an unchanged kernel is built once per checkout. Nothing is built at
import: ``library(name)`` builds on first use, and ``build()`` builds
several sources at once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# <repo>/build/repro_torch_kernels, beside src/
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")

BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: source stem -> (extra nvcc flags, {exported function: argtypes})
KERNELS = {
    # the attention launchers' last int: 1 for fp32 inputs, 0 for bf16
    "flash_attention": ((), {
        "launch_flash_attention": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    }),
    "flash_decode": ((), {
        "launch_flash_decode": [_P] * 5 + [_I] * 9 + [_P],
    }),
    "ssm_scan": ((), {
        "launch_ssm_scan": [_P] * 6 + [_I] * 7 + [_P],
    }),
    "paged_decode": ((), {
        "launch_paged_decode": [_P] * 6 + [_I] * 7 + [_P],
        "launch_paged_decode_quant": [_P] * 8 + [_I] * 7 + [_P],
    }),
    # the sampler is bit-exact against numpy: no FMA contraction, IEEE
    # division and square root
    "fused_sample": (("--fmad=false", "-prec-div=true", "-prec-sqrt=true"), {
        "launch_fused_sample": [_P, _P, _P, _I, _I, _P],
    }),
    # the staging kernels are bit-exact against the plain versions: the
    # same flags as the sampler
    "qdma_pack": (("--fmad=false", "-prec-div=true"), {
        "launch_qdma_pack": [_P, _P, _P, _L, _I, _I, _P],
        "launch_qdma_unpack": [_P, _P, _P, _L, _I, _I, _P],
        "launch_qdma_digest": [_P, _L, _P, _P],
    }),
}

_loaded: dict[str, ctypes.CDLL] = {}
# first uses from several threads (the staging engine's pool) build and
# load a library once
_load_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    flags, _ = KERNELS[name]
    h = hashlib.sha256()
    for part in (" ".join(BASE_FLAGS + flags).encode(),
                 (CSRC / "common.cuh").read_bytes(),
                 (CSRC / f"{name}.cu").read_bytes()):
        h.update(part)
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Build the named kernels (all by default) that are not built yet,
    one nvcc each, in parallel. Returns {name: seconds spent building}
    (0.0 for a cached library). ``ptxas -v`` output (registers, shared
    memory, spills) lands in ``<library>.log`` beside each library."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *BASE_FLAGS, *KERNELS[name][0], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log)
    spent = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        spent[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)        # atomic: concurrent builders agree
        else:
            failed.append(f"{name}: nvcc exit {rc}, see "
                          f"{out.with_suffix('.log')}:\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return spent


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in KERNELS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib
