"""Crash-consistent checkpoint store (mirrors ``repro.checkpoint.store``).

Layout per checkpoint:
  <dir>/step_<N>/
    leaf_00000.bin ...      one file per tree leaf: its raw bytes
    MANIFEST.json           written LAST via atomic rename — a checkpoint
                            without a valid manifest is ignored (crash mid-
                            write never corrupts restore).

Each manifest records the tree's fingerprint, per-leaf path/shape/dtype/
crc32 and user metadata (step, tenant). The JAX store writes ``.npy``
files; numpy has no bfloat16 without ``ml_dtypes``, so the port writes
each leaf's raw little-endian bytes (``t.view(torch.uint8)``) and reads
them back through the dtype named in the manifest. The crc32 runs over
the same bytes, so a leaf's crc equals the JAX store's for the same
values. Tensor leaves come back as tensors, numpy leaves as numpy. This
store backs the detach path (a detached tenant's state parks here) and
``launch.train``'s periodic checkpoints (``save_async``, ``latest``).

A tree of DTensors (``launch.train`` over a world of ranks) is saved as
its full values in the same format: every rank gathers each leaf (a
collective), and rank 0 alone writes. ``restore`` places each leaf as
the template's leaf lies: a DTensor template leaf gets its mesh and
placements (each rank keeping its block), and ``device`` may be a
``core.ranks.RankShardings`` (a tenant on a VF of ranks).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.runtime.partitioning import is_dtensor, local_shard
from repro_torch.tree import flatten, tree_map, unflatten


def _host_tensor(leaf) -> tuple[torch.Tensor, str]:
    """(contiguous CPU tensor with the leaf's bytes, "torch"|"numpy"); a
    DTensor's full value (a collective on its mesh)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").contiguous(), "torch"
    if isinstance(leaf, (np.ndarray, np.generic, int, float, bool)):
        return torch.from_numpy(np.ascontiguousarray(leaf)), "numpy"
    raise TypeError(f"CheckpointStore stores tensors and numpy arrays, "
                    f"not {type(leaf).__name__}")


def _writer() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` world, or a lone
    process."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def _is_rank_target(device) -> bool:
    from repro_torch.core.ranks import RankShardings
    return isinstance(device, RankShardings)


def _place_like(full: torch.Tensor, like):
    """``full`` laid out as the DTensor ``like``: this rank's block."""
    from torch.distributed.tensor import DTensor
    mesh, pl = like.device_mesh, like.placements
    local = local_shard(full.to(like.to_local().device), mesh, pl)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.reshape(-1).view(torch.uint8).numpy()


def tree_fingerprint(tree) -> str:
    """Structural fingerprint: paths + shapes + dtypes (not values)."""
    desc = []
    for path, leaf in flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            desc.append((path, tuple(leaf.shape), _dtype_name(leaf)))
        else:
            a = np.asarray(leaf)
            desc.append((path, a.shape, str(a.dtype)))
    return f"{zlib.crc32(json.dumps(desc).encode()):08x}"


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             verify: bool = True) -> str:
        if not _writer():
            # another rank writes; this one joins the gathers
            for _, leaf in flatten(tree)[0]:
                _host_tensor(leaf)
            return os.path.join(self.dir, f"step_{step}")
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat, _ = flatten(tree)
        leaves_meta = []
        for i, (path, leaf) in enumerate(flat):
            t, kind = _host_tensor(leaf)
            raw = _raw(t)
            fn = f"leaf_{i:05d}.bin"
            raw.tofile(os.path.join(tmp, fn))
            leaves_meta.append({
                "path": path, "file": fn, "shape": list(t.shape),
                "dtype": _dtype_name(t), "kind": kind,
                "crc32": int(zlib.crc32(raw)) if verify else None,
            })
        manifest = {"step": step, "leaves": leaves_meta,
                    "fingerprint": tree_fingerprint(tree),
                    "metadata": metadata or {}}
        mpath = os.path.join(tmp, "MANIFEST.json.part")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        os.replace(mpath, os.path.join(tmp, "MANIFEST.json"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                    # atomic publish
        self._gc()
        return final

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None) -> threading.Thread:
        """Non-blocking save: the device->host copy happens here (so the
        snapshot is consistent even if the caller then updates its
        tensors in place), the file I/O on a worker thread."""
        host_tree = tree_map(
            lambda x: (_host_tensor(x)[0].clone() if is_dtensor(x) else
                       x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)
        self.wait()
        t = threading.Thread(target=self.save,
                             args=(step, host_tree, metadata), daemon=True)
        t.start()
        self._async_thread = t
        return t

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # -- restore ---------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        if not os.path.isdir(self.dir):
            return out
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "MANIFEST.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, device=None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``like`` (its values are ignored:
        tensors on the ``meta`` device will do). Tensor leaves land on
        ``device`` when given, else on the CPU; a leaf whose ``like`` is a
        DTensor lands in that DTensor's placements on its mesh (on the
        device of its local tensor). With a ``RankShardings`` as
        ``device`` the state is placed on that VF of ranks (a
        ``RankState`` comes back)."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat_like, treedef = flatten(like)
        metas = manifest["leaves"]
        if len(metas) != len(flat_like):
            raise ValueError(
                f"checkpoint has {len(metas)} leaves, target structure "
                f"expects {len(flat_like)}")
        leaves = []
        for meta in metas:
            raw = np.fromfile(os.path.join(d, meta["file"]), dtype=np.uint8)
            if verify and meta.get("crc32") is not None:
                if int(zlib.crc32(raw)) != meta["crc32"]:
                    raise IOError(f"crc mismatch for {meta['path']}")
            t = torch.from_numpy(raw).view(getattr(torch, meta["dtype"]))
            t = t.reshape(meta["shape"])
            if meta.get("kind") == "numpy":
                leaves.append(t.numpy())
            elif is_dtensor(flat_like[len(leaves)][1]):
                leaves.append(_place_like(t, flat_like[len(leaves)][1]))
            elif device is None or _is_rank_target(device):
                leaves.append(t)
            else:
                leaves.append(t.to(device))
        if _is_rank_target(device):
            return device.place({p: x for (p, _), x in zip(flat_like,
                                                           leaves)})
        return unflatten(treedef, leaves)

    def metadata(self, step: int) -> dict:
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            return json.load(f)["metadata"]

    def remove(self, step: int) -> bool:
        """Delete one checkpoint (idempotent). Crash recovery uses this to
        drop the orphan snapshot of a detach that was rolled back."""
        d = os.path.join(self.dir, f"step_{step}")
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)
            return True
        return False

    def sweep_tmp(self) -> int:
        """Remove ``.tmp_step_*`` staging dirs a crash mid-save left
        behind (they never had a manifest, so restores already ignore
        them — this just reclaims the space)."""
        n = 0
        if not os.path.isdir(self.dir):
            return n
        for d in os.listdir(self.dir):
            if d.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.dir, d),
                              ignore_errors=True)
                n += 1
        return n

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
