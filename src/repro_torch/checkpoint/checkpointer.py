"""Checkpointing (a port of ``repro.checkpoint.checkpointer``): atomic,
resumable, optionally asynchronous, in the reference's on-disk layout.

Layout:  <dir>/step_<n:08d>/  with one .npy per tree leaf, named by its
``/``-joined path with ``/`` as ``__`` (``params__layers__wq.npy``,
``opt__step.npy`` an int32 scalar), + manifest.json (step, leaf paths).
Writes go to a temp directory first and are renamed into place, so a
failure mid-save never corrupts the latest checkpoint.  Each package
restores the other's checkpoints.

``AsyncCheckpointer`` snapshots to host memory synchronously and writes on
a background thread, overlapping I/O with the next training steps;
``wait()`` joins before the next save or at shutdown.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..sharding.regions import is_dtensor
from ..tree import tree_from_paths, tree_map, tree_paths


def _host(x, keep: bool = True) -> np.ndarray | None:
    """A leaf as a numpy array that shares no memory with the live state (a
    sharded leaf gathered whole: every rank must call this).  With
    ``keep=False`` (a rank that writes nothing) the leaf only joins the
    gather and no host copy is made."""
    if is_dtensor(x):
        x = x.full_tensor()
    if not keep:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _writer() -> bool:
    """Of several ranks, rank 0 writes; a checkpoint holds whole leaves."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, state) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_paths(state)
    manifest = {"step": step, "leaves": sorted(leaves)}
    for key, leaf in leaves.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), _host(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, state_like, step: int | None = None):
    """Restore into the structure, dtypes and devices of ``state_like``;
    returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    ref = tree_paths(state_like)
    missing = sorted(set(ref) - set(manifest["leaves"]))
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]} ...")
    from torch.distributed.tensor import distribute_tensor

    vals = {}
    for key, like in ref.items():
        arr = np.load(os.path.join(d, key.replace("/", "__") + ".npy"))
        val = torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        if is_dtensor(like):
            val = distribute_tensor(val, like.device_mesh, like.placements)
        vals[key] = val
    return tree_from_paths(vals), manifest["step"]


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, state) -> None:
        self.wait()
        writer = _writer()
        snapshot = tree_map(lambda x: _host(x, writer), state)
        if not writer:
            return

        def work():
            save(self.ckpt_dir, step, snapshot)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"))
