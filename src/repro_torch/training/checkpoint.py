"""Checkpointing with atomic commit, for states that are nested dicts of
tensors.

The port of ``repro.training.checkpoint``.  Format: one ``.npz`` of the
flattened leaves plus a JSON manifest with the step, each leaf's path,
dtype and shape.  Writes go to a temp dir that is renamed into place
(atomic on POSIX), so a failure mid-save never corrupts the latest
checkpoint: a restart sees the previous one.  Leaves are flattened in
sorted key order, as ``jax.tree.flatten`` orders a dict.

numpy has no bfloat16, so a bfloat16 leaf is stored as its uint16 bits
with its dtype name in the manifest, and restored bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional, Union

import numpy as np
import torch

from .tree import leaves_with_paths, unflatten


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(ckpt_dir: str, state, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state["step"])
    leaves = [(p, torch.as_tensor(t)) for p, t in leaves_with_paths(state)]
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp-")
    try:
        arrays = {f"leaf_{i}": _to_numpy(t)
                  for i, (_, t) in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "num_leaves": len(leaves),
                    "paths": [p for p, _ in leaves],
                    "dtypes": [_dtype_name(t) for _, t in leaves],
                    "shapes": [list(t.shape) for _, t in leaves]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int, example_state=None,
            device: Union[str, torch.device, None] = None):
    """Restore a checkpoint.  With ``example_state`` (a state of the same
    structure, dtypes and shapes, on any device, ``meta`` included) the
    leaves come back in its tree, on ``device`` (default the CPU);
    without, as (leaves by path, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = {p: _from_numpy(data[f"leaf_{i}"], dt)
                  for i, (p, dt) in enumerate(zip(manifest["paths"],
                                                  manifest["dtypes"]))}
    if example_state is None:
        return leaves, manifest
    for p, ex in leaves_with_paths(example_state):
        t, ex = leaves[p], torch.as_tensor(ex)
        if tuple(t.shape) != tuple(ex.shape) or t.dtype != ex.dtype:
            raise ValueError(f"checkpoint leaf {p}: {t.dtype} "
                             f"{tuple(t.shape)}, the state has {ex.dtype} "
                             f"{tuple(ex.shape)}")
        if device is not None:
            leaves[p] = t.to(device)
    return unflatten(example_state, leaves)


def restore_latest(ckpt_dir: str, example_state=None,
                   device: Union[str, torch.device, None] = None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    if example_state is None:
        raise ValueError("restore_latest needs a structure template")
    return restore(ckpt_dir, step, example_state, device)


__all__ = ["latest_step", "restore", "restore_latest", "save"]
