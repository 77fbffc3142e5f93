"""Checkpointing: tree ⇄ directory of .npy files + a JSON manifest
(port of ``repro/train/checkpoint.py``, the same on-disk format).

Leaves are saved one ``.npy`` each (``leaf_%05d.npy``) under
``step_%08d/``, in JAX's leaf order and with JAX's key-path strings in
``manifest.json`` (``train/pytree.py``), so either package restores the
other's checkpoints.  Tensors are moved to the host to be written; a
bfloat16 leaf, which numpy cannot hold, is written as float32 (restore
casts every leaf to the dtype of the tree it restores into, as the
reference's does).  Atomic via write-to-tmp + rename.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.pytree import flatten_with_path, path_str, unflatten

Pytree = Any


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, tree: Pytree, step: int,
         extra: Optional[Dict] = None) -> str:
    """Write ``tree`` under ``ckpt_dir/step_{step}``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    dest = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_ckpt_")
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(flatten_with_path(tree)):
        name = f"leaf_{i:05d}.npy"
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, name), arr)
        manifest["leaves"].append({
            "path": path_str(path), "file": name,
            "dtype": str(arr.dtype), "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.rename(tmp, dest)
    return dest


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Pytree, step: Optional[int] = None
            ) -> Tuple[Pytree, int, Dict]:
    """Restore into the structure of ``like``: each leaf a tensor of the
    like leaf's dtype on its device (shape-checked)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for path, leaf in flatten_with_path(like):
        key = path_str(path)
        entry = by_path.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(src, entry["file"]))
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        out.append(torch.as_tensor(arr).to(
            device=leaf.device, dtype=leaf.dtype))
    return unflatten(like, out), manifest["step"], manifest["extra"]
