"""Checkpointing: atomic, resumable, numpy-backed (the port of
``repro/train/checkpoint.py``, in the same on-disk format).

Layout: <dir>/step_<N>/
  manifest.json        — step, tree structure, shapes/dtypes, extra
  arrays.npz           — flattened leaves keyed by index

Leaves are flattened in ``jax.tree.flatten``'s order (dict keys sorted,
lists in order), and bfloat16 (float8) leaves are stored as a uint16
(uint8) view under the dtype's name, as the reference stores them, so a
checkpoint written by either package loads in the other.  The manifest's
``treedef`` is each package's own description of the structure; neither
reads it back: a load checks the leaf count and every shape.

Writes go to a tmp dir + atomic rename (a crashed writer never corrupts
the latest checkpoint).  ``latest_step`` scans for the newest complete
manifest.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import tree_flatten

# dtype name -> (the integer view npz stores, the torch dtype)
_EXOTIC = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}
# a same-width signed view: torch has every one of these on the CPU
_SIGNED = {2: torch.int16, 1: torch.int8}


def _encode(x) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array npz can hold, dtype name)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        return a, str(a.dtype)
    t = x.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if name in _EXOTIC:
        view, _ = _EXOTIC[name]
        return t.view(_SIGNED[t.element_size()]).numpy().view(view), name
    return t.numpy(), name


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        _, dt = _EXOTIC[dtype_name]
        signed = _SIGNED[a.dtype.itemsize]
        return torch.from_numpy(a.view(str(signed).replace("torch.", ""))
                                ).view(dt)
    # npz hands each read a fresh array: no copy needed, but a 0-d read
    # is a numpy scalar
    return torch.from_numpy(np.asarray(a))


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    extra: Optional[dict] = None) -> str:
    flat, _ = tree_flatten(state)
    encoded = [_encode(x) for x in flat]
    arrays = {f"a{i}": e[0] for i, e in enumerate(encoded)}
    manifest = {
        "step": int(step),
        "treedef": "repro_torch " + _structure(state),
        "n_leaves": len(flat),
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [e[1] for e in encoded],
        "extra": extra or {},
    }
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, template: Any,
                    step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``template`` (shape-checked).  Each
    leaf comes back as a tensor of the checkpoint's dtype, on the device
    of the template's leaf (the CPU where the template holds none)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t, rebuild = tree_flatten(template)
    if manifest["n_leaves"] != len(flat_t):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; template has "
            f"{len(flat_t)} — config mismatch?")
    flat = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, t in enumerate(flat_t):
            a = _decode(data[f"a{i}"], manifest["dtypes"][i])
            if tuple(a.shape) != tuple(np.shape(t)):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {tuple(a.shape)} != "
                    f"template {tuple(np.shape(t))}")
            if isinstance(t, torch.Tensor):
                a = a.to(t.device)
            flat.append(a)
    return rebuild(flat), step, manifest.get("extra", {})
