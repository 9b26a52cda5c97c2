"""Checkpointing (port of ``repro/checkpoint/checkpoint.py``; npz-based, no
external dependencies).

The reference's format: a flat ``{path: array}`` mapping in ``arrays.npz``
(keys from :func:`_flatten`: dict keys and list indices joined by ``/``)
plus ``manifest.json`` (step, keys, shapes, dtypes, extra). A checkpoint
written by either package loads in the other. numpy has no bfloat16, so a
bfloat16 tensor is written as float32, which holds it exactly (as
``interop.py`` converts); a bfloat16 array the reference wrote (raw 2-byte
records, or ``ml_dtypes.bfloat16``) is read the same way. On restore every
tensor takes ``like``'s dtype and device. Restoring onto a sharded layout
waits for the sharding rules (ROADMAP Queue A 14b).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A tensor of the array's values; 2-byte bfloat16 records as float32."""
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save_checkpoint(path: str, params: Any, step: int = 0,
                    extra: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str, like: Any, shardings: Optional[Any] = None):
    """``like``: a tree of tensors with the checkpoint's structure; each
    restored tensor takes its template's dtype and device. Returns
    ``(tree, step)``."""
    if shardings is not None:
        raise NotImplementedError(
            "load_checkpoint(shardings=...): restoring onto a sharded layout needs the "
            "port's sharding rules (core/sharding.py), which come with ROADMAP Queue A 14b")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    like_flat = _flatten(like)
    if set(like_flat) != set(flat):
        missing = set(like_flat) - set(flat)
        extra = set(flat) - set(like_flat)
        raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")

    restored = {}
    for k, template in like_flat.items():
        arr = flat.pop(k)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{k}: shape {arr.shape} != {template.shape}")
        restored[k] = _from_numpy(arr).to(device=template.device, dtype=template.dtype)

    # rebuild the original structure
    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            seq = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(seq)
        return restored[prefix[:-1]]

    return rebuild(like), manifest["step"]
