"""Checkpointing (port of ``repro/checkpoint/checkpoint.py``; npz-based, no
external dependencies).

The reference's format: a flat ``{path: array}`` mapping in ``arrays.npz``
(keys from :func:`_flatten`: dict keys and list indices joined by ``/``)
plus ``manifest.json`` (step, keys, shapes, dtypes, extra). A checkpoint
written by either package loads in the other. numpy has no bfloat16, so a
bfloat16 tensor is written as float32, which holds it exactly (as
``interop.py`` converts); a bfloat16 array the reference wrote (raw 2-byte
records, or ``ml_dtypes.bfloat16``) is read the same way. On restore every
tensor takes ``like``'s dtype and device.

Sharded state (``core/sharding.py``): ``save_checkpoint(..., shardings=)``
gathers every sharded tensor from the ranks' blocks and rank 0 writes the
full arrays, in the same format, so a checkpoint written by two ranks loads
in the reference and in one process. ``load_checkpoint(..., shardings=)``
gives each rank its own block of every sharded tensor (``like`` then holds
this rank's blocks, or full-shaped templates).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


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
                    extra: Optional[Dict] = None, shardings: Optional[Any] = None) -> None:
    """Writes ``params``' arrays and a manifest under ``path``. With
    ``shardings`` (a matching tree of ``NamedSharding``, None for a tensor
    every rank holds whole) ``params`` holds this rank's blocks: every rank
    calls this, the sharded tensors are gathered, and rank 0 writes."""
    flat = _flatten(params)
    if shardings is not None:
        shard_flat = _flatten(shardings)
        flat = {k: v if shard_flat.get(k) is None else shard_flat[k].gather(v)
                for k, v in flat.items()}
        if dist.get_rank() != 0:
            dist.barrier()
            return
    os.makedirs(path, exist_ok=True)
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
    if shardings is not None:
        dist.barrier()


def load_checkpoint(path: str, like: Any, shardings: Optional[Any] = None):
    """``like``: a tree of tensors with the checkpoint's structure; each
    restored tensor takes its template's dtype and device. ``shardings``: a
    matching tree of ``NamedSharding`` (None for a tensor held whole); a
    sharded tensor is restored as this rank's block, and its template may be
    that block or the full tensor. Returns ``(tree, step)``."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    like_flat = _flatten(like)
    if set(like_flat) != set(flat):
        missing = set(like_flat) - set(flat)
        extra = set(flat) - set(like_flat)
        raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")

    shard_flat = _flatten(shardings) if shardings is not None else {}
    restored = {}
    for k, template in like_flat.items():
        arr = flat.pop(k)
        sharding = shard_flat.get(k)
        full = _from_numpy(arr)
        if sharding is not None:
            block = sharding.local(full)
            if tuple(template.shape) not in (tuple(arr.shape), tuple(block.shape)):
                raise ValueError(f"{k}: shape {arr.shape} (block {tuple(block.shape)}) != "
                                 f"{template.shape}")
            full = block.clone(memory_format=torch.contiguous_format)
        elif tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{k}: shape {arr.shape} != {template.shape}")
        restored[k] = full.to(device=template.device, dtype=template.dtype)

    # rebuild the original structure
    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            seq = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return type(tree)(seq)
        return restored[prefix[:-1]]

    return rebuild(like), manifest["step"]
