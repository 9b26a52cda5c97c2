"""Logical-axis -> mesh-axis sharding rules (port of
``repro/core/sharding.py``).

Every tensor in the system (params, activations, KV caches, optimizer state)
carries a tuple of *logical axis names* (one per dim). The plan decides which
logical axes map onto which mesh axes; this module turns that decision into
data: a *spec*, a tuple with one entry per dim that is ``None``, a mesh-axis
name, or a tuple of names — entry for entry ``tuple()`` of the reference's
``PartitionSpec``. :func:`spec_for` and :func:`tree_specs` are pure functions
of shape, logical axes, ``PlanConfig`` and ``MeshConfig``: no process group,
no device.

:func:`named_sharding` applies a spec to a ``torch.distributed`` device mesh:
DTensor placements (``Shard(dim)`` on every mesh dim that the spec names for
``dim``, ``Replicate()`` on the rest) and, through
:meth:`NamedSharding.local`, the block of a full tensor that this rank holds.
A dim sharded over ``("pod", "data")`` is split pod-major, as JAX splits it
(DTensor's default order: the outer mesh dim first).

This is the pjit-era analogue of SystemML's "blocked matrix" physical layout
decision: the compiler, not the model author, owns the layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.config import MeshConfig
from repro_torch.core import comm
from repro_torch.core.strategies import PlanConfig

# Logical axes eligible for the "model" (tensor-parallel) mesh axis, in
# priority order. Only one logical axis per tensor maps to "model".
MODEL_AXIS_PRIORITY = (
    "experts",
    "q_heads",
    "heads",
    "kv_heads",
    "ffn",
    "vocab",
    "ssm_heads",
    "ssm_inner",
    "lru",
    "embed_out",   # output-projection embed dim (row-parallel)
)

# Logical axes eligible for FSDP (data-axes) sharding, largest-first is
# resolved dynamically; these are merely *allowed*.
FSDP_AXES = (
    "embed",
    "embed_out",
    "ffn",
    "vocab",
    "q_heads",
    "heads",
    "kv_heads",
    "ssm_inner",
    "ssm_heads",
    "lru",
    "experts",
)

# Axes that must never shard (scan-stacked layer dim, small vectors).
NEVER_SHARD = ("layers", "head_dim", "ssm_state", "conv", "scalar", "window")


class PartitionSpec(tuple):
    """A spec: one entry per dim, ``None``, a mesh-axis name or a tuple of
    names. A tuple (equal to a plain tuple of the same entries), typed so
    that a tree of specs tells a spec from a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _axis_size(mesh: MeshConfig, names: Sequence[str]) -> int:
    n = 1
    for nm, sz in zip(mesh.axis_names, mesh.shape):
        if nm in names:
            n *= sz
    return n


def spec_for(
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    plan: PlanConfig,
    mesh: MeshConfig,
    kind: str = "param",
) -> PartitionSpec:
    """The spec of one tensor.

    kind: "param" | "act" | "cache" | "opt"
    """
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs logical axes {axes}")
    assignment: list = [None] * len(shape)
    used_mesh_axes: set = set()

    def assign(i, mesh_axes):
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        mesh_axes = tuple(a for a in mesh_axes if a not in used_mesh_axes and a in mesh.axis_names)
        if not mesh_axes:
            return False
        div = _axis_size(mesh, mesh_axes)
        if div <= 1 or shape[i] % div != 0:
            return False
        assignment[i] = mesh_axes[0] if len(mesh_axes) == 1 else tuple(mesh_axes)
        used_mesh_axes.update(mesh_axes)
        return True

    def model_axis(allowed):
        for cand in allowed:
            for i, ax in enumerate(axes):
                if ax == cand and assignment[i] is None and assign(i, "model"):
                    return

    # 1. batch axis
    for i, ax in enumerate(axes):
        if ax == "batch":
            baxes = plan.cache_batch_axes if kind == "cache" else plan.batch_axes
            if baxes and shape[i] % _axis_size(mesh, baxes) == 0:
                assign(i, baxes)

    # 1b. context parallelism: activation seq dim (prefill)
    if kind == "act":
        for i, ax in enumerate(axes):
            if ax == "seq" and plan.seq_axes:
                assign(i, plan.seq_axes)

    # 2. cache sequence sharding (decode long-context)
    if kind == "cache":
        for i, ax in enumerate(axes):
            if ax == "seq" and plan.cache_seq_axes:
                assign(i, plan.cache_seq_axes)
        for i, ax in enumerate(axes):
            if ax in ("kv_heads", "heads", "ssm_heads") and plan.cache_heads_over_model:
                assign(i, "model")

    # 3. tensor / expert parallel over "model"
    if kind in ("param", "opt") and (plan.tensor_parallel or plan.expert_parallel):
        model_axis(MODEL_AXIS_PRIORITY if plan.tensor_parallel else ("experts",))

    # 4. FSDP over the data axes: largest remaining eligible dim
    if kind in ("param", "opt") and plan.params_over_data:
        daxes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
        cands = [
            (shape[i], i)
            for i, ax in enumerate(axes)
            if ax in FSDP_AXES and assignment[i] is None
        ]
        for _, i in sorted(cands, reverse=True):
            if assign(i, daxes):
                break

    # 5. activations: shard the feature dims that TP shards
    if kind == "act" and plan.tensor_parallel:
        model_axis(MODEL_AXIS_PRIORITY)

    return PartitionSpec(*assignment)


def tree_specs(shapes_tree, axes_tree, plan: PlanConfig, mesh_cfg: MeshConfig,
               kind: str = "param"):
    """:func:`spec_for` over a tree (dicts, lists, tuples) whose leaves have a
    ``.shape`` (tensors, meta tensors), beside an axes tree of the same
    structure down to those leaves, where each leaf's axes tuple sits."""
    if hasattr(shapes_tree, "shape"):
        return spec_for(tuple(shapes_tree.shape), tuple(axes_tree), plan, mesh_cfg, kind)
    if isinstance(shapes_tree, dict):
        return {k: tree_specs(v, axes_tree[k], plan, mesh_cfg, kind)
                for k, v in shapes_tree.items()}
    if isinstance(shapes_tree, (list, tuple)):
        return type(shapes_tree)(tree_specs(v, a, plan, mesh_cfg, kind)
                                 for v, a in zip(shapes_tree, axes_tree, strict=True))
    raise TypeError(f"tree_specs: leaf {type(shapes_tree).__name__} has no shape")


def placements_for(spec: PartitionSpec, mesh_dim_names: Sequence[str]) -> tuple:
    """DTensor placements of ``spec`` on a mesh with these dim names:
    ``Shard(d)`` on each mesh dim that the spec names for tensor dim ``d``,
    ``Replicate()`` on the rest. A tensor dim split over several mesh axes
    must name them in mesh order (outer first), which is the order in which
    DTensor nests its splits and JAX its pod-major ones."""
    names = tuple(mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {group} out of mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_slices(shape: Sequence[int], placements: Sequence, mesh_shape: Sequence[int],
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a ``shape`` tensor that the rank at mesh coordinate
    ``coord`` holds under ``placements``: each ``Shard(d)`` splits dim ``d``
    evenly, the outer mesh dim first."""
    lo, size = [0] * len(shape), list(shape)
    for p, n, c in zip(placements, mesh_shape, coord, strict=True):
        if isinstance(p, Shard):
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways")
            size[p.dim] //= n
            lo[p.dim] += c * size[p.dim]
    return tuple(slice(a, a + s) for a, s in zip(lo, size))


def block_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh: MeshConfig) -> Tuple[int, ...]:
    """The shape of each rank's block of a ``shape`` tensor under ``spec``:
    every dim divided by the sizes of the mesh axes the spec names for it."""
    out = []
    for n, entry in zip(shape, spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        out.append(n // _axis_size(mesh, names))
    return tuple(out)


def gather_blocks(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The full tensor from every rank's block under ``placements`` on
    ``mesh``: one all-gather per sharded mesh dim, the inner mesh dim first
    (``core/comm.py``)."""
    out = local
    for i in reversed(range(len(placements))):
        if isinstance(placements[i], Shard):
            out = comm.all_gather_dim(out, placements[i].dim, mesh.get_group(i))
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec applied to a ``DeviceMesh``: its DTensor ``placements``, the
    block this rank holds (:meth:`local`) and the full tensor gathered back
    from every rank's block (:meth:`gather`)."""

    mesh: object                      # torch.distributed.device_mesh.DeviceMesh
    spec: PartitionSpec
    placements: tuple

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view; no collective)."""
        coord = self.mesh.get_coordinate()
        return full[shard_slices(full.shape, self.placements, self.mesh.shape, coord)]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block."""
        return gather_blocks(local, self.mesh, self.placements)


def named_sharding(
    device_mesh,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    plan: PlanConfig,
    mesh_cfg: MeshConfig,
    kind: str = "param",
) -> NamedSharding:
    spec = spec_for(shape, axes, plan, mesh_cfg, kind)
    return sharding_of(device_mesh, spec)


def sharding_of(device_mesh, spec: PartitionSpec) -> NamedSharding:
    """``spec`` on ``device_mesh`` (whose dim names are the mesh axes)."""
    return NamedSharding(device_mesh, spec,
                         placements_for(spec, device_mesh.mesh_dim_names))


def tree_shardings(device_mesh, specs_tree):
    """:func:`sharding_of` over a tree of specs."""
    if isinstance(specs_tree, PartitionSpec):
        return sharding_of(device_mesh, specs_tree)
    if isinstance(specs_tree, dict):
        return {k: tree_shardings(device_mesh, v) for k, v in specs_tree.items()}
    return type(specs_tree)(tree_shardings(device_mesh, v) for v in specs_tree)
