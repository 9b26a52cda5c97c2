"""Task-parallel ``parfor`` (paper §3, "Distributed Operations"); port of
``repro/core/parfor.py``.

SystemML: "for scoring using a compute-intensive deep network ... it is often
better to use the task-parallel loop construct — parfor — with a small
batch_size ... The parfor optimizer then automatically creates optimal
parallel execution plans that exploit multi-core, multi-GPU, and cluster
parallelism ... compiles a row-partitioned remote-parfor plan ... that avoids
shuffling and scales linearly."

On ``torch.distributed``:

* *remote parfor* -> every rank of a ``DeviceMesh`` runs the body on its own
  block of rows (the block its data coordinate names, pod-major), with a
  **collective-free body** (the "avoids shuffling" property, held by
  :func:`count_collectives` over a ``make_fx`` trace). Without a reduction
  the result is a DTensor sharded on its rows over the data dims (the
  reference's row-sharded array; ``.full_tensor()`` gathers it); with
  ``reduce`` each rank sums its block and one all-reduce per data dim sums
  the ranks (one for a 1-D mesh), the paper's ``test_algo="allreduce"``.
* *local parfor* -> the body over all rows on one device.
* the *parfor optimizer* -> :func:`choose_parfor_plan`, which picks local vs
  remote from data size and mesh size, like SystemML's optimizer picks local
  vs remote workers.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import comm

# Below this many rows per device, distributing is not worth it (SystemML's
# local-parfor decision for small task sets).
MIN_ROWS_PER_WORKER = 1
DATA_AXES = ("pod", "data")


def _names(mesh):
    """A mesh's axis names: a DeviceMesh's dim names, or ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _sizes(mesh) -> dict:
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(_names(mesh), tuple(shape)))


def choose_parfor_plan(num_rows: int, mesh) -> str:
    """"local" or "remote". ``mesh``: None, a DeviceMesh, or anything with
    axis names and a shape (a JAX mesh's ``.shape`` is a name -> size map)."""
    if mesh is None or _num_devices(mesh) == 1:
        return "local"
    workers = _data_size(mesh)
    if num_rows < workers * MIN_ROWS_PER_WORKER or num_rows % workers != 0:
        return "local"
    return "remote"


def _num_devices(mesh) -> int:
    n = 1
    for s in _sizes(mesh).values():
        n *= s
    return n


def _data_size(mesh) -> int:
    n = 1
    for ax, s in _sizes(mesh).items():
        if ax in DATA_AXES:
            n *= s
    return n


def _data_dims(mesh):
    return [i for i, ax in enumerate(_names(mesh)) if ax in DATA_AXES]


def _data_index(mesh) -> int:
    """This rank's block index over the data dims, the outer dim first."""
    coord, idx = mesh.get_coordinate(), 0
    for i in _data_dims(mesh):
        idx = idx * mesh.size(i) + coord[i]
    return idx


def parfor(
    body: Callable,
    rows: torch.Tensor,
    *,
    mesh=None,
    reduce: Optional[str] = None,
):
    """Row-partitioned task-parallel map: ``body`` maps a row batch -> output
    batch. ``reduce``: None (stack results) | "sum" | "mean" — the
    ``test_algo="allreduce"`` aggregation. Every rank passes the same
    ``rows``. Returns ``(out, plan)``."""
    plan = choose_parfor_plan(rows.shape[0], mesh)
    if plan == "local":
        out = body(rows)
        return _reduce_local(out, reduce), plan

    n = rows.shape[0] // _data_size(mesh)
    i = _data_index(mesh)
    out = body(rows[i * n:(i + 1) * n])
    if reduce is None:
        dims = set(_data_dims(mesh))
        placements = [Shard(0) if d in dims else Replicate() for d in range(mesh.ndim)]
        return DTensor.from_local(out, mesh, placements, run_check=False), plan
    # one final all-reduce of the per-worker aggregate — the only collective
    # in the whole parfor plan (the paper's "allreduce")
    s = torch.sum(out, dim=0)
    for d in _data_dims(mesh):
        s = comm.all_reduce_(s, "sum", mesh.get_group(d))
    if reduce == "mean":
        s = s / rows.shape[0]
    return s, plan


def _reduce_local(out, reduce):
    if reduce == "sum":
        return torch.sum(out, dim=0)
    if reduce == "mean":
        return torch.mean(out, dim=0)
    return out


# c10d collective ops as a make_fx graph names them: the functional ops
# (torch.ops._c10d_functional.*) and the in-place c10d ones (torch.ops.c10d.*)
_COLLECTIVE = re.compile(
    r"\b(?:_c10d_functional|c10d)\.("
    r"all_reduce|all_reduce_coalesced|allreduce_|allreduce_coalesced_"
    r"|all_gather_into_tensor|all_gather_into_tensor_coalesced|allgather_"
    r"|allgather_into_tensor_coalesced_|_allgather_base_|allgather_coalesced_"
    r"|reduce_scatter_tensor|reduce_scatter_tensor_coalesced|reduce_scatter_"
    r"|_reduce_scatter_base_|reduce_scatter_tensor_coalesced_"
    r"|all_to_all_single|alltoall_|alltoall_base_"
    r"|broadcast|broadcast_|permute_tensor|send|recv_)\.")


def count_collectives(graph_text: str) -> int:
    """Number of c10d collective calls in the code of a ``make_fx`` trace
    (test helper for the "avoids shuffling" claim; the reference counts
    collectives in the lowered HLO)."""
    return len(_COLLECTIVE.findall(graph_text))
