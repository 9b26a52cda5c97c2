"""Device meshes and process groups (port of ``repro/launch/mesh.py``).

``make_local_mesh`` is the reference's: every local device on one
``("data",)`` axis, here a 1-D ``DeviceMesh`` over the initialised process
group (one rank a device); asked for a model axis, the 2-D ``("data",
"model")`` mesh of the train step's tensor, sequence and expert
parallelism. ``mesh_groups`` gives a step its data and model groups from
that mesh (on a ``("pod", "data", "model")`` mesh the data group spans
pod and data, pod-major). ``make_production_mesh`` gives the reference's
(16, 16) ``("data", "model")`` and (2, 16, 16) ``("pod", "data",
"model")`` pod meshes as a :class:`TracedMesh`: the ``MeshConfig`` seen
from one rank, its groups ``comm.TraceGroup`` stand-ins, so that the dry
run (``launch/dryrun.py``) traces that rank's step without 256 or 512
processes. ``mesh_cfg_for`` is copied. Nothing here touches distributed
state at import, and nothing here starts a process group for a traced
mesh.

``init_distributed`` starts the process group of a ``torchrun`` launch from
its environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
or from an ``init_method`` the caller gives (a file rendezvous in tests and
in the chip smoke run). Its backend (``choose_backend``) is NCCL when every
rank has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) and gloo on the CPU.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.config import MULTI_POD_MESH, SINGLE_POD_MESH, MeshConfig
from repro_torch.core.comm import TraceGroup

DATA_AXES = ("pod", "data")


@dataclass(frozen=True)
class TracedMesh:
    """A mesh of ``cfg.shape`` seen from the rank at ``coord`` (ranks fill
    it row-major), with no process behind any other rank: each group is a
    :class:`~repro_torch.core.comm.TraceGroup`."""

    cfg: MeshConfig
    coord: Tuple[int, ...]

    @property
    def rank(self) -> int:
        return int(np.ravel_multi_index(self.coord, self.cfg.shape))

    def group(self, axes: Sequence[str]) -> TraceGroup:
        """The group of the ranks that differ from this one only along
        ``axes``, its ranks in mesh order (the outer axis first)."""
        idx = [i for i, a in enumerate(self.cfg.axis_names) if a in axes]
        sizes = [self.cfg.shape[i] for i in idx]
        rank = int(np.ravel_multi_index([self.coord[i] for i in idx], sizes)) if idx else 0
        return TraceGroup(math.prod(sizes), rank)

    @property
    def data_group(self) -> TraceGroup:
        return self.group(DATA_AXES)

    @property
    def model_group(self) -> TraceGroup:
        return self.group(("model",))


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> TracedMesh:
    """The reference's pod mesh, (16, 16) ``("data", "model")`` or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``, traced from
    ``rank``."""
    cfg = mesh_cfg_for(multi_pod=multi_pod)
    return TracedMesh(cfg, tuple(int(c) for c in np.unravel_index(rank, cfg.shape)))


def mesh_cfg_for(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def choose_backend(device_type: str, local_world: int) -> str:
    """nccl when every local rank has a card of its own, else gloo (ranks
    sharing a card, or the CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> str:
    """Initialises the default process group (rank and world size from the
    arguments, else ``torchrun``'s environment); returns its backend. On
    the card each rank takes device ``LOCAL_RANK % device_count``."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    device_type = torch.device(device).type
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend or choose_backend(device_type, local_world)
    if device_type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return backend


def make_local_mesh(device="cuda", model: int = 1):
    """A DeviceMesh over every rank of the initialised process group, on
    ``device``'s type: 1-D ``("data",)``, or with ``model`` > 1 the 2-D
    ``("data", "model")`` mesh of shape ``(world // model, model)``, ranks
    filling it row-major (a model group is ``model`` consecutive ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process group "
                           "(init_distributed, or torchrun with --nproc-per-node)")
    world = dist.get_world_size()
    if model == 1:
        return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=("data",))
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} ranks")
    return init_device_mesh(torch.device(device).type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_groups(mesh_cfg, device="cuda") -> Tuple:
    """``(data group, model group)`` of this rank on ``mesh_cfg``: on a data
    mesh the default group and None; on a ``("data", "model")`` or
    ``("pod", "data", "model")`` mesh the groups of a new
    :func:`make_local_mesh`-style mesh over the process group (the data
    group spanning pod and data, pod-major), made on every rank in the same
    order (a collective call). A :class:`TracedMesh` gives its trace
    groups and starts nothing."""
    if isinstance(mesh_cfg, TracedMesh):
        return mesh_cfg.data_group, mesh_cfg.model_group
    if mesh_cfg.axis_names == ("data",):
        return None, None
    if mesh_cfg.axis_names == ("data", "model"):
        mesh = make_local_mesh(device, mesh_cfg.model_parallelism)
        if tuple(mesh.shape) != tuple(mesh_cfg.shape):
            raise ValueError(f"the process group makes a {tuple(mesh.shape)} mesh, the plan's "
                             f"is {tuple(mesh_cfg.shape)}")
        return mesh.get_group("data"), mesh.get_group("model")
    if mesh_cfg.axis_names != ("pod", "data", "model"):
        raise NotImplementedError(f"mesh axes {mesh_cfg.axis_names}: the port runs over "
                                  f"('data',), ('data', 'model') and ('pod', 'data', 'model') "
                                  f"meshes")
    return axes_group(mesh_cfg, DATA_AXES), axes_group(mesh_cfg, ("model",))


def axes_group(mesh_cfg: MeshConfig, axes: Sequence[str]):
    """This rank's process group over ``axes`` of ``mesh_cfg`` (ranks fill
    the mesh row-major): every such group is made on every rank, in the
    same order, and this rank's is returned (the whole world's where
    ``axes`` are every axis)."""
    if not dist.is_initialized():
        raise RuntimeError("axes_group needs an initialised process group")
    if dist.get_world_size() != mesh_cfg.num_devices:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh "
                         f"{mesh_cfg.num_devices} devices")
    if set(mesh_cfg.axis_names) <= set(axes):
        return dist.group.WORLD
    grid = np.arange(mesh_cfg.num_devices).reshape(mesh_cfg.shape)
    keep = [i for i, a in enumerate(mesh_cfg.axis_names) if a in axes]
    rest = [i for i in range(grid.ndim) if i not in keep]
    members = grid.transpose(rest + keep).reshape(-1, math.prod(grid.shape[i] for i in keep))
    mine = None
    for ranks in members:
        g = dist.new_group([int(r) for r in ranks])
        if dist.get_rank() in ranks:
            mine = g
    return mine
