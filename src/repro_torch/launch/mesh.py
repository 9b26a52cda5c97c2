"""Device meshes and process groups (port of ``repro/launch/mesh.py``).

``make_local_mesh`` is the reference's: every local device on one
``("data",)`` axis, here a 1-D ``DeviceMesh`` over the initialised process
group (one rank a device); asked for a model axis, the 2-D ``("data",
"model")`` mesh of the train step's tensor, sequence and expert
parallelism. ``mesh_groups`` gives a train step its data and model groups
from that mesh. ``make_production_mesh`` builds the reference's
(16, 16) / (2, 16, 16) TPU pod meshes, which have no meaning on one H100
host; it raises. ``mesh_cfg_for`` is copied. Nothing here touches
distributed state at import.

``init_distributed`` starts the process group of a ``torchrun`` launch from
its environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
or from an ``init_method`` the caller gives (a file rendezvous in tests and
in the chip smoke run). Its backend (``choose_backend``) is NCCL when every
rank has a card of its own, gloo when ranks share a card (NCCL refuses two
ranks on one device) and gloo on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.config import MULTI_POD_MESH, SINGLE_POD_MESH, MeshConfig


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "make_production_mesh builds the reference's TPU pod meshes ((16, 16) data x model, "
        "(2, 16, 16) pod x data x model); the port runs data meshes over the ranks of one "
        "host (make_local_mesh). Pod-scale meshes come with the dry-run tooling, ROADMAP "
        "Queue A 15")


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


def mesh_groups(mesh_cfg: MeshConfig, device="cuda") -> Tuple:
    """``(data group, model group)`` of this rank on ``mesh_cfg``: on a data
    mesh the default group and None; on a ``("data", "model")`` mesh the
    groups of a new :func:`make_local_mesh` 2-D mesh, taken from it so that
    every rank creates them in the same order (a collective call)."""
    if mesh_cfg.axis_names == ("data",):
        return None, None
    if mesh_cfg.axis_names != ("data", "model"):
        raise NotImplementedError(f"mesh axes {mesh_cfg.axis_names}: the port's train step "
                                  f"runs over ('data',) and ('data', 'model') meshes")
    mesh = make_local_mesh(device, mesh_cfg.model_parallelism)
    if tuple(mesh.shape) != tuple(mesh_cfg.shape):
        raise ValueError(f"the process group makes a {tuple(mesh.shape)} mesh, the plan's is "
                         f"{tuple(mesh_cfg.shape)}")
    return mesh.get_group("data"), mesh.get_group("model")
