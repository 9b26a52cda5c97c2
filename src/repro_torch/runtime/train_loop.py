"""Training runtime: plan-driven train-step construction and the sharding
rules of training (port of ``repro/runtime/train_loop.py``).

``make_train_step`` turns (model, plan, mesh, TrainConfig) into a step
function whose gradient accumulation, optimizer-state dtype, per-layer
rematerialisation and layout over the ranks all come from the *plan*; the
model code never sees the mesh. This is the runtime half of the paper's
compiler: SystemML's generated execution plan, here run eagerly.

The step keeps the reference's arithmetic: gradients of ``Model.loss``
(with ``microbatches`` > 1 accumulated in float32 over equal splits of the
batch and cast back to each parameter's dtype), clipped by their global
norm when ``TrainConfig.grad_clip`` is set, then one optimizer update with
the state in the plan's dtype and the result cast back to the parameter's
dtype, at ``t = step + 1`` (an int32 step, as the reference's). Where the
reference returns new trees, this step updates the parameters and the
optimizer state in place, one layer's slice at a time: a stacked Yi-6B
FFN tensor cast whole to float32 would add gigabytes of temporaries to a
card already holding parameters, gradients and state. Each layer's
gradient lands in a tensor of its own (the step hands the model per-layer
leaves), so no stacked gradient is assembled from per-layer pieces.

On a mesh of more than one device (the reference's train front door uses
``MeshConfig((n,), ("data",))``; its multi-device test a ``("data",
"model")`` mesh) the step runs inside an initialised process group with
one rank a device, and equals the one-device step on the global batch:

* every rank is given the same global batch and takes, of each
  microbatch (a run of the global batch's rows, as the reference splits
  it), the rows that :func:`batch_specs` assigns it over the data axis
  (all of them where the batch does not split; the model ranks of a data
  group take the same rows), and backpropagates its token-mean loss
  weighted by its share of the tokens over the data ranks;
* DP (``params_over_data`` False): parameters replicated; each gradient
  all-reduced (summed) after the backward pass;
* FSDP (``params_over_data`` True): each rank holds its block of every
  parameter and of its optimizer state as :func:`train_shardings` splits
  them (:func:`shard_params`); a layer's parameters are all-gathered over
  the data axis when the layer runs (again in its recompute under remat)
  and the gather's backward reduce-scatters their gradient, summed in its
  own dtype (``core/comm.AllGatherDim``); parameters the rules leave whole
  over the data axis are all-reduced over it as under DP;
* a ``model`` axis (``DP_TP`` / ``FSDP_TP``: ``tensor_parallel``,
  ``expert_parallel``, ``seq_shard_checkpoints``): each rank holds its
  model block of every parameter the rules split over ``"model"`` (heads,
  ffn, vocab, experts, SSM heads and inner width, RG-LRU width), and the
  blocks run on them with the collectives over the model group written out
  (``models/common.ShardCtx``, ``models/blocks.py``): Megatron's
  column- and row-parallel products, the vocab-parallel embedding and
  cross-entropy, and under ``seq_shard_checkpoints`` the residual stream
  and every remat checkpoint as the rank's sequence shard. A parameter
  every model rank holds whole has the whole gradient on every rank: its
  gradient is summed over the model group inside the backward pass where
  each rank's use of it is a part (``ShardCtx.whole``);
* the clipping norm (:func:`global_norm`) sums the squares of the blocks
  over the ranks, each gradient once over the mesh, after a power-of-two
  prescale taken from the largest gradient entry over the ranks;
* the optimizer updates this rank's blocks in place, one layer at a time;
* an MoE layer routes its data shard's rows (the reference's group of one
  data shard) and takes its load-balance statistics as means over the data
  ranks (``comm.AllReduceMean``), so its auxiliary loss is the global
  batch's.

On a pod mesh (``("pod", "data", "model")``) ``"pod"`` and ``"data"``
together are the data axes: the batch, FSDP's blocks and the data
group span both, pod-major. ``mesh_cfg`` may also be a traced mesh
(``launch/mesh.TracedMesh``, the dry run's): the step is then that rank's,
its groups ``comm.TraceGroup`` stand-ins, and no process group is needed.
A plan that puts no work on a model axis runs every block whole on each of
its ranks. Every ported family trains: dense (the
flash kernel's training forward and the reference's recompute backward),
MoE (the same attention; the expert dispatch and combine with the
reference's gather-only backward), SSM (the SSD kernel's training forward
and its backward kernel), hybrid (the RG-LRU scan's training forward and
backward kernel, and flash), vision (InternVL2: the dense stack over its
patch prefix and the text) and audio (Whisper: the bidirectional encoder
and the decoder's cross attention, both through flash's training forward).
The batch reaches the loss whole, so a vision model's ``patch_embeds`` and
an encoder-decoder's ``frames`` split with the rows (``batch_specs``,
microbatches). The step's metrics carry the MoE auxiliary loss as ``aux``
beside ``xent``, as the reference's loss returns them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.config import InputShape, MeshConfig, TrainConfig
from repro_torch.core import comm
from repro_torch.core.sharding import (placements_for, shard_slices, spec_for,
                                       tree_shardings, tree_specs)
from repro_torch.core.strategies import PlanConfig
from repro_torch.launch.mesh import TracedMesh, mesh_groups
from repro_torch.models.common import ShardCtx
from repro_torch.nn.optim import OPTIMIZER_SLOTS, get_optimizer

# the families whose full-sequence forward has a backward on the card
TRAINED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the optimizer update's span in a torch.profiler trace
OPTIMIZER_SPAN = "train.optimizer"


def opt_state_dtype(plan: PlanConfig) -> torch.dtype:
    return torch.float32 if plan.opt_state_dtype == "float32" else torch.bfloat16


def init_opt_state(optimizer: str, params: Dict, plan: PlanConfig) -> Dict:
    """Each parameter's optimizer state tuple, zeros in the plan's dtype,
    with the parameter's shape and device."""
    opt = get_optimizer(optimizer)
    dt = opt_state_dtype(plan)
    return {k: opt.init(v, dtype=dt) for k, v in params.items()}


def opt_state_specs(optimizer: str, param_specs: Dict, plan: PlanConfig) -> Dict:
    """Each parameter's optimizer state as meta tensors (its slots, in the
    plan's state dtype)."""
    slots = OPTIMIZER_SLOTS[optimizer]
    dt = opt_state_dtype(plan)
    return {k: tuple(torch.empty(s.shape, dtype=dt, device="meta") for _ in range(slots))
            for k, s in param_specs.items()}


def opt_state_axes(optimizer: str, param_axes: Dict) -> Dict:
    slots = OPTIMIZER_SLOTS[optimizer]
    return {k: tuple(ax for _ in range(slots)) for k, ax in param_axes.items()}


# ---------------------------------------------------------------------------
# batch sharding specs
# ---------------------------------------------------------------------------

BATCH_AXES_BY_RANK = {
    2: ("batch", "seq"),
    3: ("batch", "seq", None),
}


def batch_input_specs(cfg, shape: InputShape, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The global batch of a step (the reference's
    ``launch/dryrun.batch_input_specs``), as meta tensors: decode
    ``tokens`` (B, 1); otherwise ``tokens`` (B, S), a train step's
    ``targets``, a vision model's ``patch_embeds`` and an
    encoder-decoder's ``frames``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device="meta")
    if shape.kind == "decode":
        return {"tokens": torch.empty((b, 1), **i32)}
    specs = {"tokens": torch.empty((b, s), **i32)}
    if shape.kind == "train":
        specs["targets"] = torch.empty((b, s), **i32)
    if cfg.frontend == "vision":
        specs["patch_embeds"] = torch.empty((b, cfg.num_frontend_tokens, cfg.d_model),
                                            dtype=dtype, device="meta")
    if cfg.is_encdec:
        specs["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                                      device="meta")
    return specs


def batch_specs(batch_like: Dict, plan: PlanConfig, mesh_cfg: MeshConfig) -> Dict:
    out = {}
    for k, v in batch_like.items():
        axes = BATCH_AXES_BY_RANK.get(len(v.shape), ("batch",) + (None,) * (len(v.shape) - 1))
        if k in ("frames", "patch_embeds"):
            axes = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = spec_for(tuple(v.shape), axes, plan, mesh_cfg, "act")
    return out


def train_shardings(model, plan: PlanConfig, mesh_cfg: MeshConfig, train: TrainConfig,
                    device_mesh=None):
    """``(param specs, param spec tuples, placements)`` and the same for the
    optimizer state: meta tensors, ``core/sharding.py`` specs, and on a
    ``device_mesh`` each spec's ``NamedSharding`` (None without one)."""
    pspecs = model.param_specs()
    paxes = model.param_axes()
    p_part = tree_specs(pspecs, paxes, plan, mesh_cfg, "param")
    o_specs = opt_state_specs(train.optimizer, pspecs, plan)
    o_axes = opt_state_axes(train.optimizer, paxes)
    o_part = {k: tuple(spec_for(tuple(s.shape), a, plan, mesh_cfg, "opt")
                       for s, a in zip(o_specs[k], o_axes[k]))
              for k in o_specs}

    def as_shard(tree):
        return None if device_mesh is None else tree_shardings(device_mesh, tree)

    return (pspecs, p_part, as_shard(p_part)), (o_specs, o_part, as_shard(o_part))


# ---------------------------------------------------------------------------
# this rank's blocks
# ---------------------------------------------------------------------------


def _coordinate(mesh_cfg: MeshConfig, rank: int) -> tuple:
    """The mesh coordinate of ``rank`` (ranks fill the mesh row-major)."""
    return tuple(int(c) for c in np.unravel_index(rank, mesh_cfg.shape))


def local_block(full: torch.Tensor, spec, mesh_cfg: MeshConfig, rank: int) -> torch.Tensor:
    """The block of ``full`` that ``rank`` holds under ``spec`` (a view)."""
    return full[shard_slices(full.shape, placements_for(spec, mesh_cfg.axis_names),
                             mesh_cfg.shape, _coordinate(mesh_cfg, rank))]


def shard_params(params: Dict, model, plan: PlanConfig, mesh_cfg: MeshConfig,
                 rank: Optional[int] = None) -> Dict:
    """This rank's copy of each of ``params`` (full tensors, the same on
    every rank) under the plan's parameter specs: its block where the spec
    shards, the whole tensor elsewhere."""
    rank = dist.get_rank() if rank is None else rank
    specs = tree_specs(model.param_specs(), model.param_axes(), plan, mesh_cfg, "param")
    return {k: local_block(p, specs[k], mesh_cfg, rank).clone() for k, p in params.items()}


def _split_dims(spec) -> Dict[str, int]:
    """Each mesh axis ``spec`` splits a dim over -> that dim."""
    out = {}
    for i, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[axis] = i
    return out


def _check_trainable(model, mesh_cfg: MeshConfig) -> None:
    cfg = model.cfg
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family has no training step in the port; "
            f"it trains {', '.join(TRAINED_FAMILIES)} models")
    if mesh_cfg.num_devices > 1 and mesh_cfg.axis_names not in (
            ("data",), ("data", "model"), ("pod", "data", "model")):
        raise NotImplementedError(
            f"mesh axes {mesh_cfg.axis_names}: the port trains over ('data',), ('data', "
            f"'model') and ('pod', 'data', 'model') meshes")


class _Ranks:
    """What a step over the ranks of a ``("data",)`` or ``("data",
    "model")`` mesh needs: this rank's rows of the global batch, its loss
    weight, each parameter's split dims, the data and model groups, and
    the collectives around the backward pass."""

    def __init__(self, model, plan: PlanConfig, mesh_cfg: MeshConfig,
                 traced: Optional[TracedMesh] = None):
        self.plan, self.mesh_cfg, self.traced = plan, mesh_cfg, traced
        self.world = mesh_cfg.num_devices
        self.dims = data_split_dims(model, plan, mesh_cfg)
        # the model ranks of a data group see the same rows (batch_specs
        # splits only a batch that divides evenly over the data axes;
        # otherwise every rank takes every row), so each rank's share of the
        # global token count is 1 / data ranks
        self.weight = 1.0 / mesh_cfg.data_parallelism
        # work on the model axis (tensor, sequence and expert parallelism)
        self.on_model = mesh_cfg.model_parallelism > 1 and (plan.tensor_parallel
                                                            or plan.expert_parallel)
        self.groups = self.data_group = self.model_group = None

    @property
    def rank(self) -> int:
        return self.traced.rank if self.traced is not None else dist.get_rank()

    @property
    def world_group(self):
        """The group of every rank of the mesh (None: the default one)."""
        return None if self.traced is None else self.traced.group(self.mesh_cfg.axis_names)

    def check(self) -> None:
        """The step runs inside a process group of one rank a device (or on
        a traced mesh)."""
        if self.traced is not None:
            return
        if not dist.is_initialized():
            raise RuntimeError(f"a train step over {self.world} devices runs inside an "
                               f"initialised process group (launch/mesh.init_distributed)")
        if dist.get_world_size() != self.world:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks, the mesh "
                             f"{self.world} devices")

    def ctx(self, fsdp: bool, device) -> ShardCtx:
        """The forward's :class:`ShardCtx` on this rank, with the mesh's
        data and model groups (made at the step's first call)."""
        if self.groups is None:
            self.groups = mesh_groups(self.traced or self.mesh_cfg, device)
        self.data_group, self.model_group = self.groups
        return ShardCtx(self.plan, self.model_group if self.on_model else None,
                        gather=self.gather if fsdp else None,
                        ranks_mean=self.mean if self.mesh_cfg.data_parallelism > 1 else None)

    def rows(self, batch: Dict) -> Dict:
        """This rank's rows of the global batch."""
        specs = batch_specs(batch, self.plan, self.mesh_cfg)
        return {k: local_block(v, specs[k], self.mesh_cfg, self.rank)
                for k, v in batch.items()}

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``ShardCtx.ranks_mean``: the mean over the data ranks."""
        return comm.AllReduceMean.apply(t, self.data_group)

    def gather(self, prefix: str, tensors: Dict) -> Dict:
        """``ShardCtx.gather`` (FSDP): each tensor whole over the data axis
        from this rank's block of it."""
        return gather_over_data(self.dims, self.data_group, prefix, tensors)

    def reduce_whole(self, grads: Dict) -> None:
        """Sums over the data ranks the gradients of the parameters every
        data rank holds whole (all of them under DP)."""
        for k, g in grads.items():
            if "data" not in self.dims[k]:
                for gi in (g if isinstance(g, list) else [g]):
                    comm.all_reduce_(gi, group=self.data_group)

    @property
    def any_split(self) -> bool:
        """Whether the rules split any parameter over any mesh axis."""
        return any(self.dims.values())

    def counted(self, grads: Dict) -> List[bool]:
        """Which of the flat gradients this rank adds to the global norm:
        each gradient exactly once over the mesh, on the first rank of every
        mesh axis its spec does not split (a gradient is the same on every
        rank of such an axis)."""
        coord = dict(zip(self.mesh_cfg.axis_names, _coordinate(self.mesh_cfg, self.rank)))
        return [all(c == 0 for axis, c in coord.items() if axis not in self.dims[k])
                for k, g in grads.items() for _ in (g if isinstance(g, list) else [g])]


def data_split_dims(model, plan: PlanConfig, mesh_cfg: MeshConfig) -> Dict[str, Dict[str, int]]:
    """Each parameter's split dim per mesh axis in the tensors a layer is
    handed (a stacked key's per-layer tensors lose the layer dim, which
    never splits)."""
    stacked = tuple(prefix for prefix, _n, _b in model._stacks())
    specs = tree_specs(model.param_specs(), model.param_axes(), plan, mesh_cfg, "param")
    return {k: {axis: d - 1 if k.startswith(stacked) else d
                for axis, d in _split_dims(spec).items()}
            for k, spec in specs.items()}


def gather_over_data(dims: Dict[str, Dict[str, int]], group, prefix: str,
                     tensors: Dict) -> Dict:
    """FSDP's gather: each of ``tensors`` (keys under ``prefix``) whole over
    the data axes from this rank's block of it (the gradient
    reduce-scattered)."""
    out = {}
    for name, t in tensors.items():
        d = dims[prefix + name].get("data")
        out[name] = t if d is None else comm.AllGatherDim.apply(t, d, group)
    return out


def make_train_step(model, plan: PlanConfig, mesh_cfg: MeshConfig,
                    train: TrainConfig) -> Callable:
    """``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``; ``params`` and ``opt_state`` are updated in place and
    returned. ``metrics`` holds 0-d tensors: ``xent``, ``aux``, ``loss``
    and ``grad_norm`` (0 without clipping). ``mesh_cfg`` may be a
    ``TracedMesh``: the step of its rank, over trace groups."""
    traced = mesh_cfg if isinstance(mesh_cfg, TracedMesh) else None
    mesh_cfg = traced.cfg if traced is not None else mesh_cfg
    _check_trainable(model, mesh_cfg)
    opt = get_optimizer(train.optimizer)
    stacked = tuple(prefix for prefix, _n, _b in model._stacks())
    m = plan.microbatches
    ranks = _Ranks(model, plan, mesh_cfg, traced) if mesh_cfg.num_devices > 1 else None
    shard_ctx = None

    def backward(loss: torch.Tensor) -> None:
        """The loss's backward pass; over ranks, of its share of the global
        token mean."""
        (loss if ranks is None else loss * ranks.weight).backward()

    def leaves(params: Dict) -> Dict:
        """Leaves sharing the parameters' storage: a layer stack becomes a
        list of per-layer leaves."""
        return {k: ([t.requires_grad_() for t in p.detach().unbind(0)]
                    if k.startswith(stacked) else p.detach().requires_grad_())
                for k, p in params.items()}

    def take_grads(tree: Dict) -> Dict:
        """Each leaf's gradient (zeros where the loss does not reach it),
        detached from the leaves, which are reset."""
        def take(leaf):
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            leaf.grad = None
            return g
        return {k: [take(t) for t in v] if isinstance(v, list) else take(v)
                for k, v in tree.items()}

    def rows(batch: Dict) -> Dict:
        """This rank's rows of a (micro)batch of the global batch."""
        return batch if ranks is None else ranks.rows(batch)

    def compute_grads(params, batch):
        """The loss, its metrics and the gradients of the global ``batch``:
        each microbatch is a run of the global batch's rows, of which each
        rank takes its own (as the reference splits its global batch into
        microbatches before its data shards route each one's tokens)."""
        tree = leaves(params)
        if m <= 1:
            loss, metrics = model.loss(tree, rows(batch), remat=plan.remat, ctx=shard_ctx)
            backward(loss)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, take_grads(tree)
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} microbatches")
        bm = b // m
        acc = None
        loss_sum = torch.zeros((), device=batch["tokens"].device)
        for i in range(m):
            micro = rows({k: v[i * bm:(i + 1) * bm] for k, v in batch.items()})
            loss, _ = model.loss(tree, micro, remat=plan.remat, ctx=shard_ctx)
            backward(loss)
            g = _flat(take_grads(tree))
            acc = ([x.float() / m for x in g] if acc is None
                   else [a + x.float() / m for a, x in zip(acc, g)])
            loss_sum = loss_sum + loss.detach() / m
        grads = _unflat(tree, [a.to(leaf.dtype) for a, leaf in zip(acc, _flat(tree))])
        return loss_sum, {"xent": loss_sum, "aux": torch.zeros_like(loss_sum)}, grads

    @torch.no_grad()
    def update(params: Dict, grads: Dict, opt_state: Dict, step: int) -> None:
        t = torch.tensor(step + 1, dtype=torch.int32)
        for k, p in params.items():
            g, state = grads[k], opt_state[k]
            if isinstance(g, list):
                per_layer = (zip(*(s.unbind(0) for s in state)) if state
                             else [()] * len(g))
                pieces = zip(p.unbind(0), g, per_layer)
            else:
                pieces = [(p, g, state)]
            for pi, gi, si in pieces:
                new_p, new_s = opt.update(pi, gi, tuple(si), lr=train.learning_rate, t=t)
                pi.copy_(new_p)
                for dst, src in zip(si, new_s):
                    dst.copy_(src)

    def train_step(params: Dict, opt_state: Dict, batch: Dict, step: int):
        nonlocal shard_ctx
        if ranks is None:
            loss, metrics, grads = compute_grads(params, batch)
        else:
            ranks.check()
            shard_ctx = ranks.ctx(plan.params_over_data, batch["tokens"].device)
            loss, metrics, grads = compute_grads(params, batch)
            with torch.no_grad():
                ranks.reduce_whole(grads)
                # the global token mean of the loss and its parts (the same
                # on every model rank of a data group)
                parts = torch.stack([loss, metrics["xent"], metrics["aux"]]).float()
                comm.all_reduce_(parts.mul_(ranks.weight), group=ranks.data_group)
                loss, metrics = parts[0], {"xent": parts[1], "aux": parts[2]}
        if train.grad_clip:
            with torch.no_grad():
                if ranks is None or not ranks.any_split:   # every gradient whole on every rank
                    gnorm = global_norm(_flat(grads))
                else:
                    gnorm = global_norm(_flat(grads), ranks.counted(grads), ranks.world_group)
                scale = torch.clamp(train.grad_clip / (gnorm + 1e-9), max=1.0)
                torch._foreach_mul_(_flat(grads), scale)
        else:
            gnorm = torch.zeros((), device=loss.device)
        with record_function(OPTIMIZER_SPAN):
            update(params, grads, opt_state, step)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def global_norm(grads: List[torch.Tensor], counted: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """The gradients' global L2 norm: the square root of the float32 sum of
    their squares, as the reference's ``clip_by_global_norm`` takes it, over
    the gradients divided by a power of two at or above their largest
    magnitude. The power of two makes each division exact, so where the
    unscaled float32 sum (the reference's arithmetic) is finite the two
    agree to the last bit (short of squares that underflow); where an entry
    passes ~1.8e19 the unscaled squares overflow to inf and this one stays
    finite. Full-depth Yi-6B at
    the reference's random initialisation has such entries: its residual
    branches grow the gradient several times a layer. ``counted`` (FSDP)
    makes it the norm over the ranks: the power of two comes from the
    largest entry over the ranks, and the squares of the gradients
    ``counted`` marks are summed over the ranks of ``group`` (the default
    group where None); without it the norm is this rank's own."""
    amax = torch.stack([g.detach().abs().amax().float() for g in grads]).amax()
    if counted is not None:
        comm.all_reduce_(amax, "max", group)
    _mant, exp = torch.frexp(amax)
    scale = torch.where(amax > 0, torch.ldexp(torch.ones_like(amax), exp), 1.0)
    total = sum((((g.float() / scale) ** 2).sum()
                 for g, c in zip(grads, counted or [True] * len(grads)) if c),
                torch.zeros((), device=amax.device))
    if counted is not None:
        comm.all_reduce_(total, group=group)
    return torch.sqrt(total) * scale


def _flat(tree: Dict) -> List[torch.Tensor]:
    return [t for v in tree.values() for t in (v if isinstance(v, list) else [v])]


def _unflat(like: Dict, flat: List[torch.Tensor]) -> Dict:
    it = iter(flat)
    return {k: [next(it) for _ in v] if isinstance(v, list) else next(it)
            for k, v in like.items()}
