"""Training runtime: plan-driven train-step construction (port of the
single-device part of ``repro/runtime/train_loop.py``).

``make_train_step`` turns (model, plan, mesh, TrainConfig) into a step
function whose gradient accumulation, optimizer-state dtype and per-layer
rematerialisation all come from the *plan*; the model code never sees it.
This is the runtime half of the paper's compiler: SystemML's generated
execution plan, here run eagerly on one card.

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

Every ported family trains: dense (the flash kernel's training forward and
the reference's recompute backward), SSM (the SSD kernel's training
forward and its backward kernel) and hybrid (the RG-LRU scan's training
forward and backward kernel, and flash). Not ported yet, with the sharding
rules and parfor (ROADMAP Queue A 14b): ``batch_specs``,
``opt_state_specs``/``opt_state_axes`` and ``train_shardings``, so a step
runs on one device.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch.profiler import record_function

from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.core.strategies import PlanConfig
from repro_torch.nn.optim import get_optimizer

# the families whose full-sequence forward has a backward on the card
TRAINED_FAMILIES = ("dense", "ssm", "hybrid")
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


def _check_trainable(model, mesh_cfg: MeshConfig) -> None:
    cfg = model.cfg
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family has no training step in the port; "
            f"it trains {', '.join(TRAINED_FAMILIES)} models")
    if mesh_cfg.num_devices != 1:
        raise NotImplementedError(
            f"a train step over {mesh_cfg.num_devices} devices needs the port's sharding "
            f"rules and parfor (core/sharding.py, core/parfor.py), ROADMAP Queue A 14b")


def make_train_step(model, plan: PlanConfig, mesh_cfg: MeshConfig,
                    train: TrainConfig) -> Callable:
    """``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``; ``params`` and ``opt_state`` are updated in place and
    returned. ``metrics`` holds 0-d tensors: ``xent``, ``aux``, ``loss``
    and ``grad_norm`` (0 without clipping)."""
    _check_trainable(model, mesh_cfg)
    opt = get_optimizer(train.optimizer)
    stacked = tuple(prefix for prefix, _n, _b in model._stacks())
    m = plan.microbatches

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

    def compute_grads(params, batch):
        tree = leaves(params)
        if m <= 1:
            loss, metrics = model.loss(tree, batch, remat=plan.remat)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, take_grads(tree)
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} microbatches")
        bm = b // m
        acc = None
        loss_sum = torch.zeros((), device=batch["tokens"].device)
        for i in range(m):
            micro = {k: v[i * bm:(i + 1) * bm] for k, v in batch.items()}
            loss, _ = model.loss(tree, micro, remat=plan.remat)
            loss.backward()
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
        loss, metrics, grads = compute_grads(params, batch)
        if train.grad_clip:
            with torch.no_grad():
                gnorm = global_norm(_flat(grads))
                scale = torch.clamp(train.grad_clip / (gnorm + 1e-9), max=1.0)
                torch._foreach_mul_(_flat(grads), scale)
        else:
            gnorm = torch.zeros((), device=loss.device)
        with record_function(OPTIMIZER_SPAN):
            update(params, grads, opt_state, step)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The gradients' global L2 norm: the square root of the float32 sum of
    their squares, as the reference's ``clip_by_global_norm`` takes it, over
    the gradients divided by a power of two at or above their largest
    magnitude. The power of two makes each division exact, so where the
    unscaled float32 sum (the reference's arithmetic) is finite the two
    agree to the last bit (short of squares that underflow); where an entry
    passes ~1.8e19 the unscaled squares overflow to inf and this one stays
    finite. Full-depth Yi-6B at
    the reference's random initialisation has such entries: its residual
    branches grow the gradient several times a layer."""
    amax = torch.stack([g.detach().abs().amax().float() for g in grads]).amax()
    _mant, exp = torch.frexp(amax)
    scale = torch.where(amax > 0, torch.ldexp(torch.ones_like(amax), exp), 1.0)
    total = sum(((g.float() / scale) ** 2).sum() for g in grads)
    return torch.sqrt(total) * scale


def _flat(tree: Dict) -> List[torch.Tensor]:
    return [t for v in tree.values() for t in (v if isinstance(v, list) else [v])]


def _unflat(like: Dict, flat: List[torch.Tensor]) -> Dict:
    it = iter(flat)
    return {k: [next(it) for _ in v] if isinstance(v, list) else next(it)
            for k, v in like.items()}
