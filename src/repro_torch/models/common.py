"""Shared model substrate: param specs, RMSNorm, RoPE, SwiGLU, the training
loss (``softmax_xent_logits``), the causal depthwise convolution of the SSM
block, and :class:`ShardCtx`.

Port of ``repro/models/common.py``. Parameters travel as flat dicts of
tensors keyed exactly as the reference's. The reference's ``ShardCtx``
places sharding constraints and leaves the collectives to GSPMD; the
port's :class:`ShardCtx` holds what a train step's forward needs over the
ranks of a mesh and writes the collectives out: the FSDP parameter gather
and the MoE statistics' mean over the data ranks, and over a model axis
the Megatron region boundaries (``enter``/``leave``), the gradient sum of a
tensor every model rank holds whole (``whole``), the vocab-parallel
cross-entropy (:func:`softmax_xent_vocab`) and the RMS norm over a width
split across the ranks (:func:`rms_norm_sharded`). Serving under a model
axis uses the same boundaries without autograd, plus the merge of partial
attention over a decode cache whose sequence is split
(:meth:`ShardCtx.merge_attention`) and, under context-parallel prefill,
the residual stream as the rank's block of the prompt.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import comm


@dataclasses.dataclass
class ShardCtx:
    """How a step's forward runs over the ranks of a mesh, under ``plan``.
    Without a model group every boundary below is the identity, so one
    block path serves one device and a model axis.

    ``gather`` (FSDP) turns a layer's parameter blocks into the tensors the
    model axis leaves (``Model.apply``); ``ranks_mean`` is the mean over the
    data ranks (the MoE load-balance statistics). ``model_group`` is the
    ranks of this rank's model axis where the plan puts work on it (tensor
    or expert parallelism; None otherwise: every block then runs whole on
    every rank). Over a model axis every activation is, on each rank, one
    of three things: whole and the same on every model rank (the residual
    stream; under ``plan.seq_shard_checkpoints`` its sequence shard
    instead), a shard of a product split over the ranks (a block's heads,
    ffn columns, experts, SSM heads, RG-LRU channels, vocab), or a partial
    sum. :meth:`enter` and :meth:`leave` are the boundaries between them
    (Megatron's f and g; under sequence parallelism the all-gather and the
    reduce-scatter along the sequence): between them each rank's gradient
    of an activation is its part of the whole gradient, so a parameter
    held whole on every rank and used there enters through :meth:`whole`,
    which sums its gradient over the model group. Model-split parameters
    arrive as the rank's blocks (``core/sharding.py``'s rules); a block's
    code tells a block from a whole tensor by its shape.

    Serving: ``cache_group`` is the group over which a decode cache's
    sequence is split (``plan.cache_seq_axes``: the model group, or every
    idle axis at long context; None where the cache is not split along its
    sequence), over which :meth:`merge_attention` merges each rank's
    partial attention; ``mesh`` (a ``MeshConfig``) gives the serving cache
    its block shapes. Under context-parallel prefill (:attr:`cp`,
    ``plan.seq_axes`` holding ``"model"``) the residual stream is the
    rank's block of the prompt, as under sequence parallelism. Either group
    may be a process group or a ``comm.TraceGroup``."""

    plan: Any = None
    model_group: Any = None
    gather: Optional[Callable] = None
    ranks_mean: Optional[Callable] = None
    cache_group: Any = None
    mesh: Any = None

    @property
    def tp(self) -> bool:
        """Whether work is split over a model axis."""
        return self.model_group is not None

    @property
    def cp(self) -> bool:
        """Context-parallel prefill: the prompt's sequence over the model
        axis."""
        return self.tp and "model" in tuple(self.plan.seq_axes)

    @property
    def sp(self) -> bool:
        """Sequence parallelism: the residual stream (and every remat
        checkpoint) is this rank's sequence shard (also under
        context-parallel prefill)."""
        return self.tp and (bool(self.plan.seq_shard_checkpoints) or self.cp)

    @property
    def mp(self) -> int:
        return comm.world_size(self.model_group) if self.tp else 1

    @property
    def mrank(self) -> int:
        return comm.rank_in(self.model_group) if self.tp else 0

    # region boundaries -------------------------------------------------
    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """The residual stream (B, S, D) entering per-shard work: whole
        forward, its gradient summed (under SP the shards gathered along
        the sequence, the gradient reduce-scattered)."""
        if not self.tp:
            return h
        if self.sp:
            return comm.AllGatherDim.apply(h, 1, self.model_group)
        return comm.CopyToGroup.apply(h, self.model_group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """Partial sums (B, S, D) leaving for the residual stream: summed
        over the ranks (under SP reduce-scattered to this rank's sequence
        shard)."""
        if not self.tp:
            return y
        if self.sp:
            return comm.ReduceScatterDim.apply(y, 1, self.model_group)
        return comm.ReduceFromGroup.apply(y, self.model_group)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor every model rank holds whole, entering per-shard work."""
        return comm.CopyToGroup.apply(t, self.model_group) if self.tp else t

    def gain(self, g: torch.Tensor) -> torch.Tensor:
        """A norm's gain on the residual stream: under SP each rank norms
        its own positions, so the gain's gradient is summed."""
        return self.whole(g) if self.sp else g

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n``: equal blocks where ``n``
        splits, else blocks of ``ceil(n / mp)`` (the last ones shorter)."""
        step = -(-n // self.mp)
        return min(n, self.mrank * step), min(n, (self.mrank + 1) * step)

    def part(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's part of dim ``dim`` (``n`` long whole) of a
        parameter: the block itself where the rules split it, else this
        rank's :meth:`span` of the whole tensor, whose gradient is summed."""
        if t.shape[dim] != n or self.mp == 1:
            return t
        lo, hi = self.span(n)
        return self.whole(t).narrow(dim, lo, hi - lo)

    def joined(self, t: torch.Tensor, full: Tuple[int, ...]) -> torch.Tensor:
        """A parameter whole (``full`` its whole shape) for per-shard work:
        all-gathered along the dim the rules split (the gradient
        reduce-scattered), else :meth:`whole`."""
        for dim, (a, n) in enumerate(zip(t.shape, full)):
            if a != n:
                return comm.AllGatherDim.apply(t, dim, self.model_group)
        return self.whole(t)

    def whole_dim(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """A serving activation whole along ``dim`` (``n`` long): this
        rank's block of it all-gathered over the model group, or ``t``
        where it is whole already (no autograd)."""
        return t if t.shape[dim] == n else comm.all_gather_dim(t, dim, self.model_group)

    # serving ------------------------------------------------------------
    def cache_span(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` cache slots split evenly over
        :attr:`cache_group` (all of them without one)."""
        if self.cache_group is None:
            return 0, n
        step = n // comm.world_size(self.cache_group)
        lo = comm.rank_in(self.cache_group) * step
        return lo, lo + step

    def merge_attention(self, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Attention over a cache whose slots are split over
        :attr:`cache_group`, from this rank's part: ``s`` (B, H, K) float32
        scores over its slots (masked to ``NEG_INF``), ``v`` (B, K, H, D)
        its values. The row max is all-reduced (max) first; then each
        rank's numerators and denominators at that max are summed in one
        all-reduce. Returns (B, H, D) float32."""
        m = comm.all_reduce_(s.amax(dim=-1), "max", self.cache_group)      # (B, H)
        p = torch.exp(s - m[..., None])
        num = torch.einsum("bhk,bkhd->bhd", p, v.float())
        both = comm.all_reduce_(torch.cat([num, p.sum(-1, keepdim=True)], dim=-1),
                                group=self.cache_group)
        return both[..., :-1] / both[..., -1:]

    def last_rows(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Each row's hidden state at its position ``idx`` (B,) of the whole
        sequence, (B, D): under sequence parallelism the rank holding the
        position gives it and the others zeros, summed over the model
        group."""
        b = x.shape[0]
        rows = torch.arange(b, device=x.device)
        if not self.sp:
            return x[rows, idx]
        s = x.shape[1]
        local = idx - self.seq_offset(s)
        own = (local >= 0) & (local < s)
        xl = x[rows, local.clamp(0, s - 1)] * own[:, None].to(x.dtype)
        return comm.all_reduce_(xl.contiguous(), group=self.model_group)

    # work every model rank repeats in full -----------------------------
    def rep_in(self, h: torch.Tensor) -> torch.Tensor:
        """The residual stream entering work that every model rank does
        whole (under SP the sequence gathered; each rank's gradient is the
        whole one)."""
        return comm.AllGatherSlice.apply(h, 1, self.model_group) if self.sp else h

    def rep_out(self, y: torch.Tensor) -> torch.Tensor:
        """The output of such work returning to the residual stream."""
        return comm.SliceDim.apply(y, 1, self.model_group) if self.sp else y

    def rep_param(self, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """A parameter the rules split along ``dim`` made whole for work
        every model rank repeats (the backward keeps this rank's block)."""
        if t.shape[dim] != n:
            return comm.AllGatherSlice.apply(t, dim, self.model_group)
        return t

    # sequence ----------------------------------------------------------
    def seq_len(self, local: int) -> int:
        """The whole sequence of a residual stream ``local`` positions long."""
        return local * self.mp if self.sp else local

    def seq_offset(self, local: int) -> int:
        """The first position of this rank's sequence shard."""
        return self.mrank * local if self.sp else 0


class SpecBuilder:
    """Collects (shape, axes, init) triples and materializes initialized
    tensors with the reference's shapes, keys and scales. The numbers differ
    from the reference's (``torch.Generator`` is not ``jax.random``); tests
    that need both packages on one set of weights convert them with
    ``repro_torch.interop``."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        self.dtype = dtype
        self.entries: Dict[str, Any] = {}

    def add(self, name: str, shape: Tuple[int, ...],
            axes: Tuple[Optional[str], ...], init: str = "normal",
            scale: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} and axes {axes} differ in rank")
        self.entries[name] = (tuple(shape), tuple(axes), init, scale,
                              dtype or self.dtype)
        return self

    def shapes(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        return {k: (sh, dt) for k, (sh, _ax, _ini, _sc, dt) in self.entries.items()}

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Initialize every entry on ``generator.device``, in entry order."""
        dev = generator.device
        out = {}
        for k, (sh, _ax, ini, sc, dt) in self.entries.items():
            if ini == "zeros":
                out[k] = torch.zeros(sh, dtype=dt, device=dev)
            elif ini == "ones":
                out[k] = torch.ones(sh, dtype=dt, device=dev)
            elif ini == "ssm_a":
                # A_log init: log of uniform [1, 16] (mamba2 convention)
                u = torch.rand(sh, generator=generator, dtype=torch.float32,
                               device=dev)
                out[k] = torch.log(1.0 + 15.0 * u).to(dt)
            else:
                fan_in = sh[-2] if len(sh) >= 2 else sh[-1]
                s = sc if sc is not None else 1.0 / math.sqrt(max(1, fan_in))
                w = torch.randn(sh, generator=generator, dtype=torch.float32,
                                device=dev)
                out[k] = w.mul_(s).to(dt)
                # the float32 draw goes before the next one is made: a
                # stacked expert tensor's is 24 GiB at 8 Qwen3-MoE layers
                del w
        return out


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Fixed ``eps`` (not ``cfg.norm_eps``) and the cast back to ``x.dtype``
    *before* the ``gamma`` product, as the reference does."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split ("rotate-half") rotary embedding, angles in float32.
    x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, cast to ``x.dtype`` before the product with ``u``."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, w_down)


def softmax_xent_logits(logits: torch.Tensor, targets: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., V) -> the float32 mean cross-entropy of ``targets``
    (...), over the positions ``mask`` keeps where it is given (at least
    one, as the reference divides by ``max(sum(mask), 1)``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def rms_norm_sharded(x: torch.Tensor, gamma: torch.Tensor, n: int, group,
                     eps: float = 1e-5) -> torch.Tensor:
    """:func:`rms_norm` over a feature dim split across ``group``'s ranks
    (``x`` and ``gamma`` this rank's ``n / world`` of them): the mean square
    over all ``n`` features is the sum of the ranks' sums of squares, summed
    again in the backward pass (each rank's gradient of it is a part)."""
    xf = x.float()
    ss = torch.sum(xf * xf, dim=-1, keepdim=True)
    ss = comm.CopyToGroup.apply(comm.ReduceFromGroup.apply(ss, group), group)
    return (xf * torch.rsqrt(ss / n + eps)).to(x.dtype) * gamma


class _VocabXent(torch.autograd.Function):
    """The float32 mean cross-entropy over vocab blocks split across the
    ranks: each rank holds the logits of its block ``[lo, lo + V_r)``. The
    log-sum-exp takes the max over the ranks (an all-reduce max) and the
    sum of exponentials, the target logit comes from the rank that holds
    it (one all-reduce of both); every rank returns the same loss. The
    backward is this block's softmax minus its one-hot, over the positions,
    with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        vr = logits.shape[-1]
        # the max and the target logit are exact in the logits' own dtype
        m = comm.all_reduce_(logits.amax(dim=-1).float(), "max", group)
        ids = targets.long() - lo
        own = (ids >= 0) & (ids < vr)
        ids = ids.clamp(0, vr - 1)
        tgt = torch.gather(logits, -1, ids[..., None])[..., 0].float() * own
        # one float32 copy of the block, exponentiated in place: no further
        # (B, S, V_r) float32 temporary
        sumexp = logits.to(torch.float32, copy=True).sub_(m[..., None]).exp_().sum(-1)
        both = comm.all_reduce_(torch.stack([sumexp, tgt]), group=group)
        lse = m + torch.log(both[0])
        ctx.save_for_backward(logits, lse, ids, own)
        return (lse - both[1]).mean()

    @staticmethod
    def backward(ctx, grad):
        logits, lse, ids, own = ctx.saved_tensors
        p = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        p.scatter_add_(-1, ids[..., None], -own[..., None].float())
        return p.mul_(grad / lse.numel()).to(logits.dtype), None, None, None


def softmax_xent_vocab(logits: torch.Tensor, targets: torch.Tensor, lo: int,
                       group) -> torch.Tensor:
    """:func:`softmax_xent_logits` (no mask) of logits whose vocab dim is
    split over ``group``: ``logits`` (..., V_r) this rank's block, which
    starts at ``lo``."""
    return _VocabXent.apply(logits, targets, lo, group)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution. x (B, S, C), w (W, C); the sum of the
    W shifted products is taken in float32 and rounded to ``x.dtype`` once.
    With ``state`` (B, W-1, C) — the last W-1 inputs before x — it is the
    single-step decode form (S == 1) and returns ``(y, new_state)``."""
    wd = w.shape[0]
    wf = w.float()
    if state is not None:
        full = torch.cat([state, x], dim=1)                       # (B, W, C)
        y = torch.einsum("bwc,wc->bc", full[:, -wd:].float(), wf)[:, None, :]
        return y.to(x.dtype), full[:, 1:]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, wd - 1, 0))                              # zeros before t=0
    y = xp[:, 0:s].float() * wf[0]
    for i in range(1, wd):
        y += xp[:, i:i + s].float() * wf[i]
    return y.to(x.dtype)
