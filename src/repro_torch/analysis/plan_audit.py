"""Plan auditor: static analysis of the FX graph of every compiled serving
step (port of ``repro/analysis/plan_audit.py``, which walks jaxprs).

For every (arch, dtype, kind, bucket) cell of the audit matrix this pass
traces the exact step ``PlanServer`` installs (``serve_loop.plan_step``:
``make_decode_step`` / ``make_prefill`` over the port's
:class:`PlanCompiler` plan for that cell) into an aten graph with
``make_fx(tracing_mode="fake")``: params, cache, tokens, positions and
page table are fake tensors on the cell's device, so nothing is allocated
and no card is needed. On ``"cuda"`` (the
default) the graph is the card's own: each hand-written kernel is a
``torch.library`` custom op (``repro_torch::<name>``) and appears as one
node, where a CPU trace would hold the plain versions. The pass walks the
graph for:

- **dtype-promotion leaks** (``dtype-leak``): in a reduced-precision plan,
  (a) float32/float64 tensor constants (``get_attr``) baked into the step,
  (b) an aten node whose output is float32/float64 from a bfloat16 input
  with no explicit ``_to_copy`` in between (PyTorch promotes inside the op,
  where JAX would have inserted a ``convert_element_type``), and (c) logits
  or a cache leaf that leave the step wider than they came in. Deliberate
  upcasts (``.float()`` fences) pass all three; kernel nodes are opaque, as
  a ``pallas_call`` is to the reference.
- **host sync / retrace hazards** (``host-sync``, ``dynamic-shape``):
  ``.item()`` / ``.tolist()`` on the traced path (fake tracing raises a
  data-dependent error there, which is reported as this finding), a copy
  from the device to the host, ``aten._local_scalar_dense``; a node whose
  value has a symbolic size, or an op whose output shape depends on data.
- **memory-statistics validation** (``memory-under-estimate``,
  ``memory-uncovered``): a liveness scan over the graph gives a *floor*
  (inputs + outputs, less the cache leaves the step updates in place) and
  a *ceiling* (the reuse-free peak — every node's output its own buffer,
  held to its last use, in-place writes allocating nothing — plus the rest
  of the provisioned pool, plus the same workspace fraction
  ``core/memory.py`` budgets). On a CUDA device both count what
  the card allocates: each tensor in the caching allocator's 512-byte
  blocks, and the ceiling cuBLAS's workspace where a product runs there.
  The plan's estimate must sit inside ``[floor, ceiling]``.
- **decode-kernel selection** (``kernel-choice``): a port of
  :func:`check_kernel_choice`; every decode cell is audited under both
  forced operators and records the operator the plan chose.

Run ``python -m repro_torch.analysis.plan_audit --smoke``: audits the smoke
matrix on fake ``cuda`` (``--device cpu`` traces the CPU path), runs the
planted-violation self-test (a float32 constant and a ``.item()`` in a
bfloat16 decode step must flag, a clean control must not), writes
``build/ANALYSIS_report_torch.json`` and exits non-zero on any clean-tree
finding or self-test miss.
"""

from __future__ import annotations

import argparse
import operator
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException, FakeTensorMode)
from torch.fx import GraphModule, Node
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from repro_torch.analysis import Finding
from repro_torch.analysis.matrix import (DEVICE, PAGE_SIZE, POOL_ARENAS, REPORT_PATH,
                                         SMOKE_ARCHS, SMOKE_BUCKETS, SMOKE_DTYPES,
                                         matrix_meta, merge_report, smoke_cells,
                                         torch_dtype)
from repro_torch.config import SINGLE_DEVICE_MESH, InputShape
from repro_torch.configs import get_config
from repro_torch.core.planner import LONG_CONTEXT_THRESHOLD, PlanCompiler
from repro_torch.core.sharding import block_shape, spec_for, tree_specs
from repro_torch.kernels._build import NAMESPACE
from repro_torch.models.model import build_model
from repro_torch.core import comm
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill, plan_step
from repro_torch.runtime.train_loop import (batch_input_specs, batch_specs, make_train_step,
                                            train_shardings)

WORKSPACE_FRACTION = 0.08  # mirrors core/memory.py's workspace class
# what the card's path allocates beyond the graph's tensors: PyTorch's CUDA
# caching allocator rounds every block up to 512 bytes, and a product that
# goes through cuBLAS (mm, addmm, bmm, baddbmm) holds PyTorch's default
# cuBLAS workspace on sm_90, 32 MiB, allocated from the same allocator
# (chip_smoke.py's analysis phase measures it on the card)
CUDA_ALLOC_ROUND = 512
CUBLAS_WORKSPACE_BYTES = 32 << 20
CUBLAS_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")

LOW_PRECISION = (torch.bfloat16, torch.float16)
WIDE = (torch.float32, torch.float64)
HOST_SYNC_OPS = ("aten::_local_scalar_dense", "aten::item")

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# tracing on fake tensors
# ---------------------------------------------------------------------------


def _index_parts(t: torch.Tensor, index) -> Tuple[torch.Tensor, list]:
    """Basic indexing applied as aten views (select / slice / unsqueeze),
    and the advanced indices left for ``aten.index`` — the order PyTorch's
    own indexing code issues them in. A 0-d integer tensor index is read
    with ``.item()``, as PyTorch reads it (a host sync)."""
    if not isinstance(index, tuple):
        index = (index,)
    consumed = sum(i.dim() if isinstance(i, torch.Tensor) and i.dtype == torch.bool else 1
                   for i in index if i is not None and i is not Ellipsis)
    out, dim, adv = t, 0, []
    for i in index:
        if i is None:
            out = aten.unsqueeze.default(out, dim)
            adv.append(None)
            dim += 1
        elif i is Ellipsis:
            adv += [None] * (t.dim() - consumed)
            dim += t.dim() - consumed
        elif isinstance(i, slice):
            if not (i.start is None and i.stop is None and i.step in (None, 1)):
                out = aten.slice.Tensor(out, dim, i.start, i.stop,
                                        1 if i.step is None else i.step)
            adv.append(None)
            dim += 1
        elif isinstance(i, torch.Tensor) and i.dim() == 0 and i.dtype != torch.bool:
            out = aten.select.int(out, dim, i.item())
        elif isinstance(i, torch.Tensor):
            adv.append(i)
            dim += i.dim() if i.dtype == torch.bool else 1
        else:
            out = aten.select.int(out, dim, i)
    while adv and adv[-1] is None:
        adv.pop()
    return out, adv


class AtenMethods(TorchFunctionMode):
    """Issues the aten ops of the tensor methods that PyTorch binds by hand
    behind a device guard (reading by index, ``contiguous``, ``copy_``):
    the guard needs the CUDA runtime, so on a fake ``cuda`` tensor in a
    build without CUDA they would raise before reaching the tracer. The ops
    recorded are the ones the methods dispatch on the card."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            out, adv = _index_parts(*args)
            return aten.index.Tensor(out, adv) if adv else out
        if func is torch.Tensor.contiguous:
            t = args[0]
            fmt = kwargs.get("memory_format",
                             args[1] if len(args) > 1 else torch.contiguous_format)
            if t.is_contiguous(memory_format=fmt):
                return t
            return aten.clone.default(t, memory_format=fmt)
        if func is torch.Tensor.copy_:
            return aten.copy_.default(*args, **kwargs)
        return func(*args, **kwargs)


@dataclass
class Trace:
    """One traced step. ``gm`` is None when tracing stopped at a host sync
    or a data-dependent shape (``error``). ``args`` and ``out`` are the
    step's inputs and outputs as the traced function saw them (fake
    tensors), so an output that *is* an input leaf is the same object.
    ``collectives`` (a rank's trace on a traced mesh): the calls, bytes and
    traffic by op that ``comm.STATS`` counted over the trace."""

    gm: Optional[GraphModule]
    args: tuple = ()
    out: Any = None
    error: Optional[BaseException] = None
    collectives: Optional[Dict[str, Dict[str, float]]] = None


def trace_step(step: Callable, args: Sequence[Any]) -> Trace:
    """``make_fx(step, tracing_mode="fake")`` over fake ``args``."""
    seen: Dict[str, Any] = {}

    def traced(*a):
        with AtenMethods():
            out = step(*a)
        seen["args"], seen["out"] = a, out
        return out

    try:
        gm = make_fx(traced, tracing_mode="fake")(*args)
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        return Trace(gm=None, error=e)
    return Trace(gm=gm, args=seen["args"], out=seen["out"])


def step_inputs(model, kind: str, batch: int, seq: int, page: int = PAGE_SIZE,
                device: str = DEVICE) -> list:
    """Fake inputs of one step at a cell's shape: ``[params, cache, tokens,
    pos(, tables)]`` for decode (the cache in the paged layout) and
    ``[params, {"tokens", "lengths"}]`` for prefill."""
    with FakeTensorMode():
        params = {k: torch.empty(sh, dtype=dt, device=device)
                  for k, (sh, dt) in model.sb.shapes().items()}
        i32 = dict(dtype=torch.int32, device=device)
        if kind != "decode":
            return [params, {"tokens": torch.empty((batch, seq), **i32),
                             "lengths": torch.empty((batch,), **i32)}]
        ent, n_pages, sc = model.paged_cache_entries(batch, seq, page)
        cache = {k: torch.empty(s, dtype=d, device=device) for k, (s, _a, d) in ent.items()}
        args = [params, cache, torch.empty((batch, 1), **i32), torch.empty((batch,), **i32)]
        if n_pages:
            args.append(torch.empty((batch, -(-sc // page)), **i32))
        return args


def trace_cell(model, plan, kind: str, batch: int, seq: int, page: int = PAGE_SIZE,
               device: str = DEVICE, wrap=None, mesh=None, train=None) -> Trace:
    """Trace one cell's step on fake tensors. ``wrap(step)`` lets the
    self-tests plant violations in the step. With ``mesh`` (a
    ``launch.mesh.TracedMesh``) the step is that rank's under ``plan`` (an
    ``ExecutionPlan``; ``train`` the ``TrainConfig`` of a train step) on
    fake tensors of its blocks (:func:`rank_inputs`), its collectives
    counted over trace groups (``Trace.collectives``): the train step
    (``make_train_step``), the prompt pass (``make_prefill``) or the dense
    decode step (``make_decode_step``), each under the plan's layout, as
    the reference's dry run lowers them."""
    if mesh is not None:
        return trace_rank(model, plan, mesh, train, device, wrap)
    step = plan_step(model, plan, page)
    if wrap is not None:
        step = wrap(step)
    args = step_inputs(model, kind, batch, seq, page, device)
    return trace_step(step, args)


def rank_inputs(model, plan, mesh, train=None, device: str = DEVICE) -> list:
    """Fake inputs of one rank's step of ``plan`` (an ``ExecutionPlan``) on
    the traced ``mesh``, each at this rank's block shape under
    ``core/sharding.py``'s rules: ``[params, opt_state, global batch,
    step]`` for a train step (the step takes its rows itself), ``[params,
    batch block]`` for a prompt pass (its rows, and under context-parallel
    prefill its block of the prompt, with the rows' ``lengths``) and
    ``[params, cache block, tokens block, pos]`` for the dense decode
    step."""
    cfg, config, shape = mesh.cfg, plan.config, plan.shape

    def blocks(specs: Dict, parts: Dict) -> Dict:
        return {k: torch.empty(block_shape(v.shape, parts[k], cfg), dtype=v.dtype, device=device)
                for k, v in specs.items()}

    with FakeTensorMode():
        pspecs = model.param_specs()
        params = blocks(pspecs, tree_specs(pspecs, model.param_axes(), config, cfg, "param"))
        b = shape.global_batch
        if shape.kind == "train":
            _p, (o_specs, o_part, _o) = train_shardings(model, config, cfg, train)
            opt = {k: tuple(torch.empty(block_shape(t.shape, sp, cfg), dtype=t.dtype,
                                        device=device) for t, sp in zip(o_specs[k], o_part[k]))
                   for k in o_specs}
            batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                     for k, v in batch_input_specs(model.cfg, shape, model.dtype).items()}
            return [params, opt, batch, 0]
        if shape.kind == "prefill":
            specs = batch_input_specs(model.cfg, shape, model.dtype)
            specs["lengths"] = torch.empty((b,), dtype=torch.int32, device="meta")
            return [params, blocks(specs, batch_specs(specs, config, cfg))]
        cspecs, caxes = model.cache_specs(b, shape.seq_len)
        cache = blocks(cspecs, tree_specs(cspecs, caxes, config, cfg, "cache"))
        tspec = spec_for((b, 1), ("batch", None), config, cfg, "act")
        tokens = torch.empty(block_shape((b, 1), tspec, cfg), dtype=torch.int32, device=device)
        return [params, cache, tokens, torch.empty((), dtype=torch.int32, device=device)]


def trace_rank(model, plan, mesh, train=None, device: str = DEVICE, wrap=None) -> Trace:
    """:func:`trace_cell` of one rank of a traced mesh."""
    kind = plan.shape.kind
    if kind == "train":
        step = make_train_step(model, plan.config, mesh, train)
    elif kind == "prefill":
        step = make_prefill(model, plan=plan.config, mesh_cfg=mesh, device=device)
    else:
        step = make_decode_step(model, plan=plan.config, mesh_cfg=mesh, device=device)
    if wrap is not None:
        step = wrap(step)
    args = rank_inputs(model, plan, mesh, train, device)
    comm.reset_stats()
    trace = trace_step(step, args)
    trace.collectives = {k: dict(c) for k, c in comm.STATS.items()}
    comm.reset_stats()
    return trace


# ---------------------------------------------------------------------------
# graph walking
# ---------------------------------------------------------------------------


def tensors(v) -> List[torch.Tensor]:
    """The tensor leaves of a node value (a tensor, or a tuple of them)."""
    return [t for t in pytree.tree_leaves(v) if isinstance(t, torch.Tensor)]


def value_bytes(v) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(v))


def alloc_bytes(v) -> int:
    """Bytes the allocator hands out for a node value: on a CUDA device each
    tensor rounded up to the caching allocator's 512-byte blocks."""
    total = 0
    for t in tensors(v):
        nbytes = t.numel() * t.element_size()
        if t.device.type == "cuda":
            nbytes = -(-nbytes // CUDA_ALLOC_ROUND) * CUDA_ALLOC_ROUND
        total += nbytes
    return total


def library_workspace_bytes(gm: GraphModule) -> int:
    """Workspace the libraries behind the graph's nodes hold on the card:
    cuBLAS's, where a product on a CUDA tensor goes through it."""
    for n in iter_calls(gm):
        if op_name(n) in CUBLAS_OPS and any(t.device.type == "cuda"
                                           for t in tensors(node_val(n))):
            return CUBLAS_WORKSPACE_BYTES
    return 0


def node_val(n: Node):
    return n.meta.get("val")


def op_name(n: Node) -> str:
    """``ns::op`` of a call node, without its overload (``""`` for anything
    but a call)."""
    if n.op != "call_function":
        return ""
    if n.target is operator.getitem:
        return "getitem"
    schema = getattr(n.target, "_schema", None)
    return schema.name if schema is not None else str(n.target)


def is_kernel(n: Node) -> bool:
    return op_name(n).startswith(f"{NAMESPACE}::")


def aliases_input(n: Node) -> bool:
    """Whether the node's output aliases its first input (a view, an
    in-place write, or one element of a tuple output) and so allocates
    nothing."""
    if n.op != "call_function":
        return False
    if n.target is operator.getitem:
        return True
    schema = getattr(n.target, "_schema", None)
    return bool(schema and any(r.alias_info is not None for r in schema.returns))


def is_mutation(n: Node) -> bool:
    """Whether the node writes one of its arguments in place."""
    schema = getattr(n.target, "_schema", None) if n.op == "call_function" else None
    return bool(schema and schema.is_mutable)


def alias_roots(gm: GraphModule, views: bool = True) -> Dict[Node, Node]:
    """Each node's storage root: itself, or the root of the input it
    aliases. ``views=False`` gives every view its own buffer (the
    reuse-free convention: only in-place writes and tuple picks alias)."""
    root: Dict[Node, Node] = {}
    for n in gm.graph.nodes:
        src = n.args[0] if n.args and isinstance(n.args[0], Node) else None
        alias = aliases_input(n) if views else (is_mutation(n) or op_name(n) == "getitem")
        root[n] = root[src] if alias and src is not None else n
    return root


def output_nodes(gm: GraphModule) -> List[Node]:
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return [a for a in pytree.tree_leaves(out.args) if isinstance(a, Node)]


def placeholders(gm: GraphModule) -> List[Node]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def iter_calls(gm: GraphModule) -> Iterable[Node]:
    return (n for n in gm.graph.nodes if n.op == "call_function")


# ---------------------------------------------------------------------------
# pass 1: dtype-promotion leaks
# ---------------------------------------------------------------------------


def audit_dtype(trace: Trace, compute_dtype: torch.dtype, where: str) -> List[Finding]:
    """Flag float32 reachable in a reduced-precision plan (see the module
    doc for the three detectors)."""
    if compute_dtype not in LOW_PRECISION or trace.gm is None:
        return []
    gm = trace.gm
    out: List[Finding] = []
    for n in gm.graph.nodes:
        if n.op != "get_attr":
            continue
        c = getattr(gm, n.target, None)
        if isinstance(c, torch.Tensor) and c.dtype in WIDE:
            out.append(Finding(
                rule="dtype-leak", where=where,
                detail=f"{str(c.dtype)[6:]}{list(c.shape)} constant baked into a "
                       f"{str(compute_dtype)[6:]} step"))
    for n in iter_calls(gm):
        name = op_name(n)
        if name in ("aten::_to_copy", "getitem") or is_kernel(n):
            continue
        outs_wide = any(t.dtype in WIDE for t in tensors(node_val(n)))
        ins_low = any(t.dtype == compute_dtype for a in n.all_input_nodes
                      for t in tensors(node_val(a)))
        if outs_wide and ins_low:
            out.append(Finding(
                rule="dtype-leak", where=where,
                detail=f"{name} promotes {str(compute_dtype)[6:]} to float32 without an "
                       f"explicit _to_copy fence (node {n.name})"))
    logits, cache_out = trace.out
    if logits.dtype != compute_dtype:
        out.append(Finding(
            rule="dtype-leak", where=where,
            detail=f"logits come out {str(logits.dtype)[6:]} in a "
                   f"{str(compute_dtype)[6:]} plan"))
    in_cache = trace.args[1] if len(trace.args) > 2 else {}
    for k, t in in_cache.items():
        if k in cache_out and cache_out[k].dtype != t.dtype:
            out.append(Finding(
                rule="dtype-leak", where=where,
                detail=f"cache leaf {k!r} widens {str(t.dtype)[6:]} -> "
                       f"{str(cache_out[k].dtype)[6:]} across the step"))
    return out


# ---------------------------------------------------------------------------
# pass 2: host sync + retrace hazards
# ---------------------------------------------------------------------------


def audit_host_sync(trace: Trace, where: str) -> List[Finding]:
    out: List[Finding] = []
    if isinstance(trace.error, DataDependentOutputException):
        out.append(Finding(
            rule="host-sync", where=where,
            detail=f"the step reads a device value on the host "
                   f"({trace.error}) — a device sync in every tick"))
    if trace.gm is None:
        return out
    for n in iter_calls(trace.gm):
        name = op_name(n)
        if name in HOST_SYNC_OPS:
            out.append(Finding(rule="host-sync", where=where,
                               detail=f"{name} synchronizes with the host inside the step"))
        elif name in ("aten::_to_copy", "aten::to"):
            src = [t.device.type for a in n.all_input_nodes for t in tensors(node_val(a))]
            dst = [t.device.type for t in tensors(node_val(n))]
            if dst == ["cpu"] and src and src[0] != "cpu":
                out.append(Finding(rule="host-sync", where=where,
                                   detail=f"{n.name} copies a device tensor to the host "
                                          f"inside the step"))
    return out


def audit_static_shapes(trace: Trace, where: str) -> List[Finding]:
    out: List[Finding] = []
    if isinstance(trace.error, DynamicOutputShapeException):
        out.append(Finding(rule="dynamic-shape", where=where,
                           detail=f"an op's output shape depends on data ({trace.error})"))
    if trace.gm is None:
        return out
    for n in trace.gm.graph.nodes:
        for t in tensors(node_val(n)):
            if any(not isinstance(d, int) for d in t.shape):
                out.append(Finding(rule="dynamic-shape", where=where,
                                   detail=f"non-static size {tuple(t.shape)} at {n.name} "
                                          f"(retrace hazard)"))
    return out


# ---------------------------------------------------------------------------
# pass 3: memory-statistics validation
# ---------------------------------------------------------------------------


def graph_peak_bytes(gm: GraphModule) -> int:
    """Reuse-free peak, the reference's convention: inputs and constants
    resident throughout, every node's output its own buffer (a view too;
    an in-place write allocates nothing), held from the node that makes it
    to its last use, in the allocator's rounded bytes, plus the libraries'
    workspace."""
    nodes = list(gm.graph.nodes)
    root = alias_roots(gm, views=False)
    resident = sum(alloc_bytes(node_val(n)) for n in nodes
                   if n.op in ("placeholder", "get_attr")) + library_workspace_bytes(gm)
    last_use: Dict[Node, int] = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            last_use[root[a]] = max(last_use.get(root[a], -1), i)
    live: Dict[Node, int] = {}
    peak = 0
    for i, n in enumerate(nodes):
        if n.op == "call_function" and root[n] is n:
            nbytes = alloc_bytes(node_val(n))
            peak = max(peak, sum(live.values()) + nbytes)
            if last_use.get(n, i) > i:
                live[n] = nbytes
        live = {v: b for v, b in live.items() if last_use.get(v, -1) > i}
    return resident + peak


def inplace_output_bytes(gm: GraphModule, size=alloc_bytes) -> int:
    """Bytes of the outputs that are input buffers (the cache leaves the
    step updates in place): they occupy one allocation with their input."""
    root = alias_roots(gm)
    seen = {root[o] for o in output_nodes(gm) if root[o].op == "placeholder"}
    return sum(size(node_val(r)) for r in seen)


def resident_floor_bytes(gm: GraphModule, size=alloc_bytes) -> int:
    """Certified lower bound on the step's peak: its inputs and outputs must
    coexist, whatever happens in between — less the outputs that are input
    buffers updated in place. ``size`` counts a value's bytes: allocated
    (default) or moved (:func:`value_bytes`, for traffic)."""
    total = sum(size(node_val(n)) for n in placeholders(gm))
    total += sum(size(node_val(o)) for o in dict.fromkeys(output_nodes(gm)))
    return max(0, total - inplace_output_bytes(gm, size))


def audit_memory(gm: GraphModule, estimate_total: float, pool_slack_bytes: float,
                 where: str) -> Tuple[Dict[str, Any], List[Finding]]:
    """Sandwich the plan's estimate between the certified floor and the
    reuse-free ceiling (plus pool slack and workspace). Both bounds follow
    the graph: a step that updates its cache in place holds one copy, one
    that rebuilds a leaf out of place holds two, so an estimate that still
    carries a double-buffer term overflows an in-place step's ceiling."""
    floor = resident_floor_bytes(gm)
    ceiling = int((graph_peak_bytes(gm) + pool_slack_bytes) * (1.0 + WORKSPACE_FRACTION))
    record = {
        "floor_bytes": int(floor),
        "estimate_bytes": float(estimate_total),
        "ceiling_bytes": int(ceiling),
        "inplace_bytes": int(inplace_output_bytes(gm)),
        "covered": bool(ceiling >= estimate_total),
    }
    findings: List[Finding] = []
    if estimate_total < floor:
        findings.append(Finding(
            rule="memory-under-estimate", where=where,
            detail=f"estimate {estimate_total:.0f}B below the certified floor {floor}B — "
                   f"the plan will breach its watermark and burn a corrective "
                   f"recompile at serve time", data=record))
    elif not record["covered"]:
        findings.append(Finding(
            rule="memory-uncovered", where=where,
            detail=f"estimate {estimate_total:.0f}B exceeds the reuse-free ceiling "
                   f"{ceiling}B — the statistic over-provisions beyond any possible "
                   f"execution", data=record))
    return record, findings


# ---------------------------------------------------------------------------
# pass 4: decode-kernel selection
# ---------------------------------------------------------------------------


def check_kernel_choice(model, config, shape, page: int, where: str,
                        forced: str = "auto") -> List[Finding]:
    """Static checks over the plan's recorded decode kernel — plan metadata,
    no tracing. ``model`` is the ``ModelConfig``, ``config`` the chosen
    ``PlanConfig``, ``forced`` the compiler's kernel knob. A forced compiler
    must record what it was forced to (attention-free families: ``none``),
    and a long-context paged decode plan must run the fused paged kernel."""
    out: List[Finding] = []
    if shape.kind != "decode":
        return out
    if model.layer_pattern().count("a") == 0:
        if config.decode_kernel != "none":
            out.append(Finding(
                rule="kernel-choice", where=where,
                detail=f"attention-free family records decode kernel "
                       f"{config.decode_kernel!r} (expected 'none')"))
        return out
    if forced != "auto" and config.decode_kernel != forced:
        out.append(Finding(
            rule="kernel-choice", where=where,
            detail=f"compiler forced decode kernel {forced!r} but the plan records "
                   f"{config.decode_kernel!r}"))
    if (page > 0 and shape.seq_len > LONG_CONTEXT_THRESHOLD
            and config.decode_kernel != "paged"):
        out.append(Finding(
            rule="kernel-choice", where=where,
            detail=f"long-context decode plan (seq {shape.seq_len}) runs "
                   f"{config.decode_kernel!r}, not the fused paged kernel — every step "
                   f"pays the gather materialization's {2 + 2 * model.q_per_kv}x cache "
                   f"traffic"))
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def compile_cell(arch: str, dtype: str, kind: str, batch: int, seq: int, *,
                 page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
                 decode_kernel: str = "auto", donate: bool = True):
    """(ModelConfig, Model, plan, InputShape) of one cell, compiled as
    ``PlanServer`` compiles it (the H100's figures)."""
    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch_dtype(dtype))
    compiler = PlanCompiler(cache_page_size=page, cache_pool_arenas=pool_arenas,
                            decode_kernel=decode_kernel, donate_cache=donate)
    shape = InputShape(f"req_{batch}x{seq}", seq, batch, kind)
    return cfg, model, compiler.compile(cfg, shape, SINGLE_DEVICE_MESH, dtype=dtype), shape


def cell_where(arch: str, dtype: str, kind: str, batch: int, seq: int,
               decode_kernel: str = "auto") -> str:
    where = f"{arch}/{dtype}/{kind}/b{batch}s{seq}"
    if kind == "decode" and decode_kernel != "auto":
        where += f"/{decode_kernel}"
    return where


def pool_slack_bytes(model, batch: int, seq: int, pool_arenas: int) -> float:
    """The rest of the pool the step serves next to: ``pool_arenas - 1``
    dense arenas of this bucket."""
    ent = model.cache_entries(batch, seq)
    arena = sum(int(np.prod(s)) * (torch.finfo(d).bits // 8) for s, _a, d in ent.values())
    return (pool_arenas - 1) * arena


def audit_cell(arch: str, dtype: str, kind: str, batch: int, seq: int, *,
               page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
               decode_kernel: str = "auto", device: str = DEVICE, wrap=None,
               trace: Optional[Trace] = None) -> Tuple[Dict[str, Any], List[Finding]]:
    """Compile the plan and audit the traced step for one matrix cell
    (``trace``: a trace of this cell another pass made)."""
    where = cell_where(arch, dtype, kind, batch, seq, decode_kernel)
    cfg, model, plan, shape = compile_cell(arch, dtype, kind, batch, seq, page=page,
                                           pool_arenas=pool_arenas,
                                           decode_kernel=decode_kernel)
    if trace is None:
        trace = trace_cell(model, plan, kind, batch, seq, page=page, device=device,
                           wrap=wrap)
    findings: List[Finding] = []
    if kind == "decode":
        findings += audit_dtype(trace, model.dtype, where)
    findings += audit_host_sync(trace, where)
    findings += audit_static_shapes(trace, where)
    findings += check_kernel_choice(cfg, plan.config, shape, page, where,
                                    forced=decode_kernel)
    mem: Dict[str, Any] = {}
    if trace.gm is not None:
        mem, mem_findings = audit_memory(trace.gm, plan.memory.total if plan.memory else 0.0,
                                         pool_slack_bytes(model, batch, seq, pool_arenas),
                                         where)
        findings += mem_findings
    record = {
        "arch": arch, "dtype": dtype, "kind": kind, "batch": batch, "seq": seq,
        "device": device,
        "donate_cache": bool(plan.config.donate_cache if kind == "decode" else False),
        # what the plan chose (against the compiler knob)
        "decode_kernel": plan.config.decode_kernel,
        "forced_kernel": decode_kernel,
        "nodes": sum(1 for _ in iter_calls(trace.gm)) if trace.gm is not None else 0,
        "kernel_nodes": kernel_counts(trace.gm) if trace.gm is not None else {},
        "memory": mem,
        "findings": len(findings),
    }
    return record, findings


def kernel_counts(gm: GraphModule) -> Dict[str, int]:
    """Kernel nodes of a graph by op name."""
    out: Dict[str, int] = {}
    for n in iter_calls(gm):
        if is_kernel(n):
            out[op_name(n)] = out.get(op_name(n), 0) + 1
    return out


def run_audit(archs: Sequence[str] = SMOKE_ARCHS,
              dtypes: Sequence[str] = SMOKE_DTYPES,
              buckets: Sequence[Tuple[int, int]] = SMOKE_BUCKETS,
              kinds: Sequence[str] = ("decode", "prefill"),
              page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
              device: str = DEVICE,
              log=None) -> Tuple[List[Dict[str, Any]], List[Finding]]:
    cells: List[Dict[str, Any]] = []
    findings: List[Finding] = []
    for cell in smoke_cells(archs=archs, dtypes=dtypes, buckets=buckets, kinds=kinds,
                            device=device):
        rec, found = audit_cell(cell.arch, cell.dtype, cell.kind, cell.batch, cell.seq,
                                page=page, pool_arenas=pool_arenas,
                                decode_kernel=cell.forced_kernel, device=device)
        cells.append(rec)
        findings.extend(found)
        if log:
            kernels = ", ".join(f"{k.split('::')[1]} x{v}"
                                for k, v in rec["kernel_nodes"].items()) or "no kernel"
            log(f"  {cell.where}: {rec['nodes']} nodes ({kernels}), "
                f"kernel={rec['decode_kernel']}, {rec['findings']} finding(s)")
    return cells, findings


# ---------------------------------------------------------------------------
# self-test: planted violations the auditor must flag
# ---------------------------------------------------------------------------


def _wrap_fp32_const(step):
    """Plant the historical bug: a float32 constant baked into a bfloat16
    decode step (cast back afterwards, so only the constant and the
    transient promotion betray it)."""
    bias = np.linspace(0.0, 0.1, 8, dtype=np.float32)

    def wrapped(params, cache, tokens, pos, tables=None):
        args = (params, cache, tokens, pos) + ((tables,) if tables is not None else ())
        logits, cache_out = step(*args)
        leaked = logits + torch.tensor(bias, device=logits.device).sum()
        return leaked.to(logits.dtype), cache_out

    return wrapped


def _wrap_item(step):
    """Plant a host sync: a ``.item()`` inside the tick."""

    def wrapped(params, cache, tokens, pos, tables=None):
        args = (params, cache, tokens, pos) + ((tables,) if tables is not None else ())
        logits, cache_out = step(*args)
        scale = logits.float().abs().max().item()
        return logits * (1.0 / (1.0 + scale)), cache_out

    return wrapped


def selftest(arch: str = "yi-6b-smoke", device: str = DEVICE) -> Dict[str, Any]:
    """The detectors on planted violations (and a clean control) in a
    bfloat16 decode step; returns per-probe pass/fail."""
    _, clean = audit_cell(arch, "bfloat16", "decode", 2, 64, device=device)
    _, fp32 = audit_cell(arch, "bfloat16", "decode", 2, 64, device=device,
                         wrap=_wrap_fp32_const)
    _, item = audit_cell(arch, "bfloat16", "decode", 2, 64, device=device, wrap=_wrap_item)

    # a long-context plan whose paged kernel was dropped must flag (and the
    # honest plan must not)
    cfg = get_config("yi-6b")
    shape = InputShape("probe", LONG_CONTEXT_THRESHOLD + 1, 8, "decode")
    plan = PlanCompiler(cache_page_size=PAGE_SIZE, cache_pool_arenas=POOL_ARENAS).compile(
        cfg, shape, SINGLE_DEVICE_MESH, dtype="bfloat16")
    doctored = plan.config.replace(decode_kernel="gather")
    flagged = check_kernel_choice(cfg, doctored, shape, PAGE_SIZE, "selftest/long-context")
    honest = check_kernel_choice(cfg, plan.config, shape, PAGE_SIZE, "selftest/long-context")

    # the bounds follow the graph: a step that rebuilds its cache out of
    # place holds a second arena, so an estimate without that term falls
    # under its floor and is flagged, while the in-place step's floor and
    # ceiling hold the same figure
    _, model, probe_plan, _ = compile_cell(arch, "bfloat16", "decode", 2, 64,
                                           decode_kernel="paged")
    inplace = trace_cell(model, probe_plan, "decode", 2, 64, device=device)
    rebuilt = trace_cell(model, probe_plan, "decode", 2, 64, device=device,
                         wrap=rebuild_cache_out_of_place)
    arena = sum(alloc_bytes(t) for t in inplace.args[1].values())
    estimate = resident_floor_bytes(inplace.gm) + arena // 2
    _, fits = audit_memory(inplace.gm, estimate, 0.0, "selftest/in-place")
    _, under = audit_memory(rebuilt.gm, estimate, 0.0, "selftest/out-of-place")
    return {
        "clean_control": not clean,
        "fp32_const_flagged": any(f.rule == "dtype-leak" for f in fp32),
        "host_sync_flagged": any(f.rule == "host-sync" for f in item),
        "paged_kernel_absent_flagged": (any(f.rule == "kernel-choice" for f in flagged)
                                        and not honest),
        "out_of_place_floor_enforced": (any(f.rule == "memory-under-estimate"
                                            for f in under) and not fits),
    }


def rebuild_cache_out_of_place(step):
    """Plant a step that returns each cache leaf as a fresh tensor
    (``index_copy`` where the model writes with ``index_copy_``): the
    second copy of the arena the port's in-place step avoids."""

    def wrapped(params, cache, tokens, pos, tables=None):
        args = (params, cache, tokens, pos) + ((tables,) if tables is not None else ())
        logits, cache_out = step(*args)
        first = torch.zeros((1,), dtype=torch.long, device=logits.device)
        fresh = {k: v.index_copy(0, first, v.index_select(0, first)) if v.numel() else v
                 for k, v in cache_out.items()}
        return logits, fresh

    return wrapped


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def findings_json(findings: Sequence[Finding]) -> List[Dict[str, str]]:
    return [{"rule": f.rule, "where": f.where, "detail": f.detail} for f in findings]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="static FX-graph audit of every compiled serving step")
    ap.add_argument("--smoke", action="store_true",
                    help="audit the smoke matrix (archs x dtypes x buckets) plus the "
                         "planted-violation self-test")
    ap.add_argument("--archs", nargs="*", default=None, help="override the arch list")
    ap.add_argument("--device", default=DEVICE,
                    help="device of the fake tensors traced (default cuda: the card's "
                         "path; no card needed)")
    ap.add_argument("--report", default=REPORT_PATH,
                    help=f"JSON report path (default {REPORT_PATH})")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the planted-violation self-test")
    args = ap.parse_args(argv)

    archs = tuple(args.archs) if args.archs else SMOKE_ARCHS
    print(f"plan_audit: {len(archs)} arch(s) x {len(SMOKE_DTYPES)} dtypes x "
          f"{len(SMOKE_BUCKETS)} buckets on fake {args.device}")
    cells, findings = run_audit(archs=archs, device=args.device, log=print)

    st: Dict[str, Any] = {}
    if not args.no_selftest:
        st = selftest(device=args.device)
        for probe, ok in st.items():
            print(f"  selftest {probe}: {'ok' if ok else 'MISSED'}")

    # the report is shared with the memory and cost auditors (their
    # sections live under "memory" / "cost"): update ours in place
    merge_report(args.report, {
        "matrix": matrix_meta(archs=archs, device=args.device),
        "cells": cells,
        "findings": findings_json(findings),
        "selftest": st,
    })
    for f in findings:
        print(f)
    missed = [k for k, ok in st.items() if not ok]
    print(f"plan_audit: {len(cells)} cells, {len(findings)} finding(s), report -> "
          f"{args.report}")
    if missed:
        print(f"plan_audit: self-test MISSED: {', '.join(missed)}")
    return 1 if findings or missed else 0


if __name__ == "__main__":
    sys.exit(main())
