"""Compute-cost certifier: graph-derived FLOP/traffic bounds that audit the
planner's cost model and its kernel-selection decisions (port of
``repro/analysis/cost_audit.py``, which walks jaxprs).

SystemML's compiler picks physical operators from size/cost statistics,
so the statistics must be right: a drifted constant in ``core/cost.py``
silently flips the paged/gather crossover and nothing numerical notices.
The plan auditor sandwiches the memory statistics and the memory auditor
certifies lifetimes; this pass does the same for the compute statistics
and the decisions made from them.

**Per-cell cost sandwich.** Every smoke cell's aten graph (traced on fake
tensors, ``plan_audit.trace_cell``) is walked by :func:`graph_cost`:

- ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` / ``convolution`` give a
  certified MAC-FLOP floor (2 x output elements x contraction size);
  element-wise ops add one FLOP per output element and reductions one per
  input element, on the ceiling side; views and data movement count zero.
- A kernel node (``repro_torch::<name>``) counts on the ceiling side only,
  as the reference counts a ``pallas_call``: its FLOPs and bytes come from
  the ``work(...)`` beside the kernel in its own module
  (``kernels._build.WORK``), which ``chip_smoke.py``'s bounds read too.
- Bytes give a traffic floor (step inputs + outputs, less the cache leaves
  updated in place) and a reuse-free ceiling (every node's operands and
  results spilled, no fusion).

The analytic model must sit inside both: ``flops`` within
``[0.95 x floor, 1.25 x (ceiling + embedding-lookup allowance)]`` and
``physical_hbm_bytes()`` within the traffic bounds (``CostTerm.physical``
keeps latency folded into byte currency out of it).

**Decision audits**, pure functions of the port's ``PlanCompiler``, as in
the reference: crossover monotonicity (context-length and committed-frac
sweeps), forced-kernel consistency, donation-independence, explain
completeness, and the trace-closure certificate.

Run ``python -m repro_torch.analysis.cost_audit --smoke``: audits the
matrix on fake ``cuda``, runs the planted-violation self-test (an inflated
and a deflated FLOP figure, a crossover inversion and a plan axis missing
from ``explain()`` must flag; clean controls must not), merges a ``cost``
section into ``build/ANALYSIS_report_torch.json`` and exits non-zero on any
clean-tree finding or self-test miss.
"""

from __future__ import annotations

import argparse
import math
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.fx import GraphModule

from repro_torch.analysis import Finding
from repro_torch.analysis.matrix import (DEVICE, PAGE_SIZE, POOL_ARENAS, REPORT_PATH,
                                         SMOKE_ARCHS, SMOKE_BUCKETS, SMOKE_DTYPES,
                                         matrix_meta, merge_report, smoke_cells)
from repro_torch.analysis.plan_audit import (Trace, cell_where, compile_cell, findings_json,
                                             is_kernel, iter_calls, node_val, op_name,
                                             resident_floor_bytes, tensors, trace_cell,
                                             value_bytes)
from repro_torch.config import SINGLE_DEVICE_MESH, InputShape
from repro_torch.configs import get_config
from repro_torch.core.plan_cache import BucketPolicy, bucket_pow2
from repro_torch.core.planner import PlanCompiler
from repro_torch.core.strategies import PLAN_AXES
from repro_torch.kernels._build import WORK
from repro_torch.runtime.engine_config import EngineConfig

# Sandwich conventions (documented, not silent slack), the reference's:
# - the analytic model counts the embedding lookup at matmul convention
#   (2 x vocab x d_model FLOPs per token) where the trace does a gather;
#   the ceiling gets that allowance explicitly (_lookup_allowance).
# - FLOP_FLOOR_SLACK absorbs counting-convention skew on grouped convs /
#   SSM scans, where the analytic 2ND undercounts traced MACs by a few
#   percent.
# - FLOP_CEIL_SLACK covers transcendental weighting (exp/rsqrt count one
#   FLOP here, several on hardware) and window-convention skew on the
#   analytic attention term.
FLOP_FLOOR_SLACK = 0.95
FLOP_CEIL_SLACK = 1.25

# products: certified MACs
_PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::convolution")
# data movement and allocation: zero FLOPs (the traffic bounds price these)
_MOVEMENT = frozenset((
    "aten::index", "aten::index_select", "aten::index_copy", "aten::index_copy_",
    "aten::index_put", "aten::index_put_", "aten::gather", "aten::scatter",
    "aten::copy_", "aten::_to_copy", "aten::clone", "aten::cat", "aten::stack",
    "aten::constant_pad_nd", "aten::where", "aten::arange", "aten::full",
    "aten::zeros", "aten::ones", "aten::empty", "aten::zeros_like", "aten::ones_like",
    "aten::empty_like", "aten::full_like", "aten::lift_fresh_copy", "aten::embedding",
    "aten::repeat", "aten::repeat_interleave", "aten::flip", "aten::roll", "getitem",
))
# reductions (and the scans and softmaxes built on them): one FLOP an input
# element
_REDUCE = frozenset(f"aten::{r}" for r in (
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "cumsum", "cumprod",
    "prod", "any", "all", "_softmax", "_log_softmax", "logsumexp", "var", "std",
    "linalg_vector_norm"))


@dataclass
class CostBounds:
    """Accumulated per-node costs of one graph."""

    macs_lo: float = 0.0      # certified MAC FLOPs (floor side)
    flops_hi: float = 0.0     # MACs + element-wise + reduces + kernels (ceiling side)
    node_bytes: float = 0.0   # reuse-free traffic: per-node operand + result bytes
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0


def _product_flops(n) -> float:
    """2 x output elements x contraction length of one product node."""
    name = op_name(n)
    out = tensors(node_val(n))[0]
    if name == "aten::convolution":
        # the weight is (F, C / groups, k...): one output element's MACs
        w = node_val(n.args[1])
        return 2.0 * out.numel() * (w.numel() // max(1, w.shape[0]))
    lhs = node_val(n.args[1] if name in ("aten::addmm", "aten::baddbmm") else n.args[0])
    return 2.0 * out.numel() * lhs.shape[-1]


def graph_cost(gm: GraphModule) -> CostBounds:
    """The per-node cost interpreter (see the module doc)."""
    out = CostBounds()
    for n in iter_calls(gm):
        name = op_name(n)
        if is_kernel(n):
            work = WORK[name](*[node_val(a) if hasattr(a, "meta") else a for a in n.args])
            out.flops_hi += work.flops
            out.node_bytes += work.bytes
            out.kernel_flops += work.flops
            out.kernel_bytes += work.bytes
            continue
        if name == "getitem":
            continue      # a pick from a tuple the op already counted
        out.node_bytes += value_bytes(node_val(n)) + sum(
            value_bytes(node_val(a)) for a in n.all_input_nodes)
        if name in _PRODUCTS:
            f = _product_flops(n)
            out.macs_lo += f
            out.flops_hi += f
            if name in ("aten::addmm", "aten::baddbmm"):
                out.flops_hi += sum(t.numel() for t in tensors(node_val(n)))
        elif name in _MOVEMENT:
            pass
        elif name in _REDUCE:
            out.flops_hi += sum(t.numel() for a in n.all_input_nodes
                                for t in tensors(node_val(a)))
        else:             # element-wise / transcendental: one FLOP an element
            out.flops_hi += sum(t.numel() for t in tensors(node_val(n)))
    return out


def _lookup_allowance(cfg, kind: str, batch: int, seq: int) -> float:
    """FLOPs the analytic model charges for the embedding lookup (matmul
    convention) that the trace performs as a zero-FLOP index."""
    tokens = batch * (seq if kind != "decode" else 1)
    return 2.0 * cfg.vocab_size * cfg.d_model * tokens


# ---------------------------------------------------------------------------
# per-cell sandwich
# ---------------------------------------------------------------------------


def audit_cell(arch: str, dtype: str, kind: str, batch: int, seq: int, *,
               page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
               decode_kernel: str = "auto", device: str = DEVICE,
               flop_scale: float = 1.0, traffic_scale: float = 1.0,
               trace: Optional[Trace] = None) -> Tuple[Dict[str, Any], List[Finding]]:
    """Sandwich one cell's analytic FLOP and traffic statistics between the
    graph-derived bounds. ``flop_scale`` / ``traffic_scale`` are the
    self-test hooks (a drifted constant in ``core/cost.py``); ``trace``
    reuses a trace of this cell made by another pass."""
    where = cell_where(arch, dtype, kind, batch, seq, decode_kernel)
    cfg, model, plan, _shape = compile_cell(arch, dtype, kind, batch, seq, page=page,
                                            pool_arenas=pool_arenas,
                                            decode_kernel=decode_kernel)
    if trace is None:
        trace = trace_cell(model, plan, kind, batch, seq, page=page, device=device)
    bounds = graph_cost(trace.gm)

    flop_floor = FLOP_FLOOR_SLACK * bounds.macs_lo
    flop_ceiling = FLOP_CEIL_SLACK * (bounds.flops_hi
                                      + _lookup_allowance(cfg, kind, batch, seq))
    analytic_flops = plan.cost.flops * flop_scale
    # inputs + outputs, less the cache leaves the step updates in place
    # (only the new token's slot is written, never a second copy)
    traffic_floor = resident_floor_bytes(trace.gm, value_bytes)
    traffic_ceiling = bounds.node_bytes
    analytic_traffic = plan.cost.physical_hbm_bytes() * traffic_scale

    findings: List[Finding] = []
    if analytic_flops < flop_floor:
        findings.append(Finding(
            rule="flop-under-estimate", where=where,
            detail=f"analytic {analytic_flops:.3g} FLOPs below the certified floor "
                   f"{flop_floor:.3g} (traced MACs {bounds.macs_lo:.3g}) — the roofline "
                   f"compute term under-prices the step"))
    elif analytic_flops > flop_ceiling:
        findings.append(Finding(
            rule="flop-over-estimate", where=where,
            detail=f"analytic {analytic_flops:.3g} FLOPs above the derived ceiling "
                   f"{flop_ceiling:.3g} — a cost-model constant has drifted (inflated "
                   f"FLOP term)"))
    if analytic_traffic < traffic_floor:
        findings.append(Finding(
            rule="traffic-under-estimate", where=where,
            detail=f"analytic {analytic_traffic:.3g}B physical traffic below the floor "
                   f"{traffic_floor:.3g}B (inputs + non-reused outputs must cross HBM) — "
                   f"the memory roofline term under-prices the step"))
    elif analytic_traffic > traffic_ceiling:
        findings.append(Finding(
            rule="traffic-over-estimate", where=where,
            detail=f"analytic {analytic_traffic:.3g}B physical traffic above the "
                   f"reuse-free ceiling {traffic_ceiling:.3g}B — the statistic exceeds "
                   f"even a fusion-free execution"))
    record = {
        "arch": arch, "dtype": dtype, "kind": kind, "batch": batch, "seq": seq,
        "device": device,
        "decode_kernel": plan.config.decode_kernel,
        "forced_kernel": decode_kernel,
        "flops": {
            "floor": float(flop_floor),
            "analytic": float(analytic_flops),
            "ceiling": float(flop_ceiling),
            "traced_macs": float(bounds.macs_lo),
            "kernel_flops": float(bounds.kernel_flops),
        },
        "traffic": {
            "floor_bytes": float(traffic_floor),
            "analytic_bytes": float(analytic_traffic),
            "ceiling_bytes": float(traffic_ceiling),
            "kernel_bytes": float(bounds.kernel_bytes),
        },
        "findings": len(findings),
    }
    return record, findings


# ---------------------------------------------------------------------------
# decision audits (pure checkers + the sweeps that feed them)
# ---------------------------------------------------------------------------


def check_selection_monotonic(picks: Sequence[Tuple[Any, str]], where: str,
                              axis: str = "seq") -> List[Finding]:
    """No crossover inversions along one swept statistic: the analytic
    paged-vs-gather delta is linear in it, so a valid selection sequence
    flips at most once, and the committed-frac sweep only paged -> gather."""
    out: List[Finding] = []
    kernels = [k for _, k in picks]
    flips = [(picks[i - 1], picks[i]) for i in range(1, len(kernels))
             if kernels[i] != kernels[i - 1]]
    if len(flips) > 1:
        pts = ", ".join(f"{a[1]}@{a[0]}->{b[1]}@{b[0]}" for a, b in flips)
        out.append(Finding(
            rule="crossover-inversion", where=where,
            detail=f"kernel choice flips {len(flips)} times along the {axis} sweep "
                   f"({pts}); the analytic delta is linear in {axis}, so at most one "
                   f"crossover is possible"))
    elif flips and axis == "committed_frac":
        (_, k_lo), (_, k_hi) = flips[0]
        if (k_lo, k_hi) != ("paged", "gather"):
            out.append(Finding(
                rule="crossover-inversion", where=where,
                detail=f"committed-frac sweep flips {k_lo} -> {k_hi}; raising the "
                       f"fraction only raises the paged cost, so only paged -> gather "
                       f"is admissible"))
    return out


def check_explain_axes(axes: Dict[str, str], where: str) -> List[Finding]:
    """Every plan axis must be recorded by ``explain_axes()``."""
    return [Finding(
        rule="explain-axis-missing", where=where,
        detail=f"plan axis {a!r} is not recorded by ExecutionPlan.explain(): the "
               f"decision cannot be debugged from EXPLAIN output")
        for a in PLAN_AXES if a not in axes]


def _sweep_seqs(max_seq: int = 8192) -> List[int]:
    s, out = 16, []
    while s <= max_seq:
        out.append(s)
        s *= 2
    return out


def audit_decisions(archs: Sequence[str] = SMOKE_ARCHS,
                    dtypes: Sequence[str] = SMOKE_DTYPES,
                    page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
                    hw=None, log=None) -> Tuple[Dict[str, Any], List[Finding]]:
    """The plan-axis cross product of selection checks: crossover
    monotonicity (context-length and committed-frac sweeps), forced-kernel
    consistency, donation-independence and explain completeness, per
    (arch x dtype x bucket). ``hw`` defaults to the compiler's (the H100)."""
    findings: List[Finding] = []
    sweeps: List[Dict[str, Any]] = []
    hw_kw = {} if hw is None else {"hw": hw}

    def compiler(**kw) -> PlanCompiler:
        return PlanCompiler(cache_page_size=page, cache_pool_arenas=pool_arenas,
                            **hw_kw, **kw)

    for arch in archs:
        cfg = get_config(arch)
        for dtype in dtypes:
            where = f"{arch}/{dtype}"
            auto = compiler()
            picks = [(s, auto.selection_trace(
                cfg, InputShape("sweep", s, 4, "decode"))["kernel"]) for s in _sweep_seqs()]
            findings += check_selection_monotonic(picks, f"{where}/seq-sweep", axis="seq")
            shape = InputShape("sweep", 128, 4, "decode")
            fracs = [i / 20.0 for i in range(1, 21)]
            frac_picks = [(f, auto.selection_trace(cfg, shape, committed_frac=f)["kernel"])
                          for f in fracs]
            findings += check_selection_monotonic(frac_picks, f"{where}/frac-sweep",
                                                  axis="committed_frac")
            sweeps.append({"arch": arch, "dtype": dtype,
                           "seq_picks": [[s, k] for s, k in picks],
                           "frac_picks": [[f, k] for f, k in frac_picks]})
            for batch, seq in SMOKE_BUCKETS:
                shape = InputShape(f"b{batch}s{seq}", seq, batch, "decode")
                cell = f"{where}/b{batch}s{seq}"
                for forced in ("paged", "gather", "ref"):
                    got = compiler(decode_kernel=forced).compile(
                        cfg, shape, SINGLE_DEVICE_MESH, dtype=dtype).config.decode_kernel
                    want = "none" if cfg.layer_pattern().count("a") == 0 else forced
                    if got != want:
                        findings.append(Finding(
                            rule="forced-kernel-mismatch", where=cell,
                            detail=f"compiler forced {forced!r} but the plan records "
                                   f"{got!r} (expected {want!r})"))
                kernels = {compiler(donate_cache=donate).compile(
                    cfg, shape, SINGLE_DEVICE_MESH, dtype=dtype).config.decode_kernel
                    for donate in (True, False)}
                if len(kernels) > 1:
                    findings.append(Finding(
                        rule="donation-dependent-kernel", where=cell,
                        detail=f"kernel choice depends on the donate knob "
                               f"({sorted(kernels)}); the write-back term is "
                               f"operator-independent, so it must never move the "
                               f"crossover"))
                plan = auto.compile(cfg, shape, SINGLE_DEVICE_MESH, dtype=dtype)
                findings += check_explain_axes(plan.explain_axes(), cell)
            if log:
                log(f"  {where}: seq sweep {'/'.join(k for _, k in picks)}")
    return {"sweeps": sweeps}, findings


# ---------------------------------------------------------------------------
# trace-closure certificate
# ---------------------------------------------------------------------------


def _bucket_ladder(max_value: int, minimum: int) -> List[int]:
    """All buckets reachable from requests bounded by ``max_value``."""
    out, b = [], bucket_pow2(1, minimum)
    top = bucket_pow2(max_value, minimum)
    while b <= top:
        out.append(b)
        b *= 2
    return out


def trace_closure_certificate(engine: Optional[EngineConfig] = None,
                              policy: Optional[BucketPolicy] = None,
                              max_seq: int = 65_536) -> Tuple[Dict[str, Any], List[Finding]]:
    """Certify that the step signatures reachable from an EngineConfig are a
    finite set: keyed by (kind, batch bucket, seq bucket, decode kernel),
    the bucket ladders are finite pow2 sets and closed under re-bucketing
    (checked bucket by bucket), the kernel axis is bounded by the operator
    vocabulary."""
    engine = engine or EngineConfig()
    policy = policy or BucketPolicy()
    findings: List[Finding] = []
    where = "trace-closure"
    batches = _bucket_ladder(engine.max_group_batch, policy.min_batch)
    seqs = _bucket_ladder(max_seq, policy.min_seq)
    for b in batches:
        if bucket_pow2(b, policy.min_batch) != b:
            findings.append(Finding(
                rule="trace-closure", where=where,
                detail=f"batch bucket {b} is not a bucketing fixed point — re-entrant "
                       f"recompiles mint new signatures"))
    for s in seqs:
        if bucket_pow2(s, policy.min_seq) != s:
            findings.append(Finding(
                rule="trace-closure", where=where,
                detail=f"seq bucket {s} is not a bucketing fixed point"))
    for n in (1, 2, 3, max_seq // 2 + 1, max_seq):
        if 1 <= n <= max_seq and bucket_pow2(n, policy.min_seq) not in seqs:
            findings.append(Finding(
                rule="trace-closure", where=where,
                detail=f"request seq {n} buckets outside the ladder"))
    kinds = ("decode", "prefill") if engine.prefill else ("decode",)
    kernels = 1 if engine.decode_kernel != "auto" else 2   # auto: paged <-> gather
    signatures = len(batches) * len(seqs) * len(kinds) * kernels
    bound = ((math.floor(math.log2(max(batches) // min(batches))) + 1)
             * (math.floor(math.log2(max(seqs) // min(seqs))) + 1)
             * len(kinds) * kernels)
    if signatures > bound:
        findings.append(Finding(
            rule="trace-closure", where=where,
            detail=f"{signatures} reachable signatures exceed the log-product bound "
                   f"{bound}"))
    record = {
        "batch_buckets": batches,
        "seq_buckets": seqs,
        "kinds": list(kinds),
        "kernel_axis": kernels,
        "signatures": signatures,
        "bound": bound,
        "finite": not findings,
    }
    return record, findings


# ---------------------------------------------------------------------------
# the smoke matrix + self-test
# ---------------------------------------------------------------------------


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
            log(f"  {cell.where}: {cost_line(rec)}; {rec['findings']} finding(s)")
    return cells, findings


def cost_line(rec: Dict[str, Any]) -> str:
    fl, tr = rec["flops"], rec["traffic"]
    return (f"flops {fl['floor']:.3g} <= {fl['analytic']:.3g} <= {fl['ceiling']:.3g}; "
            f"traffic {tr['floor_bytes']:.3g} <= {tr['analytic_bytes']:.3g} <= "
            f"{tr['ceiling_bytes']:.3g}")


def selftest(arch: str = "yi-6b-smoke", device: str = DEVICE) -> Dict[str, Any]:
    """Planted violations (an inflated and a deflated FLOP figure, a
    crossover inversion, a plan axis missing from explain) and clean
    controls."""
    _, clean = audit_cell(arch, "bfloat16", "decode", 2, 64, decode_kernel="gather",
                          device=device)
    _, inflated = audit_cell(arch, "bfloat16", "decode", 2, 64, decode_kernel="gather",
                             device=device, flop_scale=64.0)
    _, deflated = audit_cell(arch, "bfloat16", "decode", 2, 64, decode_kernel="gather",
                             device=device, flop_scale=1 / 64.0)
    doctored = [(64, "gather"), (128, "paged"), (256, "gather"), (512, "paged")]
    inversion = check_selection_monotonic(doctored, "selftest/doctored")
    compiler = PlanCompiler(cache_page_size=PAGE_SIZE, cache_pool_arenas=POOL_ARENAS)
    cfg = get_config(arch)
    honest = check_selection_monotonic(
        [(s, compiler.selection_trace(cfg, InputShape("sweep", s, 4, "decode"))["kernel"])
         for s in _sweep_seqs()], "selftest/honest")
    plan = compiler.compile(cfg, InputShape("probe", 64, 2, "decode"), SINGLE_DEVICE_MESH,
                            dtype="bfloat16")
    axes = dict(plan.explain_axes())
    axes.pop("decode_kernel")
    missing = check_explain_axes(axes, "selftest/dropped-axis")
    complete = check_explain_axes(plan.explain_axes(), "selftest/full")
    return {
        "clean_control": not clean,
        "inflated_flops_flagged": any(f.rule == "flop-over-estimate" for f in inflated),
        "deflated_flops_flagged": any(f.rule == "flop-under-estimate" for f in deflated),
        "crossover_inversion_flagged": (any(f.rule == "crossover-inversion"
                                            for f in inversion) and not honest),
        "missing_explain_axis_flagged": (any(f.rule == "explain-axis-missing"
                                             for f in missing) and not complete),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="graph-derived FLOP/traffic bounds auditing the planner's cost model "
                    "and its selection decisions")
    ap.add_argument("--smoke", action="store_true",
                    help="audit the smoke matrix (cost sandwich + selection invariants + "
                         "trace closure) plus the planted-violation self-test")
    ap.add_argument("--archs", nargs="*", default=None, help="override the arch list")
    ap.add_argument("--device", default=DEVICE,
                    help="device of the fake tensors traced (default cuda: the card's path)")
    ap.add_argument("--report", default=REPORT_PATH,
                    help=f"JSON report path (default {REPORT_PATH})")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the planted-violation self-test")
    args = ap.parse_args(argv)

    archs = tuple(args.archs) if args.archs else SMOKE_ARCHS
    print(f"cost_audit: {len(archs)} arch(s) x {len(SMOKE_DTYPES)} dtypes x "
          f"{len(SMOKE_BUCKETS)} buckets on fake {args.device}")
    cells, findings = run_audit(archs=archs, device=args.device, log=print)
    decisions, dec_findings = audit_decisions(archs=archs, log=print)
    findings += dec_findings
    closure, cls_findings = trace_closure_certificate()
    findings += cls_findings
    print(f"  trace closure: {closure['signatures']} reachable step signatures (bound "
          f"{closure['bound']}), finite={closure['finite']}")

    st: Dict[str, Any] = {}
    if not args.no_selftest:
        st = selftest(device=args.device)
        for probe, ok in st.items():
            print(f"  selftest {probe}: {'ok' if ok else 'MISSED'}")
    merge_report(args.report, {"cost": {
        "matrix": matrix_meta(archs=archs, device=args.device),
        "cells": cells,
        "decisions": decisions,
        "trace_closure": closure,
        "findings": findings_json(findings),
        "selftest": st,
    }})
    for f in findings:
        print(f)
    missed = [k for k, ok in st.items() if not ok]
    print(f"cost_audit: {len(cells)} cells, {len(findings)} finding(s), report -> "
          f"{args.report} [cost]")
    if missed:
        print(f"cost_audit: self-test MISSED: {', '.join(missed)}")
    return 1 if findings or missed else 0


if __name__ == "__main__":
    sys.exit(main())
