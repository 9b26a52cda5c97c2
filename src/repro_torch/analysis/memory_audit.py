"""Memory-lifetime auditor: certify that every decode plan updates its
cache in place (port of ``repro/analysis/memory_audit.py``).

The reference reads the input-output aliasing that buffer donation leaves
on the lowered StableHLO. The port has no donation: its decode step writes
the cache in place (``index_copy_`` / ``copy_`` into the arena's tensors,
``models/attention.py`` and ``models/blocks.py``). So for every decode cell
of the smoke matrix (arch x dtype x bucket x both forced operators) this
pass traces the exact step ``PlanServer`` installs on fake tensors
(``plan_audit.trace_cell``) and reads the aten graph:

- every step input is classified into a buffer class (``params``,
  ``attention-slot-stack``, ``recurrent-state``, ``tokens`` /
  ``positions``, ``page-table``; :func:`classify_leaves`) and marked
  **in-place** (an in-place op writes a view of its placeholder, and the
  step returns the placeholder itself) or **double-buffered** (the step
  returns a fresh tensor for it);
- a **certified peak** follows from those lifetimes: inputs + outputs −
  the in-place pairs, which share one buffer;
- ``cache-not-donated`` (the reference's id) flags a plan compiled with
  ``donate_cache=False`` and any cache leaf the step rebuilds out of place
  or never writes.

On the card, :func:`measure_decode` and :func:`measure_prefill` run one
eager tick and one prompt pass of a live server and take the peak device
memory around each (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, less what was allocated before, plus the
step's inputs), check that every cache leaf keeps its ``data_ptr`` across
the tick, and :func:`hold_measured` holds the measured peak inside the
traced floor and the plan's estimate (``chip_smoke.py``'s ``analysis``
phase, or this CLI on ``cuda`` where a card is present).

Run ``python -m repro_torch.analysis.memory_audit --smoke``: audits the
matrix, runs the planted-violation self-test (a compiler forced to
``donate_cache=False`` and a step that returns ``index_copy`` where the
model writes with ``index_copy_`` must flag; the in-place control and the
pure-recurrent family must not), merges a ``memory`` section into
``build/ANALYSIS_report_torch.json``, and exits non-zero on any finding or
self-test miss.

Adding a buffer class: classification lives in :func:`classify_leaves`,
which follows the step's flat argument order; a new input needs its class
there (and in ``DONATED_CLASSES`` if the step must write it in place).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.fx import GraphModule, Node

from repro_torch.analysis import Finding
from repro_torch.analysis.matrix import (DEVICE, PAGE_SIZE, POOL_ARENAS, REPORT_PATH,
                                         SMOKE_ARCHS, SMOKE_BUCKETS, SMOKE_DTYPES,
                                         matrix_meta, merge_report, smoke_cells)
from repro_torch.analysis.plan_audit import (alias_roots, alloc_bytes, cell_where,
                                             compile_cell, findings_json, is_mutation,
                                             node_val, output_nodes, placeholders,
                                             rebuild_cache_out_of_place, trace_cell)
from repro_torch.analysis.plan_audit import audit_cell as audit_plan_cell
from repro_torch.configs import get_config
from repro_torch.runtime.engine_config import EngineConfig
from repro_torch.runtime.graph_step import tick
from repro_torch.runtime.serve_loop import PlanServer, plan_step

# classes the step must write in place: the cache dict, split into the paged
# attention slot stacks and the per-row recurrent/conv state
DONATED_CLASSES = ("attention-slot-stack", "recurrent-state")


def classify_leaves(model, cache: Dict[str, Any], params: Dict[str, Any],
                    n_flat: int, has_tables: bool) -> List[Tuple[str, str]]:
    """(buffer class, leaf label) per flat step input, in the step's flat
    order: params in insertion order, the cache in insertion order (split by
    ``model.is_paged_cache_key``), then tokens / positions / page table.
    The one place a new step input gets its class."""
    out: List[Tuple[str, str]] = [("params", k) for k in params]
    for key in cache:
        cls = "attention-slot-stack" if model.is_paged_cache_key(key) else "recurrent-state"
        out.append((cls, key))
    out.append(("tokens", "tokens"))
    out.append(("positions", "pos"))
    if has_tables:
        out.append(("page-table", "tables"))
    assert n_flat == len(out), f"leaf map drift: {n_flat} != {len(out)}"
    return out


def written_in_place(gm: GraphModule) -> Set[Node]:
    """Placeholders that an in-place op writes through a view."""
    root = alias_roots(gm)
    out: Set[Node] = set()
    for n in gm.graph.nodes:
        if is_mutation(n) and n.args and isinstance(n.args[0], Node):
            target = root[n.args[0]]
            if target.op == "placeholder":
                out.add(target)
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def audit_cell(arch: str, dtype: str, batch: int, seq: int, *,
               page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
               decode_kernel: str = "auto", donate: bool = True, device: str = DEVICE,
               wrap=None) -> Tuple[Dict[str, Any], List[Finding]]:
    """Trace one decode cell as the server installs it and classify every
    input's lifetime from the graph. ``wrap`` plants a step (self-test)."""
    where = cell_where(arch, dtype, "decode", batch, seq, decode_kernel)
    _cfg, model, plan, _shape = compile_cell(arch, dtype, "decode", batch, seq, page=page,
                                             pool_arenas=pool_arenas,
                                             decode_kernel=decode_kernel, donate=donate)
    trace = trace_cell(model, plan, "decode", batch, seq, page=page, device=device,
                       wrap=wrap)
    gm = trace.gm
    params, cache = trace.args[0], trace.args[1]
    phs = placeholders(gm)
    labels = classify_leaves(model, cache, params, len(phs), has_tables=len(trace.args) > 4)
    written = written_in_place(gm)
    root = alias_roots(gm)
    returned = {root[o] for o in output_nodes(gm)}

    classes: Dict[str, Dict[str, Any]] = {}
    findings: List[Finding] = []
    in_bytes = inplace_bytes = 0
    for ph, (cls, label) in zip(phs, labels):
        nb = alloc_bytes(node_val(ph))
        in_bytes += nb
        # an empty leaf (a zero-layer stack) has nothing to double-buffer
        inplace = not nb or (ph in written and ph in returned)
        if inplace:
            inplace_bytes += nb
        rec = classes.setdefault(cls, {"bytes": 0, "leaves": 0, "inplace_leaves": 0,
                                       "lifetime": "double-buffered"})
        rec["bytes"] += nb
        rec["leaves"] += 1
        rec["inplace_leaves"] += int(inplace)
        if cls in DONATED_CLASSES and nb and not inplace:
            why = ("the step returns a fresh tensor for it" if ph not in returned
                   else "no in-place op writes it")
            findings.append(Finding(
                rule="cache-not-donated", where=where,
                detail=f"cache leaf {label!r} ({cls}) is not updated in place: {why} — "
                       f"the tick double-buffers it"))
    for rec in classes.values():
        rec["lifetime"] = ("in-place" if rec["leaves"] == rec["inplace_leaves"]
                           else "double-buffered")
    if not plan.config.donate_cache:
        findings.append(Finding(
            rule="cache-not-donated", where=where,
            detail=f"plan compiled without cache donation: its estimate charges a "
                   f"second {sum(r['bytes'] for c, r in classes.items() if c in DONATED_CLASSES)}B "
                   f"copy of the arena the in-place step never holds"))
    out_bytes = sum(alloc_bytes(node_val(o)) for o in dict.fromkeys(output_nodes(gm)))
    # inputs + outputs coexist, less the in-place pairs that share a buffer
    peak = in_bytes + out_bytes - inplace_bytes
    record = {
        "arch": arch, "dtype": dtype, "batch": batch, "seq": seq, "device": device,
        "decode_kernel": plan.config.decode_kernel,
        "forced_kernel": decode_kernel,
        "donate_cache": plan.config.donate_cache,
        "classes": classes,
        "input_bytes": int(in_bytes),
        "output_bytes": int(out_bytes),
        "inplace_bytes": int(inplace_bytes),
        "certified_peak_bytes": int(peak),
        "estimate_bytes": float(plan.memory.total),
        "findings": len(findings),
    }
    return record, findings


# ---------------------------------------------------------------------------
# on the card: measured peaks
# ---------------------------------------------------------------------------


def _measured(fn, input_bytes: int) -> Tuple[int, Any]:
    """(step peak, result): the allocator's peak during ``fn`` less what was
    allocated before it, plus the step's inputs (allocated before)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before + input_bytes, out


def measure_decode(srv, batch: int, context: int) -> Tuple[Dict[str, Any], List[Finding]]:
    """One eager decode tick of ``srv``'s (batch, context) decode entry on a
    leased arena with every row admitted for the whole bucket: the measured
    peak and the plan's estimate (the floor comes from the trace,
    :func:`hold_measured`), and a ``cache-not-donated`` finding for any
    cache leaf whose ``data_ptr`` moved across the tick."""
    entry = srv.decode_entry(batch, context)
    b, s = entry.key.batch_bucket, entry.key.seq_bucket
    where = cell_where(srv.cfg.name, srv.dtype_name, "decode", b, s)
    step = plan_step(srv.model, entry.plan, srv.page_size)
    arena = srv.pool.acquire(b, s, force=True)
    rows = srv.pool.admit_request_rows(arena, b, prompt=s - 1, span=s, eager=True)
    try:
        toks = torch.ones((b, 1), dtype=torch.int32, device=srv.device)
        pos = torch.full((b,), s - 2, dtype=torch.int32, device=srv.device)
        ptrs = {k: t.data_ptr() for k, t in arena.cache.items()}
        tables = arena.tables
        measured, _ = _measured(
            lambda: tick(step, srv.params, arena.cache, tables, toks, pos),
            alloc_bytes([srv.params, arena.cache, toks, pos, tables]))
        moved = sorted(k for k, t in arena.cache.items() if t.data_ptr() != ptrs[k])
    finally:
        srv.pool.free_rows(arena, rows)
        srv.pool.release(arena)
    record = {"where": where, "kind": "decode", "measured_bytes": int(measured),
              "floor_bytes": None, "estimate_bytes": float(entry.plan.memory.total),
              "cache_moved": moved}
    findings = []
    if moved:
        findings.append(Finding(
            rule="cache-not-donated", where=where,
            detail=f"cache leaves {moved} changed their data_ptr across the tick"))
    return record, findings


def measure_prefill(srv, batch: int, context: int) -> Tuple[Dict[str, Any], List[Finding]]:
    """One prompt pass of ``srv``'s (batch, context) prefill entry: the
    measured peak and the plan's estimate."""
    entry = srv.prefill_entry(batch, context)
    b, s = entry.key.batch_bucket, entry.key.seq_bucket
    batch_in = {"tokens": torch.ones((b, s), dtype=torch.int32, device=srv.device),
                "lengths": torch.full((b,), s, dtype=torch.int32, device=srv.device)}
    measured, out = _measured(lambda: entry.step_fn(srv.params, batch_in),
                              alloc_bytes([srv.params, batch_in]))
    del out
    record = {"where": cell_where(srv.cfg.name, srv.dtype_name, "prefill", b, s),
              "kind": "prefill", "measured_bytes": int(measured), "floor_bytes": None,
              "estimate_bytes": float(entry.plan.memory.total), "cache_moved": []}
    return record, []


def hold_measured(record: Dict[str, Any], floor_bytes: int) -> List[Finding]:
    """The measured peak against the traced floor of its cell (recorded
    into ``record``) and the plan's estimate."""
    record["floor_bytes"] = int(floor_bytes)
    where, measured = record["where"], record["measured_bytes"]
    findings: List[Finding] = []
    if measured > record["estimate_bytes"]:
        findings.append(Finding(
            rule="memory-under-estimate", where=where,
            detail=f"measured peak {measured}B on the card exceeds the plan's estimate "
                   f"{record['estimate_bytes']:.0f}B", data=record))
    if measured < floor_bytes:
        findings.append(Finding(
            rule="memory-under-estimate", where=where,
            detail=f"measured peak {measured}B is below the traced floor {floor_bytes}B: "
                   f"the trace does not describe the step the card ran", data=record))
    return findings


def measured_line(record: Dict[str, Any]) -> str:
    mib = 2.0 ** 20
    return (f"{record['where']}: measured {record['measured_bytes'] / mib:.2f} MiB, floor "
            f"{record['floor_bytes'] / mib:.2f} MiB, estimate "
            f"{record['estimate_bytes'] / mib:.2f} MiB")


def measure_servers(servers, floors: Optional[Dict[str, int]] = None, device: str = DEVICE,
                    log=print) -> Tuple[List[Dict[str, Any]], List[Finding]]:
    """One tick's and one prompt pass's measured peak per (server, (batch,
    context)) pair on the card, each held against its cell's floor
    (``floors`` by cell label, else traced here on fake ``device`` tensors)
    and the plan's estimate."""
    records: List[Dict[str, Any]] = []
    findings: List[Finding] = []
    floors = dict(floors or {})
    for srv, requests in servers:
        for batch, context in requests:
            for kind, measure in (("decode", measure_decode), ("prefill", measure_prefill)):
                rec, found = measure(srv, batch, context)
                if rec["where"] not in floors:
                    b, s = srv.buckets(batch, context)
                    cell, _ = audit_plan_cell(srv.cfg.name, srv.dtype_name, kind, b, s,
                                              page=srv.page_size,
                                              pool_arenas=srv.pool_arenas, device=device)
                    floors[rec["where"]] = cell["memory"]["floor_bytes"]
                found += hold_measured(rec, floors[rec["where"]])
                records.append(rec)
                findings += found
                if log:
                    log(f"  {measured_line(rec)}"
                        f"{'' if not found else ' ' + '; '.join(f.rule for f in found)}")
    return records, findings


# ---------------------------------------------------------------------------
# matrix + self-test
# ---------------------------------------------------------------------------


def run_audit(archs: Sequence[str] = SMOKE_ARCHS,
              dtypes: Sequence[str] = SMOKE_DTYPES,
              buckets: Sequence[Tuple[int, int]] = SMOKE_BUCKETS,
              page: int = PAGE_SIZE, pool_arenas: int = POOL_ARENAS,
              donate: bool = True, device: str = DEVICE,
              log=None) -> Tuple[List[Dict[str, Any]], List[Finding]]:
    cells: List[Dict[str, Any]] = []
    findings: List[Finding] = []
    for cell in smoke_cells(archs=archs, dtypes=dtypes, buckets=buckets,
                            kinds=("decode",), device=device):
        rec, found = audit_cell(cell.arch, cell.dtype, cell.batch, cell.seq, page=page,
                                pool_arenas=pool_arenas, decode_kernel=cell.forced_kernel,
                                donate=donate, device=device)
        cells.append(rec)
        findings.extend(found)
        if log:
            slot = rec["classes"].get("attention-slot-stack")
            state = rec["classes"].get("recurrent-state")
            log(f"  {cell.where}: slot-stack={slot['lifetime'] if slot else 'n/a'} "
                f"state={state['lifetime'] if state else 'n/a'} "
                f"peak={rec['certified_peak_bytes']}B {rec['findings']} finding(s)")
    return cells, findings


def selftest(arch: str = "yi-6b-smoke", device: str = DEVICE) -> Dict[str, Any]:
    """A plan compiled without donation and a step that rebuilds its cache
    out of place must flag; the in-place control and the pure-recurrent
    family must not."""
    _, clean = audit_cell(arch, "bfloat16", 2, 64, decode_kernel="paged", device=device)
    _, undonated = audit_cell(arch, "bfloat16", 2, 64, decode_kernel="paged", donate=False,
                              device=device)
    _, rebuilt = audit_cell(arch, "bfloat16", 2, 64, decode_kernel="paged", device=device,
                            wrap=rebuild_cache_out_of_place)
    _, rec_clean = audit_cell("mamba2-1.3b-smoke", "bfloat16", 2, 64,
                              decode_kernel="gather", device=device)
    return {
        "clean_control": not clean,
        "undonated_cache_flagged": any(f.rule == "cache-not-donated" for f in undonated),
        "out_of_place_cache_flagged": any(f.rule == "cache-not-donated" for f in rebuilt),
        "recurrent_state_in_place": not rec_clean,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="certify that every decode step updates its cache in place, from "
                    "the traced aten graph (and, on cuda with a card present, measured)")
    ap.add_argument("--smoke", action="store_true",
                    help="audit the smoke matrix (archs x dtypes x buckets x both forced "
                         "decode kernels) plus the planted self-test")
    ap.add_argument("--archs", nargs="*", default=None, help="override the arch list")
    ap.add_argument("--device", default=DEVICE,
                    help="device of the fake tensors traced (default cuda: the card's path)")
    ap.add_argument("--no-donate", action="store_true",
                    help="audit the un-donated configuration (every cell is expected "
                         "to flag)")
    ap.add_argument("--report", default=REPORT_PATH,
                    help=f"JSON report path (default {REPORT_PATH})")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the planted-violation self-test")
    args = ap.parse_args(argv)

    archs = tuple(args.archs) if args.archs else SMOKE_ARCHS
    print(f"memory_audit: {len(archs)} arch(s) x {len(SMOKE_DTYPES)} dtypes x "
          f"{len(SMOKE_BUCKETS)} buckets x 2 kernels on fake {args.device}")
    cells, findings = run_audit(archs=archs, donate=not args.no_donate, device=args.device,
                                log=print)
    measured: List[Dict[str, Any]] = []
    if args.device == "cuda" and torch.cuda.is_available():
        # a real card: serve each smoke arch and measure its peaks
        servers = [(PlanServer(get_config(a), config=EngineConfig(dtype=d, prefill=True)),
                    SMOKE_BUCKETS) for a in archs for d in SMOKE_DTYPES]
        measured, found = measure_servers(servers, device=args.device)
        findings += found

    st: Dict[str, Any] = {}
    if not args.no_selftest:
        st = selftest(device=args.device)
        for probe, ok in st.items():
            print(f"  selftest {probe}: {'ok' if ok else 'MISSED'}")
    merge_report(args.report, {"memory": {
        "matrix": matrix_meta(archs=archs, kernels=["paged", "gather"], device=args.device),
        "cells": cells,
        "measured": measured,
        "findings": findings_json(findings),
        "selftest": st,
    }})
    for f in findings:
        print(f)
    missed = [k for k, ok in st.items() if not ok]
    print(f"memory_audit: {len(cells)} cells, {len(findings)} finding(s), report -> "
          f"{args.report} [memory]")
    if missed:
        print(f"memory_audit: self-test MISSED: {', '.join(missed)}")
    return 1 if findings or missed else 0


if __name__ == "__main__":
    sys.exit(main())
