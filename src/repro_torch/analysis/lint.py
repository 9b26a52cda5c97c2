"""Invariant linter: AST rules for the conventions the port's runtime relies
on (port of ``repro/analysis/lint.py``, retargeted at ``src/repro_torch``,
``chip_smoke.py`` and ``tools/``; rule ids are the reference's):

- ``init-cache-outside-pool`` — decode caches are built only by
  :class:`~repro_torch.runtime.kv_cache.KVCachePool` (``model.init_cache`` /
  ``init_paged_cache`` anywhere else bypasses arena recycling and the byte
  budget).
- ``admission-outside-pool`` — row/page admission goes through
  ``KVCachePool.admit_request_rows``; direct ``alloc_rows`` / ``admit_row`` /
  ``ensure_slot`` calls skip the budget and reservation accounting.
- ``rid-mint`` — ``ServeRequest.rid`` is stamped once at construction;
  assigning ``.rid`` or touching ``_NEXT_RID`` elsewhere breaks handle
  identity across the engine and the router.
- ``local-import`` — imports live at module top level; function-local
  imports hide layering cycles and re-resolve on the hot path. Waive the
  deliberate ones with ``# lint: allow-local-import``.
- ``tracer-host-sync`` — tick-path modules (``models/``, ``kernels/``,
  ``serve_loop``, ``runtime/graph_step``) must not call ``.item()``,
  ``.tolist()``, ``.cpu()``, ``float()`` / ``int()`` or ``np.asarray`` /
  ``np.array`` on what may be a tensor: each is a device sync in the decode
  tick (and a capture error inside a CUDA graph).
- ``plan-cache-mutation`` — :class:`~repro_torch.core.plan_cache.PlanCache`
  owns its entry dict; reaching into ``._entries`` bypasses LRU metrics and
  capacity accounting.
- ``plan-axis-in-explain`` — every ``PlanConfig`` field except ``notes`` is
  a plan axis and must be read by an ``explain_axes()`` / ``explain()``
  renderer in the same module (``core/strategies.py``).

The reference's ``use-after-donation`` is not ported: it guards a cache
reference handed to a donating jitted step, whose buffer XLA deletes. The
port donates nothing and deletes no buffer — its decode step writes the
arena's tensors in place — so there is no read to guard; the memory
auditor's in-place check (``analysis/memory_audit.py``) stands in its place.

A finding on line N is suppressed by the marker ``# lint: allow-<rule>`` on
that line. Run ``python -m repro_torch.analysis.lint``; exit status 0 means
a clean tree. The findings also land in the ``lint`` section of
``build/ANALYSIS_report_torch.json``.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from repro_torch.analysis import Finding
from repro_torch.analysis.matrix import REPORT_PATH, merge_report

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py", "tools")

# files allowed to call the guarded cache/admission/rid primitives: the
# modules that define them
CACHE_BLESSED = ("runtime/kv_cache.py", "models/model.py")
RID_BLESSED = ("runtime/serve_loop.py",)
PLAN_CACHE_BLESSED = ("core/plan_cache.py",)
TICK_PATH = ("models/", "kernels/", "serve_loop", "runtime/graph_step")

ADMISSION_CALLS = ("alloc_rows", "admit_row", "ensure_slot")
HOST_SYNC_CALLS = ("asarray", "array")
HOST_SYNC_METHODS = ("item", "tolist", "cpu")


def _blessed(path: str, suffixes: Sequence[str]) -> bool:
    norm = path.replace("\\", "/")
    return any(norm.endswith(s) for s in suffixes)


def _tick_path(path: str) -> bool:
    norm = path.replace("\\", "/")
    return any(t in norm for t in TICK_PATH)


def _waived(src_lines: Sequence[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(src_lines):
        return f"# lint: allow-{rule}" in src_lines[lineno - 1]
    return False


class _Ctx:
    """One file's parse: source lines, numpy aliases, finding sink."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.lines = src.splitlines()
        self.tree = ast.parse(src)
        self.findings: List[Finding] = []
        self.np_aliases = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "numpy":
                        self.np_aliases.add(a.asname or "numpy")

    def report(self, rule: str, node: ast.AST, detail: str) -> None:
        lineno = getattr(node, "lineno", 0)
        if _waived(self.lines, lineno, rule):
            return
        self.findings.append(Finding(rule=rule, where=f"{self.path}:{lineno}",
                                     detail=detail))


Rule = Callable[[_Ctx], None]
LINT_RULES: List[Rule] = []


def rule(fn: Rule) -> Rule:
    LINT_RULES.append(fn)
    return fn


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@rule
def local_import(ctx: _Ctx) -> None:
    """Imports belong at module scope; a function-body import is a hidden
    cycle or hot-path re-resolution."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for inner in ast.walk(node):
            if isinstance(inner, (ast.Import, ast.ImportFrom)):
                names = ", ".join(a.name for a in inner.names)
                ctx.report("local-import", inner, f"import of {names} inside {node.name}()")


@rule
def init_cache_outside_pool(ctx: _Ctx) -> None:
    if _blessed(ctx.path, CACHE_BLESSED):
        return
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("init_cache", "init_paged_cache")):
            ctx.report("init-cache-outside-pool", node,
                       f".{node.func.attr}() called outside KVCachePool; lease an arena "
                       f"(pool.acquire / admit_request_rows) instead")


@rule
def admission_outside_pool(ctx: _Ctx) -> None:
    if _blessed(ctx.path, CACHE_BLESSED):
        return
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ADMISSION_CALLS):
            ctx.report("admission-outside-pool", node,
                       f".{node.func.attr}() bypasses KVCachePool.admit_request_rows "
                       f"accounting")


@rule
def rid_mint(ctx: _Ctx) -> None:
    if _blessed(ctx.path, RID_BLESSED):
        return
    for node in ast.walk(ctx.tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "rid":
                ctx.report("rid-mint", node,
                           "assignment to .rid outside ServeRequest construction")
        if isinstance(node, ast.Name) and node.id == "_NEXT_RID":
            ctx.report("rid-mint", node, "_NEXT_RID touched outside serve_loop")


@rule
def tracer_host_sync(ctx: _Ctx) -> None:
    if not _tick_path(ctx.path):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in HOST_SYNC_METHODS and not node.args:
            ctx.report("tracer-host-sync", node,
                       f".{fn.attr}() reads a device value on the host in the tick path")
        elif (isinstance(fn, ast.Name) and fn.id in ("float", "int")
                and len(node.args) == 1 and not isinstance(node.args[0], ast.Constant)):
            ctx.report("tracer-host-sync", node,
                       f"{fn.id}() on a possible tensor in the tick path")
        elif (isinstance(fn, ast.Attribute) and fn.attr in HOST_SYNC_CALLS
                and isinstance(fn.value, ast.Name) and fn.value.id in ctx.np_aliases):
            ctx.report("tracer-host-sync", node,
                       f"{fn.value.id}.{fn.attr}() materializes to host in the tick path")


@rule
def plan_axis_in_explain(ctx: _Ctx) -> None:
    """Each PlanConfig axis must be rendered by explain_axes()/explain(),
    in modules that define ``class PlanConfig``: the annotated fields minus
    ``notes``, read as an attribute by an ``explain_axes`` / ``explain``
    function of the module."""
    plan_cls = next((n for n in ast.walk(ctx.tree)
                     if isinstance(n, ast.ClassDef) and n.name == "PlanConfig"), None)
    if plan_cls is None:
        return
    fields = [s for s in plan_cls.body
              if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
              and s.target.id != "notes"]
    renderers = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and n.name in ("explain_axes", "explain")]
    if not renderers:
        ctx.report("plan-axis-in-explain", plan_cls,
                   "module defines PlanConfig but no explain_axes()/explain() renderer; "
                   "plan decisions have no EXPLAIN surface")
        return
    rendered = {node.attr for fn in renderers
                for node in ast.walk(fn) if isinstance(node, ast.Attribute)}
    for f in fields:
        if f.target.id not in rendered:
            ctx.report("plan-axis-in-explain", f,
                       f"PlanConfig field {f.target.id!r} is a plan axis but is never "
                       f"read by explain_axes()/explain() — the decision cannot be "
                       f"surfaced by EXPLAIN")


@rule
def plan_cache_mutation(ctx: _Ctx) -> None:
    if _blessed(ctx.path, PLAN_CACHE_BLESSED):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute) and node.attr == "_entries":
            ctx.report("plan-cache-mutation", node,
                       "PlanCache._entries reached from outside; use the cache API "
                       "(get/get_or_compile/invalidate)")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(src: str, path: str = "<memory>") -> List[Finding]:
    """Run every rule over one source string (the self-test surface)."""
    ctx = _Ctx(path, src)
    for r in LINT_RULES:
        r(ctx)
    return ctx.findings


def lint_paths(roots: Sequence[str], repo_root: Optional[Path] = None) -> List[Finding]:
    repo_root = repo_root or REPO_ROOT
    findings: List[Finding] = []
    for root in roots:
        base = repo_root / root
        if not base.exists():
            continue
        files = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for f in files:
            rel = f.relative_to(repo_root).as_posix()
            try:
                src = f.read_text()
            except (OSError, UnicodeDecodeError) as e:
                findings.append(Finding(rule="unreadable", where=rel, detail=str(e)))
                continue
            try:
                findings.extend(lint_source(src, rel))
            except SyntaxError as e:
                findings.append(Finding(rule="syntax-error", where=rel, detail=str(e)))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="project invariant linter (repro_torch.analysis)")
    ap.add_argument("roots", nargs="*", default=list(DEFAULT_ROOTS),
                    help="paths (relative to the repository root) to scan")
    ap.add_argument("--json", metavar="PATH", help="also write findings as JSON")
    ap.add_argument("--report", default=REPORT_PATH,
                    help=f"analysis report the findings are merged into (default "
                         f"{REPORT_PATH})")
    args = ap.parse_args(argv)
    roots = args.roots or DEFAULT_ROOTS
    findings = lint_paths(roots)
    for f in findings:
        print(f)
    found = [{"rule": f.rule, "where": f.where, "detail": f.detail} for f in findings]
    if args.json:
        Path(args.json).write_text(json.dumps(found, indent=2))
    merge_report(args.report, {"lint": {"roots": list(roots), "rules": len(LINT_RULES),
                                        "findings": found}})
    print(f"lint: {len(findings)} finding(s) over {len(LINT_RULES)} rules in "
          f"{', '.join(roots)}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
