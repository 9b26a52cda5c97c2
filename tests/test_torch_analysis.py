"""PyTorch port, the analysis layer (``repro_torch/analysis/{lint,matrix,
plan_audit,memory_audit,cost_audit}.py``) against the reference's
(``repro/analysis``).

- The linter: one seeded violation per ported rule, the waiver, and the
  port's own roots (``src/repro_torch``, ``chip_smoke.py``, ``tools/``)
  clean; rule ids are the reference's, letter for letter.
- The three audits traced on fake ``cuda`` tensors (the card's path, each
  kernel one custom-op node): clean on one decode and one prefill cell per
  family, their planted-violation self-tests flagged and their controls
  clean, and per cell the same rule ids as the reference's audits on the
  same cells (clean and planted), the reference run as
  ``tests/test_analysis.py`` runs it.
- The certified FLOP floor (MACs of ``mm``/``bmm``/``addmm``) equal to the
  reference's jaxpr floor on ``decode_kernel="gather"`` decode cells, where
  neither graph holds a kernel node: relative tolerance 1e-12 (both count
  the same products exactly).
- The decision audits and the trace-closure certificate equal to the
  reference's on the reference's hardware figures (``TPU_V5E`` copied into
  a port ``HardwareSpec``, the reference's paged-dispatch constant patched
  in, as ``tests/test_torch_planner.py`` does).
- The report goes to a ``tmp_path`` file (never the root
  ``ANALYSIS_report.json``); the measured-peak check on its own data.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config_module  # noqa: E402
from repro.analysis import cost_audit as ref_cost  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis import matrix as ref_matrix  # noqa: E402
from repro.analysis import memory_audit as ref_memory  # noqa: E402
from repro.analysis import plan_audit as ref_plan  # noqa: E402
from repro.core import cost as jax_cost  # noqa: E402
from repro_torch import config as port_config_module  # noqa: E402
from repro_torch.analysis import Finding  # noqa: E402
from repro_torch.analysis import cost_audit, lint, matrix, memory_audit, plan_audit  # noqa: E402
from repro_torch.core import cost as port_cost  # noqa: E402

torch.set_num_threads(2)

FAMILIES = ["yi-6b-smoke", "mamba2-1.3b-smoke", "recurrentgemma-2b-smoke"]
JAX_HW = jax_config_module.TPU_V5E
PORT_HW = port_config_module.HardwareSpec(**dataclasses.asdict(JAX_HW))


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------

TICK = "src/repro_torch/models/x.py"
SEEDED = [
    ("local-import", "def f():\n    import os\n    return os.getpid()\n",
     "src/repro_torch/core/x.py"),
    ("init-cache-outside-pool", "def f(m):\n    return m.init_cache(1, 8, 'cpu')\n",
     "src/repro_torch/runtime/engine.py"),
    ("init-cache-outside-pool", "def f(m):\n    return m.init_paged_cache(1, 8, 4, 'cpu')\n",
     "chip_smoke.py"),
    ("admission-outside-pool", "def f(a):\n    return a.alloc_rows(2)\n",
     "src/repro_torch/runtime/engine.py"),
    ("admission-outside-pool", "def f(a):\n    a.ensure_slot(0, 3)\n", "tools/x.py"),
    ("rid-mint", "def f(r):\n    r.rid = 3\n", "src/repro_torch/runtime/router.py"),
    ("rid-mint", "def f():\n    return next(_NEXT_RID)\n", "src/repro_torch/runtime/engine.py"),
    ("tracer-host-sync", "def f(x):\n    return x.item()\n", TICK),
    ("tracer-host-sync", "def f(x):\n    return x.tolist()\n", "src/repro_torch/kernels/x.py"),
    ("tracer-host-sync", "def f(x):\n    return x.cpu()\n",
     "src/repro_torch/runtime/serve_loop.py"),
    ("tracer-host-sync", "def f(x):\n    return float(x)\n",
     "src/repro_torch/runtime/graph_step.py"),
    ("tracer-host-sync", "def f(x):\n    return int(x.sum())\n", TICK),
    ("tracer-host-sync", "import numpy as np\n\ndef f(x):\n    return np.asarray(x)\n", TICK),
    ("plan-cache-mutation", "def f(c):\n    return c._entries\n", "src/repro_torch/runtime/x.py"),
    ("plan-axis-in-explain",
     "class PlanConfig:\n    a: int = 0\n    b: int = 0\n    notes: tuple = ()\n\n"
     "def explain_axes(c):\n    return {'a': c.a}\n", "src/repro_torch/core/strategies.py"),
]


@pytest.mark.parametrize("rule,src,path", SEEDED,
                         ids=[f"{r}-{i}" for i, (r, _s, _p) in enumerate(SEEDED)])
def test_lint_flags_each_seeded_violation(rule, src, path):
    assert _rules(lint.lint_source(src, path)) == {rule}


@pytest.mark.parametrize("src,path", [
    ("def f(m):\n    return m.init_cache(1, 8, 'cpu')\n", "src/repro_torch/runtime/kv_cache.py"),
    ("def f(a):\n    return a.alloc_rows(2)\n", "src/repro_torch/models/model.py"),
    ("def f(r):\n    r.rid = 3\n", "src/repro_torch/runtime/serve_loop.py"),
    ("def f(c):\n    return c._entries\n", "src/repro_torch/core/plan_cache.py"),
    ("def f(x):\n    return x.item()\n", "src/repro_torch/runtime/engine.py"),
    ("def f(x):\n    return float(2)\n", TICK),
], ids=["pool", "model", "serve_loop", "plan_cache", "off-tick-path", "constant"])
def test_lint_blessed_modules_and_off_path_code_pass(src, path):
    assert lint.lint_source(src, path) == []


def test_lint_waiver_suppresses_only_its_rule():
    src = ("def f(x):\n"
           "    import os  # lint: allow-local-import\n"
           "    return x.item()  # lint: allow-local-import\n")
    assert _rules(lint.lint_source(src, TICK)) == {"tracer-host-sync"}


def test_lint_rule_ids_are_the_reference_ids_less_use_after_donation():
    """The ported rules carry the reference's ids; ``use-after-donation`` is
    the one left out (the port deletes no buffer)."""
    ported = {f.rule for r, s, p in SEEDED for f in lint.lint_source(s, p)}
    ref_ids = {f.rule for r, s, p in SEEDED for f in ref_lint.lint_source(
        s, p.replace("repro_torch", "repro").replace("runtime/graph_step", "serve_loop"))}
    assert ported == ref_ids
    assert len(lint.LINT_RULES) == len(ref_lint.LINT_RULES) - 1
    assert "use-after-donation" not in {f.rule for f in lint.lint_source(
        "def f(e, c):\n    e.step_fn(p, c)\n    return c\n", "src/repro_torch/runtime/engine.py")}


def test_lint_clean_tree_is_green(tmp_path):
    """The gate: zero findings over the port's roots, deliberate exceptions
    waived in place; the CLI exits 0 and merges its section into the
    report."""
    found = lint.lint_paths(lint.DEFAULT_ROOTS)
    assert found == [], "\n".join(str(f) for f in found)
    report = tmp_path / "report.json"
    assert lint.main(["--report", str(report)]) == 0
    assert json.loads(report.read_text())["lint"]["findings"] == []


# ---------------------------------------------------------------------------
# the matrix and the report
# ---------------------------------------------------------------------------


def test_matrix_cells_equal_the_reference_and_trace_the_card():
    ours = list(matrix.smoke_cells())
    ref = list(ref_matrix.smoke_cells())
    assert [c.where for c in ours] == [c.where for c in ref]
    assert {c.device for c in ours} == {"cuda"}
    assert (matrix.SMOKE_ARCHS, matrix.SMOKE_DTYPES, matrix.SMOKE_BUCKETS, matrix.PAGE_SIZE,
            matrix.POOL_ARENAS) == (ref_matrix.SMOKE_ARCHS, ref_matrix.SMOKE_DTYPES,
                                    ref_matrix.SMOKE_BUCKETS, ref_matrix.PAGE_SIZE,
                                    ref_matrix.POOL_ARENAS)
    assert matrix.REPORT_PATH.endswith("build/ANALYSIS_report_torch.json")


def test_merge_report_preserves_sections_and_survives_corruption(tmp_path):
    path = tmp_path / "sub" / "report.json"
    matrix.merge_report(str(path), {"cells": [1]})
    matrix.merge_report(str(path), {"memory": {"cells": []}})
    assert json.loads(path.read_text()) == {"cells": [1], "memory": {"cells": []}}
    path.write_text("{not json")
    assert matrix.merge_report(str(path), {"cost": 2}) == {"cost": 2}


# ---------------------------------------------------------------------------
# the three audits on fake cuda: clean cells, self-tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind,batch,seq", [("decode", 1, 64), ("prefill", 4, 128)])
def test_plan_and_cost_audits_clean_on_the_card_path(arch, kind, batch, seq):
    """Zero findings; the estimate inside [floor, ceiling], the analytic
    FLOPs and traffic inside their sandwiches; prompt passes hold their
    family's kernel nodes (flash, SSD, RG-LRU scan; recurrentgemma's smoke
    pattern ``rr`` has no attention layer)."""
    rec, found = plan_audit.audit_cell(arch, "bfloat16", kind, batch, seq)
    assert found == [], "\n".join(map(str, found))
    mem = rec["memory"]
    assert mem["floor_bytes"] <= mem["estimate_bytes"] <= mem["ceiling_bytes"]
    if kind == "prefill":
        want = {"yi-6b-smoke": "flash_attention", "mamba2-1.3b-smoke": "ssd_scan",
                "recurrentgemma-2b-smoke": "rglru_scan"}[arch]
        assert rec["kernel_nodes"] == {f"repro_torch::{want}": 2}
    cost, found = cost_audit.audit_cell(arch, "bfloat16", kind, batch, seq)
    assert found == [], "\n".join(map(str, found))
    fl, tr = cost["flops"], cost["traffic"]
    assert fl["floor"] <= fl["analytic"] <= fl["ceiling"] and fl["traced_macs"] > 0
    assert tr["floor_bytes"] <= tr["analytic_bytes"] <= tr["ceiling_bytes"]
    assert (fl["kernel_flops"] > 0) == (kind == "prefill")


@pytest.mark.parametrize("arch", FAMILIES)
def test_memory_audit_certifies_in_place_cache(arch):
    """Every cache leaf is written in place by the traced decode step (and
    returned as itself); the certified peak counts one copy of the arena."""
    rec, found = memory_audit.audit_cell(arch, "bfloat16", 4, 128, decode_kernel="paged")
    assert found == [], "\n".join(map(str, found))
    for cls in memory_audit.DONATED_CLASSES:
        if cls in rec["classes"]:
            assert rec["classes"][cls]["lifetime"] == "in-place", rec["classes"]
    assert rec["certified_peak_bytes"] == (rec["input_bytes"] + rec["output_bytes"]
                                           - rec["inplace_bytes"])


def test_paged_decode_traces_the_kernel_and_gather_does_not():
    rec, _ = plan_audit.audit_cell("yi-6b-smoke", "bfloat16", "decode", 4, 128,
                                   decode_kernel="paged")
    assert rec["kernel_nodes"] == {"repro_torch::paged_decode_attention": 2}
    rec, _ = plan_audit.audit_cell("yi-6b-smoke", "bfloat16", "decode", 4, 128,
                                   decode_kernel="gather")
    assert rec["kernel_nodes"] == {}
    # the CPU path's prompt pass holds the plain attention, not the op
    rec, _ = plan_audit.audit_cell("yi-6b-smoke", "bfloat16", "prefill", 1, 64, device="cpu")
    assert rec["kernel_nodes"] == {}


@pytest.mark.parametrize("audit", [plan_audit, memory_audit, cost_audit],
                         ids=["plan", "memory", "cost"])
def test_selftest_flags_planted_violations_and_passes_controls(audit):
    probes = audit.selftest()
    assert probes and all(probes.values()), probes


# ---------------------------------------------------------------------------
# the same rule ids as the reference's audits on the same cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype,kind,batch,seq,kernel", [
    ("yi-6b-smoke", "bfloat16", "decode", 1, 64, "gather"),
    ("yi-6b-smoke", "float32", "decode", 4, 128, "paged"),
    ("mamba2-1.3b-smoke", "bfloat16", "prefill", 1, 64, "auto"),
    ("recurrentgemma-2b-smoke", "float32", "decode", 4, 128, "paged"),
])
def test_rule_ids_per_cell_equal_the_reference(arch, dtype, kind, batch, seq, kernel):
    cell = (arch, dtype, kind, batch, seq)
    _, ours = plan_audit.audit_cell(*cell, decode_kernel=kernel)
    _, ref = ref_plan.audit_cell(*cell, decode_kernel=kernel)
    assert _rules(ours) == _rules(ref)
    _, ours = cost_audit.audit_cell(*cell, decode_kernel=kernel, flop_scale=64.0)
    _, ref = ref_cost.audit_cell(*cell, decode_kernel=kernel, flop_scale=64.0)
    assert _rules(ours) == _rules(ref) == {"flop-over-estimate"}
    if kind == "decode":
        for donate in (True, False):
            _, ours = memory_audit.audit_cell(arch, dtype, batch, seq, decode_kernel=kernel,
                                              donate=donate)
            _, ref = ref_memory.audit_cell(arch, dtype, batch, seq, decode_kernel=kernel,
                                           donate=donate)
            assert _rules(ours) == _rules(ref)


def test_planted_rule_ids_equal_the_reference():
    """The planted float32 constant and host sync give the reference's ids
    (its planted host callback and the port's planted ``.item()``)."""
    cell = ("yi-6b-smoke", "bfloat16", "decode", 2, 64)
    _, ours = plan_audit.audit_cell(*cell, wrap=plan_audit._wrap_fp32_const)
    _, ref = ref_plan.audit_cell(*cell, wrap=ref_plan._wrap_fp32_const)
    assert _rules(ours) == _rules(ref) == {"dtype-leak"}
    _, ours = plan_audit.audit_cell(*cell, wrap=plan_audit._wrap_item)
    _, ref = ref_plan.audit_cell(*cell, wrap=ref_plan._wrap_host_callback)
    assert _rules(ours) == _rules(ref) == {"host-sync"}


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype,batch,seq", [("bfloat16", 1, 64), ("float32", 4, 128)])
def test_certified_flop_floor_equals_the_reference_on_gather_decode(arch, dtype, batch, seq):
    ours, _ = cost_audit.audit_cell(arch, dtype, "decode", batch, seq, decode_kernel="gather")
    ref, _ = ref_cost.audit_cell(arch, dtype, "decode", batch, seq, decode_kernel="gather")
    assert ours["flops"]["kernel_flops"] == 0
    assert ours["flops"]["traced_macs"] == pytest.approx(ref["flops"]["traced_macs"],
                                                         rel=1e-12)


# ---------------------------------------------------------------------------
# decision audits on the reference's hardware figures
# ---------------------------------------------------------------------------


def test_decision_audits_equal_the_reference_on_its_hardware(monkeypatch):
    monkeypatch.setattr(port_cost, "PAGED_STEP_LATENCY_S", jax_cost.PAGED_STEP_LATENCY_S)
    ours, ours_found = cost_audit.audit_decisions(hw=PORT_HW)
    ref, ref_found = ref_cost.audit_decisions()
    assert ours == ref
    assert [(f.rule, f.where) for f in ours_found] == [(f.rule, f.where) for f in ref_found]
    assert cost_audit._sweep_seqs() == ref_cost._sweep_seqs()
    # the selection checkers on the same doctored and honest data
    doctored = [(16, "gather"), (32, "paged"), (64, "gather"), (128, "paged")]
    for axis in ("seq", "committed_frac"):
        assert (_rules(cost_audit.check_selection_monotonic(doctored, "t", axis=axis))
                == _rules(ref_cost.check_selection_monotonic(doctored, "t", axis=axis)))


def test_trace_closure_certificate_equals_the_reference():
    from repro.runtime.engine_config import EngineConfig as RefEngineConfig

    from repro_torch.runtime.engine_config import EngineConfig
    for kw in ({}, {"prefill": True}, {"decode_kernel": "paged", "max_group_batch": 4}):
        ours, ours_found = cost_audit.trace_closure_certificate(EngineConfig(**kw))
        ref, ref_found = ref_cost.trace_closure_certificate(RefEngineConfig(**kw))
        assert ours == ref and ours_found == [] and ref_found == []


# ---------------------------------------------------------------------------
# measured peaks (the card's check on its own data)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("measured,rules", [
    (150, set()), (90, {"memory-under-estimate"}), (250, {"memory-under-estimate"})],
    ids=["inside", "below-floor", "above-estimate"])
def test_hold_measured_against_floor_and_estimate(measured, rules):
    rec = {"where": "cell", "measured_bytes": measured, "estimate_bytes": 200.0}
    found = memory_audit.hold_measured(rec, 100)
    assert _rules(found) == rules and rec["floor_bytes"] == 100
    assert all(isinstance(f, Finding) for f in found)


# ---------------------------------------------------------------------------
# the repairs the audits asked for: the H100's prompt-pass terms in
# core/memory.py and the SSD handoff product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,ssd", [("mamba2-1.3b", True), ("yi-6b", False),
                                      ("recurrentgemma-2b", False)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_h100_prefill_estimate_counts_the_eager_working_set(arch, ssd, dtype):
    """On the H100 (``hw.H100``'s name) a prompt pass's working set is
    counted at float32 (and 1.5 times that for the SSD family): the measured
    peak of Mamba-2's (8, 2048) pass exceeded the fused terms. Any other
    spec keeps the reference's terms (``tests/test_torch_planner.py`` holds
    them equal on the reference's figures); decode estimates do not move."""
    from repro_torch.config import SINGLE_DEVICE_MESH, InputShape, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import memory
    from repro_torch.core.strategies import PlanConfig, Strategy
    from repro_torch.hw import H100

    cfg = get_config(arch)
    fused_hw = dataclasses.replace(H100, name="h100-fused")
    plan = PlanConfig(strategy=Strategy.LOCAL)
    for kind in ("prefill", "decode"):
        shape = InputShape("t", 2048, 8, kind)
        eager = memory.estimate_memory(cfg, shape, SINGLE_DEVICE_MESH, plan, TrainConfig(),
                                       H100, dtype)
        fused = memory.estimate_memory(cfg, shape, SINGLE_DEVICE_MESH, plan, TrainConfig(),
                                       fused_hw, dtype)
        extra = eager.per_device["activations"] - fused.per_device["activations"]
        if kind == "decode":
            assert extra == 0
            continue
        nb = memory.dtype_bytes(dtype)
        working = 8 * 2048 * memory._layer_working_cols(cfg, 1, "full") * nb
        factor = (memory.EAGER_WORKING_BYTES / nb) * (memory.EAGER_SSD_FACTOR if ssd else 1.0)
        assert extra == pytest.approx(working * (factor - 1.0), rel=1e-12)


def test_ssd_handoff_state_never_expands_b_to_every_head():
    """The prompt pass's handoff state is one (H P, S) @ (S, N) product per
    row: no value of the traced graph has B's (B, H, S, N) expansion (it took
    512 MiB a layer at Mamba-2's (8, 2048) bucket)."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-1.3b-smoke")
    rec, _ = plan_audit.audit_cell(cfg.name, "bfloat16", "prefill", 4, 128)
    _, model, plan, _ = plan_audit.compile_cell(cfg.name, "bfloat16", "prefill", 4, 128)
    trace = plan_audit.trace_cell(model, plan, "prefill", 4, 128)
    expanded = (4, cfg.ssm_num_heads, 128, cfg.ssm_state)
    shapes = {tuple(t.shape) for n in trace.gm.graph.nodes
              for t in plan_audit.tensors(plan_audit.node_val(n))}
    assert expanded not in shapes
    assert rec["kernel_nodes"] == {"repro_torch::ssd_scan": cfg.num_layers}
