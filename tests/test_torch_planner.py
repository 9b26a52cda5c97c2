"""PyTorch port, plan compiler (``repro_torch/core/{strategies,memory,cost,
planner}.py``) against the reference's, given the same hardware figures:
the port gets a ``HardwareSpec`` built from the reference's ``TPU_V5E`` and,
through a fixture, the reference's paged-dispatch constant in place of the
H100's own. Over every architecture (full and smoke), the reference's
shapes plus serving buckets, all three meshes, page sizes 0, 16 and 64,
donated and un-donated decode and both compute dtypes, the two compilers
must give equal ``explain_axes()``, equal ``selection_trace()`` records
(floats to a relative 1e-12), equal ``estimate_memory`` classes and equal
``analytic_cost`` terms. The port's fit test also refuses any shape
``csrc/paged_decode.cu`` does not take (g <= 16, D <= 256), and then selects
``gather`` with the reason named; no arch of the registry has such a shape,
so every record equals the reference's (recurrentgemma-2b's g * D = 2560
included)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config_module  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import cost as jax_cost  # noqa: E402
from repro.core import memory as jax_memory  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core.strategies import RuntimeStats as JaxRuntimeStats  # noqa: E402
from repro_torch import config as port_config_module  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost as port_cost  # noqa: E402
from repro_torch.core import memory as port_memory  # noqa: E402
from repro_torch.core import planner as port_planner  # noqa: E402
from repro_torch.core.strategies import RuntimeStats  # noqa: E402
from repro_torch.hw import H100  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

torch.set_num_threads(2)
# the port's own figure, before the fixture replaces it in each test
PORT_DISPATCH_S = port_cost.PAGED_STEP_LATENCY_S
JAX_HW = jax_config_module.TPU_V5E
PORT_HW = port_config_module.HardwareSpec(**dataclasses.asdict(JAX_HW))
ARCHES = [a + s for a in ARCH_IDS for s in ("", "-smoke")]
MESHES = ("SINGLE_DEVICE_MESH", "SINGLE_POD_MESH", "MULTI_POD_MESH")
# the reference's shapes plus the serving buckets the smoke servers and the
# H100 smoke run use (decode and prefill)
SHAPES = [(s.name, s.seq_len, s.global_batch, s.kind)
          for s in jax_config_module.INPUT_SHAPES.values()] + [
    ("decode_b8x2048", 2048, 8, "decode"), ("decode_b1x1024", 1024, 1, "decode"),
    ("decode_b4x64", 64, 4, "decode"), ("decode_b2x128", 128, 2, "decode"),
    ("prefill_b2x128", 128, 2, "prefill")]


@pytest.fixture(autouse=True)
def _reference_dispatch_figure(monkeypatch):
    monkeypatch.setattr(port_cost, "PAGED_STEP_LATENCY_S", jax_cost.PAGED_STEP_LATENCY_S)


def _shapes(name, seq, batch, kind):
    return (jax_config_module.InputShape(name, seq, batch, kind),
            port_config_module.InputShape(name, seq, batch, kind))


def _kernel_takes(cfg) -> bool:
    g, d = cfg.q_per_kv, cfg.head_dim
    return g <= PA.MAX_GROUP and d <= PA.MAX_HEAD_DIM


def _same_record(ours: dict, ref: dict) -> None:
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, float):
            assert ours[k] == pytest.approx(v, rel=1e-12), k
        else:
            assert ours[k] == v, k


def _same_cost(ours, ref) -> None:
    assert [(t.name, t.physical) for t in ours.terms] == \
        [(t.name, t.physical) for t in ref.terms]
    for a, b in zip(ours.terms, ref.terms):
        assert (a.flops, a.hbm_bytes, a.collective_bytes) == pytest.approx(
            (b.flops, b.hbm_bytes, b.collective_bytes), rel=1e-12), a.name
    for k in ("compute_s", "memory_s", "collective_s", "flops", "hbm_bytes",
              "collective_bytes", "model_flops"):
        assert getattr(ours, k) == pytest.approx(getattr(ref, k), rel=1e-12), k
    assert ours.dominant == ref.dominant


def _same_memory(ours, ref) -> None:
    assert ours.per_device == pytest.approx(ref.per_device, rel=1e-12)
    assert ours.budget == ref.budget and ours.fits() == ref.fits()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHES)
def test_plans_equal_reference(arch, mesh):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jmesh, tmesh = getattr(jax_config_module, mesh), getattr(port_config_module, mesh)
    attention = 0
    # the paged kernel takes every arch's head shape (recurrentgemma-2b's
    # g * D = 2560 included), so no record differs from the reference's
    assert _kernel_takes(tcfg)
    for page in (0, 16, 64):
        for donate in (True, False):
            jc = jax_planner.PlanCompiler(JAX_HW, cache_pool_arenas=4, cache_page_size=page,
                                          donate_cache=donate)
            tc = port_planner.PlanCompiler(PORT_HW, cache_pool_arenas=4, cache_page_size=page,
                                           donate_cache=donate)
            for shape in SHAPES:
                jshape, tshape = _shapes(*shape)
                jrec = jc.selection_trace(jcfg, jshape)
                trec = tc.selection_trace(tcfg, tshape)
                _same_record(trec, jrec)
                attention += jrec["paged_s"] is not None
                for dtype in ("bfloat16", "float32"):
                    jp = jc.compile(jcfg, jshape, jmesh, dtype=dtype)
                    tp = tc.compile(tcfg, tshape, tmesh, dtype=dtype)
                    assert tp.explain_axes() == jp.explain_axes()
                    assert tp.config.notes == jp.config.notes
                    _same_memory(tp.memory, jp.memory)
                    _same_cost(tp.cost, jp.cost)
                    assert tp.explain() == jp.explain()
    # the sweep reaches the cost comparison wherever a paged decode bucket
    # has attention
    assert bool(attention) == (jcfg.layer_pattern().count("a") > 0)


@pytest.mark.parametrize("arch", ["yi-6b-smoke", "granite-8b", "mamba2-1.3b-smoke"])
@pytest.mark.parametrize("forced", ["paged", "gather", "ref"])
def test_forced_kernel_and_train_plans_equal_reference(arch, forced):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jc = jax_planner.PlanCompiler(JAX_HW, cache_page_size=16, decode_kernel=forced)
    tc = port_planner.PlanCompiler(PORT_HW, cache_page_size=16, decode_kernel=forced)
    for shape in SHAPES:
        jshape, tshape = _shapes(*shape)
        _same_record(tc.selection_trace(tcfg, tshape), jc.selection_trace(jcfg, tshape))
        for mesh in MESHES:
            jtrain = jax_config_module.TrainConfig(opt_state_dtype="bfloat16")
            ttrain = port_config_module.TrainConfig(opt_state_dtype="bfloat16")
            jp = jc.compile(jcfg, jshape, getattr(jax_config_module, mesh), jtrain)
            tp = tc.compile(tcfg, tshape, getattr(port_config_module, mesh), ttrain)
            assert tp.explain() == jp.explain()
            _same_cost(tp.cost, jp.cost)


@pytest.mark.parametrize("case", ["watermark", "outgrown", "committed", "pool"])
def test_recompile_equals_reference(case):
    """Dynamic recompilation with each kind of observed divergence,
    including a decode-kernel re-selection from observed page commitment."""
    arch = "yi-6b-smoke"
    jc = jax_planner.PlanCompiler(JAX_HW, cache_pool_arenas=2, cache_page_size=16)
    tc = port_planner.PlanCompiler(PORT_HW, cache_pool_arenas=2, cache_page_size=16)
    jshape, tshape = _shapes("decode_b4x1024", 1024, 4, "decode")
    jp = jc.compile(jax_config(arch), jshape, jax_config_module.SINGLE_DEVICE_MESH,
                    dtype="float32")
    tp = tc.compile(get_config(arch), tshape, port_config_module.SINGLE_DEVICE_MESH,
                    dtype="float32")
    kw = {"watermark": dict(watermark_bytes=3.0 * jp.memory.total),
          "outgrown": {},
          "committed": dict(committed_pages_per_row=1.0),
          "pool": dict(cache_pool_bytes=5.0 * jp.memory.per_device["kv_cache"])}[case]
    seen = (2048, 6) if case == "outgrown" else (1024, 4)
    jseen, tseen = _shapes("seen", seen[0], seen[1], "decode")
    jn = jc.recompile(jp, JaxRuntimeStats(shape=jseen, **kw))
    tn = tc.recompile(tp, RuntimeStats(shape=tseen, **kw))
    assert tn.explain() == jn.explain()
    assert tn.config.notes == jn.config.notes
    _same_memory(tn.memory, jn.memory)
    _same_cost(tn.cost, jn.cost)


@pytest.mark.parametrize("fn,args", [
    ("cache_page_count", (2048, 8, 64)), ("_cache_dense_bytes", (2048, 8)),
    ("_cache_eff_seq", (524_288,)), ("dtype_bytes", None)])
def test_memory_helpers_equal_reference(fn, args):
    for arch in ARCHES:
        if args is None:
            for name in ("float32", "bfloat16", "int8", "float8_e4m3fn", "unknown"):
                assert port_memory.dtype_bytes(name) == jax_memory.dtype_bytes(name)
            return
        assert getattr(port_memory, fn)(get_config(arch), *args) == \
            getattr(jax_memory, fn)(jax_config(arch), *args), arch
    assert (port_memory.ACT_BYTES, port_memory.PARAM_BYTES) == \
        (jax_memory.ACT_BYTES, jax_memory.PARAM_BYTES)


def test_roofline_terms_and_model_flops_equal_reference():
    for arch in ARCHES:
        for shape in SHAPES:
            jshape, tshape = _shapes(*shape)
            assert port_cost.model_flops_per_step(get_config(arch), tshape) == \
                jax_cost.model_flops_per_step(jax_config(arch), jshape)
    for per_chip in (False, True):
        args = (3e15, 4e12, 5e9, 8)
        _same_cost(port_cost.roofline_terms(*args, PORT_HW, model_flops=1e15,
                                            per_chip=per_chip),
                   jax_cost.roofline_terms(*args, JAX_HW, model_flops=1e15,
                                           per_chip=per_chip))


@pytest.mark.parametrize("num_heads,num_kv_heads,head_dim", [
    (64, 2, 128),    # g = 32 > 16
    (8, 8, 512),     # D = 512 > 256
    (17, 1, 64),     # g = 17 > 16
])
def test_paged_shape_beyond_the_kernel_selects_gather_with_the_reason(
        num_heads, num_kv_heads, head_dim):
    """On the H100's figures and on the reference's: ``auto`` never picks a
    paged kernel that would refuse the shape."""
    cfg = get_config("yi-6b-smoke").replace(num_heads=num_heads, num_kv_heads=num_kv_heads,
                                            head_dim=head_dim)
    shape = port_config_module.InputShape("b", 2048, 8, "decode")
    for hw in (H100, PORT_HW):
        rec = port_planner.PlanCompiler(hw, cache_page_size=64).selection_trace(cfg, shape)
        assert rec["kernel"] == "gather" and rec["vmem_fit"] is False
        assert rec["paged_s"] is None and rec["gather_s"] is None
        assert (f"got g={num_heads // num_kv_heads}, D={head_dim}") in rec["reason"]
        plan = port_planner.PlanCompiler(hw, cache_page_size=64).compile(
            cfg, shape, port_config_module.SINGLE_DEVICE_MESH)
        assert plan.config.decode_kernel == "gather"
    # within the limits the same bucket runs the cost comparison and picks
    # the paged kernel on the H100, at recurrentgemma's g = 10, D = 256 too
    for arch in ("yi-6b", "recurrentgemma-2b"):
        rec = port_planner.PlanCompiler(cache_page_size=64).selection_trace(
            get_config(arch), shape)
        assert rec["vmem_fit"] is True and rec["kernel"] == "paged", arch


def test_h100_is_the_default_and_its_dispatch_figure_is_the_ports_own():
    assert port_planner.PlanCompiler().hw is H100
    assert PORT_DISPATCH_S != jax_cost.PAGED_STEP_LATENCY_S
    assert port_cost.PAGED_STEP_LATENCY_S == jax_cost.PAGED_STEP_LATENCY_S  # the fixture
