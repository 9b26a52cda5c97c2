"""PyTorch port, the sharding rules (``core/sharding.py``: ``spec_for``,
``tree_specs``; ``Model.param_specs`` / ``param_axes`` / ``cache_specs``;
``runtime/serve_loop.py::cache_shardings``; ``runtime/train_loop.py``:
``opt_state_specs``, ``opt_state_axes``, ``batch_specs``,
``train_shardings``) against the reference, with no process group.

Every spec must equal ``tuple()`` of the reference's ``PartitionSpec``,
entry for entry, for every arch id and its ``-smoke``, the four kinds
(param, opt, act, cache), every plan the port's planner yields for each of
``INPUT_SHAPES`` on a (2,) data mesh, a (4, 2) data x model mesh,
``SINGLE_POD_MESH`` and ``MULTI_POD_MESH``. The per-rank blocks of a few
specs are held against the reference's
``NamedSharding(...).devices_indices_map`` on 8 host devices and against
DTensor's own local-shard arithmetic.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from conftest import run_multidev  # noqa: E402
from torch.distributed.tensor import _utils as dtensor_utils  # noqa: E402

from repro import config as jax_config_module  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import sharding as jax_sharding  # noqa: E402
from repro.core.strategies import PlanConfig as JaxPlan  # noqa: E402
from repro.core.strategies import Strategy as JaxStrategy  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime import train_loop as jax_train_loop  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.config import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.core.planner import PlanCompiler  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serve_loop, train_loop  # noqa: E402

MESHES = {
    "data2": MeshConfig((2,), ("data",)),
    "data4-model2": MeshConfig((4, 2), ("data", "model")),
    "single-pod": port_config.SINGLE_POD_MESH,
    "multi-pod": port_config.MULTI_POD_MESH,
}
ARCHES = [a + s for a in ARCH_IDS for s in ("", "-smoke")]
PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the archs whose model the port builds
PORTED_ARCHES = [a for a in ARCHES if get_config(a).family in PORTED]
# activation axes the reference's model code constrains, beside batch_specs
ACT_AXES = (("batch", "seq", "embed"), ("batch", "seq", "q_heads", "head_dim"),
            ("batch", "seq", "ffn"), ("batch", "seq", "vocab"))


def _plans(cfg, mesh):
    """Every plan the port's planner yields for each input shape on ``mesh``,
    with the reference's twin of each."""
    out = []
    for shape in port_config.INPUT_SHAPES.values():
        for plan in PlanCompiler()._candidates(cfg, shape, mesh, TrainConfig()):
            kw = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
            kw["strategy"] = JaxStrategy(plan.strategy.value)
            out.append((shape, plan, JaxPlan(**kw)))
    return out


def _jax_mesh(mesh):
    return jax_config_module.MeshConfig(mesh.shape, mesh.axis_names)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _same(got, want, what):
    """A tree of port specs equals the reference's tree of PartitionSpecs."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
    elif isinstance(got, sharding.PartitionSpec):
        assert tuple(got) == tuple(want), (what, got, want)
    else:
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}/{i}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHES)
def test_param_and_opt_specs_equal_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, jcfg = get_config(arch), jax_config(arch)
    jm = jax_build(jcfg, dtype=jnp.bfloat16)
    jspecs, jaxes = jm.param_specs(), jm.param_axes()
    shapes = {k: _meta(s.shape) for k, s in jspecs.items()}
    if cfg.family in PORTED:
        model = build_model(cfg, dtype=torch.bfloat16)
        assert model.param_axes() == jaxes
        assert {k: tuple(v.shape) for k, v in model.param_specs().items()} == \
            {k: tuple(s.shape) for k, s in jspecs.items()}
        assert all(v.device.type == "meta" and v.dtype == torch.bfloat16
                   for v in model.param_specs().values())
    for _shape, plan, jplan in _plans(cfg, mesh):
        jmesh = _jax_mesh(mesh)
        _same(sharding.tree_specs(shapes, jaxes, plan, mesh, "param"),
              jax_sharding.tree_specs(jspecs, jaxes, jplan, jmesh, "param"), "param")
        for opt in ("adam", "sgd_momentum"):
            ospecs = train_loop.opt_state_specs(opt, shapes, plan)
            jospecs = jax_train_loop.opt_state_specs(opt, jspecs, jplan)
            oaxes = train_loop.opt_state_axes(opt, jaxes)
            assert oaxes == jax_train_loop.opt_state_axes(opt, jaxes)
            for k in jospecs:
                assert [tuple(s.shape) for s in ospecs[k]] == [s.shape for s in jospecs[k]]
                for s, js, a in zip(ospecs[k], jospecs[k], oaxes[k]):
                    assert tuple(sharding.spec_for(tuple(s.shape), a, plan, mesh, "opt")) == \
                        tuple(jax_sharding.spec_for(js.shape, a, jplan, jmesh, "opt"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", PORTED_ARCHES)
def test_train_shardings_equal_reference_on_ported_families(arch, mesh_name):
    """``train_shardings``' specs for the families the port builds against
    the reference's rules over its model's specs."""
    cfg = get_config(arch)
    mesh = MESHES[mesh_name]
    model = build_model(cfg, dtype=torch.float32)
    jm = jax_build(jax_config(arch), dtype=jnp.float32)
    for _shape, plan, jplan in _plans(cfg, mesh)[:6]:
        for opt in ("adam", "sgd"):
            train = TrainConfig(optimizer=opt)
            (ps, pp, psh), (os_, op, osh) = train_loop.train_shardings(model, plan, mesh, train)
            jpp = jax_sharding.tree_specs(jm.param_specs(), jm.param_axes(), jplan,
                                          _jax_mesh(mesh), "param")
            _same(pp, jpp, "param")
            assert psh is None and osh is None
            assert all(len(op[k]) == len(os_[k]) for k in op)
            for k in op:
                for spec in op[k]:
                    assert tuple(spec) == tuple(pp[k])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHES)
def test_act_and_batch_specs_equal_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg = get_config(arch)
    for shape, plan, jplan in _plans(cfg, mesh):
        jmesh = _jax_mesh(mesh)
        b, s = shape.global_batch, shape.seq_len
        like = {"tokens": (b, s), "targets": (b, s)}
        if cfg.frontend == "vision":
            like["patch_embeds"] = (b, cfg.num_frontend_tokens, cfg.d_model)
        if cfg.is_encdec:
            like["frames"] = (b, cfg.encoder_seq, cfg.d_model)
        got = train_loop.batch_specs({k: _meta(v) for k, v in like.items()}, plan, mesh)
        want = jax_train_loop.batch_specs({k: _ShapeOnly(v) for k, v in like.items()},
                                          jplan, jmesh)
        _same(got, want, "batch")
        for axes in ACT_AXES:
            dims = {"batch": b, "seq": s, "embed": cfg.d_model, "q_heads": cfg.num_heads,
                    "head_dim": cfg.head_dim, "ffn": cfg.d_ff, "vocab": cfg.vocab_size}
            shp = tuple(dims[a] for a in axes)
            assert tuple(sharding.spec_for(shp, axes, plan, mesh, "act")) == \
                tuple(jax_sharding.spec_for(shp, axes, jplan, jmesh, "act"))


class _ShapeOnly:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHES)
def test_cache_specs_and_cache_shardings_equal_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg, jcfg = get_config(arch), jax_config(arch)
    jm = jax_build(jcfg, dtype=jnp.bfloat16)
    ported = cfg.family in PORTED
    model = build_model(cfg, dtype=torch.bfloat16) if ported else None
    for shape, plan, jplan in _plans(cfg, mesh):
        if shape.kind == "train":
            continue
        b, s = shape.global_batch, min(shape.seq_len, 4096)
        jspecs, jaxes = jm.cache_specs(b, s)
        want = jax_sharding.tree_specs(jspecs, jaxes, jplan, _jax_mesh(mesh), "cache")
        if ported:
            specs, axes = model.cache_specs(b, s)
            assert axes == jaxes
            assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == \
                {k: (tuple(v.shape), getattr(torch, str(v.dtype))) for k, v in jspecs.items()}
            _specs, parts, shards = serve_loop.cache_shardings(model, b, s, plan, mesh)
            assert shards is None
        else:
            parts = sharding.tree_specs({k: _meta(v.shape) for k, v in jspecs.items()}, jaxes,
                                        plan, mesh, "cache")
        _same(parts, want, "cache")


def test_spec_for_rejects_rank_mismatch_as_reference():
    plan = PlanCompiler()._candidates(get_config("yi-6b"), port_config.INPUT_SHAPES["train_4k"],
                                      MESHES["data2"], TrainConfig())
    with pytest.raises(ValueError, match="logical axes"):
        sharding.spec_for((2, 3), ("embed",), next(plan), MESHES["data2"])


def test_placements_follow_the_spec_and_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    spec = sharding.PartitionSpec(None, ("pod", "data"), "model")
    assert sharding.placements_for(spec, names) == (Shard(1), Shard(1), Shard(2))
    assert sharding.placements_for(sharding.PartitionSpec("data", None), names) == \
        (Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements_for(sharding.PartitionSpec(("data", "pod")), names)


def test_production_mesh_raises_and_mesh_cfg_is_the_reference():
    from repro.launch import mesh as jax_mesh_module

    # the pod meshes are traced: one rank's view, its groups trace groups,
    # and no process group is started
    for multi in (False, True):
        traced = port_mesh.make_production_mesh(multi_pod=multi)
        assert traced.cfg == port_mesh.mesh_cfg_for(multi_pod=multi)
        assert traced.model_group.size == 16
        assert traced.data_group.size == (32 if multi else 16)
    assert not torch.distributed.is_initialized()
    for multi in (False, True):
        assert dataclasses.asdict(port_mesh.mesh_cfg_for(multi_pod=multi)) == \
            dataclasses.asdict(jax_mesh_module.mesh_cfg_for(multi_pod=multi))
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_local_mesh("cpu")
    assert port_mesh.choose_backend("cpu", 2) == "gloo"
    assert port_mesh.choose_backend("cuda", 2) == "gloo"        # no card here


# ---------------------------------------------------------------------------
# per-rank blocks: the reference's devices_indices_map on 8 host devices
# ---------------------------------------------------------------------------

# (mesh shape, axis names, tensor shape, spec)
SLICE_CASES = (
    ((2,), ("data",), (64, 48), ("data", None)),
    ((2,), ("data",), (6, 64, 8), (None, "data", None)),
    ((4, 2), ("data", "model"), (16, 8, 12), ("data", None, "model")),
    ((4, 2), ("data", "model"), (8, 16), (("data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 12, 6), (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (4, 16), (None, ("pod", "data", "model"))),
    ((2, 2, 2), ("pod", "data", "model"), (4, 8), ("data", "pod")),
)

_SLICE_SCRIPT = """
import json, numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads({cases!r})
out = []
for mesh_shape, names, shape, spec in cases:
    n = int(np.prod(mesh_shape))
    mesh = jax.make_mesh(tuple(mesh_shape), tuple(names), devices=jax.devices()[:n])
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    blocks = []
    for coord in np.ndindex(*mesh_shape):
        d = mesh.devices[coord]
        blocks.append([[s.start or 0, s.stop if s.stop is not None else shape[i]]
                       for i, s in enumerate(idx[d])])
    out.append(blocks)
print("BLOCKS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_blocks():
    out = run_multidev(_SLICE_SCRIPT.format(cases=json.dumps(SLICE_CASES)), n=8, timeout=240)
    return json.loads(out.split("BLOCKS", 1)[1])


@pytest.mark.parametrize("case", range(len(SLICE_CASES)))
def test_rank_blocks_equal_reference_devices_indices_map(reference_blocks, case):
    mesh_shape, names, shape, spec = SLICE_CASES[case]
    pspec = sharding.PartitionSpec(*spec)
    placements = sharding.placements_for(pspec, names)
    for coord, want in zip(np.ndindex(*mesh_shape), reference_blocks[case]):
        got = sharding.shard_slices(shape, placements, mesh_shape, coord)
        assert [[s.start, s.stop] for s in got] == want, (coord, got, want)
        local, offset = dtensor_utils._compute_local_shape_and_global_offset(
            shape, mesh_shape, list(coord), placements)
        assert [[o, o + n] for o, n in zip(offset, local)] == want, coord
