"""PyTorch port, the pod-scale dry run (``launch/dryrun.py``, counterpart
of the reference's ``launch/dryrun.py`` and ``launch/hlo_analysis.py``).

- For every one of the 80 combinations (10 archs x 4 input shapes x 2 pod
  meshes) the plan the dry run records equals the reference planner's
  ``compile_plan``, the port given a ``HardwareSpec`` built from the
  reference's ``TPU_V5E`` figures and its paged dispatch figure, as
  ``tests/test_torch_planner.py`` does. Pure Python: nothing is traced.
- The depth extrapolation: ``tests/test_torch_dryrun_depth.py``; trace
  groups against gloo ranks' counts: ``tests/test_torch_dryrun_counts.py``.
- A record's keys are the reference's (two renamed); a full-size train,
  prefill and ``long_500k`` decode combination traces whole.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config_module  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import cost as jax_cost  # noqa: E402
from repro.core.planner import compile_plan as jax_compile_plan  # noqa: E402

from repro_torch import config as port_config_module  # noqa: E402
from repro_torch.config import INPUT_SHAPES, TrainConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import cost as port_cost  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

torch.set_num_threads(2)
JAX_HW = jax_config_module.TPU_V5E
PORT_HW = port_config_module.HardwareSpec(**dataclasses.asdict(JAX_HW))
COMBOS = [(a, s, mp) for mp in (False, True) for a in ARCH_IDS for s in INPUT_SHAPES]


@pytest.mark.parametrize("arch,shape,multi_pod", COMBOS,
                         ids=[f"{a}-{s}-{'2pod' if mp else '1pod'}" for a, s, mp in COMBOS])
def test_plan_fields_equal_reference_planner(monkeypatch, arch, shape, multi_pod):
    monkeypatch.setattr(port_cost, "PAGED_STEP_LATENCY_S", jax_cost.PAGED_STEP_LATENCY_S)
    got = dryrun.combo_plan(arch, shape, multi_pod, TrainConfig(), PORT_HW).config
    jmesh = jax_config_module.MULTI_POD_MESH if multi_pod else jax_config_module.SINGLE_POD_MESH
    want = jax_compile_plan(jax_config(arch), jax_config_module.INPUT_SHAPES[shape], jmesh,
                            jax_config_module.TrainConfig(), JAX_HW).config
    assert got.strategy.value == want.strategy.value
    assert dryrun.plan_fields(got) == dryrun.plan_fields(want)
    assert tuple(got.notes) == tuple(want.notes)


# -- records ---------------------------------------------------------------

# the reference record's keys (``repro/launch/dryrun.py::lower_combo`` and
# ``run_one``), less ``xla_cost_analysis``, with the port's two renames
REFERENCE_KEYS = {"arch", "shape", "mesh", "multi_pod", "strategy", "plan_notes", "plan",
                  "compile_seconds", "memory", "hlo_cost", "roofline", "planner_estimate",
                  "planner_cost", "ok"}
RENAMED = {"compile_seconds": "trace_seconds", "hlo_cost": "graph_cost"}
FULL_SIZE = [("yi-6b", "train_4k", False), ("llama3-405b", "prefill_32k", False),
             ("llama3-405b", "long_500k", True)]


@pytest.mark.parametrize("arch,shape,multi_pod", FULL_SIZE,
                         ids=[f"{a}-{s}" for a, s, _m in FULL_SIZE])
def test_full_size_combo_record(tmp_path, arch, shape, multi_pod):
    rec = dryrun.run_one(arch, shape, multi_pod, out_dir=str(tmp_path))
    assert rec["ok"], rec.get("error")
    assert {RENAMED.get(k, k) for k in REFERENCE_KEYS} <= set(rec)
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "peak_estimate_bytes", "hbm_budget"}
    assert set(rec["plan"]) == set(dryrun.plan_fields(
        dryrun.combo_plan(arch, shape, multi_pod).config))
    assert rec["mesh"] == ([2, 16, 16] if multi_pod else [16, 16])
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["roofline"]["useful_flops_ratio"] <= 1.5
    assert rec["graph_cost"]["flops"] > 0 and rec["graph_cost"]["hbm_bytes"] > 0
    assert rec["memory"]["peak_estimate_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["trace_seconds"] < 60
    assert (tmp_path / f"{dryrun.combo_tag(arch, shape, multi_pod)}.json").exists()


def test_production_mesh_is_traced_not_started():
    mesh = make_production_mesh(multi_pod=True, rank=300)
    assert mesh.cfg.axis_names == ("pod", "data", "model")
    assert mesh.coord == (1, 2, 12)
    assert (mesh.data_group.size, mesh.data_group.rank) == (32, 18)
    assert (mesh.model_group.size, mesh.model_group.rank) == (16, 12)
    assert not torch.distributed.is_initialized()
