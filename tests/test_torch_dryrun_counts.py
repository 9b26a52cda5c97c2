"""PyTorch port, the dry run's trace groups (``core/comm.TraceGroup``): the
collective calls, bytes and traffic a rank's step counts over trace
groups (``analysis/plan_audit.trace_cell`` on a ``launch/mesh.TracedMesh``)
equal what gloo CPU ranks count running the same train step, prompt pass
and decode tick on (1, 2) and (2, 2) meshes (``_torch_ranks.dryrun_count_case``).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.plan_audit import trace_cell  # noqa: E402
from repro_torch.config import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import TracedMesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

from _torch_dryrun_plans import plan_of  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402

torch.set_num_threads(2)
B, S = 4, 64
HEADS = {"cache_heads_over_model": True}

COUNT_ARCH = "yi-6b-smoke"
COUNT_CASES = [("train", {"strategy": "fsdp_tensor_parallel", "seq_shard_checkpoints": True}),
               ("train", {"strategy": "dp_tensor_parallel"}),
               ("prefill", HEADS), ("prefill", dict(HEADS, seq_axes=("model",))),
               ("decode", HEADS)]
COUNT_MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    return {mesh: run_ranks("dryrun_count_case", mesh[0] * mesh[1],
                            tmp_path_factory.mktemp("c"), COUNT_ARCH, mesh, COUNT_CASES, B, S)
            for mesh in COUNT_MESHES}


@pytest.mark.parametrize("mesh_shape", COUNT_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", range(len(COUNT_CASES)),
                         ids=[f"{k}-{i}" for i, (k, _f) in enumerate(COUNT_CASES)])
def test_trace_group_counts_equal_gloo_ranks(gloo_counts, mesh_shape, case):
    kind, fields = COUNT_CASES[case]
    cfg = get_config(COUNT_ARCH)
    mesh_cfg = MeshConfig(mesh_shape, ("data", "model"))
    plan = plan_of(cfg, kind, fields, mesh_cfg, B, S)
    model = build_model(cfg, dtype=torch.float32)
    for rank, outs in enumerate(gloo_counts[mesh_shape]):
        coord = (rank // mesh_shape[1], rank % mesh_shape[1])
        trace = trace_cell(model, plan, kind, B, S, mesh=TracedMesh(mesh_cfg, coord),
                           train=TrainConfig(), device="cpu")
        assert trace.gm is not None
        want = {k: {op: n for op, n in c.items() if n} for k, c in outs[case].items()}
        got = {k: {op: n for op, n in c.items() if n} for k, c in trace.collectives.items()}
        assert got == want, (rank, kind)
        assert got["calls"]
