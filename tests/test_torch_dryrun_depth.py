"""PyTorch port, the dry run's depth (``launch/dryrun.py``): on smoke
widths, every count extrapolated from two and three periods of a stack's
layer pattern (``depth_plan``: the ``rra`` period for RecurrentGemma with
the layers past the last whole period, Whisper's encoder and decoder
apart) equals a trace of the whole depth: FLOPs, HBM bytes and collective
calls and bytes exactly, the peak within 1 %. One rank of a (2, 2) mesh,
traced on fake tensors.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import TracedMesh  # noqa: E402

from _torch_dryrun_plans import plan_of  # noqa: E402

torch.set_num_threads(2)

SMALL = MeshConfig((2, 2), ("data", "model"))
B, S = 4, 64
HEADS = {"cache_heads_over_model": True}
DEPTH_CASES = [
    ("yi-6b-smoke", {"num_layers": 5}, "train", {"seq_shard_checkpoints": True}),
    ("yi-6b-smoke", {"num_layers": 5}, "prefill", HEADS),
    ("yi-6b-smoke", {"num_layers": 5}, "decode", HEADS),
    ("mamba2-1.3b-smoke", {"num_layers": 4}, "train", {}),
    ("recurrentgemma-2b-smoke", {"num_layers": 14, "block_pattern": "rra"}, "prefill",
     {"cache_seq_axes": ("model",)}),
    ("recurrentgemma-2b-smoke", {"num_layers": 14, "block_pattern": "rra"}, "decode",
     {"cache_seq_axes": ("model",)}),
    ("qwen3-moe-235b-a22b-smoke", {"num_layers": 4}, "train", {}),
    ("whisper-medium-smoke", {"num_layers": 4, "encoder_layers": 5}, "train", {}),
    ("whisper-medium-smoke", {"num_layers": 4, "encoder_layers": 5}, "decode", HEADS),
]


@pytest.mark.parametrize("arch,cut,kind,fields", DEPTH_CASES,
                         ids=[f"{a}-{k}" for a, _c, k, _f in DEPTH_CASES])
def test_period_extrapolation_equals_full_depth_trace(arch, cut, kind, fields):
    cfg = dataclasses.replace(get_config(arch), **cut)
    plan = plan_of(cfg, kind, fields, SMALL, B, S)
    mesh = TracedMesh(SMALL, (1, 1))
    traced = {}
    for full in (False, True):
        traced[full], _cuts = dryrun.trace_combo(cfg, plan, mesh, TrainConfig(), full)
    got, want = traced[False], traced[True]
    assert got.flops == want.flops
    assert got.hbm_bytes == want.hbm_bytes
    assert got.collectives == want.collectives
    assert got.collective_calls == want.collective_calls
    assert want.collective_count > 0
    peak_got, peak_want = got.memory["peak_estimate_bytes"], want.memory["peak_estimate_bytes"]
    assert abs(peak_got - peak_want) <= 0.01 * peak_want
