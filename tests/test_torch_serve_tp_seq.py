"""PyTorch port, serving under a model axis with the decode cache split
along its sequence (``cache_seq_axes = ("model",)``, the planner's layout
where the kv heads do not divide the model axis), against the reference's
one-device ``prefill`` and ``decode_step`` (``tests/_torch_serve_ref.py``).

``yi-6b-smoke`` (2 kv heads) on 4 gloo CPU ranks as a (1, 4) mesh: each
rank holds every kv head of a quarter of the slots; the prompt pass hands
each rank its slots, a tick writes the new K/V on the rank whose slot it
is and merges the ranks' partial attention (``ShardCtx.merge_attention``:
an all-reduce of each row's max, then one of the numerators and
denominators). A paged layout of such a cache raises.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (BATCH, BUCKET, SEQ, check_serve_run,  # noqa: E402
                              serve_params, serve_rank_runs)

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"
RUNS = {"1x4": (ARCH, (), None, (1, 4), [("seq-dense", SEQ, "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_seq_cache_equals_reference(rank_runs, run, name):
    outs = check_serve_run(RUNS, rank_runs, run, name)
    for out in outs:
        assert out["cache_shapes"]["l.k"][2:4] == (BUCKET // 4, 2)
        assert out["cache_group"] == 4
        # each attention layer: the q heads gathered, the max and the
        # partial sums all-reduced, the row-parallel output and the FFN
        # summed; the embedding summed and the logits gathered
        assert out["decode_calls"] == {"all_gather": 2 + 1, "all_reduce": 2 * 4 + 1}


def test_paged_layout_of_a_sequence_split_cache_raises():
    from repro_torch.configs import get_config
    from repro_torch.core.comm import TraceGroup
    from repro_torch.core.strategies import PlanConfig, Strategy
    from repro_torch.config import MeshConfig
    from repro_torch.models.common import ShardCtx
    from repro_torch.models.model import build_model

    plan = PlanConfig(strategy=Strategy.DP_TP, tensor_parallel=True, cache_seq_axes=("model",))
    group = TraceGroup(4, 1)
    ctx = ShardCtx(plan, group, cache_group=group, mesh=MeshConfig((1, 4), ("data", "model")))
    model = build_model(get_config(ARCH), dtype=torch.float32)
    assert model.cache_entries(BATCH, BUCKET, ctx)["l.k"][0] == (2, BATCH, BUCKET // 4, 2, 32)
    with pytest.raises(ValueError, match="split along its sequence"):
        model.paged_cache_entries(BATCH, BUCKET, 8, ctx)
