"""PyTorch port, the train step over 4 gloo CPU ranks of a (1, 4) ``("data",
"model")`` mesh whose model axis the heads do not divide, against the
reference's single-device steps (``tests/_torch_train_ref.py``'s
tolerances).

``yi-6b-smoke`` cut to 6/2 heads: the rules leave ``wq`` whole and split
``wo`` over ``embed_out``. With ``seq_shard_checkpoints`` each rank's query
positions attend over the gathered K/V at its ``q_offset`` (the
reference's SP attention, ``wo``'s blocks gathered); without it every rank
runs the attention whole.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
SP_CUT = (("num_heads", 6), ("num_kv_heads", 2))
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "yi-6heads": ("yi-6b-smoke", SP_CUT, None, (1, 4),
                  [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 2, True),
                   (FSDP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_heads_not_dividing_model_axis_equal_reference(rank_runs, run, case):
    outs, _want = check_tp_run(RUNS, rank_runs, run, case)
    # the rules leave wq whole and split wo over embed_out
    shapes = outs[0]["local_shapes"]
    assert shapes["l.wq"][2] == 6 and shapes["l.wo"][3] == 128 // 4
