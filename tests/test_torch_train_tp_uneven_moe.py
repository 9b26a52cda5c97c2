"""PyTorch port, the train step of the MoE family over a (1, 4) ``("data",
"model")`` mesh whose model axis its experts do not divide, against the
reference's single-device steps (``tests/_torch_train_ref.py``'s
tolerances; the other uneven splits: ``test_torch_train_tp_uneven.py``).

``qwen3-moe-235b-a22b-smoke`` cut to 6 experts: the rules leave the experts
whole and split their ``ffn`` columns, so every rank runs every expert on
its columns and the combine's partial sums are reduced.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "moe-experts6": ("qwen3-moe-235b-a22b-smoke", (("num_experts", 6),), None, (1, 4),
                     [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_uneven_moe_tp_step_equals_reference(rank_runs, run, case):
    outs, _want = check_tp_run(RUNS, rank_runs, run, case)
    # the experts whole, their columns split
    shapes = outs[0]["local_shapes"]
    assert shapes["l.e_wg"][1] == 6 and shapes["l.e_wg"][3] == 256 // 4
