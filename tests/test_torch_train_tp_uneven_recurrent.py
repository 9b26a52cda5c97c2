"""PyTorch port, the train step of the SSM family over a (1, 4) ``("data",
"model")`` mesh whose model axis its heads do not divide, against the
reference's single-device steps (``tests/_torch_train_ref.py``'s
tolerances; the hybrid family: ``test_torch_train_tp_uneven_hybrid.py``).

``mamba2-1.3b-smoke`` cut to ``d_model=72``: 9 SSD heads, so the rules
split the inner width but not the heads, and the block runs whole on every
rank, its split parameters gathered.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "mamba2-d72": ("mamba2-1.3b-smoke", (("d_model", 72),), None, (1, 4),
                   [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_uneven_recurrent_tp_step_equals_reference(rank_runs, run, case):
    outs, _want = check_tp_run(RUNS, rank_runs, run, case)
    # the inner width split, the 9 heads whole
    shapes = outs[0]["local_shapes"]
    assert shapes["l.wz"][2] == 144 // 4 and shapes["l.wdt"][2] == 9
