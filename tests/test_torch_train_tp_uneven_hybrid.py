"""PyTorch port, the train step of the hybrid family over a (1, 4) ``("data",
"model")`` mesh whose model axis its RG-LRU width does not divide, against
the reference's single-device steps (``tests/_torch_train_ref.py``'s
tolerances; the SSM family: ``test_torch_train_tp_uneven_recurrent.py``).

``recurrentgemma-2b-smoke`` cut to ``lru_width=126`` and pattern ``rra``:
the RG-LRU block whole on every rank; its attention layer still over
heads.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "rgemma-lru126": ("recurrentgemma-2b-smoke",
                      (("lru_width", 126), ("num_layers", 3), ("block_pattern", "rra")), None,
                      (1, 4), [(DP_TP, "sgd", 1e-3, 1.0, 1, True),
                               (FSDP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_uneven_hybrid_tp_step_equals_reference(rank_runs, run, case):
    outs, _want = check_tp_run(RUNS, rank_runs, run, case)
    assert outs[0]["local_shapes"]["r.wx"][2] == 126
