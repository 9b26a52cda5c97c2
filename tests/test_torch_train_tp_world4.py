"""PyTorch port, the train step over 4 gloo CPU ranks of a (2, 2) ``("data",
"model")`` mesh for the dense family, against the reference's
single-device steps (``tests/_torch_train_ref.py``; the (1, 2) mesh:
``test_torch_train_tp.py``; heads that do not split the model axis:
``test_torch_train_tp_sp_attention.py``).

``yi-6b-smoke``: two data groups of two model ranks each, under
``FSDP_TP`` (every parameter split over both axes where the rules allow)
and ``DP_TP``, with and without ``seq_shard_checkpoints``, SGD and Adam.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "yi-22": ("yi-6b-smoke", (), None, (2, 2),
              [(FSDP_TP, "sgd", 1e-3, 1.0, 1, True), (DP_TP, "sgd", 1e-3, 1.0, 2, False),
               (FSDP_TP, "adam", 1e-4, 1.0, 1, False), (DP_TP, "adam", 1e-4, 1.0, 1, True)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_tp_step_on_2x2_mesh_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
