"""PyTorch port, the train step of the SSM family over a (1, 2) ``("data",
"model")`` mesh against the reference's single-device steps
(``tests/_torch_train_ref.py``'s tolerances; the (2, 2) mesh:
``test_torch_train_tp_recurrent_world4.py``; the hybrid family:
``test_torch_train_tp_hybrid.py``).

``mamba2-1.3b-smoke``: each model rank its block of the SSD heads (``wz``,
``wx``, ``conv_x``, ``wdt``, ``w_out`` split; ``dt_bias``, ``a_log``,
``d_skip`` and ``gate_ln`` sliced from whole tensors; B and C whole on
every rank; the gated RMS norm's mean square summed over the ranks), under
``DP_TP`` with ``seq_shard_checkpoints`` and ``FSDP_TP`` without it over 2
microbatches.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "mamba2-12": ("mamba2-1.3b-smoke", (), None, (1, 2),
                  [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 2, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_recurrent_tp_step_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
