"""PyTorch port, the train step of the vision family over a ``("data",
"model")`` mesh against the reference's single-device steps
(``tests/_torch_train_ref.py``'s tolerances; the audio family:
``test_torch_train_tp_audio.py``).

``internvl2-2b-smoke``: the patch prefix enters the vocab-parallel
embedding's partial sum on one model rank, the prefix and the text split
by position together under sequence parallelism, and the logits drop the
prefix. On a (1, 2) mesh, ``FSDP_TP`` with ``seq_shard_checkpoints`` and
``DP_TP`` without.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "vlm-12": ("internvl2-2b-smoke", (), None, (1, 2),
               [(FSDP_TP, "sgd", 1e-3, 1.0, 1, True), (DP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_vlm_tp_step_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
