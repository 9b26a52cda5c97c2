"""PyTorch port, the train step of the audio family over 4 gloo CPU ranks of
a (2, 2) ``("data", "model")`` mesh against the reference's single-device
step (``tests/_torch_train_ref.py``'s tolerances; the (1, 2) mesh:
``test_torch_train_tp_audio.py``).

``whisper-medium-smoke`` from the reference's init with the attention
norms' gains at 0.1: two data groups of two model ranks, ``FSDP_TP`` with
``seq_shard_checkpoints``.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
WHISPER_GAIN = 0.1
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "audio-22": ("whisper-medium-smoke", (), WHISPER_GAIN, (2, 2),
                 [(FSDP_TP, "sgd", 1e-3, 1.0, 1, True)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_audio_tp_step_on_2x2_mesh_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
