"""PyTorch port, the train step of the audio family over a (1, 2) ``("data",
"model")`` mesh against the reference's single-device steps
(``tests/_torch_train_ref.py``'s tolerances; the (2, 2) mesh:
``test_torch_train_tp_audio_world4.py``; the vision family:
``test_torch_train_tp_vlm.py``).

``whisper-medium-smoke`` (the encoder's frames split by position under
sequence parallelism; cross attention over the gathered encoder output;
from the reference's init with the attention norms' gains at 0.1, as
``tests/test_torch_train_sharded.py`` runs it): ``DP_TP`` with
``seq_shard_checkpoints`` and ``FSDP_TP`` without.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
WHISPER_GAIN = 0.1
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "audio-12": ("whisper-medium-smoke", (), WHISPER_GAIN, (1, 2),
                 [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_audio_tp_step_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
