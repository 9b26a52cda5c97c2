"""PyTorch port, serving the audio family under a model axis against the
reference (``tests/_torch_serve_ref.py``): Whisper's last-position logits
over the frames and the prompt (``apply(..., last_only=True)`` over a
model axis), then ``build_cross_cache`` (the encoder on the rank's
parameter blocks, each decoder layer's cross K/V on the rank's kv heads)
and decode ticks, each layer's cross attention on the rank's head block
of the cross K/V. ``whisper-medium-smoke`` on a (1, 2) mesh, from the
reference's init with the attention norms' gains at 0.1 (its smoke init
is badly conditioned: ``tests/test_torch_audio.py``).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import HEADS, check_serve_run, serve_params, serve_rank_runs  # noqa: E402

torch.set_num_threads(2)
ARCH = "whisper-medium-smoke"
RUNS = {"1x2": (ARCH, (), 0.1, (1, 2), [("heads", HEADS, "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_audio_equals_reference(rank_runs, run, name):
    outs = check_serve_run(RUNS, rank_runs, run, name)
    for out in outs:
        assert out["cache_shapes"]["x.k"][3] == 1
