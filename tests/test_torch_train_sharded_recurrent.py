"""PyTorch port, FSDP train steps of the SSM and hybrid families over 2
gloo CPU ranks, and ``launch/train.py``'s entry over 2 ranks, against the
reference's single-device steps (``tests/_torch_train_ref.py``: the
tolerances of ``tests/test_torch_train.py``).

``mamba2-1.3b-smoke`` and ``recurrentgemma-2b-smoke`` (pattern ``rr``: its
attention stack has zero layers, whose blocks the ranks still hold) take
one FSDP case each: SGD with clipping and 2 microbatches, 3 steps, (8, 32).
The launcher's run over 2 ranks (the planner's DP plan for ``(2,)``) gives
the losses of its run in one process.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402
from _torch_train_ref import (BATCH, FSDP, SEQ, STEPS, check_blocks, check_case,  # noqa: E402
                              reference)

from repro_torch.launch import train as train_cli  # noqa: E402

torch.set_num_threads(2)
CASE = (FSDP, "sgd", 1e-3, 1.0, 2)


@pytest.mark.parametrize("arch", ["mamba2-1.3b-smoke", "recurrentgemma-2b-smoke"])
def test_fsdp_step_of_recurrent_family_equals_reference(tmp_path, arch):
    _s, opt, lr, clip, micro = CASE
    init, want_mets, want_params = reference(arch, opt, lr, clip, micro)
    outs = [r[0] for r in run_ranks("train_case", 2, tmp_path, arch, init, [CASE], STEPS,
                                    BATCH, SEQ)]
    check_blocks(outs, CASE, 2, init)
    assert outs[1]["metrics"] == outs[0]["metrics"]
    check_case(outs[0], want_mets, want_params, opt, lr)


def test_train_cli_over_two_ranks_equals_one_process(tmp_path):
    argv = ["--device", "cpu", "--steps", "3", "--log-every", "1"]
    want = [h["loss"] for h in train_cli.main(argv).timer.history]
    outs = run_ranks("train_cli_case", 2, tmp_path, argv)
    for out in outs:
        assert out["plan"] == "data_parallel"
        np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
