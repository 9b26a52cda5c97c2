"""PyTorch port, the train step of the MoE family over 4 gloo CPU ranks of a
(2, 2) ``("data", "model")`` mesh against the reference's single-device
steps (``tests/_torch_train_ref.py``'s tolerances; the (1, 2) mesh:
``test_torch_train_tp_families.py``).

``qwen3-moe-235b-a22b-smoke``: two data groups of two model ranks each,
every group routing its data shard's tokens, the load-balance statistics
means over the data ranks; ``FSDP_TP`` with ``seq_shard_checkpoints`` and
``DP_TP`` without it over 2 microbatches (each a run of the global batch's
rows, as the reference splits it: the auxiliary loss is not linear in the
rows).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "moe-22": ("qwen3-moe-235b-a22b-smoke", (), None, (2, 2),
               [(FSDP_TP, "sgd", 1e-3, 1.0, 1, True), (DP_TP, "sgd", 1e-3, 1.0, 2, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_family_tp_step_on_2x2_mesh_equals_reference(rank_runs, run, case):
    outs, want_mets = check_tp_run(RUNS, rank_runs, run, case)
    micro = case[4]
    for got, want in zip(outs[0]["metrics"], want_mets, strict=True):
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        # over microbatches the step reports no auxiliary loss, as the reference's
        assert (got["aux"] > 0.0) == (micro == 1)
    # expert parallel: each model rank holds half the experts
    assert outs[0]["local_shapes"]["l.e_wg"][1] == 2
