"""PyTorch port, the train step of the hybrid family over 4 gloo CPU ranks
of a (2, 2) ``("data", "model")`` mesh against the reference's
single-device steps (``tests/_torch_train_ref.py``'s tolerances; the
(1, 2) mesh and what each rank holds: ``test_torch_train_tp_hybrid.py``).

``recurrentgemma-2b-smoke`` cut to pattern ``rra`` (3 layers): two data
groups of two model ranks, ``FSDP_TP`` with ``seq_shard_checkpoints`` and
``DP_TP`` without.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
RRA = (("num_layers", 3), ("block_pattern", "rra"))
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "rgemma-22": ("recurrentgemma-2b-smoke", RRA, None, (2, 2),
                  [(FSDP_TP, "sgd", 1e-3, 1.0, 1, True), (DP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_hybrid_tp_step_on_2x2_mesh_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
