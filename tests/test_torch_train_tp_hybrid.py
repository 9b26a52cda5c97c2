"""PyTorch port, the train step of the hybrid family over a (1, 2) ``("data",
"model")`` mesh against the reference's single-device steps
(``tests/_torch_train_ref.py``'s tolerances; the (2, 2) mesh:
``test_torch_train_tp_hybrid_world4.py``; the SSM family:
``test_torch_train_tp_recurrent.py``).

``recurrentgemma-2b-smoke``: each model rank its block of the RG-LRU
channels (``wx``, ``wy``, ``conv``, ``w_r``, ``w_i``, ``w_out`` split;
``b_r``, ``b_i`` and ``a_log`` sliced from whole tensors; the conv output
all-gathered for the gates, which read every channel). The registry's
smoke pattern ``rr`` has no attention layer, so the runs take a cut with
pattern ``rra`` (3 layers): its local-attention layer's one kv head serves
the query heads of every rank. ``DP_TP`` with ``seq_shard_checkpoints``
and ``FSDP_TP`` without it over 2 microbatches.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
RRA = (("num_layers", 3), ("block_pattern", "rra"))
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "rgemma-12": ("recurrentgemma-2b-smoke", RRA, None, (1, 2),
                  [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 2, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_hybrid_tp_step_equals_reference(rank_runs, run, case):
    check_tp_run(RUNS, rank_runs, run, case)
