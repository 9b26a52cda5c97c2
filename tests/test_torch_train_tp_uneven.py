"""PyTorch port, the train step over a (1, 4) ``("data", "model")`` mesh
where split dims do not divide the model axis, against the reference's
single-device steps (``tests/_torch_train_ref.py``'s tolerances; the MoE
family: ``test_torch_train_tp_uneven_moe.py``; the SSM and hybrid
families: ``test_torch_train_tp_uneven_recurrent.py``,
``test_torch_train_tp_uneven_hybrid.py``).

The sharding rules then leave a tensor whole (or split another of its
dims), and the port runs that part whole on every rank or in uneven
blocks. ``yi-6b-smoke`` cut to ``d_ff=250`` (the FFN whole on every rank,
``wd``'s ``embed_out`` blocks gathered), ``vocab_size=510`` (the
vocab-parallel embedding, logits and cross-entropy over uneven blocks of
the whole table, as Whisper-medium's and InternVL2-2B's odd vocabularies
take them) and 12/6 heads (3 query heads a rank over 6 kv heads the rules
leave whole: rank 0's heads read kv heads 0, 0, 1, so each rank's kv heads
are expanded to one a query head).
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_train_tp import (DP_TP, FSDP_TP, check_tp_run, tp_params,  # noqa: E402
                                tp_rank_runs)

torch.set_num_threads(2)
YI_CUT = (("d_ff", 250), ("vocab_size", 510), ("num_heads", 12), ("num_kv_heads", 6))
# (arch, cut, gain of the attention norms, mesh, cases)
RUNS = {
    "yi-uneven": ("yi-6b-smoke", YI_CUT, None, (1, 4),
                  [(DP_TP, "sgd", 1e-3, 1.0, 1, True), (FSDP_TP, "sgd", 1e-3, 1.0, 1, False)]),
}
PARAMS, IDS = tp_params(RUNS)
rank_runs = tp_rank_runs(RUNS)


@pytest.mark.parametrize("run,case", PARAMS, ids=IDS)
def test_uneven_tp_step_equals_reference(rank_runs, run, case):
    outs, _want = check_tp_run(RUNS, rank_runs, run, case)
    shapes = outs[0]["local_shapes"]
    # the rules leave the table, wg and wk whole, and split wd over
    # embed_out and wq over its heads
    assert shapes["embed"][0] == 510 and shapes["l.wg"][2] == 250
    assert shapes["l.wd"][2] == 128 // 4
    assert shapes["l.wk"][2] == 6 and shapes["l.wq"][2] == 3
