"""PyTorch port, serving under a model axis (``DP_TP`` serve plans;
``runtime/serve_loop.make_prefill`` / ``make_decode_step`` with the plan,
``models/common.ShardCtx``): the dense family with the decode cache on kv
heads (``cache_heads_over_model``), against the reference's one-device
``prefill`` and ``decode_step`` on the same weights
(``tests/_torch_serve_ref.py``).

``yi-6b-smoke`` (4 q heads, 2 kv heads) on 2 gloo CPU ranks as a (1, 2)
mesh: each rank its q heads and the kv heads they read, its cache block
those kv heads, decoded from dense rows and from paged slot stacks (the
paged kernel's plain version and the gather read); on a (2, 2) mesh each
data rank also its rows. The cache split along its sequence:
``test_torch_serve_tp_seq.py``; context-parallel prefill:
``test_torch_serve_tp_cp.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (HEADS, check_serve_run, serve_params,  # noqa: E402
                              serve_rank_runs)

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"
CASES = [("heads-dense", HEADS, "dense"), ("heads-paged", HEADS, "paged"),
         ("heads-gather", HEADS, "gather")]
RUNS = {"1x2": (ARCH, (), None, (1, 2), CASES),
        "2x2": (ARCH, (), None, (2, 2), CASES[:1])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_equals_reference(rank_runs, run, name):
    outs = check_serve_run(RUNS, rank_runs, run, name)
    for out in outs:
        # the cache block holds this rank's kv head of the two
        assert out["cache_shapes"]["l.k"][3] == 1
        assert out["cache_group"] is None
        # a tick all-reduces each block's two row-parallel products and the
        # embedding's partial sums, and gathers the vocab-parallel logits
        assert out["decode_calls"] == {"all_reduce": 2 * 2 + 1, "all_gather": 1}
