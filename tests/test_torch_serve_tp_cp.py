"""PyTorch port, context-parallel prefill (``seq_axes = ("model",)``, the
planner's escalation for long prompts) then decode, against the
reference's one-device ``prefill`` and ``decode_step``
(``tests/_torch_serve_ref.py``).

``yi-6b-smoke`` on a (1, 2) mesh with the cache on kv heads and on a
(1, 4) mesh with the cache split along its sequence: each rank is given
its block of the prompt, holds its block of the residual stream, runs its
queries against the K/V gathered along the sequence at ``q_offset`` = its
block's start, and hands the decode ticks its block of the cache. Also
context parallelism alone (the weights whole on every rank, the cache
whole): the FFN runs on the rank's block.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (CP, HEADS, SEQ, check_serve_run, serve_params,  # noqa: E402
                              serve_rank_runs)

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"
RUNS = {"1x2": (ARCH, (), None, (1, 2), [("cp-heads", HEADS + CP, "dense"),
                                          ("cp-heads-paged", HEADS + CP, "paged")]),
        "1x4": (ARCH, (), None, (1, 4), [("cp-seq", SEQ + CP, "dense"),
                                          ("cp-only", CP + (("tensor_parallel", False),),
                                           "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_context_parallel_prefill_equals_reference(rank_runs, run, name):
    outs = check_serve_run(RUNS, rank_runs, run, name)
    for out in outs:
        calls = out["prefill_calls"]
        # the residual stream leaves each block by reduce-scatter along the
        # sequence; the K/V, the attention weights and the FFN's input are
        # gathered
        assert calls["reduce_scatter"] > 0 and calls["all_gather"] > 0
