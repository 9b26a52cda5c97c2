"""PyTorch port, serving the hybrid family under a model axis against the
reference's one-device ``prefill`` and ``decode_step``
(``tests/_torch_serve_ref.py``).

``recurrentgemma-2b-smoke`` cut to the pattern ``rra`` (3 layers; the smoke
pattern ``rr`` has no attention layer) with a window of 16, so prompts and
ticks pass the window and the rotating cache wraps. Its one kv head does
not divide the model axis, so the attention cache splits along its
(rotating) sequence; the RG-LRU blocks run on their channels and gather
the whole state back into the cache. On (1, 2) and (1, 4) meshes, and
under context-parallel prefill.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (CP, SEQ, check_serve_run, serve_params,  # noqa: E402
                              serve_rank_runs)

torch.set_num_threads(2)
ARCH = "recurrentgemma-2b-smoke"
RRA = (("num_layers", 3), ("block_pattern", "rra"), ("window_size", 16))
RUNS = {"1x2": (ARCH, RRA, None, (1, 2), [("seq", SEQ, "dense"), ("cp", SEQ + CP, "dense")]),
        "1x4": (ARCH, RRA, None, (1, 4), [("seq", SEQ, "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_hybrid_equals_reference(rank_runs, run, name):
    outs = check_serve_run(RUNS, rank_runs, run, name)
    mp = RUNS[run][3][1]
    for out in outs:
        assert out["cache_shapes"]["a.k"][2] == 16 // mp
        assert out["cache_shapes"]["r.h"] == (2, 4, 128)
