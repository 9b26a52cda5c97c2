"""PyTorch port, serving the vision family under a model axis against the
reference (``tests/_torch_serve_ref.py``): InternVL2's prompt pass over
its patch prefix and the text has no handoff, so it is ``apply(...,
last_only=True)`` over a model axis (the last position's vocab-parallel
logits gathered over the model group), then decode ticks from a zero
cache. ``internvl2-2b-smoke`` on a (1, 2) mesh, the cache on kv heads, and
under context-parallel prefill.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (CP, HEADS, check_serve_run, serve_params,  # noqa: E402
                              serve_rank_runs)

torch.set_num_threads(2)
ARCH = "internvl2-2b-smoke"
RUNS = {"1x2": (ARCH, (), None, (1, 2), [("heads", HEADS, "dense"),
                                          ("cp", HEADS + CP, "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_vlm_equals_reference(rank_runs, run, name):
    check_serve_run(RUNS, rank_runs, run, name)
