"""PyTorch port, serving the SSM family under a model axis against the
reference's one-device ``prefill`` and ``decode_step``
(``tests/_torch_serve_ref.py``).

``mamba2-1.3b-smoke`` (16 SSM heads) on (1, 2) and (1, 4) meshes: each rank
its heads of the SSD block (its block of the SSM state; the conv tail of x
whole in the cache, gathered back each tick; B and C whole), the gated
norm's mean square and the output projection summed over the model group;
and under context-parallel prefill, the scan run on the gathered
sequence.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (CP, HEADS, check_serve_run, serve_params,  # noqa: E402
                              serve_rank_runs)

torch.set_num_threads(2)
ARCH = "mamba2-1.3b-smoke"
RUNS = {"1x2": (ARCH, (), None, (1, 2), [("heads", HEADS, "dense"),
                                          ("cp", HEADS + CP, "dense")]),
        "1x4": (ARCH, (), None, (1, 4), [("heads", HEADS, "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_ssm_equals_reference(rank_runs, run, name):
    outs = check_serve_run(RUNS, rank_runs, run, name)
    mp = RUNS[run][3][1]
    for out in outs:
        assert out["cache_shapes"]["l.state"][2] == 16 // mp
        assert out["cache_shapes"]["l.conv_x"][3] == 256
