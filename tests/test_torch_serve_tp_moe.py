"""PyTorch port, serving the MoE family under a model axis (experts over
``"model"``) against the reference's one-device ``prefill`` and
``decode_step`` (``tests/_torch_serve_ref.py``).

``qwen3-moe-235b-a22b-smoke`` (4 experts, top 2) on a (1, 2) mesh: every
rank routes the tokens whole, runs its experts' slots of the capacity
buffer and the combine's partial sums are reduced; attention on kv heads;
also under context-parallel prefill.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_serve_ref import (CP, HEADS, MOE, check_serve_run, serve_params,  # noqa: E402
                              serve_rank_runs)

torch.set_num_threads(2)
ARCH = "qwen3-moe-235b-a22b-smoke"
RUNS = {"1x2": (ARCH, (), None, (1, 2), [("ep", HEADS + MOE, "dense"),
                                          ("ep-cp", HEADS + MOE + CP, "dense")])}
rank_runs = serve_rank_runs(RUNS)
PARAMS, IDS = serve_params(RUNS)


@pytest.mark.parametrize("run,name", PARAMS, ids=IDS)
def test_serve_tp_moe_equals_reference(rank_runs, run, name):
    check_serve_run(RUNS, rank_runs, run, name)
