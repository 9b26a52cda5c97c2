"""PyTorch port, the train step over 2 ranks of a data mesh
(``runtime/train_loop.py``: DP and FSDP under the plans the port's planner
yields for ``MeshConfig((2,), ("data",))``) against the reference's
single-device ``make_train_step`` on the same weights and global batch
(``tests/_torch_train_ref.py``; 4 ranks: ``test_torch_train_sharded_world4.py``,
the SSM and hybrid families: ``test_torch_train_sharded_recurrent.py``).

The reference's own multi-device test cannot run on this container
(``tests/test_parfor_multidev.py::test_sharded_train_step_multidev``,
ROADMAP Queue C), so the sharded steps are held to its one-device steps.
Every rank runs in a gloo CPU process of its own (``tests/_torch_ranks.py``);
the cases share one process group. Each rank of an FSDP case holds a block
of every parameter the rules split: its block shapes are checked too.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402
from _torch_train_ref import (ARCH, BATCH, CASES, SEQ, STEPS, case_id, check_blocks,  # noqa: E402
                              check_case, reference)

torch.set_num_threads(2)
WORLD = 2


@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    """The ranks' results, every case in one process group."""
    init = reference(ARCH, "sgd", 1e-3, 1.0, 1)[0]
    return run_ranks("train_case", WORLD, tmp_path_factory.mktemp("ranks"), ARCH, init, CASES,
                     STEPS, BATCH, SEQ)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sharded_step_equals_reference_single_device_step(rank_run, case):
    _strategy, opt, lr, clip, micro = case
    init, want_mets, want_params = reference(ARCH, opt, lr, clip, micro)
    outs = [r[CASES.index(case)] for r in rank_run]
    check_blocks(outs, case, WORLD, init)
    # every rank reports the global loss and norm
    for out in outs[1:]:
        assert out["metrics"] == outs[0]["metrics"]
    check_case(outs[0], want_mets, want_params, opt, lr)
