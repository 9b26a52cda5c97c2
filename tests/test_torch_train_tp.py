"""PyTorch port, the train step over a ``("data", "model")`` mesh (tensor
and sequence parallelism, ``runtime/train_loop.py`` with
``models/common.ShardCtx``) for the dense family, against the reference's
single-device ``make_train_step`` on the same weights and global batch
(``tests/_torch_train_ref.py``'s tolerances).

``yi-6b-smoke`` on 2 gloo CPU ranks as a (1, 2) mesh under the planner's
``DP_TP`` and ``FSDP_TP`` plans, with and without ``seq_shard_checkpoints``
(sequence parallelism: the residual stream and every remat checkpoint the
rank's sequence shard), SGD and Adam, clipping on and off, 1 and 2
microbatches. Every rank reports the global loss and norm, and holds of
each parameter the block the reference's own sharding rules give it. The
(2, 2) mesh: ``test_torch_train_tp_world4.py``; heads that do not split the
model axis (SP attention): ``test_torch_train_tp_sp_attention.py``; the
vocab-parallel cross-entropy alone:
``test_torch_train_tp_xent.py``. The other families' files use this one's
fixture and checks (:func:`tp_rank_runs`, :func:`check_tp_run`).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402
from _torch_train_ref import (ARCH, BATCH, SEQ, STEPS, check_blocks_2d, check_case,  # noqa: E402
                              reference)

torch.set_num_threads(2)
MESH = (1, 2)
DP_TP, FSDP_TP = "dp_tensor_parallel", "fsdp_tensor_parallel"
# (strategy, optimizer, lr, grad_clip, microbatches, seq_shard_checkpoints)
TP_CASES = [(s, "sgd", 1e-3, clip, m, sp) for s in (DP_TP, FSDP_TP) for sp in (False, True)
            for clip, m in ((1.0, 1), (0.0, 2))]
TP_CASES += [(FSDP_TP, "adam", 1e-4, 1.0, 2, True)]


def tp_case_id(case):
    s, opt, _lr, clip, m, sp = case
    return f"{'dp' if s == DP_TP else 'fsdp'}_tp-{'sp-' if sp else ''}{opt}-clip{clip:g}-micro{m}"


def check_tp_outs(outs, case, mesh, arch, want_mets, want_params, cut=()):
    """Every rank ran the plan asked for with the blocks the reference's
    rules give it and reports the same global metrics; the gathered
    parameters equal the reference's single-device step's."""
    strategy, opt, lr, _clip, _m, sp = case
    for out in outs:
        name, over_data, batch_axes, tp, _ep, seq_shard = out["plan"]
        assert (name, over_data, tp, seq_shard) == (strategy, strategy == FSDP_TP, True, sp)
        assert batch_axes == ("data",)
    check_blocks_2d(outs, mesh, arch, cut)
    for out in outs[1:]:
        assert out["metrics"] == outs[0]["metrics"]
    check_case(outs[0], want_mets, want_params, opt, lr)


def tp_rank_runs(runs):
    """A module fixture: every run of ``runs`` ({name: (arch, cut, gain of
    the attention norms, mesh, cases)}) on gloo CPU ranks from the
    reference's init, each run's cases in one process group."""

    @pytest.fixture(scope="module")
    def rank_runs(tmp_path_factory):
        out = {}
        for name, (arch, cut, gain, mesh, cases) in runs.items():
            init = reference(arch, "sgd", 1e-3, 1.0, 1, cut=cut, gain=gain)[0]
            out[name] = run_ranks("tp_train_case", mesh[0] * mesh[1],
                                  tmp_path_factory.mktemp("r"), arch, init, cases, STEPS, BATCH,
                                  SEQ, mesh, cut)
        return out

    return rank_runs


def tp_params(runs):
    """``(run, case)`` pairs of ``runs`` and their ids, for ``parametrize``."""
    params = [(run, case) for run, (*_r, cases) in runs.items() for case in cases]
    return params, [f"{r}-{tp_case_id(c)}" for r, c in params]


def check_tp_run(runs, rank_runs, run, case):
    """:func:`check_tp_outs` of one case of one run against the reference;
    returns the ranks' outputs and the reference's metrics."""
    arch, cut, gain, mesh, cases = runs[run]
    _s, opt, lr, clip, micro, _sp = case
    _init, want_mets, want_params = reference(arch, opt, lr, clip, micro, cut=cut, gain=gain)
    outs = [r[cases.index(case)] for r in rank_runs[run]]
    check_tp_outs(outs, case, mesh, arch, want_mets, want_params, cut)
    return outs, want_mets


@pytest.fixture(scope="module")
def rank_run(tmp_path_factory):
    init = reference(ARCH, "sgd", 1e-3, 1.0, 1)[0]
    return run_ranks("tp_train_case", 2, tmp_path_factory.mktemp("ranks"), ARCH, init, TP_CASES,
                     STEPS, BATCH, SEQ, MESH)


@pytest.mark.parametrize("case", TP_CASES, ids=tp_case_id)
def test_tp_step_equals_reference_single_device_step(rank_run, case):
    _s, opt, lr, clip, micro, sp = case
    _init, want_mets, want_params = reference(ARCH, opt, lr, clip, micro)
    outs = [r[TP_CASES.index(case)] for r in rank_run]
    check_tp_outs(outs, case, MESH, ARCH, want_mets, want_params)
    calls = outs[0]["calls"]
    # sequence parallelism moves the residual stream by all-gather and
    # reduce-scatter; without it the model axis only all-reduces
    assert (calls.get("reduce_scatter", 0) > 0) == sp
    assert calls["all_reduce"] > 0
