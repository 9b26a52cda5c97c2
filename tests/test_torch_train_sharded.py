"""PyTorch port, the train step over 2 ranks of a data mesh
(``runtime/train_loop.py``: DP and FSDP under the plans the port's planner
yields for ``MeshConfig((2,), ("data",))``) against the reference's
single-device ``make_train_step`` on the same weights and global batch
(``tests/_torch_train_ref.py``; 4 ranks: ``test_torch_train_sharded_world4.py``,
the SSM and hybrid families: ``test_torch_train_sharded_recurrent.py``).
The MoE family (``qwen3-moe-235b-a22b-smoke``, dropless) takes a DP and an
FSDP case: each rank routes its own rows (the reference's group of one data
shard), takes the load-balance statistics as means over the ranks, and
under FSDP gathers the ``(E, D, F)`` expert leaves from their blocks. The
audio family (``whisper-medium-smoke``) takes a DP case: each rank's rows
of the batch's ``frames`` go through the encoder with its rows of tokens.
It runs from the reference's init with the attention norms' gains at 0.1
(``tests/test_torch_audio.py``: at the init's own gains the scores are so
peaked that float32 rounding alone moves the grad norm by ~2e-3, on one
device as across ranks).

The reference's own multi-device test cannot run on this container
(``tests/test_parfor_multidev.py::test_sharded_train_step_multidev``,
ROADMAP Queue C), so the sharded steps are held to its one-device steps.
Every rank runs in a gloo CPU process of its own (``tests/_torch_ranks.py``);
the cases share one process group. Each rank of an FSDP case holds a block
of every parameter the rules split: its block shapes are checked too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from _torch_train_ref import (ARCH, BATCH, CASES, DP, FSDP, JAX_MESH, SEQ, STEPS,  # noqa: E402
                              case_id, check_blocks, check_case, reference)
from repro import config as jax_config_module  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.strategies import PlanConfig as JaxPlan  # noqa: E402
from repro.core.strategies import Strategy as JaxStrategy  # noqa: E402
from repro.data import make_batch as jax_make_batch  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime import train_loop as jax_train_loop  # noqa: E402

torch.set_num_threads(2)
WORLD = 2
MOE_ARCH = "qwen3-moe-235b-a22b-smoke"
MOE_CASES = [(DP, "sgd", 1e-3, 1.0, 1), (FSDP, "adam", 1e-4, 1.0, 1)]
ENCDEC_ARCH = "whisper-medium-smoke"
ENCDEC_CASES = [(DP, "sgd", 1e-3, 1.0, 1)]


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


@pytest.fixture(scope="module")
def moe_rank_run(tmp_path_factory):
    init = reference(MOE_ARCH, "sgd", 1e-3, 1.0, 1)[0]
    return run_ranks("train_case", WORLD, tmp_path_factory.mktemp("ranks"), MOE_ARCH, init,
                     MOE_CASES, STEPS, BATCH, SEQ)


@pytest.mark.parametrize("case", MOE_CASES, ids=case_id)
def test_moe_sharded_step_equals_reference_single_device_step(moe_rank_run, case):
    _strategy, opt, lr, clip, micro = case
    init, want_mets, want_params = reference(MOE_ARCH, opt, lr, clip, micro)
    outs = [r[MOE_CASES.index(case)] for r in moe_rank_run]
    check_blocks(outs, case, WORLD, init)
    for out in outs[1:]:
        assert out["metrics"] == outs[0]["metrics"]
    for got, want in zip(outs[0]["metrics"], want_mets, strict=True):
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        assert got["aux"] > 0.0
    check_case(outs[0], want_mets, want_params, opt, lr)
    if case[0] == FSDP:       # the expert leaves are split over the ranks
        assert outs[0]["local_shapes"]["l.e_wg"] != init["l.e_wg"].shape


ENCDEC_GAIN = 0.1
_ENCDEC_REF = {}


def encdec_reference(opt, lr, clip, micro):
    """``reference`` for the audio family, from the init with the ``ln1`` and
    ``xln`` gains times ENCDEC_GAIN."""
    key = (opt, lr, clip, micro)
    if key not in _ENCDEC_REF:
        jm = jax_build(jax_config(ENCDEC_ARCH), dtype=jnp.float32)
        jp = {k: v * ENCDEC_GAIN if k.endswith((".ln1", ".xln")) else v
              for k, v in jm.init_params(jax.random.PRNGKey(0)).items()}
        init = {k: np.asarray(v) for k, v in jp.items()}
        plan = JaxPlan(strategy=JaxStrategy.LOCAL, microbatches=micro)
        train = jax_config_module.TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip)
        step = jax.jit(jax_train_loop.make_train_step(jm, plan, JAX_MESH, train))
        state = jax_train_loop.init_opt_state(opt, jp, plan)
        shape = jax_config_module.InputShape("t", SEQ, BATCH, "train")
        mets = []
        for i in range(STEPS):
            b = jax_make_batch(jax_config(ENCDEC_ARCH), shape, step=i, dtype=jnp.float32)
            jp, state, met = step(jp, state, b, jnp.int32(i))
            mets.append({k: float(v) for k, v in met.items()})
        _ENCDEC_REF[key] = (init, mets, {k: np.asarray(v) for k, v in jp.items()})
    return _ENCDEC_REF[key]


@pytest.fixture(scope="module")
def encdec_rank_run(tmp_path_factory):
    init = encdec_reference("sgd", 1e-3, 1.0, 1)[0]
    return run_ranks("train_case", WORLD, tmp_path_factory.mktemp("ranks"), ENCDEC_ARCH, init,
                     ENCDEC_CASES, STEPS, BATCH, SEQ)


@pytest.mark.parametrize("case", ENCDEC_CASES, ids=case_id)
def test_encdec_sharded_step_equals_reference_single_device_step(encdec_rank_run, case):
    _strategy, opt, lr, clip, micro = case
    init, want_mets, want_params = encdec_reference(opt, lr, clip, micro)
    outs = [r[ENCDEC_CASES.index(case)] for r in encdec_rank_run]
    check_blocks(outs, case, WORLD, init)
    for out in outs[1:]:
        assert out["metrics"] == outs[0]["metrics"]
    check_case(outs[0], want_mets, want_params, opt, lr)
