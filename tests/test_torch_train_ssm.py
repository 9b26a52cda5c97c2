"""PyTorch port, training the SSM family: ``Model.loss`` and
``make_train_step`` on ``mamba2-1.3b-smoke`` (the SSD blocks through the
training op ``ssd_scan_train`` and its backward, on the CPU their plain
versions), the train launcher on the two new families, and the planner's
one-card plans for them, against the reference on the same seeded inputs
and on weights converted by ``repro_torch.interop``.

Tolerances, float32: the loss ``rtol = 1e-5``; every parameter's gradient
within ``5e-5`` of its largest entry (measured: 1.7e-5, on ``a_log``); three
train steps at the tolerances of
``tests/test_torch_train.py::test_train_step_trajectory_matches_reference``.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as jax_config_module  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.strategies import PlanConfig as JaxPlan  # noqa: E402
from repro.core.strategies import Strategy as JaxStrategy  # noqa: E402
from repro.data import make_batch as jax_make_batch  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import InputShape, MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.strategies import PlanConfig, Strategy  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

torch.set_num_threads(2)
MESH = MeshConfig((1,), ("data",))
JAX_MESH = jax_config_module.MeshConfig((1,), ("data",))
STEPS, SEQ, BATCH = 3, 32, 4
ARCH = "mamba2-1.3b-smoke"


def _close_to_max(got, want, frac, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=name)


# ---------------------------------------------------------------------------
# the model and the train step
# ---------------------------------------------------------------------------

_MODELS = {}


def _models():
    if ARCH not in _MODELS:
        jm = jax_build(jax_config(ARCH), dtype=jnp.float32)
        jp = jm.init_params(jax.random.PRNGKey(0))
        _MODELS[ARCH] = (jm, jp, build_model(get_config(ARCH), dtype=torch.float32))
    jm, jp, tm = _MODELS[ARCH]
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   torch.float32, "cpu")
    return jm, jp, tm, tp


def _batches(step):
    return (jax_make_batch(jax_config(ARCH), jax_config_module.InputShape("t", SEQ, BATCH,
                                                                            "train"),
                           step=step, dtype=jnp.float32),
            make_batch(get_config(ARCH), InputShape("t", SEQ, BATCH, "train"), step=step,
                       dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("remat", [False, True])
def test_model_loss_and_every_gradient_match_reference(remat):
    jm, jp, tm, tp = _models()
    jb, tb = _batches(0)
    (want, _), jgrads = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(jp)
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    got, met = tm.loss(leaves, tb, remat=remat)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(met["aux"]) == 0.0
    for k, g in jgrads.items():
        assert leaves[k].grad is not None, k
        _close_to_max(leaves[k].grad, np.asarray(g), 5e-5, name=k)


def _steps(opt, clip, lr):
    jm, jp, tm, tp = _models()
    jplan, tplan = JaxPlan(strategy=JaxStrategy.LOCAL), PlanConfig(strategy=Strategy.LOCAL)
    jtrain = jax_config_module.TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip)
    jstep = jax.jit(jax_train_loop.make_train_step(jm, jplan, JAX_MESH, jtrain))
    tstep = make_train_step(tm, tplan, MESH, TrainConfig(optimizer=opt, learning_rate=lr,
                                                          grad_clip=clip))
    jo, to = jax_train_loop.init_opt_state(opt, jp, jplan), init_opt_state(opt, tp, tplan)
    for i in range(STEPS):
        jb, tb = _batches(i)
        jp, jo, jmet = jstep(jp, jo, jb, jnp.int32(i))
        tp, to, tmet = tstep(tp, to, tb, i)
        yield jmet, tmet, {k: np.asarray(v) for k, v in jp.items()}, tp


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_trajectory_matches_reference(opt):
    lr = 1e-3 if opt == "sgd" else 1e-4
    for jmet, tmet, jp, tp in _steps(opt, 1.0, lr):
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-3)
        for k, want in jp.items():
            got = tp[k].detach().numpy()
            if opt == "sgd":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * STEPS * lr, err_msg=k)
                rms = np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30))
                assert rms <= 3e-3, (k, rms)


def test_train_cli_runs_mamba2_on_the_cpu():
    run = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "32", "--log-every", "1"])
    losses = [h["loss"] for h in run.timer.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert run.cfg.family == "ssm" and run.plan.config.strategy == Strategy.LOCAL


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_planner_plans_the_full_recurrent_models_on_one_h100(arch):
    """The H100's one-card lattice at (4, 2048): both full models fit as
    LOCAL with remat and float32 Adam state; the estimate carries the
    float32 cross-entropy (12 bytes a logit beside the bf16 logits)
    and the recurrent layers' backward terms."""
    from repro_torch.core.memory import estimate_memory
    from repro_torch.core.planner import compile_plan
    from repro_torch.hw import H100

    cfg = get_config(arch)
    shape = InputShape("cli", 2048, 4, "train")
    plan = compile_plan(cfg, shape, MESH, TrainConfig())
    print(plan.explain())
    assert (plan.config.strategy, plan.config.remat, plan.config.opt_state_dtype,
            plan.config.microbatches) == (Strategy.LOCAL, True, "float32", 1)
    assert plan.memory.fits()
    est = estimate_memory(cfg, shape, MESH, plan.config, TrainConfig(), H100)
    assert est.per_device["xent"] == 4 * 2048 * cfg.vocab_size * 12
    # one layer's saved states (remat) as the training op's fake returns them,
    # plus the scratch its backward's wrapper allocates
    meta = dict(device="meta")
    if cfg.family == "ssm":
        h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
        x = torch.empty((4, 2048, h, p), dtype=torch.bfloat16, **meta)
        bm, v = torch.empty((4, 2048, n), dtype=torch.bfloat16, **meta), torch.empty(h, **meta)
        states = torch.ops.repro_torch.ssd_scan_train(x, x[..., 0].float(), v, bm, bm, v,
                                                      SSD.MAX_CHUNK)[1]
        scratch = SSD.bwd_scratch(4, 2048, h, p, n)
    else:
        xb = torch.empty((4, 2048, cfg.lru_width), dtype=torch.bfloat16, **meta)
        states = torch.ops.repro_torch.rglru_scan_train(
            xb, xb, xb, xb, torch.empty(cfg.lru_width, **meta))[1]
        scratch = ((RG.bwd_scratch_shape(4, cfg.lru_width), torch.float32),)
    want = states.nbytes + sum(math.prod(sh) * dt.itemsize for sh, dt in scratch)
    assert est.per_device["recurrent_backward"] == want
