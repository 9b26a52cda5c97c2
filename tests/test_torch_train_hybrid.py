"""PyTorch port, training the hybrid family: ``Model.loss`` and
``make_train_step`` on ``recurrentgemma-2b-smoke`` (the RG-LRU blocks
through the training op ``rglru_scan_train`` and its backward, on the CPU
their plain versions; the attention layers through ``flash_attention_train``
and the reference's recompute backward), with the registry's pattern ``rr``
(its attention stack holds zero layers) and with ``rra`` at window 16
(prompts of 32, past it), against the reference on the same seeded inputs
and on weights converted by ``repro_torch.interop``.

Tolerances, float32: the loss ``rtol = 1e-5``; every parameter's gradient
within ``2e-4`` of its largest entry — measured 1.8e-6 with ``rr`` and
6.8e-5 with ``rra``, whose attention layer's softmax backward cancels in
float32 (``tests/test_torch_train.py`` measured the reference's own
gradient moving by up to 3e-4 of the embedding's between float32 and
float64); three train steps at the tolerances of
``tests/test_torch_train.py::test_train_step_trajectory_matches_reference``,
SGD at its lr of 1e-3 and Adam at 1e-5, not 1e-4: after step 0 eight of
the ~300,000 parameters (embedding entries whose gradient sits near Adam's
eps) move by a rounding-dependent fraction of lr in either package, and the
tied embedding scales each by sqrt(d_model) into every position holding its
token. At lr 1e-4 that moved step 2's grad_norm by 2.4e-3; at 1e-5 by
2.3e-5 (``_steps`` below at each lr; SGD's trajectories agree to 1e-7).
"""

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
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

torch.set_num_threads(2)
MESH = MeshConfig((1,), ("data",))
JAX_MESH = jax_config_module.MeshConfig((1,), ("data",))
STEPS, SEQ, BATCH = 3, 32, 4
ARCH = "recurrentgemma-2b-smoke"
GRAD_TOL = 2e-4


def _cfgs(pattern):
    """(reference config, port config): the registry's smoke for ``rr``,
    else ``pattern`` as many layers as it has letters at window 16."""
    if pattern == "rr":
        return jax_config(ARCH), get_config(ARCH)
    kw = dict(block_pattern=pattern, num_layers=len(pattern), window_size=16)
    return jax_config(ARCH).replace(**kw), get_config(ARCH).replace(**kw)


def _close_to_max(got, want, frac, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=name)


_MODELS = {}


def _models(pattern):
    if pattern not in _MODELS:
        jcfg, tcfg = _cfgs(pattern)
        jm = jax_build(jcfg, dtype=jnp.float32)
        jp = jm.init_params(jax.random.PRNGKey(0))
        _MODELS[pattern] = (jm, jp, build_model(tcfg, dtype=torch.float32))
    jm, jp, tm = _MODELS[pattern]
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   torch.float32, "cpu")
    return jm, jp, tm, tp


def _batches(pattern, step):
    jcfg, tcfg = _cfgs(pattern)
    return (jax_make_batch(jcfg, jax_config_module.InputShape("t", SEQ, BATCH, "train"),
                           step=step, dtype=jnp.float32),
            make_batch(tcfg, InputShape("t", SEQ, BATCH, "train"), step=step,
                       dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("pattern", ["rr", "rra"])
def test_model_loss_and_every_gradient_match_reference(pattern, remat):
    jm, jp, tm, tp = _models(pattern)
    jb, tb = _batches(pattern, 0)
    (want, _), jgrads = jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True)(jp)
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    got, met = tm.loss(leaves, tb, remat=remat)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(met["aux"]) == 0.0
    assert [k for k, _p, _i in tm.layers()] == list(pattern)
    for k, g in jgrads.items():
        if not np.asarray(g).size:          # the zero-layer attention stack of rr
            continue
        assert leaves[k].grad is not None, k
        _close_to_max(leaves[k].grad, np.asarray(g), GRAD_TOL, name=k)


def _steps(pattern, opt, clip, lr):
    jm, jp, tm, tp = _models(pattern)
    jplan, tplan = JaxPlan(strategy=JaxStrategy.LOCAL), PlanConfig(strategy=Strategy.LOCAL)
    jtrain = jax_config_module.TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip)
    jstep = jax.jit(jax_train_loop.make_train_step(jm, jplan, JAX_MESH, jtrain))
    tstep = make_train_step(tm, tplan, MESH, TrainConfig(optimizer=opt, learning_rate=lr,
                                                          grad_clip=clip))
    jo, to = jax_train_loop.init_opt_state(opt, jp, jplan), init_opt_state(opt, tp, tplan)
    for i in range(STEPS):
        jb, tb = _batches(pattern, i)
        jp, jo, jmet = jstep(jp, jo, jb, jnp.int32(i))
        tp, to, tmet = tstep(tp, to, tb, i)
        yield jmet, tmet, {k: np.asarray(v) for k, v in jp.items()}, tp


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_trajectory_matches_reference(opt):
    lr = 1e-3 if opt == "sgd" else 1e-5
    for jmet, tmet, jp, tp in _steps("rra", opt, 1.0, lr):
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




def test_train_cli_runs_recurrentgemma_on_the_cpu():
    """The launcher's own entry; the smoke pattern's RG-LRU layers go
    through the training op (plain versions on the CPU, no launch)."""
    before = (RG.rglru_scan_train.launches, RG.rglru_scan_bwd.launches)
    run = train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2",
                          "--seq", "32", "--log-every", "1"])
    losses = [h["loss"] for h in run.timer.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert run.cfg.family == "hybrid" and run.plan.config.strategy == Strategy.LOCAL
    assert (RG.rglru_scan_train.launches, RG.rglru_scan_bwd.launches) == before
