"""PyTorch port, training (``models/common.py::softmax_xent_logits``,
``Model.loss``, ``models/attention.py::_blocked``,
``kernels/flash_attention.py::flash_attention_train``,
``runtime/train_loop.py``, ``launch/train.py``) against the reference on the
same seeded inputs and on weights converted by ``repro_torch.interop``.

Tolerances, float32:

- the loss and ``Model.loss``: ``rtol = 1e-5`` (sums in another order);
- ``_blocked``'s output, ``lse`` and gradients against ``jax.vjp`` of the
  reference's ``_blocked``, at Sk = 1100 (two KV chunks of 1024, the second
  ragged): ``rtol = 1e-5`` with an ``atol`` of 1e-5 of the largest entry
  (measured: 8e-7 of it); the reference takes K/V expanded to every head,
  so its dk/dv are summed over each GQA group before the comparison;
- three train steps against the reference's: loss ``rtol = 1e-5``;
  grad_norm ``rtol = 1e-3`` — softmax backward cancels in float32, and the
  reference's own gradient moves by up to 3e-4 of the embedding's between
  float32 and float64 at these weights (the port's by 1e-4); parameters
  under SGD ``atol = 1e-5``, ``rtol = 1e-5`` (lr times that spread of the
  gradient: 2.5e-6 measured without clipping); under Adam every element
  within ``2 * steps * lr`` (an element whose gradient is near Adam's eps,
  1e-8, moves by a rounding-dependent fraction of lr in either package) and
  the error's RMS within 3e-3 of the parameter's; lr is 1e-3 for SGD and
  1e-4 for Adam, whose noise-moved elements then shift the next steps'
  gradients by less than the grad_norm tolerance.
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
from repro.models import attention as JATT  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime import train_loop as jax_train_loop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import InputShape, MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.planner import compile_plan  # noqa: E402
from repro_torch.core.strategies import PlanConfig, Strategy  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as TATT  # noqa: E402
from repro_torch.models.common import softmax_xent_logits  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

torch.set_num_threads(2)
MESH = MeshConfig((1,), ("data",))
JAX_MESH = jax_config_module.MeshConfig((1,), ("data",))
STEPS, SEQ, BATCH = 3, 32, 4


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad) for a in arrays]


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_atol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_logits_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax_common.softmax_xent_logits(jnp.asarray(logits), jnp.asarray(targets),
                                          None if mask is None else jnp.asarray(mask))
    got = softmax_xent_logits(*_t(logits, targets), None if mask is None else _t(mask)[0])
    assert got.dtype == torch.float32
    _close(got, want)
    # a mask that keeps nothing divides by one, as the reference's max(sum, 1)
    zero = softmax_xent_logits(*_t(logits, targets), torch.zeros((3, 7)))
    assert float(zero) == 0.0


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jm = jax_build(jax_config(arch), dtype=jnp.float32)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(get_config(arch), dtype=torch.float32)
        _MODELS[arch] = (jm, jp, tm)
    jm, jp, tm = _MODELS[arch]
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   torch.float32, "cpu")
    return jm, jp, tm, tp


def _batches(arch, step):
    jshape = jax_config_module.InputShape("t", SEQ, BATCH, "train")
    return (jax_make_batch(jax_config(arch), jshape, step=step, dtype=jnp.float32),
            make_batch(get_config(arch), InputShape("t", SEQ, BATCH, "train"), step=step,
                       dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("arch", ["yi-6b-smoke", "granite-8b-smoke"])
@pytest.mark.parametrize("remat", [False, True])
def test_model_loss_matches_reference(arch, remat):
    jm, jp, tm, tp = _models(arch)
    jb, tb = _batches(arch, 0)
    want, wmet = jm.loss(jp, jb)
    got, gmet = tm.loss(tp, tb, remat=remat)
    _close(got, want)
    _close(gmet["xent"], wmet["xent"])
    assert float(gmet["aux"]) == float(wmet["aux"]) == 0.0


# ---------------------------------------------------------------------------
# attention: _blocked and flash_attention_train against the reference's
# _blocked (its custom VJP is the recompute backward)
# ---------------------------------------------------------------------------

BLOCKED_CASES = [  # (b, sq, sk, hq, hkv, d, causal, window, q_offset)
    (2, 1100, 1100, 4, 2, 16, True, 0, 0),        # causal, GQA, ragged 2nd chunk
    (1, 300, 1100, 4, 1, 16, True, 0, 700),       # q_offset, one kv head
    (1, 1100, 1100, 4, 2, 16, True, 100, 0),      # sliding window
    (1, 200, 1100, 4, 2, 16, False, 0, 0),        # bidirectional
    (1, 64, 1100, 2, 2, 8, True, 300, 1036),      # window and q_offset, no GQA
]


def _attn_case(b, sq, sk, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)))


def _reference_blocked(q, k, v, dout, causal, window, q_offset):
    """The reference's out, lse and (dq, dk, dv), dk/dv summed over each
    GQA group."""
    g = q.shape[2] // k.shape[2]
    ke, ve = jnp.repeat(jnp.asarray(k), g, axis=2), jnp.repeat(jnp.asarray(v), g, axis=2)
    _, lse = JATT._blocked_fwd_impl(jnp.asarray(q), ke, ve, causal, window, q_offset)
    out, vjp = jax.vjp(lambda a, b_, c: JATT._blocked(a, b_, c, causal, window, q_offset),
                       jnp.asarray(q), ke, ve)
    dq, dk, dv = (np.asarray(x) for x in vjp(jnp.asarray(dout)))
    b, sk, hkv, d = k.shape
    return (np.asarray(out), np.asarray(lse), dq, dk.reshape(b, sk, hkv, g, d).sum(3),
            dv.reshape(b, sk, hkv, g, d).sum(3))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_offset", BLOCKED_CASES)
def test_blocked_forward_lse_and_gradients_match_reference(b, sq, sk, hq, hkv, d, causal,
                                                           window, q_offset):
    q, k, v, dout = _attn_case(b, sq, sk, hq, hkv, d)
    want = _reference_blocked(q, k, v, dout, causal, window, q_offset)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = TATT._blocked(tq, tk, tv, causal, window, q_offset)
    out.backward(_t(dout)[0])
    _, lse = FA.flash_attention_train_torch(*(t.detach().transpose(1, 2) for t in (tq, tk, tv)),
                                            causal=causal, window=window, q_offset=q_offset)
    for got, ref in zip((out, lse.transpose(1, 2), tq.grad, tk.grad, tv.grad), want):
        _close(got, ref)
    # the model-level operator takes this path beyond the blocked threshold
    # or past the window, K/V in kv-head form
    if sk >= TATT.BLOCKED_THRESHOLD or (window and sk > window):
        _close(TATT.attention(*_t(q, k, v), causal=causal, window=window,
                              q_offset=q_offset), want[0])


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window,q_offset", BLOCKED_CASES[:3])
def test_flash_attention_train_cpu_gradients_match_reference(b, sq, sk, hq, hkv, d, causal,
                                                            window, q_offset):
    """The training op on CPU tensors (kernel layout): its plain forward,
    ``(out, lse)``, and its registered autograd (the recompute rule)."""
    q, k, v, dout = _attn_case(b, sq, sk, hq, hkv, d, seed=1)
    want = _reference_blocked(q, k, v, dout, causal, window, q_offset)
    tq, tk, tv = (t.transpose(1, 2).detach().requires_grad_() for t in _t(q, k, v))
    before = FA.flash_attention_train.launches
    out, lse = FA.flash_attention_train(tq, tk, tv, causal=causal, window=window,
                                        q_offset=q_offset)
    assert not lse.requires_grad and lse.dtype == torch.float32
    out.backward(_t(dout)[0].transpose(1, 2))
    assert FA.flash_attention_train.launches == before     # no kernel on the CPU
    for got, ref in zip((out.transpose(1, 2), lse.transpose(1, 2), tq.grad.transpose(1, 2),
                         tk.grad.transpose(1, 2), tv.grad.transpose(1, 2)), want):
        _close(got, ref)


def test_flash_attention_train_passes_opcheck():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
               for s in ((1, 4, 40, 16), (1, 2, 40, 16), (1, 2, 40, 16)))
    for mask in ((True, 0, -1), (True, 8, -1), (False, 0, -1)):
        torch.library.opcheck(torch.ops.repro_torch.flash_attention_train.default,
                              (q, k, v, *mask))


def test_flash_attention_train_output_is_the_serving_ops_and_lse_marks_empty_rows():
    """On the CPU both ops are plain versions of one function; rows that
    see no key give zeros and an lse of -1e30, as the reference's."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 30, 16), (2, 2, 20, 16), (2, 2, 20, 16)))
    out, lse = FA.flash_attention_train(q, k, v, causal=True, window=0, q_offset=-1)
    np.testing.assert_allclose(out.numpy(), FA.flash_attention(q, k, v).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.all(out[:, :, :10] == 0) and torch.all(lse[:, :, :10] == -1e30)
    assert torch.all(lse[:, :, 10:] > -1e29)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _steps(arch, opt, clip, lr, plan_kw, steps=STEPS):
    """Both packages' trajectories: per step (loss, grad_norm, params)."""
    jm, jp, tm, tp = _models(arch)
    jplan = JaxPlan(strategy=JaxStrategy.LOCAL, **plan_kw)
    tplan = PlanConfig(strategy=Strategy.LOCAL, **plan_kw)
    jtrain = jax_config_module.TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip)
    ttrain = TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip)
    jstep = jax.jit(jax_train_loop.make_train_step(jm, jplan, JAX_MESH, jtrain))
    tstep = make_train_step(tm, tplan, MESH, ttrain)
    jo = jax_train_loop.init_opt_state(opt, jp, jplan)
    to = init_opt_state(opt, tp, tplan)
    out = []
    for i in range(steps):
        jb, tb = _batches(arch, i)
        jp, jo, jmet = jstep(jp, jo, jb, jnp.int32(i))
        tp, to, tmet = tstep(tp, to, tb, i)
        out.append((jmet, tmet, {k: np.asarray(v) for k, v in jp.items()},
                    {k: v.detach().clone() for k, v in tp.items()}))
    return out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_train_step_trajectory_matches_reference(opt, clip):
    lr = 1e-3 if opt == "sgd" else 1e-4
    for jmet, tmet, jp, tp in _steps("yi-6b-smoke", opt, clip, lr, {}):
        _close(tmet["loss"], jmet["loss"])
        _close(tmet["xent"], jmet["xent"])
        _close(tmet["grad_norm"], jmet["grad_norm"], rtol=1e-3)
        for k, want in jp.items():
            got = tp[k].numpy()
            if opt == "sgd":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * STEPS * lr, err_msg=k)
                rms = np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30))
                assert rms <= 3e-3, (k, rms)


@pytest.mark.parametrize("plan_kw", [dict(microbatches=2, remat=False),
                                     dict(microbatches=4, remat=True)],
                         ids=["micro2", "micro4-remat"])
def test_microbatched_train_step_matches_reference(plan_kw):
    for jmet, tmet, jp, tp in _steps("yi-6b-smoke", "sgd", 1.0, 1e-2, plan_kw, steps=2):
        _close(tmet["loss"], jmet["loss"])
        _close(tmet["grad_norm"], jmet["grad_norm"], rtol=1e-3)
        for k, want in jp.items():
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-5, atol=1e-6, err_msg=k)


def test_microbatched_step_matches_unmicrobatched():
    """The reference's test_system twin: gradient accumulation over 4
    microbatches keeps the step (float32 sums in another order)."""
    cfg = get_config("yi-6b-smoke")
    model = build_model(cfg, dtype=torch.float32)
    shape = InputShape("t", 16, 8, "train")
    train = TrainConfig(optimizer="sgd", learning_rate=1e-2, grad_clip=0.0)
    p1 = compile_plan(cfg, shape, MESH, dtype="float32").config.replace(microbatches=1)
    p4 = p1.replace(microbatches=4)
    batch = make_batch(cfg, shape, dtype=torch.float32, device="cpu")
    outs = []
    for plan in (p1, p4):
        params = model.init_params(torch.Generator().manual_seed(0))
        step = make_train_step(model, plan, MESH, train)
        outs.append(step(params, init_opt_state("sgd", params, plan), batch, 0))
    (out1, _, m1), (out4, _, m4) = outs
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for k in out1:
        np.testing.assert_allclose(out1[k].numpy(), out4[k].numpy(), rtol=2e-3, atol=2e-5)


def test_remat_on_equals_off():
    """Recomputing each layer in the backward pass gives the same step."""
    cfg = get_config("yi-6b-smoke")
    model = build_model(cfg, dtype=torch.float32)
    shape = InputShape("t", 32, 4, "train")
    train = TrainConfig(optimizer="adam", learning_rate=1e-3)
    batch = make_batch(cfg, shape, dtype=torch.float32, device="cpu")
    outs = []
    for remat in (False, True):
        plan = PlanConfig(strategy=Strategy.LOCAL, remat=remat)
        params = model.init_params(torch.Generator().manual_seed(0))
        step = make_train_step(model, plan, MESH, train)
        outs.append(step(params, init_opt_state("adam", params, plan), batch, 0))
    (p0, s0, m0), (p1, s1, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    np.testing.assert_allclose(float(m0["grad_norm"]), float(m1["grad_norm"]), rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(p0[k].numpy(), p1[k].numpy(), rtol=1e-6, atol=1e-7)
        for a, b in zip(s0[k], s1[k]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-12)


def test_opt_state_follows_the_plan_dtype():
    cfg = get_config("yi-6b-smoke")
    params = build_model(cfg, dtype=torch.float32).init_params(torch.Generator().manual_seed(0))
    for dt, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        state = init_opt_state("adam", params, PlanConfig(strategy=Strategy.LOCAL,
                                                          opt_state_dtype=dt))
        assert all(s.dtype == want and s.shape == params[k].shape
                   for k in params for s in state[k])
    assert init_opt_state("sgd", params, PlanConfig(strategy=Strategy.LOCAL))["embed"] == ()


def test_multi_device_train_step_raises_and_names_its_slice():
    """A data mesh builds a step (DP or FSDP) and so does a data x model mesh
    (tensor, sequence and expert parallelism under DP_TP and FSDP_TP); each
    runs inside a process group of as many ranks
    (tests/test_torch_train_sharded*.py, tests/test_torch_train_tp*.py) and
    raises outside one; so does a pod mesh, whose pod and data axes are the
    data axes. A mesh with other axes raises and names the meshes the port
    trains over."""
    model = build_model(get_config("yi-6b-smoke"), dtype=torch.float32)
    for over_data in (False, True):
        plan = PlanConfig(strategy=Strategy.FSDP if over_data else Strategy.DATA_PARALLEL,
                          batch_axes=("data",), params_over_data=over_data)
        step = make_train_step(model, plan, MeshConfig((2,), ("data",)), TrainConfig())
        assert callable(step)
        with pytest.raises(RuntimeError, match="process group"):
            step({}, {}, {}, 0)
    for over_data in (False, True):
        for seq_shard in (False, True):
            plan = PlanConfig(strategy=Strategy.FSDP_TP if over_data else Strategy.DP_TP,
                              batch_axes=("data",), tensor_parallel=True,
                              params_over_data=over_data, seq_shard_checkpoints=seq_shard)
            step = make_train_step(model, plan, MeshConfig((2, 2), ("data", "model")),
                                   TrainConfig())
            assert callable(step)
            with pytest.raises(RuntimeError, match="process group"):
                step({}, {}, {}, 0)
    step = make_train_step(model, PlanConfig(strategy=Strategy.DP_TP, tensor_parallel=True,
                                             batch_axes=("pod", "data")),
                           MeshConfig((2, 2, 2), ("pod", "data", "model")), TrainConfig())
    with pytest.raises(RuntimeError, match="process group"):
        step({}, {}, {}, 0)
    with pytest.raises(NotImplementedError, match="'pod', 'data', 'model'"):
        make_train_step(model, PlanConfig(strategy=Strategy.DP_TP, tensor_parallel=True),
                        MeshConfig((2, 2), ("data", "expert")), TrainConfig())


def test_planner_compresses_opt_state_for_yi_6b_on_one_h100():
    """The H100's one-card lattice: full Yi-6B at (4, 2048) does not fit
    with float32 Adam state and fits with bfloat16 state; smoke widths keep
    the reference's single plan."""
    shape = InputShape("cli", 2048, 4, "train")
    plan = compile_plan(get_config("yi-6b"), shape, MESH, TrainConfig())
    assert (plan.config.opt_state_dtype, plan.config.microbatches, plan.config.remat) == \
        ("bfloat16", 1, True)
    assert plan.memory.fits() and "opt-state compressed to bf16 by planner" in plan.explain()
    asked = compile_plan(get_config("yi-6b"), shape, MESH,
                         TrainConfig(opt_state_dtype="bfloat16"))
    assert (asked.config.opt_state_dtype, asked.config.notes) == ("bfloat16", ())
    smoke = compile_plan(get_config("yi-6b-smoke"), shape, MESH, TrainConfig())
    assert (smoke.config.opt_state_dtype, smoke.config.notes) == ("float32", ())


def test_train_cli_runs_on_the_cpu():
    run = train_cli.main(["--device", "cpu", "--steps", "3", "--log-every", "1"])
    losses = [h["loss"] for h in run.timer.history]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert run.plan.config.strategy == Strategy.LOCAL and run.device.type == "cpu"
    assert {"tokens_per_s", "mfu", "grad_norm", "seconds"} <= set(run.timer.history[-1])


def test_train_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])


def test_step_timer_counts_tokens_and_mfu_against_the_h100():
    from repro_torch.hw import H100
    from repro_torch.core.cost import model_flops_per_step
    from repro_torch.runtime.metrics import StepTimer

    cfg = get_config("yi-6b")
    shape = InputShape("cli", 2048, 4, "train")
    timer = StepTimer(model=cfg, shape=shape, mesh=MESH)
    assert timer.hw == H100
    timer.start()
    rec = timer.stop(0, {"loss": torch.tensor(2.0)})
    assert rec["loss"] == 2.0
    assert rec["tokens_per_s"] == pytest.approx(4 * 2048 / rec["seconds"])
    assert rec["mfu"] == pytest.approx(model_flops_per_step(cfg, shape) / rec["seconds"]
                                       / H100.peak_flops)
    assert timer.summary()["loss"] == 2.0


def test_clip_norm_equals_the_references_where_finite_and_survives_overflow():
    """The train step's global norm divides by a power of two before
    squaring: bit for bit the plain float32 sum of squares (the NN library's
    ``global_norm``, the reference's arithmetic) where that is finite, and
    finite where it overflows."""
    from repro.nn.optim import global_norm as jax_global_norm
    from repro_torch.nn.optim import global_norm as plain_global_norm
    from repro_torch.runtime.train_loop import global_norm

    rng = np.random.default_rng(5)
    grads = [rng.standard_normal((40, 30)).astype(np.float32) * 3,
             rng.standard_normal(7).astype(np.float32) * 1e3, np.zeros(3, np.float32)]
    want = float(jax_global_norm([jnp.asarray(g) for g in grads]))
    assert float(global_norm(_t(*grads))) == float(plain_global_norm(_t(*grads)))
    assert float(global_norm(_t(*grads))) == pytest.approx(want, rel=1e-6)
    big = [g * np.float32(1e25) for g in grads]
    assert not np.isfinite(float(jax_global_norm([jnp.asarray(g) for g in big])))
    got = float(global_norm(_t(*big)))
    assert np.isfinite(got) and got == pytest.approx(want * 1e25, rel=1e-6)
    assert float(global_norm([torch.zeros(4)])) == 0.0
