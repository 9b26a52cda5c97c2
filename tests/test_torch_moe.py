"""PyTorch port, the MoE family (``models/blocks.py::moe_ffn``,
``routing_tables``, the dispatch and combine functions, ``Model`` with
experts, ``PlanServer`` and the train step) against the reference on the
same seeded inputs and on weights converted by ``repro_torch.interop``.

``qwen3-moe-235b-a22b-smoke`` and ``dbrx-132b-smoke`` are dropless (4
experts, top-2, capacity factor 2.0: the capacity exceeds a group's
tokens). The dropping variant sets the capacity factor to 1.0 at 192 tokens
of which 128 share two experts, tied in probability for every token (their
router columns are equal), so tokens past each expert's capacity drop and
the tie order decides which expert comes first.

Tolerances, float32:

- routing tables: exactly equal, integers and masks;
- ``moe_ffn``'s output: ``atol = rtol = 1e-5`` (router and expert products
  summed in another order; measured ~1e-6 of outputs of ~2); ``aux``:
  ``rtol = 1e-5``; the top-k experts exactly equal;
- its gradients (x, router and the three expert weights) against
  ``jax.grad``: ``rtol = 1e-5`` with an ``atol`` of 1e-5 of the largest
  entry (measured up to 6e-7 of it);
- the model's logits, prefill cache and decode steps: ``atol = rtol =
  1e-4``, as ``tests/test_torch_model.py``; greedy tokens identical;
  decode against the reference's full forward at that test's own 5e-3;
- ``PlanServer`` streams: byte-identical;
- train steps: ``tests/test_torch_train.py``'s (loss, xent and aux
  ``rtol = 1e-5``; grad_norm ``rtol = 1e-3``; parameters under SGD
  ``atol = rtol = 1e-5``, under Adam every element within ``2 * steps * lr``
  and the error's RMS within 3e-3 of the parameter's).
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
from repro.models import blocks as JB  # noqa: E402
from repro.models.common import NULL_CTX  # noqa: E402
from repro.models.model import MOE_AUX_COEF as JAX_AUX_COEF  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime import train_loop as jax_train_loop  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import InputShape, MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.strategies import PlanConfig, Strategy  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models.model import MOE_AUX_COEF, build_model  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

torch.set_num_threads(2)
ARCHES = ["qwen3-moe-235b-a22b-smoke", "dbrx-132b-smoke"]
TOL = dict(atol=1e-4, rtol=1e-4)
FFN_TOL = dict(atol=1e-5, rtol=1e-5)
TABLES = ("j_of_slot", "s_valid", "slot_of_j", "j_valid")


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_atol * max(np.abs(want).max(), 1e-30))


def _f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# routing tables
# ---------------------------------------------------------------------------


def _assignments(kind, rng, tokens, e, kk):
    """(tokens * k,) expert of each (token, k) pair, each token's k
    experts distinct (as top-k gives them)."""
    if kind == "one expert":
        # every token's first pair on expert 0, its others spread: expert 0
        # takes a slot from every token
        rest = np.stack([rng.permutation(np.arange(1, e))[:kk - 1] for _ in range(tokens)])
        return np.concatenate([np.zeros((tokens, 1), np.int64), rest], 1).reshape(-1)
    picks = np.stack([rng.permutation(e)[:kk] for _ in range(tokens)])
    if kind == "overflow":
        # two hot experts take most tokens' pairs
        hot = rng.random(tokens) < 0.8
        picks[hot, 0], picks[hot, 1] = 2, 5
        for t in np.flatnonzero(hot):      # keep each token's k experts distinct
            others = [x for x in rng.permutation(e) if x not in (2, 5)]
            picks[t, 2:] = others[:kk - 2]
    return picks.reshape(-1)


@pytest.mark.parametrize("kind,tokens,e,kk,cap", [
    ("random", 50, 8, 2, 16), ("random", 37, 6, 3, 24),
    ("one expert", 40, 4, 2, 16), ("overflow", 64, 8, 4, 16)])
def test_routing_tables_equal_reference(kind, tokens, e, kk, cap):
    rng = np.random.default_rng(3)
    flat = _assignments(kind, rng, tokens, e, kk)
    want = JB._routing_tables(jnp.asarray(flat, jnp.int32), e, cap, kk)
    got = TB.routing_tables(torch.from_numpy(flat), e, cap)
    for name, w, g in zip(TABLES, want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if kind != "random":      # some pairs drop
        assert not bool(got[3].all())


# ---------------------------------------------------------------------------
# moe_ffn and its gradients
# ---------------------------------------------------------------------------


def _layer_params(arch, capacity_factor=None):
    """(reference cfg, port cfg, layer 0's parameters as numpy arrays) from
    the reference's ``init_params``."""
    jc, tc = jax_config(arch), get_config(arch)
    if capacity_factor is not None:
        jc = jc.replace(moe_capacity_factor=capacity_factor)
        tc = tc.replace(moe_capacity_factor=capacity_factor)
    jp = jax_build(jc, dtype=jnp.float32).init_params(jax.random.PRNGKey(0))
    return jc, tc, {k[2:]: np.array(v[0]) for k, v in jp.items() if k.startswith("l.")}


# (arch, capacity factor, batch, seq): the smoke configs as registered
# (dropless), and the dropping variant with tied experts
FFN_CASES = [("qwen3-moe-235b-a22b-smoke", None, 3, 12), ("dbrx-132b-smoke", None, 2, 20),
             ("qwen3-moe-235b-a22b-smoke", 1.0, 3, 64)]


def _ffn_inputs(arch, cf, b, s):
    jc, tc, lp = _layer_params(arch, cf)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    if cf is not None:
        # experts 0 and 1 tie for every token; rows 0 and 1 (equal) lean to
        # them, so both take 128 pairs of the 192 tokens against a capacity
        # of 104
        lp["router"][:, 1] = lp["router"][:, 0]
        u = lp["router"][:, 0] / np.linalg.norm(lp["router"][:, 0])
        x[0] += 6.0 * u
        x[1] = x[0]
    return jc, tc, lp, x


@pytest.mark.parametrize("arch,cf,b,s", FFN_CASES, ids=["qwen3", "dbrx", "qwen3-dropping"])
def test_moe_ffn_matches_reference(arch, cf, b, s):
    jc, tc, lp, x = _ffn_inputs(arch, cf, b, s)
    want, want_aux = JB.moe_ffn(jc, {k: jnp.asarray(v) for k, v in lp.items()},
                                jnp.asarray(x), NULL_CTX)
    got, aux = TB.moe_ffn(tc, {k: torch.from_numpy(v) for k, v in lp.items()},
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFN_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # the same experts, in the same order, for every token
    xf = x.reshape(-1, x.shape[-1])
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(lp["router"]), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jc.experts_per_token)
    tprobs = torch.softmax(torch.from_numpy(xf) @ torch.from_numpy(lp["router"]), dim=-1)
    tidx = torch.sort(tprobs, dim=-1, descending=True, stable=True)[1][:, :tc.experts_per_token]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if cf is not None:
        # the tied pair: expert 0 before expert 1 wherever both are taken
        both = (tidx == 0).any(1) & (tidx == 1).any(1)
        assert int(both.sum()) >= 128
        first = torch.argmax((tidx == 0).int(), 1) < torch.argmax((tidx == 1).int(), 1)
        assert bool(first[both].all())
        t = b * s
        cap = max(8, -(-(int(t * tc.experts_per_token * cf / tc.num_experts) + 1) // 8) * 8)
        _, _, _, j_valid = TB.routing_tables(tidx.reshape(-1), tc.num_experts, cap)
        assert int((~j_valid).sum()) > 0          # pairs were dropped


@pytest.mark.parametrize("arch,cf,b,s", FFN_CASES, ids=["qwen3", "dbrx", "qwen3-dropping"])
def test_moe_ffn_gradients_match_reference(arch, cf, b, s):
    jc, tc, lp, x = _ffn_inputs(arch, cf, b, s)
    rng = np.random.default_rng(12)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    names = ("router", "e_wg", "e_wu", "e_wd")

    def ref_loss(p, xx):
        y, aux = JB.moe_ffn(jc, p, xx, NULL_CTX)
        return jnp.sum(y * ct) + 0.5 * aux

    jgp, jgx = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(k in names) for k, v in lp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TB.moe_ffn(tc, tp, tx)
    ((y * torch.from_numpy(ct)).sum() + 0.5 * aux).backward()
    _close(tx.grad, jgx)
    for k in names:
        _close(tp[k].grad, jgp[k])


def test_dispatch_and_combine_backward_pass_gradcheck():
    """The hand-written gather backwards equal the numerical gradient
    (``torch.autograd.gradcheck`` in float64), with dropped pairs and empty
    slots."""
    rng = np.random.default_rng(5)
    tokens, e, kk, cap, d = 24, 4, 2, 8, 6
    flat = torch.from_numpy(_assignments("one expert", rng, tokens, e, kk))
    tables = TB.routing_tables(flat, e, cap)
    x, out, w = (torch.from_numpy(a).requires_grad_() for a in (
        rng.standard_normal((tokens, d)), rng.standard_normal((e * cap, d)),
        rng.random(tokens * kk)))
    assert torch.autograd.gradcheck(lambda a: TB._MoEDispatch.apply(a, kk, *tables), (x,))
    assert torch.autograd.gradcheck(lambda a, b: TB._MoECombine.apply(a, b, kk, *tables),
                                    (out, w))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

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


def _prompts(arch, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jax_config(arch).vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "dbrx-132b"])
def test_full_configs_build_with_the_reference_parameters(arch):
    """The full configs build; every parameter key, shape and logical axis is
    the reference's (the experts stacked (L, E, D, F)), so weights convert
    one to one."""
    jm = jax_build(jax_config(arch), dtype=jnp.bfloat16)
    tm = build_model(get_config(arch), dtype=torch.bfloat16)
    want = jm.param_specs()
    got = tm.param_specs()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert tm.param_axes() == jm.param_axes()
    assert tm.param_count() == jm.param_count()
    assert tuple(got["l.e_wg"].shape) == (jax_config(arch).num_layers,
                                         jax_config(arch).num_experts,
                                         jax_config(arch).d_model, jax_config(arch).d_ff)
    assert "l.wg" not in got and "l.router" in got


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("remat", [False, True])
def test_apply_and_loss_match_reference(arch, remat):
    jm, jp, tm, tp = _models(arch)
    jshape = jax_config_module.InputShape("t", 16, 3, "train")
    jb = jax_make_batch(jax_config(arch), jshape, step=0, dtype=jnp.float32)
    tb = make_batch(get_config(arch), InputShape("t", 16, 3, "train"), step=0,
                    dtype=torch.float32, device="cpu")
    jl, jaux = jm.apply(jp, jb["tokens"])
    tl, taux = tm.apply(tp, tb["tokens"], remat=remat)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0.0
    want, wmet = jm.loss(jp, jb)
    got, gmet = tm.loss(tp, tb, remat=remat)
    _close(got, want)
    _close(gmet["xent"], wmet["xent"])
    _close(gmet["aux"], wmet["aux"])
    # the auxiliary loss enters the total with the reference's coefficient
    assert MOE_AUX_COEF == JAX_AUX_COEF
    _close(got, gmet["xent"] + MOE_AUX_COEF * gmet["aux"], rtol=1e-7)


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_matches_full_forward(arch):
    """The reference's ``test_decode_matches_full_forward`` through the port:
    token by token from a zero cache equals the full forward (the
    reference's, at that test's 5e-3, and each step the reference's decode
    step at 1e-4)."""
    jm, jp, tm, tp = _models(arch)
    b, s = 2, 12
    toks = _prompts(arch, b, s)
    full, _ = jm.apply(jp, jnp.asarray(toks))
    jcache, tcache = jm.init_cache(b, s), tm.init_cache(b, s, "cpu")
    jstep = jax.jit(jm.decode_step)
    outs = []
    for t in range(s):
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tlg, _ = tm.decode_step(tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                                torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        outs.append(tlg[:, 0])
    np.testing.assert_allclose(_f32(torch.stack(outs, 1)), _f32(full), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_handoff_then_decode_match_reference(arch):
    """Prefill of mixed prompt lengths (the padded rows route too), the
    cache handed to decode, then 8 greedy steps at per-row positions: the
    logits, the cache and the tokens those of the reference."""
    jm, jp, tm, tp = _models(arch)
    lens = np.asarray([30, 7, 19], np.int32)
    toks = _prompts(arch, 3, 30, seed=4)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=48)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=48)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), atol=1e-3, rtol=1e-4)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jpos, tpos = jnp.asarray(lens), torch.from_numpy(lens.copy())
    jstep = jax.jit(jm.decode_step)
    for _ in range(8):
        jlg, jc = jstep(jp, jc, jt, jpos)
        tlg, tc = tm.decode_step(tp, tc, tt, tpos)
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jpos, tpos = jpos + 1, tpos + 1


# ---------------------------------------------------------------------------
# PlanServer
# ---------------------------------------------------------------------------


def _private_tables(self):
    """The reference arena's page table uploaded from a private copy
    (``tests/test_torch_serve.py`` explains the race this avoids)."""
    if self._tables_dirty:
        self._tables = jnp.asarray(self._tables_np.copy())
        self._tables_dirty = False
    return self._tables


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("kernel", ["paged", "gather"])
def test_plan_server_streams_equal_reference(monkeypatch, arch, kernel):
    monkeypatch.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
    jsrv = JaxPlanServer(jax_config(arch), config=JaxEngineConfig(
        dtype="float32", prefill=True, page_size=16, decode_kernel=kernel))
    srv = PlanServer(get_config(arch), config=EngineConfig(
        dtype="float32", prefill=True, page_size=16, decode_kernel=kernel), device="cpu")
    srv.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.params.items()}, torch.float32, "cpu")
    for batch, context in ((1, 40), (3, 100), (2, 17)):
        jout = jsrv.handle(JaxRequest(batch, context, new_tokens=6))
        out = srv.handle(ServeRequest(batch, context, new_tokens=6))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["finish_reason"] == jout["finish_reason"]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEPS, SEQ, BATCH = 3, 32, 4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(opt, remat):
    arch = "qwen3-moe-235b-a22b-smoke"
    lr = 1e-3 if opt == "sgd" else 1e-4
    jm, jp, tm, tp = _models(arch)
    jplan = JaxPlan(strategy=JaxStrategy.LOCAL, remat=remat)
    tplan = PlanConfig(strategy=Strategy.LOCAL, remat=remat)
    jtrain = jax_config_module.TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=1.0)
    jstep = jax.jit(jax_train_loop.make_train_step(
        jm, jplan, jax_config_module.MeshConfig((1,), ("data",)), jtrain))
    tstep = make_train_step(tm, tplan, MeshConfig((1,), ("data",)),
                            TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=1.0))
    jo = jax_train_loop.init_opt_state(opt, jp, jplan)
    to = init_opt_state(opt, tp, tplan)
    for i in range(STEPS):
        jb = jax_make_batch(jax_config(arch), jax_config_module.InputShape(
            "t", SEQ, BATCH, "train"), step=i, dtype=jnp.float32)
        tb = make_batch(get_config(arch), InputShape("t", SEQ, BATCH, "train"), step=i,
                        dtype=torch.float32, device="cpu")
        jp, jo, jmet = jstep(jp, jo, jb, jnp.int32(i))
        tp, to, tmet = tstep(tp, to, tb, i)
        for key in ("loss", "xent", "aux"):
            _close(tmet[key], jmet[key])
        assert float(tmet["aux"]) > 0.0
        _close(tmet["grad_norm"], jmet["grad_norm"], rtol=1e-3)
    for k, want in jp.items():
        got, want = tp[k].numpy(), np.asarray(want)
        if opt == "sgd":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * STEPS * lr, err_msg=k)
            rms = np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30))
            assert rms <= 3e-3, (k, rms)
