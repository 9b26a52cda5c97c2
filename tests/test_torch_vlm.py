"""PyTorch port, the vision family (InternVL2's patch prefix): ``Model.apply``
with ``patch_embeds`` put before the text, ``prefill`` without a handoff,
decode, ``PlanServer`` and the train step, against the reference on
``internvl2-2b-smoke`` (2 layers, 16 prefix tokens, GQA 4/2), on the
reference's ``init_params`` converted by ``repro_torch.interop`` and inputs
made with numpy from a seed.

Tolerances: float32 ``atol = rtol = 1e-4`` and bfloat16 ``3e-2``
(``tests/test_torch_model.py``'s ``TOL`` and ``BF16_TOL``); greedy and
``PlanServer`` streams byte-identical; train steps
``tests/test_torch_train.py``'s (loss and xent ``rtol = 1e-5``; grad_norm
``rtol = 1e-3``; parameters under SGD ``atol = rtol = 1e-5``, under Adam
every element within ``2 * steps * lr`` and the error's RMS within 3e-3 of
the parameter's).
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
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime import train_loop as jax_train_loop  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.kv_cache import KVCachePool as JaxPool  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import InputShape, MeshConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.strategies import PlanConfig, Strategy  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.kv_cache import KVCachePool  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

torch.set_num_threads(2)
ARCH = "internvl2-2b-smoke"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
_MODELS = {}


def _f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _models(dtype_name="float32"):
    if dtype_name not in _MODELS:
        jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        jm = jax_build(jax_config(ARCH), dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(get_config(ARCH), dtype=tdt)
        _MODELS[dtype_name] = (jm, jp, tm, tdt)
    jm, jp, tm, tdt = _MODELS[dtype_name]
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tdt, "cpu")
    return jm, jp, tm, tp


def _inputs(b, s, seed=1):
    """Seeded tokens (B, S) and patch embeddings (B, P, D), float32."""
    cfg = jax_config(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pe = rng.standard_normal((b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, pe


@pytest.mark.parametrize("arch", ["internvl2-2b", ARCH])
def test_configs_build_with_the_reference_parameters(arch):
    jm = jax_build(jax_config(arch), dtype=jnp.bfloat16)
    tm = build_model(get_config(arch), dtype=torch.bfloat16)
    want, got = jm.param_specs(), tm.param_specs()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert tm.param_axes() == jm.param_axes()
    assert tm.param_count() == jm.param_count()
    assert "head" in got and "l.wg" in got                # untied, SwiGLU
    assert not tm.supports_handoff
    specs, axes = tm.cache_specs(2, 64)
    jspecs, jaxes = jm.cache_specs(2, 64)
    assert axes == jaxes and {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_with_the_patch_prefix_matches_reference(dtype):
    """The prefix cast to the activation dtype and put before the text,
    positions over both: the logits of the text positions only, and
    ``last_only`` the last position's; without ``patch_embeds`` the text
    alone."""
    jm, jp, tm, tp = _models(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    toks, pe = _inputs(2, 12)
    jl, _ = jm.apply(jp, jnp.asarray(toks), extra={"patch_embeds": jnp.asarray(pe)})
    tl, aux = tm.apply(tp, torch.from_numpy(toks), {"patch_embeds": torch.from_numpy(pe)})
    assert tl.shape == (2, 12, jax_config(ARCH).vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    jlast, _ = jm.apply(jp, jnp.asarray(toks), extra={"patch_embeds": jnp.asarray(pe)},
                        last_only=True)
    tlast, _ = tm.apply(tp, torch.from_numpy(toks), {"patch_embeds": torch.from_numpy(pe)},
                        last_only=True)
    np.testing.assert_allclose(_f32(tlast), _f32(jlast), **tol)
    np.testing.assert_allclose(_f32(tlast[:, 0]), _f32(tl[:, -1]), **tol)
    jtext, _ = jm.apply(jp, jnp.asarray(toks))
    ttext, _ = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_f32(ttext), _f32(jtext), **tol)
    # the prefix reaches the text positions
    assert float(np.abs(_f32(ttext) - _f32(tl)).max()) > 1e-2


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_reference(remat):
    jm, jp, tm, tp = _models()
    shape = ("t", 16, 3, "train")
    jb = jax_make_batch(jax_config(ARCH), jax_config_module.InputShape(*shape), step=0,
                        dtype=jnp.float32)
    tb = make_batch(get_config(ARCH), InputShape(*shape), step=0, dtype=torch.float32,
                    device="cpu")
    np.testing.assert_array_equal(tb["patch_embeds"].numpy(), np.asarray(jb["patch_embeds"]))
    want, wmet = jm.loss(jp, jb)
    got, gmet = tm.loss(tp, tb, remat=remat)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gmet["xent"]), float(wmet["xent"]), rtol=1e-5)


@pytest.mark.parametrize("prefix", [False, True])
def test_prefill_has_no_handoff_as_reference(prefix):
    """A family without a handoff: the last position's logits of the prompt
    pass (``lengths`` unread) and no cache."""
    jm, jp, tm, tp = _models()
    toks, pe = _inputs(3, 20, seed=4)
    lens = np.asarray([20, 7, 13], np.int32)
    jextra = {"patch_embeds": jnp.asarray(pe)} if prefix else None
    textra = {"patch_embeds": torch.from_numpy(pe)} if prefix else None
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jextra, lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), textra, lengths=torch.from_numpy(lens))
    assert jc is None and tc is None
    assert tl.shape == (3, jax_config(ARCH).vocab_size)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)


def _decode_run(kernel, steps, b=3, seq=32, page=16):
    """Greedy decode from a zero cache, token 1 at position 0, as the
    engine runs a family without a handoff: ``kernel`` "dense" (per-row
    rows) or a paged read through each package's own pool."""
    jm, jp, tm, tp = _models()
    if kernel == "dense":
        jcache, tcache, jkw, tkw = jm.init_cache(b, seq), tm.init_cache(b, seq, "cpu"), {}, {}
    else:
        jpool, tpool = JaxPool(jm, page_size=page), KVCachePool(tm, "cpu", page_size=page)
        ja, ta = jpool.acquire(b, seq), tpool.acquire(b, seq)
        assert jpool.admit_request_rows(ja, b, prompt=0, span=steps + 1, eager=True) == \
            tpool.admit_request_rows(ta, b, prompt=0, span=steps + 1, eager=True)
        jcache, tcache = ja.cache, ta.cache
        jkw = dict(tables=ja.tables, page=page, seq_len=seq, decode_kernel=kernel)
        tkw = dict(tables=ta.tables, page=page, seq_len=seq, decode_kernel=kernel)
    jstep = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, **jkw))
    jt, tt = jnp.ones((b, 1), jnp.int32), torch.ones((b, 1), dtype=torch.int32)
    jpos, tpos = jnp.zeros((b,), jnp.int32), torch.zeros((b,), dtype=torch.int32)
    out = []
    for _ in range(steps):
        jlg, jcache = jstep(jp, jcache, jt, jpos)
        tlg, tcache = tm.decode_step(tp, tcache, tt, tpos, **tkw)
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        out.append((np.asarray(jt), tt.numpy()))
        jpos, tpos = jpos + 1, tpos + 1
    return out


@pytest.mark.parametrize("kernel", ["dense", "paged", "gather", "ref"])
def test_decode_matches_reference(kernel):
    """Each tick's logits at ``TOL``; 16 greedy tokens byte-identical."""
    out = _decode_run(kernel, steps=16)
    np.testing.assert_array_equal(np.concatenate([o[1] for o in out], 1),
                                  np.concatenate([o[0] for o in out], 1))


def _private_tables(self):
    """The reference arena's page table uploaded from a private copy
    (``tests/test_torch_serve.py`` explains the race this avoids)."""
    if self._tables_dirty:
        self._tables = jnp.asarray(self._tables_np.copy())
        self._tables_dirty = False
    return self._tables


@pytest.mark.parametrize("kernel", ["paged", "gather"])
def test_plan_server_streams_equal_reference(monkeypatch, kernel):
    """``prefill=True``: the prompt pass gives the first token (text only:
    the server's prompt pass carries no prefix) and no cache, so decode
    starts from a zero cache at position 0, as the reference's engine does;
    the streams byte-identical."""
    monkeypatch.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
    jsrv = JaxPlanServer(jax_config(ARCH), config=JaxEngineConfig(
        dtype="float32", prefill=True, page_size=16, decode_kernel=kernel))
    srv = PlanServer(get_config(ARCH), config=EngineConfig(
        dtype="float32", prefill=True, page_size=16, decode_kernel=kernel), device="cpu")
    srv.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.params.items()}, torch.float32, "cpu")
    for batch, context in ((1, 40), (3, 100), (2, 17)):
        jout = jsrv.handle(JaxRequest(batch, context, new_tokens=6))
        out = srv.handle(ServeRequest(batch, context, new_tokens=6))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["finish_reason"] == jout["finish_reason"]


STEPS, SEQ, BATCH = 3, 16, 4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(opt, remat):
    """One device, the batch's patch prefix before the text."""
    lr = 1e-3 if opt == "sgd" else 1e-4
    jm, jp, tm, tp = _models()
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
        jb = jax_make_batch(jax_config(ARCH), jax_config_module.InputShape(
            "t", SEQ, BATCH, "train"), step=i, dtype=jnp.float32)
        tb = make_batch(get_config(ARCH), InputShape("t", SEQ, BATCH, "train"), step=i,
                        dtype=torch.float32, device="cpu")
        jp, jo, jmet = jstep(jp, jo, jb, jnp.int32(i))
        tp, to, tmet = tstep(tp, to, tb, i)
        for key in ("loss", "xent"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-3)
    for k, want in jp.items():
        got, want = tp[k].numpy(), np.asarray(want)
        if opt == "sgd":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * STEPS * lr, err_msg=k)
            rms = np.sqrt(((got - want) ** 2).mean() / max((want ** 2).mean(), 1e-30))
            assert rms <= 3e-3, (k, rms)
