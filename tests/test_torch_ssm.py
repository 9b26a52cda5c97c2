"""PyTorch port, SSM family: ``mamba2-1.3b-smoke`` through both packages on
the same weights (the reference's ``init_params``, converted by
``repro_torch.interop``) and the same seeded random prompts, from the
causal convolution up to ``PlanServer.handle``.

- float32, ``atol = rtol = 1e-4``: block outputs, prefill logits at mixed
  prompt lengths, the handed-off cache entries and every decode step's
  logits (two layers of matmuls and scans summed in another order); greedy
  token streams must be identical;
- bfloat16 prefill logits within ``3e-2``: each package rounds its bf16
  matmul outputs and activations at its own places (one bf16 ulp at these
  magnitudes is ~4e-3);
- ``PlanServer.handle``: tokens, buckets, pool counters, ``peak_bytes`` and
  ``live_bytes`` equal to the reference's, for the pure-recurrent arena too
  (no pages, no page table, rows charged their recurrent bytes).
"""

import io
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.common import causal_conv1d as jax_conv  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.kv_cache import KVCachePool as JaxPool  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro.runtime.serve_loop import greedy_decode as jax_greedy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models.common import causal_conv1d  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.kv_cache import KVCachePool  # noqa: E402
from repro_torch.runtime.serve_loop import (PlanServer, ServeRequest,  # noqa: E402
                                            greedy_decode, make_decode_step)

torch.set_num_threads(2)
ARCH = "mamba2-1.3b-smoke"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
COUNTERS = ("pages_leased", "pages_freed", "pages_denied", "rows_leased",
            "rows_reused", "handoff_writes", "arenas_created", "arenas_reused",
            "pages_reclaimed", "peak_pages")
_MODELS, _SERVERS = {}, {}


def _models(dtype_name: str):
    """(jax model, jax params, torch model, torch params), built once per
    dtype for the module."""
    if dtype_name not in _MODELS:
        jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        jm = jax_build(jax_config(ARCH), dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(get_config(ARCH), dtype=tdt)
        tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                       tdt, "cpu")
        _MODELS[dtype_name] = (jm, jp, tm, tp)
    return _MODELS[dtype_name]


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    vocab = jax_config(ARCH).vocab_size
    return (rng.integers(0, vocab, (len(lengths), max(lengths))).astype(np.int32),
            np.asarray(lengths, np.int32))


def _layer0(jp, tp):
    jl = {k[2:]: v[0] for k, v in jp.items() if k.startswith("l.")}
    tl = {k[2:]: v[0] for k, v in tp.items() if k.startswith("l.")}
    return jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["sequence", "step"])
def test_causal_conv1d_matches_reference(form, dtype):
    """float32 within 1e-5; bfloat16 within one output ulp (2^-7 relative):
    the port sums the taps in float32 and rounds once."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1 if form == "step" else 24, 40)).astype(np.float32)
    w = rng.normal(size=(4, 40)).astype(np.float32)
    state = rng.normal(size=(2, 3, 40)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=2 ** -7)
    jx, jw, js = (jnp.asarray(v, jdt) for v in (x, w, state))
    tx, tw, ts = (torch.from_numpy(v).to(tdt) for v in (x, w, state))
    if form == "step":
        jy, jnew = jax_conv(jx, jw, state=js)
        ty, tnew = causal_conv1d(tx, tw, state=ts)
        np.testing.assert_array_equal(_f32(tnew), _f32(jnew))
    else:
        jy, ty = jax_conv(jx, jw), causal_conv1d(tx, tw)
    assert ty.dtype == tdt and tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **tol)


def test_ssd_block_apply_and_decode_match_reference():
    """One SSD block at mixed prompt lengths: its output, the decode state it
    hands off (closed-form SSD state from the unrounded float32 x/B, conv
    tails of the raw inputs), and three decode steps from that state, each
    updating the cache in place."""
    jm, jp, tm, tp = _models("float32")
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 32, cfg.d_model)).astype(np.float32)
    lens = np.asarray([32, 5, 17], np.int32)
    japply = jax.jit(lambda p, x, n: JB.ssd_block_apply(jcfg, p, x, lengths=n,
                                                         want_cache=True))
    jdecode = jax.jit(lambda p, x, c: JB.ssd_block_decode(jcfg, p, x, c, None))
    jout, _, jc = japply(jl, jnp.asarray(x), jnp.asarray(lens))
    tout, tc = TB.ssd_block_apply(cfg, tl, torch.from_numpy(x),
                                  lengths=torch.from_numpy(lens), want_cache=True)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
    assert set(tc) == set(jc) == {"state", "conv_x", "conv_b", "conv_c"}
    for k in jc:
        assert tc[k].dtype == (torch.float32 if k == "state" else tm.dtype)
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **TOL)
    assert TB.ssd_block_apply(cfg, tl, torch.from_numpy(x)).shape == tout.shape
    held = {k: v.data_ptr() for k, v in tc.items()}
    for step in range(3):
        xs = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jdecode(jl, jnp.asarray(xs), jc)
        to = TB.ssd_block_decode(cfg, tl, torch.from_numpy(xs), tc)
        np.testing.assert_allclose(_f32(to), _f32(jo), **TOL)
        for k in jc:
            np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **TOL)
    assert {k: v.data_ptr() for k, v in tc.items()} == held


@pytest.mark.parametrize("lengths", [[40, 17, 32], [64, 1, 50]])
def test_prefill_logits_and_cache_match_reference(lengths):
    jm, jp, tm, tp = _models("float32")
    toks, lens = _prompts(lengths)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=96)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=96)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **TOL)
    jfull, _ = jm.apply(jp, jnp.asarray(toks))
    tfull, aux = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_f32(tfull), _f32(jfull), **TOL)
    assert float(aux) == 0.0


def test_bf16_prefill_logits_within_tolerance():
    jm, jp, tm, tp = _models("bfloat16")
    toks, lens = _prompts([40, 17, 32])
    jl, _ = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens))
    assert tl.dtype == torch.bfloat16 and tc["l.state"].dtype == torch.float32
    assert np.isfinite(_f32(tl)).all()
    np.testing.assert_allclose(_f32(tl), _f32(jl), **BF16_TOL)


@pytest.mark.parametrize("page", [0, 16])
def test_handoff_then_greedy_tokens_identical_to_reference(page):
    """Prefill at mixed lengths, the cache written into each package's
    arena (page 16: a pure-recurrent paged arena with no page table), then
    12 greedy tokens from ``greedy_decode``: identical streams, and every
    handed-off entry allclose."""
    jm, jp, tm, tp = _models("float32")
    toks, lens = _prompts([40, 9, 33])
    seq, steps = 64, 12
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=seq)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=seq)
    jpool, tpool = JaxPool(jm, page_size=page), KVCachePool(tm, "cpu", page_size=page)
    ja, ta = jpool.acquire(3, seq), tpool.acquire(3, seq)
    jrows = jpool.admit_request_rows(ja, 3, prompt=40, span=40 + steps, eager=True)
    trows = tpool.admit_request_rows(ta, 3, prompt=40, span=40 + steps, eager=True)
    assert jrows == trows
    jpool.write_rows(ja, jrows, jc)
    tpool.write_rows(ta, trows, tc)
    for k in ja.cache:
        np.testing.assert_allclose(_f32(ta.cache[k]), _f32(ja.cache[k]), **TOL)
    assert ta.tables is None and ja.tables is None
    jfirst = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tfirst = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jkw, tkw = dict(decode_step=jax.jit(jm.decode_step)), {}
    if page:
        jkw = dict(decode_step=jax.jit(lambda p, c, t, q: jm.decode_step(
            p, c, t, q, tables=None, page=page, seq_len=seq)))
        step = make_decode_step(tm, page=page, seq_len=seq)
        tkw = dict(decode_step=lambda p, c, t, q: step(p, c, t, q, ta.tables))
    jtoks, _ = jax_greedy(jm, jp, ja.cache, jfirst, jnp.asarray(lens), steps, **jkw)
    ttoks, _ = greedy_decode(tm, tp, ta.cache, tfirst, torch.from_numpy(lens.copy()),
                             steps, **tkw)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_decode_step_logits_match_reference():
    jm, jp, tm, tp = _models("float32")
    toks, lens = _prompts([12, 30, 7])
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens))
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jstep = jax.jit(jm.decode_step)
    for i in range(4):
        jlg, jc = jstep(jp, jc, jt, jnp.asarray(lens + i))
        tlg, tc = tm.decode_step(tp, tc, tt, torch.from_numpy(lens + i))
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch,page", [("mamba2-1.3b-smoke", 16), ("mamba2-1.3b-smoke", 64),
                                       ("yi-6b-smoke", 16)])
def test_arena_params_and_member_bytes_match_reference(arch, page):
    """The pool's per-arena charges: pages for paged entries, rows for the
    rest. The SSM family has no paged entry (0 pages, 39,680 bytes of state
    and conv tails per row at float32); the dense family's row charge is 0,
    so its numbers do not move."""
    jm = jax_build(jax_config(arch), dtype=jnp.float32)
    tm = build_model(get_config(arch), dtype=torch.float32)
    jpool, tpool = JaxPool(jm, page_size=page), KVCachePool(tm, "cpu", page_size=page)
    for batch, seq in ((1, 64), (2, 128), (4, 256)):
        jp_, tp_ = jpool._arena_params(batch, seq), tpool._arena_params(batch, seq)
        assert len(tp_) == len(jp_) == 6
        assert tp_[1:] == tuple(jp_[1:])
        for span in (1, 40, seq):
            assert tpool.span_pages(seq, span) == jpool.span_pages(seq, span)
            assert tpool.member_bytes(seq, batch, span) == jpool.member_bytes(seq, batch, span)
    row_nbytes = tpool._arena_params(2, 128)[4]
    assert row_nbytes == (39_680 if arch.startswith("mamba2") else 0)


def test_pure_recurrent_arena_leases_rows_only():
    """A paged pool over the SSM family: no allocator, no page table, no
    pages granted at admission or decode, and live bytes are exactly the
    leased rows' recurrent bytes."""
    _jm, _jp, tm, _tp = _models("float32")
    pool = KVCachePool(tm, "cpu", page_size=16)
    arena = pool.acquire(4, 128, demand_bytes=pool.member_bytes(128, 3, 100))
    assert arena.allocator is None and arena.tables is None and arena.n_pages == 0
    assert pool.member_bytes(128, 3, 100) == 3 * arena.row_nbytes
    rows = pool.admit_request_rows(arena, 3, prompt=90, span=100)
    assert arena.span_pages(100) == 0 and arena.pages_committed == 0
    pool.ensure_decode_slots(arena, rows, 95)
    assert pool.live_bytes() == 3 * arena.row_nbytes
    assert pool.metrics.peak_bytes == 3 * arena.row_nbytes
    pool.free_rows(arena, rows[:1], early=True)
    assert pool.live_bytes() == 2 * arena.row_nbytes
    pool.release(arena)
    assert pool.live_bytes() == 0 and pool.metrics.pages_leased == 0


def _jax_server(prefill: bool, page: int):
    if (prefill, page) not in _SERVERS:
        cfg = JaxEngineConfig(dtype="float32", prefill=prefill, page_size=page)
        _SERVERS[prefill, page] = JaxPlanServer(jax_config(ARCH), config=cfg)
    return _SERVERS[prefill, page]


@pytest.mark.parametrize("prefill,page", [(True, 16), (False, 16), (True, 0), (False, 0)])
def test_plan_server_matches_reference(prefill, page):
    """Requests 1x40, 2x100, 1x40 (6 tokens each): the reference serves
    [236, 290, 502, 502, 502, 2] per row with the prompt pass on; a 2x100
    request peaks at two rows of 39,680 bytes in the paged pool."""
    jsrv = _jax_server(prefill, page)
    srv = PlanServer(get_config(ARCH), config=EngineConfig(
        dtype="float32", prefill=prefill, page_size=page), device="cpu")
    srv.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.params.items()}, torch.float32, "cpu")
    for batch, context in ((1, 40), (2, 100), (1, 40)):
        jout = jsrv.handle(JaxRequest(batch, context, new_tokens=6))
        out = srv.handle(ServeRequest(batch, context, new_tokens=6))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["finish_reason"] == jout["finish_reason"]
        if prefill:
            assert out["tokens"][0].tolist() == [236, 290, 502, 502, 502, 2]
    jm, m = jsrv.pool.metrics, srv.pool.metrics
    for name in COUNTERS:
        assert getattr(m, name) == getattr(jm, name), name
    assert m.peak_bytes == jm.peak_bytes
    assert m.pages_leased == 0
    if page:
        assert m.peak_bytes == 79_360
    assert srv.pool.live_bytes() == jsrv.pool.live_bytes() == 0


def test_serve_cli_defaults_to_mamba2_smoke(monkeypatch):
    """``python -m repro_torch.launch.serve --stream --prefill --device cpu``
    serves the reference launcher's default arch."""
    monkeypatch.setattr(sys, "argv", ["serve", "--stream", "--prefill", "--device", "cpu",
                                      "--requests", "2", "--tokens", "3",
                                      "--shapes", "2x100,1x40"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve_cli.main()
    out = buf.getvalue()
    assert "mamba2-1.3b-smoke" in out
    assert out.count("req[") == 2 and "handoff_writes=2" in out
