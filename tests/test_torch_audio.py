"""PyTorch port, the audio family (Whisper's encoder-decoder): the decoder
block's cross attention and the GELU MLP (``models/blocks.py``), the model's
encoder, ``build_cross_cache`` and ``decode_step`` with the cross K/V
(``models/model.py``), ``PlanServer`` and the train step, against the
reference on ``whisper-medium-smoke`` (2 encoder and 2 decoder layers, 64
frames), on the reference's ``init_params`` converted by
``repro_torch.interop`` and inputs made with numpy from a seed.

Tolerances:

- the cross block and the GELU MLP, float32: ``atol = rtol = 1e-5``;
- ``apply``, ``build_cross_cache`` and ``decode_step`` (dense, and paged
  under ``paged``, ``gather`` and ``ref``), float32: ``atol = rtol = 1e-4``,
  ``tests/test_torch_model.py``'s ``TOL``; bfloat16: its ``BF16_TOL``
  (``3e-2``), the decode steps fed the reference's tokens (a bf16 near-tie
  may flip a greedy token), and the cross K/V, which reach ~40 here (a
  bf16 ulp of 0.25; each package's bf16 ``x.k`` is ~0.2 from the float32
  one), at its rtol with an atol of 3e-2 of their largest magnitude;
- greedy streams and ``PlanServer`` streams: byte-identical;
- train steps: ``tests/test_torch_train.py``'s (loss and xent ``rtol =
  1e-5``; grad_norm ``rtol = 1e-3``; parameters under SGD ``atol = rtol =
  1e-5``, under Adam every element within ``2 * steps * lr`` and the
  error's RMS within 3e-3 of the parameter's).

The init's norms are ones, and at this init the attention scores reach +-50:
the softmax is so peaked that float32 rounding in either package moves a
logit by up to ~2e-4 (the reference's and the port's float32 blocks are
equally far from the same block in float64; with the attention norms'
gains at 0.1 the two packages agree to ~2e-6 on the logits, float32
rounding). So the model-level comparisons run on the reference's init with
the ``ln1`` and ``xln`` gains of every layer set to ``GAIN`` = 0.1, in both
packages; one test holds the blocks at the init's own gains against
float64.

The reference's ``PlanServer`` cannot prefill an encoder-decoder (its prompt
pass hands the model no ``frames``): both packages raise ``KeyError`` there,
and both serve Whisper with ``prefill=False``, decoding from a zero cache.
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
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.kv_cache import KVCachePool  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402
from repro_torch.runtime.train_loop import init_opt_state, make_train_step  # noqa: E402

torch.set_num_threads(2)
ARCH = "whisper-medium-smoke"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
# the attention norms' gains the model-level comparisons run at (see above)
GAIN = 0.1
_MODELS = {}


def _f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _models(dtype_name="float32", gain=GAIN):
    """(reference model, its parameters, port model, the same parameters
    converted): the reference's init, the ``ln1``/``xln`` gains times
    ``gain``."""
    if dtype_name not in _MODELS:
        jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        jm = jax_build(jax_config(ARCH), dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(get_config(ARCH), dtype=tdt)
        _MODELS[dtype_name] = (jm, jp, tm, tdt)
    jm, jp, tm, tdt = _MODELS[dtype_name]
    jp = {k: v * gain if k.endswith((".ln1", ".xln")) else v for k, v in jp.items()}
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tdt, "cpu")
    return jm, jp, tm, tp


def _inputs(b, s, seed=1):
    """Seeded tokens (B, S) and frames (B, Senc, D), float32."""
    cfg = jax_config(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, frames


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-medium", ARCH])
def test_configs_build_with_the_reference_parameters(arch):
    """Every parameter key, shape and logical axis is the reference's: the
    encoder under ``e.``, the decoder (with its cross leaves) under ``d.``,
    the GELU MLP's ``wi``/``wo_mlp`` in place of SwiGLU."""
    jm = jax_build(jax_config(arch), dtype=jnp.bfloat16)
    tm = build_model(get_config(arch), dtype=torch.bfloat16)
    want, got = jm.param_specs(), tm.param_specs()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert tm.param_axes() == jm.param_axes()
    assert tm.param_count() == jm.param_count()
    keys = set(got)
    assert {"d.xwq", "d.xwk", "d.xwv", "d.xwo", "d.xln", "e.wi", "d.wo_mlp"} <= keys
    assert not any(k.startswith(("e.x", "l.")) for k in keys) and "d.wg" not in keys
    cfg = get_config(arch)
    assert [p for _k, p, _i in tm.layers()] == ["d."] * cfg.num_layers
    assert [p for _k, p, _i in tm.layers(encoder=True)] == ["e."] * cfg.encoder_layers


@pytest.mark.parametrize("batch,seq,page", [(2, 32, 16), (3, 100, 64)])
def test_cache_entries_match_reference(batch, seq, page):
    """Self-attention K/V under ``d.`` (paged), cross K/V ``x.k``/``x.v``
    per row (never paged), shapes, axes and dtypes the reference's."""
    jm, _jp, tm, _tp = _models()
    want = jm.cache_entries(batch, seq)
    got = tm.cache_entries(batch, seq)
    assert set(got) == set(want) == {"d.k", "d.v", "x.k", "x.v"}
    for k, (shape, axes, _dt) in want.items():
        assert got[k][:2] == (tuple(shape), tuple(axes)), k
    pw, pn, ps = jm.paged_cache_entries(batch, seq, page)
    tw, tn, ts = tm.paged_cache_entries(batch, seq, page)
    assert (tn, ts) == (pn, ps)
    assert {k: v[:2] for k, v in tw.items()} == {k: (tuple(s), tuple(a))
                                                for k, (s, a, _d) in pw.items()}
    assert tw["x.k"][0] == (2, batch, 64, 2, 32) and tm.is_paged_cache_key("d.k")
    assert not tm.is_paged_cache_key("x.k")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _layer(jp, prefix):
    return {k[len(prefix):]: np.array(v[0]) for k, v in jp.items() if k.startswith(prefix)}


def _block(part, lp, x, enc, lib):
    """The GELU MLP, or an encoder or decoder block's forward, through the
    reference (``lib`` = "jax") or the port (a torch dtype)."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    if lib == "jax":
        jl = {k: jnp.asarray(v) for k, v in lp.items()}
        if part == "gelu mlp":
            return np.asarray(JB._ffn(jcfg, jl, jnp.asarray(x), NULL_CTX)[0])
        return np.asarray(JB.attn_block_apply(
            jcfg, jl, jnp.asarray(x), jnp.arange(x.shape[1]), causal=part == "decoder block",
            enc_out=None if enc is None else jnp.asarray(enc))[0])
    tl = {k: _t(v, lib) for k, v in lp.items()}
    if part == "gelu mlp":
        out, aux = TB._ffn(tcfg, tl, _t(x, lib))
        assert aux == 0.0
        return out.double().numpy()
    out = TB.attn_block_apply(tcfg, tl, _t(x, lib), torch.arange(x.shape[1]),
                              causal=part == "decoder block",
                              enc_out=None if enc is None else _t(enc, lib))[0]
    return out.double().numpy()


def _block_inputs(part, gain):
    """Layer 0's parameters (the decoder's for the MLP and the decoder
    block), the attention norms' gains times ``gain``; x (2, 12, D) and, for
    the decoder block, an encoder output of 20 frames at RMS ``gain``."""
    _jm, jp, _tm, _tp = _models(gain=gain)
    lp = _layer(jp, "e." if part == "encoder block" else "d.")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, jax_config(ARCH).d_model)).astype(np.float32)
    enc = None
    if part == "decoder block":
        enc = gain * rng.standard_normal((2, 20, jax_config(ARCH).d_model)).astype(np.float32)
    return lp, x, enc


@pytest.mark.parametrize("part", ["gelu mlp", "encoder block", "decoder block"])
def test_blocks_match_reference(part):
    """The GELU MLP (tanh form on the float32 product), a bidirectional
    encoder block and a decoder block with cross attention over an encoder
    output of another length, at ``atol = rtol = 1e-5``, at ``GAIN`` (the
    next test: the init's own gains)."""
    lp, x, enc = _block_inputs(part, GAIN)
    np.testing.assert_allclose(_block(part, lp, x, enc, torch.float32),
                               _block(part, lp, x, enc, "jax"), **BLOCK_TOL)


@pytest.mark.parametrize("part", ["encoder block", "decoder block"])
def test_blocks_at_the_init_as_close_to_float64_as_reference(part):
    """At the init's own norms the port's float32 block is no further from
    the same block in float64 than the reference's float32 block is (the
    larger error at most 2x the other's)."""
    lp, x, enc = _block_inputs(part, 1.0)
    exact = _block(part, lp, x, enc, torch.float64)
    port = np.abs(_block(part, lp, x, enc, torch.float32) - exact).max()
    ref = np.abs(_block(part, lp, x, enc, "jax") - exact).max()
    assert port <= 2 * ref + 1e-6, (port, ref)


def test_cross_decode_block_matches_reference():
    """One decode tick of a decoder block: the self-attention write and
    read, then the cross read of precomputed K/V, at ``1e-5``."""
    jcfg, tcfg = jax_config(ARCH), get_config(ARCH)
    _jm, jp, _tm, _tp = _models()
    lp = _layer(jp, "d.")
    rng = np.random.default_rng(8)
    b, sc, senc = 2, 16, 24
    x = (0.1 * rng.standard_normal((b, 1, jcfg.d_model))).astype(np.float32)
    kc, vc = (rng.standard_normal((b, sc, 2, 32)).astype(np.float32) for _ in range(2))
    xk, xv = (rng.standard_normal((b, senc, 2, 32)).astype(np.float32) for _ in range(2))
    pos = np.asarray([3, 9], np.int32)
    want, wc = JB.attn_block_decode(jcfg, {k: jnp.asarray(v) for k, v in lp.items()},
                                    jnp.asarray(x), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                    jnp.asarray(pos), enc_out_kv=(jnp.asarray(xk),
                                                                  jnp.asarray(xv)))
    tc = {"k": _t(kc), "v": _t(vc)}
    got = TB.attn_block_decode(tcfg, {k: _t(v) for k, v in lp.items()}, _t(x), tc,
                               torch.from_numpy(pos), enc_out_kv=(_t(xk), _t(xv)))
    np.testing.assert_allclose(_f32(got), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(_f32(tc["k"]), np.asarray(wc["k"]), **BLOCK_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_cross_cache_match_reference(dtype):
    """The full forward over frames and tokens, ``last_only``, and
    ``build_cross_cache`` (the encoder once, each decoder layer's K/V)."""
    jm, jp, tm, tp = _models(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    toks, frames = _inputs(2, 10)
    jl, jaux = jm.apply(jp, jnp.asarray(toks), extra={"frames": jnp.asarray(frames)})
    tl, taux = tm.apply(tp, torch.from_numpy(toks), {"frames": torch.from_numpy(frames)})
    assert tl.shape == (2, 10, jax_config(ARCH).vocab_size)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
    assert float(taux) == float(jaux) == 0.0
    jlast, _ = jm.apply(jp, jnp.asarray(toks), extra={"frames": jnp.asarray(frames)},
                        last_only=True)
    tlast, _ = tm.apply(tp, torch.from_numpy(toks), {"frames": torch.from_numpy(frames)},
                        last_only=True)
    np.testing.assert_allclose(_f32(tlast), _f32(jlast), **tol)
    jx = jm.build_cross_cache(jp, jnp.asarray(frames, jm.dtype))
    tx = tm.build_cross_cache(tp, _t(frames, tdt))
    for k in ("x.k", "x.v"):
        assert tx[k].dtype == tdt and tuple(tx[k].shape) == jx[k].shape == (2, 2, 64, 2, 32)
        want = _f32(jx[k])
        ktol = tol if dtype == "float32" else dict(
            rtol=tol["rtol"], atol=tol["atol"] * np.abs(want).max())
        np.testing.assert_allclose(_f32(tx[k]), want, **ktol)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_reference(remat):
    jm, jp, tm, tp = _models()
    shape = ("t", 16, 3, "train")
    jb = jax_make_batch(jax_config(ARCH), jax_config_module.InputShape(*shape), step=0,
                        dtype=jnp.float32)
    tb = make_batch(get_config(ARCH), InputShape(*shape), step=0, dtype=torch.float32,
                    device="cpu")
    np.testing.assert_array_equal(tb["frames"].numpy(), np.asarray(jb["frames"]))
    want, wmet = jm.loss(jp, jb)
    got, gmet = tm.loss(tp, tb, remat=remat)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gmet["xent"]), float(wmet["xent"]), rtol=1e-5)


def _decode_run(dtype, paged, kernel, steps=8, b=3, shared_tokens=False):
    """The reference's model-level enc-dec decode: the cross cache built from
    frames, then ``steps`` greedy ticks from token 1 at position 0 (dense
    rows, or a paged arena of pages of 16 through each package's own pool).
    Returns per-step (reference logits, port logits, reference tokens, port
    tokens). ``shared_tokens`` feeds the reference's tokens to both."""
    jm, jp, tm, tp = _models(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    _toks, frames = _inputs(b, 1, seed=3)
    jx = jm.build_cross_cache(jp, jnp.asarray(frames, jm.dtype))
    tx = tm.build_cross_cache(tp, _t(frames, tdt))
    seq, page = 32, 16
    if paged:
        jpool, tpool = JaxPool(jm, page_size=page), KVCachePool(tm, "cpu", page_size=page)
        ja, ta = jpool.acquire(b, seq), tpool.acquire(b, seq)
        jrows = jpool.admit_request_rows(ja, b, prompt=0, span=steps + 1, eager=True)
        trows = tpool.admit_request_rows(ta, b, prompt=0, span=steps + 1, eager=True)
        assert jrows == trows
        jcache = dict(ja.cache, **jx)
        tcache = ta.cache
        jtables, ttables = ja.tables, ta.tables
        jkw = dict(tables=jtables, page=page, seq_len=seq, decode_kernel=kernel)
        tkw = dict(tables=ttables, page=page, seq_len=seq, decode_kernel=kernel)
    else:
        jcache = dict(jm.init_cache(b, seq), **jx)
        tcache = tm.init_cache(b, seq, "cpu")
        jkw, tkw = {}, {}
    for k in ("x.k", "x.v"):
        tcache[k].copy_(tx[k])
    jstep = jax.jit(lambda p, c, t, q: jm.decode_step(p, c, t, q, **jkw))
    jt = jnp.ones((b, 1), jnp.int32)
    tt = torch.ones((b, 1), dtype=torch.int32)
    jpos, tpos = jnp.zeros((b,), jnp.int32), torch.zeros((b,), dtype=torch.int32)
    out = []
    for _ in range(steps):
        jlg, jcache = jstep(jp, jcache, jt, jpos)
        tlg, tcache = tm.decode_step(tp, tcache, tt, tpos, **tkw)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        out.append((jlg, tlg, np.asarray(jt), tt.numpy()))
        if shared_tokens:
            tt = torch.from_numpy(np.array(jt))
        jpos, tpos = jpos + 1, tpos + 1
    return out


@pytest.mark.parametrize("paged,kernel", [(False, "gather"), (True, "paged"),
                                          (True, "gather"), (True, "ref")])
def test_decode_step_matches_reference(paged, kernel):
    """Dense and paged decode (the paged kernel's plain version, the
    gathered view and the oracle) with the cross K/V threaded through
    every layer: logits at ``TOL``, tokens identical."""
    out = _decode_run("float32", paged, kernel)
    for jlg, tlg, jt, tt in out:
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        np.testing.assert_array_equal(tt, jt)


def test_decode_step_bf16_within_tolerance():
    for jlg, tlg, _jt, _tt in _decode_run("bfloat16", True, "paged", steps=3,
                                          shared_tokens=True):
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **BF16_TOL)


def test_greedy_stream_of_16_tokens_identical():
    """Float32 greedy decoding of 16 tokens over a cross cache: the same
    token stream as the reference's, byte for byte."""
    out = _decode_run("float32", True, "paged", steps=16, b=2)
    np.testing.assert_array_equal(np.concatenate([o[3] for o in out], 1),
                                  np.concatenate([o[2] for o in out], 1))


def test_decode_reads_the_cross_cache():
    """The cross K/V move the logits: zero cross K/V (the server's
    ``prefill=False`` start) give other logits than the encoder's."""
    jm, jp, tm, tp = _models()
    _toks, frames = _inputs(2, 1, seed=3)
    tx = tm.build_cross_cache(tp, _t(frames))
    logits = []
    for cross in (tx, None):
        cache = tm.init_cache(2, 8, "cpu")
        if cross is not None:
            cache.update(cross)
        lg, _ = tm.decode_step(tp, cache, torch.ones((2, 1), dtype=torch.int32),
                               torch.zeros((2,), dtype=torch.int32))
        logits.append(lg)
    assert float((logits[0] - logits[1]).abs().max()) > 1e-2


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


def _servers(prefill, kernel="paged"):
    jsrv = JaxPlanServer(jax_config(ARCH), config=JaxEngineConfig(
        dtype="float32", prefill=prefill, page_size=16, decode_kernel=kernel))
    srv = PlanServer(get_config(ARCH), config=EngineConfig(
        dtype="float32", prefill=prefill, page_size=16, decode_kernel=kernel), device="cpu")
    srv.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.params.items()}, torch.float32, "cpu")
    return jsrv, srv


@pytest.mark.parametrize("kernel", ["paged", "gather"])
def test_plan_server_streams_equal_reference(monkeypatch, kernel):
    """``prefill=False``, the reference's one engine shape for an
    encoder-decoder: each request decodes from a zero cache (zero cross K/V)
    with token 1 at position 0; the streams byte-identical."""
    monkeypatch.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
    jsrv, srv = _servers(False, kernel)
    for batch, context in ((1, 40), (3, 100), (2, 17)):
        jout = jsrv.handle(JaxRequest(batch, context, new_tokens=6))
        out = srv.handle(ServeRequest(batch, context, new_tokens=6))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["finish_reason"] == jout["finish_reason"]


def test_plan_server_prefill_raises_key_error_as_reference(monkeypatch):
    """Under ``prefill=True`` the prompt pass hands the model only tokens and
    lengths; the encoder needs ``frames``: ``KeyError`` in both packages."""
    monkeypatch.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
    jsrv, srv = _servers(True)
    with pytest.raises(KeyError, match="frames"):
        jsrv.handle(JaxRequest(1, 20, new_tokens=2))
    with pytest.raises(KeyError, match="frames"):
        srv.handle(ServeRequest(1, 20, new_tokens=2))


def test_recycled_rows_start_from_zero_cross_state():
    """A recycled arena whose previous tenant left cross K/V (and
    self-attention K/V) behind: the next request decodes from zero state,
    as on a fresh arena; ``zero_rows`` clears a joiner's ``x.k``/``x.v``
    rows and leaves the others."""
    _jsrv, srv = _servers(False)
    req = ServeRequest(2, 20, new_tokens=6)
    first = srv.handle(req)["tokens"].numpy()
    arenas = list(srv.pool._pooled)
    assert arenas and all("x.k" in a.cache for a in arenas)
    for a in arenas:                       # what a previous tenant leaves
        for t in a.cache.values():
            t.fill_(0.5)
    again = srv.handle(req)["tokens"].numpy()
    np.testing.assert_array_equal(again, first)
    pool = srv.pool
    arena = pool.acquire(4, 32, force=True)
    for t in arena.cache.values():
        t.fill_(0.5)
    rows = pool.admit_request_rows(arena, 2, prompt=0, span=8, eager=True)
    pool.zero_rows(arena, rows)
    for k in ("x.k", "x.v"):
        assert float(arena.cache[k][:, rows].abs().max()) == 0.0
        others = [r for r in range(4) if r not in rows]
        assert bool((arena.cache[k][:, others] == 0.5).all())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEPS, SEQ, BATCH = 3, 16, 4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(opt, remat):
    """One device: the encoder over the batch's frames, the decoder's
    cross attention, loss, grad norm and parameters after each step."""
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
