"""PyTorch port, model layer: ``yi-6b-smoke`` through both packages on the
same weights (the reference's ``init_params``, converted by
``repro_torch.interop``) and the same seeded random prompts.

- prefill last-position logits, mixed prompt lengths: float32,
  ``atol = rtol = 1e-4`` (two layers of matmuls summed in another order);
- the prefill cache handed to a paged arena through each package's own
  ``KVCachePool.write_rows``, then 12 greedy decode steps under each
  ``decode_kernel`` and page size: the token streams must be identical and
  every step's logits allclose at ``1e-4``;
- bfloat16: logits allclose at ``3e-2`` — each package rounds its bf16
  matmul outputs and activations at its own places, and one bf16 ulp at
  these magnitudes is ~4e-3, so a few roundings across two layers stay
  well inside 3e-2 while a real fault (wrong mask, wrong slot) does not.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime.kv_cache import KVCachePool as JaxPool  # noqa: E402
from repro.runtime.serve_loop import greedy_decode as jax_greedy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.kv_cache import KVCachePool  # noqa: E402
from repro_torch.runtime.serve_loop import greedy_decode, make_decode_step  # noqa: E402

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
_MODELS = {}


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


def test_param_keys_and_shapes_match_reference():
    jm, jp, tm, tp = _models("float32")
    assert set(tm.sb.entries) == set(jp)
    for k, (shape, _dt) in tm.sb.shapes().items():
        assert shape == tuple(jp[k].shape), k
    assert tm.param_count() == jm.param_count()
    gen = torch.Generator().manual_seed(0)
    own = tm.init_params(gen)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for batch, seq, page in ((2, 64, 16), (3, 100, 64)):
        jc = jm.init_paged_cache(batch, seq, page)
        tc = tm.init_paged_cache(batch, seq, page, "cpu")
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        assert tm.paged_cache_entries(batch, seq, page)[1:] == \
            jm.paged_cache_entries(batch, seq, page)[1:]


@pytest.mark.parametrize("lengths", [[40, 17, 32], [16, 1, 64]])
def test_prefill_logits_and_cache_match_jax(lengths):
    jm, jp, tm, tp = _models("float32")
    toks, lens = _prompts(lengths)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens),
                        cache_len=96)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=96)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), atol=1e-3, rtol=1e-4)


def _paged_run(jm, jp, tm, tp, lengths, seq, page, kernel, steps,
               shared_tokens=False, cache_tol=dict(atol=1e-3, rtol=1e-4)):
    """Prefill → handoff into each package's paged arena → ``steps`` greedy
    decode steps. Returns per-step (jax logits, torch logits) and tokens.
    ``shared_tokens`` feeds the reference's greedy tokens to both packages
    (for comparing logits where rounding may flip a near-tie)."""
    toks, lens = _prompts(lengths)
    b = len(lengths)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=seq)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=seq)
    jpool, tpool = JaxPool(jm, page_size=page), KVCachePool(tm, "cpu", page_size=page)
    ja, ta = jpool.acquire(b, seq), tpool.acquire(b, seq)
    jrows = jpool.admit_request_rows(ja, b, prompt=max(lengths),
                                     span=max(lengths) + steps + 1, eager=True)
    trows = tpool.admit_request_rows(ta, b, prompt=max(lengths),
                                     span=max(lengths) + steps + 1, eager=True)
    assert jrows == trows
    jpool.write_rows(ja, jrows, jc)
    tpool.write_rows(ta, trows, tc)
    for k in ja.cache:
        np.testing.assert_allclose(_f32(ta.cache[k]), _f32(ja.cache[k]),
                                   **cache_tol)
    np.testing.assert_array_equal(ta.tables.numpy(), np.asarray(ja.tables))

    jstep = jax.jit(lambda p, c, t, q, tb: jm.decode_step(
        p, c, t, q, tables=tb, page=page, seq_len=seq, decode_kernel=kernel))
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jpos, tpos = jnp.asarray(lens), torch.from_numpy(lens.copy())
    jcache = ja.cache
    out = []
    for _ in range(steps):
        jlg, jcache = jstep(jp, jcache, jt, jpos, ja.tables)
        tlg, _ = tm.decode_step(tp, ta.cache, tt, tpos, tables=ta.tables, page=page,
                                seq_len=seq, decode_kernel=kernel)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        out.append((jlg, tlg, np.asarray(jt), tt.numpy()))
        if shared_tokens:
            tt = torch.from_numpy(np.array(jt))
        jpos, tpos = jpos + 1, tpos + 1
    return out


@pytest.mark.parametrize("kernel", ["paged", "gather", "ref"])
@pytest.mark.parametrize("page,lengths", [(16, [16, 33, 64]), (64, [64, 1, 40])])
def test_paged_greedy_tokens_identical_to_jax(kernel, page, lengths):
    """Prompts on page boundaries, rows at mixed depths: 12 greedy tokens
    token-identical to the reference, every step's logits allclose."""
    jm, jp, tm, tp = _models("float32")
    steps = 12
    out = _paged_run(jm, jp, tm, tp, lengths, 128, page, kernel, steps)
    jtoks = np.concatenate([o[2] for o in out], axis=1)
    ttoks = np.concatenate([o[3] for o in out], axis=1)
    np.testing.assert_array_equal(ttoks, jtoks)
    for jlg, tlg, _, _ in out:
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)


def test_dense_decode_matches_jax():
    """The unpaged decode path (per-row dense cache rows, (B,) positions)."""
    jm, jp, tm, tp = _models("float32")
    toks, lens = _prompts([12, 30, 7])
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=48)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=48)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jpos, tpos = jnp.asarray(lens), torch.from_numpy(lens.copy())
    jstep = jax.jit(jm.decode_step)
    for _ in range(6):
        jlg, jc = jstep(jp, jc, jt, jpos)
        tlg, tc = tm.decode_step(tp, tc, tt, tpos)
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jpos, tpos = jpos + 1, tpos + 1


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_decode_matches_jax(paged):
    """The greedy loop from a prefill handoff, dense rows or a paged arena."""
    jm, jp, tm, tp = _models("float32")
    toks, lens = _prompts([20, 9])
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=32)
    jfirst = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tfirst = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jkw, tkw = {}, {}
    if paged:
        jpool, tpool = JaxPool(jm, page_size=16), KVCachePool(tm, "cpu", page_size=16)
        ja, ta = jpool.acquire(2, 32), tpool.acquire(2, 32)
        jrows = jpool.admit_request_rows(ja, 2, prompt=20, span=32, eager=True)
        trows = tpool.admit_request_rows(ta, 2, prompt=20, span=32, eager=True)
        jpool.write_rows(ja, jrows, jc)
        tpool.write_rows(ta, trows, tc)
        jc, tc = ja.cache, ta.cache
        jkw = dict(tables=ja.tables, decode_step=lambda p, c, t, q, tb: jm.decode_step(
            p, c, t, q, tables=tb, page=16, seq_len=32, decode_kernel="paged"))
        tkw = dict(tables=ta.tables, decode_step=make_decode_step(tm, page=16, seq_len=32))
    jtoks, _ = jax_greedy(jm, jp, jc, jfirst, jnp.asarray(lens), 8, **jkw)
    ttoks, _ = greedy_decode(tm, tp, tc, tfirst, torch.from_numpy(lens.copy()), 8, **tkw)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_apply_last_only_matches_jax():
    jm, jp, tm, tp = _models("float32")
    toks, _ = _prompts([24, 24])
    jl, _ = jm.apply(jp, jnp.asarray(toks), last_only=True)
    tl, aux = tm.apply(tp, torch.from_numpy(toks), last_only=True)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert float(aux) == 0.0


def test_bf16_logits_within_tolerance():
    jm, jp, tm, tp = _models("bfloat16")
    # handed-off K/V: within two bf16 ulps (2^-7 relative; 0.25 absolute at
    # the |K| ~ 16-32 these random weights give)
    out = _paged_run(jm, jp, tm, tp, [16, 33, 40], 64, 16, "paged", steps=3,
                     shared_tokens=True, cache_tol=dict(atol=0.25, rtol=2 ** -7))
    for jlg, tlg, _, _ in out:
        assert np.isfinite(_f32(tlg)).all()
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **BF16_TOL)
