"""PyTorch port, the rest of the paper's NN library and the CSR half of
``core/sparsity.py`` against the JAX package on the same seeded numpy
inputs: ``layer_norm``, ``rms_norm``, ``scale_shift``, ``embedding``,
``simple_rnn`` and ``lstm`` (forward and hand-written backward; the
recurrent layers' ``lax.scan`` is a loop over T here, its BPTT the loop in
reverse), and ``CSRMatrix``/``to_csr``/``csr_to_dense``/``spmm``/
``matmul_auto``/``sparse_flops_matmul``. Float32 throughout: ``rtol =
atol = 1e-5`` (sums in another order), ``1e-4`` for the recurrent
layers' weight gradients (sums over T steps of products over N rows)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import sparsity as JSP  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro_torch.core import sparsity as TSP  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-5)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# norms and scale_shift
# ---------------------------------------------------------------------------


def test_layer_norm_forward_backward_match_reference():
    x, dout = _normal((6, 9), 0, 3.0), _normal((6, 9), 1)
    gamma, beta = _normal((1, 9), 2) + 1, _normal((1, 9), 3)
    jout, jcache = JL.layer_norm.forward(x, gamma, beta)
    tout, tcache = TL.layer_norm.forward(*_t(x, gamma, beta))
    _close(tout, jout)
    for g, w in zip(TL.layer_norm.backward(*_t(dout), tcache, *_t(x, gamma)),
                    JL.layer_norm.backward(dout, jcache, x, gamma)):
        _close(g, w)


def test_rms_norm_forward_backward_match_reference():
    x, dout, gamma = _normal((5, 12), 4, 2.0), _normal((5, 12), 5), _normal((1, 12), 6) + 1
    jout, jinv = JL.rms_norm.forward(x, gamma)
    tout, tinv = TL.rms_norm.forward(*_t(x, gamma))
    _close(tout, jout)
    _close(tinv, jinv)
    for g, w in zip(TL.rms_norm.backward(*_t(dout), tinv, *_t(x, gamma)),
                    JL.rms_norm.backward(dout, jinv, x, gamma)):
        _close(g, w)


def test_scale_shift_forward_backward_match_reference():
    x, dout = _normal((4, 7), 7), _normal((4, 7), 8)
    gamma, beta = _normal((1, 7), 9), _normal((1, 7), 10)
    _close(TL.scale_shift.forward(*_t(x, gamma, beta)), JL.scale_shift.forward(x, gamma, beta))
    for g, w in zip(TL.scale_shift.backward(*_t(dout, x, gamma)),
                    JL.scale_shift.backward(dout, x, gamma)):
        _close(g, w)


@pytest.mark.parametrize("layer", ["layer_norm", "rms_norm", "scale_shift"])
def test_norm_inits_match_reference(layer):
    gen = torch.Generator().manual_seed(0)
    for g, w in zip(getattr(TL, layer).init(5, gen), getattr(JL, layer).init(5)):
        assert g.shape == w.shape and g.device == gen.device
        _close(g, w)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


def test_embedding_forward_backward_sum_repeated_ids():
    table = _normal((11, 6), 11)
    ids = np.array([[1, 3, 3], [10, 1, 3]], np.int32)        # repeated ids
    dout = _normal((2, 3, 6), 12)
    _close(TL.embedding.forward(*_t(ids, table)), JL.embedding.forward(ids, table))
    got = TL.embedding.backward(*_t(dout, ids, table))
    _close(got, JL.embedding.backward(jnp.asarray(dout), jnp.asarray(ids), jnp.asarray(table)))
    np.testing.assert_allclose(got[3].numpy(), dout[0, 1] + dout[0, 2] + dout[1, 2],
                               rtol=1e-6)
    assert float(got[0].abs().sum()) == 0.0


def test_embedding_init_scale_and_device():
    (table,) = TL.embedding.init(1000, 64, torch.Generator().manual_seed(1))
    assert table.shape == (1000, 64) and abs(float(table.std()) - 0.02) < 1e-3


# ---------------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------------


def _rnn_inputs(n, t, d, m, gates, seed):
    return (_normal((n, t, d), seed), _normal((d, gates * m), seed + 1, d ** -0.5),
            _normal((m, gates * m), seed + 2, m ** -0.5), _normal((1, gates * m), seed + 3, 0.1),
            _normal((n, m), seed + 4, 0.5), _normal((n, t, m), seed + 5))


@pytest.mark.parametrize("n,t,d,m", [(3, 5, 4, 6), (2, 9, 7, 3)])
def test_simple_rnn_forward_and_bptt_match_reference(n, t, d, m):
    x, wx, wh, b, h0, dhs = _rnn_inputs(n, t, d, m, 1, 20)
    jhs, jht = JL.simple_rnn.forward(x, wx, wh, b, h0)
    ths, tht = TL.simple_rnn.forward(*_t(x, wx, wh, b, h0))
    _close(ths, jhs)
    _close(tht, jht)
    want = JL.simple_rnn.backward(dhs, x, wx, wh, b, h0)
    got = TL.simple_rnn.backward(*_t(dhs, x, wx, wh, b, h0))
    for g, w in zip(got, want, strict=True):
        _close(g, w, SUM_TOL)


@pytest.mark.parametrize("n,t,d,m", [(3, 5, 4, 6), (2, 8, 5, 2)])
def test_lstm_forward_and_bptt_match_reference(n, t, d, m):
    x, wx, wh, b, h0, dhs = _rnn_inputs(n, t, d, m, 4, 30)
    c0 = _normal((n, m), 40, 0.5)
    jhs, (jh, jc), jcache = JL.lstm.forward(x, wx, wh, b, h0, c0)
    ths, (th, tc), tcache = TL.lstm.forward(*_t(x, wx, wh, b, h0, c0))
    for g, w in zip((ths, th, tc, *tcache), (jhs, jh, jc, *jcache), strict=True):
        _close(g, w)
    want = JL.lstm.backward(dhs, jcache, x, wx, wh, b, h0, c0)
    got = TL.lstm.backward(_t(dhs)[0], tcache, *_t(x, wx, wh, b, h0, c0))
    for g, w in zip(got, want, strict=True):
        _close(g, w, SUM_TOL)


@pytest.mark.parametrize("layer,gates", [("simple_rnn", 1), ("lstm", 4)])
def test_recurrent_inits_follow_the_reference_shapes_and_scales(layer, gates):
    wx, wh, b = getattr(TL, layer).init(64, 32, torch.Generator().manual_seed(2))
    jwx, jwh, jb = getattr(JL, layer).init(64, 32, jax.random.PRNGKey(0))
    assert (wx.shape, wh.shape, b.shape) == (jwx.shape, jwh.shape, jb.shape)
    assert wx.shape == (64, gates * 32) and float(b.abs().sum()) == 0.0
    assert abs(float(wx.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert abs(float(wh.std()) - 32 ** -0.5) < 0.1 * 32 ** -0.5


# ---------------------------------------------------------------------------
# CSR-lite sparse matrices
# ---------------------------------------------------------------------------


def _sparse(m, k, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x * (rng.random((m, k)) < density)


@pytest.mark.parametrize("capacity", [None, 500])
def test_csr_round_trip_matches_reference(capacity):
    x = _sparse(20, 17, 0.2, 1)
    ours, ref = TSP.to_csr(x, capacity), JSP.to_csr(jnp.asarray(x), capacity)
    assert ours.shape == ref.shape and ours.nnz_capacity == ref.nnz_capacity
    for name in ("values", "col_idx", "row_idx", "valid"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(TSP.csr_to_dense(ours).numpy(), x)
    # a tensor keeps its device and gives the same matrix
    assert torch.equal(TSP.csr_to_dense(TSP.to_csr(torch.from_numpy(x), capacity)),
                       torch.from_numpy(x))


def test_csr_capacity_too_small_raises():
    with pytest.raises(ValueError, match="exceeds capacity"):
        TSP.to_csr(np.eye(4, dtype=np.float32), capacity=3)


@settings(max_examples=20, deadline=None, database=None)
@given(m=st.integers(1, 30), k=st.integers(1, 30), n=st.integers(1, 9),
       density=st.floats(0.0, 1.0), seed=st.integers(0, 1000))
def test_spmm_matches_reference_and_dense(m, k, n, density, seed):
    a = _sparse(m, k, density, seed)
    b = _normal((k, n), seed + 1)
    got = TSP.spmm(TSP.to_csr(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(JSP.spmm(JSP.to_csr(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("density_a,density_b,m,k,n", [
    (1.0, 1.0, 80, 64, 70), (0.1, 1.0, 80, 64, 70), (1.0, 0.1, 80, 64, 70),
    (0.1, 0.1, 80, 64, 70), (0.1, 0.1, 8, 8, 8)])
def test_matmul_auto_values_and_operator_names_match_reference(density_a, density_b, m, k, n):
    a, b = _sparse(m, k, density_a, 5), _sparse(k, n, density_b, 6)
    got, op = TSP.matmul_auto(*_t(a, b))
    want, jop = JSP.matmul_auto(jnp.asarray(a), jnp.asarray(b))
    assert op == jop
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("a,b", [((100, 100, 300), (100, 50, -1)), ((100, 100, -1), (100, 50, 10)),
                                 ((100, 100, 100), (100, 50, 200)), ((10, 10, 5), (10, 10, 5)),
                                 ((100, 100, -1), (100, 50, -1))])
def test_sparse_flops_matmul_matches_reference(a, b):
    ours = TSP.sparse_flops_matmul(TSP.MatrixCharacteristics(*a), TSP.MatrixCharacteristics(*b))
    ref = JSP.sparse_flops_matmul(JSP.MatrixCharacteristics(*a), JSP.MatrixCharacteristics(*b))
    assert ours == ref
