"""PyTorch port, the paper's deep-learning path: every ported NN layer's
forward and backward, the losses, the six optimizers and their tree
helpers, ``Sequential`` on LeNet, ``core/linearize.py`` and the format
decisions of ``core/sparsity.py``, and ``Keras2Plan`` — each against the JAX
package on the same seeded numpy inputs and, where weights are involved,
the same weights (``interop.nn_params_from_numpy``). Everything runs on the
CPU, where the conv and affine products take the kernels' plain versions.
Float32 throughout; the tolerance of each comparison is stated beside it."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.lenet import make_spec as jlenet_spec  # noqa: E402
from repro.configs.softmax_classifier import make_spec as jsoftmax_spec  # noqa: E402
from repro.core import linearize as JLIN  # noqa: E402
from repro.core import sparsity as JSP  # noqa: E402
from repro.data import SyntheticClassification  # noqa: E402
from repro.frontend import Keras2Plan as JKeras2Plan  # noqa: E402
from repro.frontend import generate_dml as jgenerate_dml  # noqa: E402
from repro.nn import layers as JL  # noqa: E402
from repro.nn import loss as JLOSS  # noqa: E402
from repro.nn import optim as JOPT  # noqa: E402
from repro.nn.module import Sequential as JSequential  # noqa: E402
from repro_torch.configs.lenet import make_spec as lenet_spec  # noqa: E402
from repro_torch.configs.softmax_classifier import make_spec as softmax_spec  # noqa: E402
from repro_torch.core import linearize as TLIN  # noqa: E402
from repro_torch.core import sparsity as TSP  # noqa: E402
from repro_torch.frontend import Keras2Plan, generate_dml  # noqa: E402
from repro_torch.interop import nn_params_from_numpy  # noqa: E402
from repro_torch.launch import train_lenet  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import loss as TLOSS  # noqa: E402
from repro_torch.nn import optim as TOPT  # noqa: E402
from repro_torch.nn.module import Sequential  # noqa: E402

torch.set_num_threads(2)
# float32 on both sides; sums are taken in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-5)
# products over a few hundred terms (conv backward, LeNet's layers)
SUM_TOL = dict(rtol=1e-4, atol=1e-5)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(*arrs):
    out = [torch.from_numpy(np.array(a, np.float32)) for a in arrs]
    return out[0] if len(out) == 1 else out


def _j(*arrs):
    out = [jnp.asarray(a) for a in arrs]
    return out[0] if len(out) == 1 else out


def _close(got, want, **tol):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **(tol or TOL))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_affine_forward_and_backward():
    x, w, b, dout = (_normal(s, i) for i, s in enumerate([(8, 5), (5, 3), (1, 3), (8, 3)]))
    _close(TL.affine.forward(*_t(x, w, b)), JL.affine.forward(*_j(x, w, b)))
    _close(TL.affine.backward(*_t(dout, x, w, b)), JL.affine.backward(*_j(dout, x, w, b)))


def test_affine_init_is_he_normal_with_zero_bias():
    w, b = TL.affine.init(400, 300, torch.Generator().manual_seed(0))
    assert tuple(w.shape) == (400, 300) and tuple(b.shape) == (1, 300)
    assert abs(float(w.std()) - (2.0 / 400) ** 0.5) < 2e-3 and not b.any()


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "elu", "sigmoid", "tanh", "gelu",
                                  "softmax", "log_softmax"])
def test_activation_forward_and_backward(name):
    x, dout = _normal((6, 7), 0, 2.0), _normal((6, 7), 1)
    t, j = getattr(TL, name), getattr(JL, name)
    _close(t.forward(_t(x)), j.forward(_j(x)))
    _close(t.backward(*_t(dout, x)), j.backward(*_j(dout, x)))


def test_dropout_scales_the_kept_values_and_backward_takes_the_reference_mask():
    x = torch.ones((400, 10))
    out, mask = TL.dropout.forward(x, 0.3, torch.Generator().manual_seed(0))
    assert set(torch.unique(mask).tolist()) == {0.0, float(np.float32(1.0 / 0.7))}
    assert torch.equal(out, x * mask)
    assert abs(float(out.mean()) - 1.0) < 0.1          # inverted dropout keeps the mean
    # one mask, the reference's, handed to both backward passes
    _, jmask = JL.dropout.forward(jnp.ones((40, 10)), 0.3, jax.random.PRNGKey(0))
    dout = _normal((40, 10), 1)
    _close(TL.dropout.backward(_t(dout), _t(np.asarray(jmask))),
           JL.dropout.backward(_j(dout), jmask))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_batch_norm1d_forward_and_backward(mode):
    x, dout = _normal((16, 5), 0), _normal((16, 5), 1)
    g, b, rm, rv = _normal((1, 5), 2), _normal((1, 5), 3), _normal((1, 5), 4), \
        np.abs(_normal((1, 5), 5)) + 0.5
    tout = TL.batch_norm1d.forward(*_t(x, g, b), mode, *_t(rm, rv))
    jout = JL.batch_norm1d.forward(*_j(x, g, b), mode, *_j(rm, rv))
    _close([tout[0], tout[2], tout[3], *tout[1]], [jout[0], jout[2], jout[3], *jout[1]])
    _close(TL.batch_norm1d.backward(_t(dout), tout[1], _t(x), _t(g)),
           JL.batch_norm1d.backward(_j(dout), jout[1], _j(x), _j(g)), **SUM_TOL)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_batch_norm2d_forward_and_backward(mode):
    c, h, w = 3, 4, 4
    x, dout = _normal((5, c * h * w), 0), _normal((5, c * h * w), 1)
    g, b, rm, rv = _normal((1, c), 2), _normal((1, c), 3), _normal((1, c), 4), \
        np.abs(_normal((1, c), 5)) + 0.5
    tout = TL.batch_norm2d.forward(*_t(x, g, b), c, h, w, mode, *_t(rm, rv))
    jout = JL.batch_norm2d.forward(*_j(x, g, b), c, h, w, mode, *_j(rm, rv))
    _close([tout[0], tout[2], tout[3]], [jout[0], jout[2], jout[3]])
    _close(TL.batch_norm2d.backward(_t(dout), tout[1], _t(x), _t(g), c, h, w),
           JL.batch_norm2d.backward(_j(dout), jout[1], _j(x), _j(g), c, h, w), **SUM_TOL)


def test_batch_norm_init_matches_reference():
    _close(TL.batch_norm2d.init(3), JL.batch_norm2d.init(3))


@pytest.mark.parametrize("kern,stride,pad", [(3, 1, 1), (5, 2, 2), (3, 2, 0), (5, 1, 2),
                                             (1, 1, 0)])
def test_im2col_and_col2im(kern, stride, pad):
    c, h, w = 3, 8, 8
    x = _normal((4, c * h * w), 0)
    tcols = TL.im2col(_t(x), c, h, w, kern, stride, pad)
    jcols = JL.im2col(_j(x), c, h, w, kern, stride, pad)
    _close(tcols, jcols)
    dcols = _normal(tuple(jcols.shape), 1)
    _close(TL.col2im(_t(dcols), c, h, w, kern, stride, pad),
           JL.col2im(_j(dcols), c, h, w, kern, stride, pad))


@pytest.mark.parametrize("kern,stride,pad", [(3, 1, 1), (5, 2, 2), (3, 2, 0), (5, 1, 2)])
def test_conv2d_forward_and_backward(kern, stride, pad):
    c, h, w, f = 3, 8, 8, 6
    x = _normal((4, c * h * w), 0)
    cw, cb = _normal((f, c * kern * kern), 1, 0.3), _normal((f, 1), 2)
    tout, tcols = TL.conv2d.forward(*_t(x, cw, cb), c, h, w, kern, stride, pad)
    jout, jcols = JL.conv2d.forward(*_j(x, cw, cb), c, h, w, kern, stride, pad)
    _close([tout, tcols], [jout, jcols], **SUM_TOL)
    dout = _normal(tuple(jout.shape), 3)
    _close(TL.conv2d.backward(_t(dout), tcols, *_t(x, cw), c, h, w, kern, stride, pad),
           JL.conv2d.backward(_j(dout), jcols, *_j(x, cw), c, h, w, kern, stride, pad),
           **SUM_TOL)


def test_conv2d_builds_the_patch_matrix_only_when_asked():
    x, cw, cb = _t(_normal((2, 48), 0), _normal((4, 27), 1), _normal((4, 1), 2))
    with_cols, cols = TL.conv2d.forward(x, cw, cb, 3, 4, 4, 3, 1, 1)
    without, none = TL.conv2d.forward(x, cw, cb, 3, 4, 4, 3, 1, 1, need_cols=False)
    assert none is None and tuple(cols.shape) == (2, 16, 27)
    assert torch.equal(with_cols, without)


@pytest.mark.parametrize("cls_name", ["max_pool2d", "avg_pool2d"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties-after-relu"])
def test_pool_forward_and_backward(cls_name, ties):
    """With ties: inputs through relu first (whole windows of zeros) plus
    duplicated maxima; the reference splits the gradient evenly."""
    c, h, w, pool = 2, 8, 8, 2
    x = _normal((3, c * h * w), 0)
    if ties:
        x = np.maximum(x, 0)
        x4 = x.reshape(3, c, h, w)
        x4[:, :, 0::2, 1::2] = x4[:, :, 0::2, 0::2]     # duplicate each window's first
    t, j = getattr(TL, cls_name), getattr(JL, cls_name)
    _close(t.forward(_t(x), c, h, w, pool)[0], j.forward(_j(x), c, h, w, pool)[0])
    dout = _normal((3, c * (h // pool) * (w // pool)), 1)
    _close(t.backward(_t(dout), None, _t(x), c, h, w, pool),
           j.backward(_j(dout), None, _j(x), c, h, w, pool))


# ---------------------------------------------------------------------------
# losses and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,probs", [("cross_entropy_loss", True),
                                        ("softmax_cross_entropy", False),
                                        ("l2_loss", False), ("log_loss", True)])
def test_loss_forward_and_backward(name, probs):
    raw = _normal((6, 4), 0)
    pred = np.asarray(jax.nn.softmax(raw)) if probs else raw
    y = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1, 0]]
    t, j = getattr(TLOSS, name), getattr(JLOSS, name)
    _close(t.forward(*_t(pred, y)), j.forward(*_j(pred, y)))
    _close(t.backward(*_t(pred, y)), j.backward(*_j(pred, y)))


@pytest.mark.parametrize("name", ["l2_reg", "l1_reg"])
def test_regularizer_forward_and_backward(name):
    w = _normal((5, 5), 0)
    t, j = getattr(TLOSS, name), getattr(JLOSS, name)
    _close(t.forward(_t(w), 0.1), j.forward(_j(w), 0.1))
    _close(t.backward(_t(w), 0.1), j.backward(_j(w), 0.1))


@pytest.mark.parametrize("name", sorted(JOPT.OPTIMIZERS))
def test_optimizer_matches_reference_over_steps(name):
    assert TOPT.OPTIMIZER_SLOTS[name] == JOPT.OPTIMIZER_SLOTS[name]
    t, j = TOPT.get_optimizer(name), JOPT.get_optimizer(name)
    p = _normal((4, 3), 0)
    tp, jp = _t(p), _j(p)
    ts, js = t.init(tp), j.init(jp)
    for step in range(1, 5):
        g = _normal((4, 3), step)
        tp, ts = t.update(tp, _t(g), ts, lr=0.05, t=step)
        jp, js = j.update(jp, _j(g), js, lr=0.05, t=step)
        _close([tp, *ts], [jp, *js])


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError, match="unknown optimizer"):
        TOPT.get_optimizer("lbfgs")


def _tree(seed):
    return {"a": [_normal((3, 2), seed), (_normal((2,), seed + 1),)],
            "b": _normal((4,), seed + 2)}


def _to_torch(tree):
    return TOPT.tree_map(lambda x: x, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                                    tree))


@pytest.mark.parametrize("name", ["sgd_momentum", "adam"])
def test_tree_init_and_update_match_reference(name):
    params, grads = _tree(0), _tree(10)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    tp, tg = _to_torch(params), _to_torch(grads)
    js, ts = JOPT.tree_init(name, jp), TOPT.tree_init(name, tp)
    for step in (1, 2):
        jp, js = JOPT.tree_update(name, jp, jg, js, lr=0.1, t=step)
        tp, ts = TOPT.tree_update(name, tp, tg, ts, lr=0.1, t=step)
    _close(TOPT._leaves(tp), jax.tree.leaves(jp))
    _close(TOPT._leaves(ts), jax.tree.leaves(js))
    assert isinstance(tp["a"], list) and isinstance(tp["a"][1], tuple)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(3)
    jclipped, jn = JOPT.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    tclipped, tn = TOPT.clip_by_global_norm(_to_torch(tree), max_norm)
    _close(tn, jn)
    _close(TOPT._leaves(tclipped), jax.tree.leaves(jclipped))


# ---------------------------------------------------------------------------
# linearize and sparsity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,w,kernel,stride,pad", [(28, 28, 5, 1, 2), (14, 14, 5, 1, 2),
                                                   (12, 12, 5, 2, 2), (10, 10, 3, 2, 1)])
def test_conv2d_out_hw_matches_reference(h, w, kernel, stride, pad):
    assert TLIN.conv2d_out_hw(h, w, kernel, stride, pad) == \
        JLIN.conv2d_out_hw(h, w, kernel, stride, pad)


def test_linearize_round_trip_matches_reference():
    x = _normal((2, 3, 4, 5), 0)
    t2d, ttrail = TLIN.linearize(_t(x))
    j2d, jtrail = JLIN.linearize(_j(x))
    assert ttrail == jtrail and TLIN.linearized_cols(ttrail) == JLIN.linearized_cols(jtrail)
    _close(t2d, j2d)
    _close(TLIN.delinearize(t2d, ttrail), JLIN.delinearize(j2d, jtrail))
    with pytest.raises(ValueError, match="cannot delinearize"):
        TLIN.delinearize(t2d, (3, 4, 4))


@pytest.mark.parametrize("density", [1.0, 0.3, 0.05])
@pytest.mark.parametrize("shape", [(128, 64), (16, 16)], ids=["large", "small"])
def test_format_and_operator_selection_match_reference(density, shape):
    rng = np.random.default_rng(0)
    x = _normal(shape, 1) * (rng.random(shape) < density)
    tmc, jmc = TSP.characteristics(x), JSP.characteristics(x)
    assert (tmc.nrows, tmc.ncols, tmc.nnz) == (jmc.nrows, jmc.ncols, jmc.nnz)
    assert TSP.characteristics(_t(x)) == tmc              # a tensor counts the same
    assert tmc.density == jmc.density and tmc.sparse_bytes() == jmc.sparse_bytes()
    assert tmc.dense_bytes() == jmc.dense_bytes()
    assert TSP.select_format(tmc) == JSP.select_format(jmc)
    dense = TSP.MatrixCharacteristics(shape[1], 32)
    assert TSP.select_matmul_operator(tmc, dense) == JSP.select_matmul_operator(
        jmc, JSP.MatrixCharacteristics(shape[1], 32))
    assert TSP.select_conv_operator(tmc, dense) == JSP.select_conv_operator(
        jmc, JSP.MatrixCharacteristics(shape[1], 32))


# ---------------------------------------------------------------------------
# Sequential on LeNet
# ---------------------------------------------------------------------------


def _lenet_pair(input_shape, num_classes=10, drop_dropout=False, seed=0):
    spec, meta = lenet_spec(input_shape=input_shape, num_classes=num_classes)
    jspec, jmeta = jlenet_spec(input_shape=input_shape, num_classes=num_classes)
    if drop_dropout:
        spec = [s for s in spec if s["kind"] != "dropout"]
        jspec = [s for s in jspec if s["kind"] != "dropout"]
    jmod = JSequential(jspec, jmeta)
    jparams = jmod.init(jax.random.PRNGKey(seed))
    tmod = Sequential(spec, meta)
    tparams = nn_params_from_numpy(jax.tree.map(np.asarray, jparams), torch.float32, "cpu")
    return tmod, tparams, jmod, jparams


def test_nn_params_from_numpy_keeps_the_layer_structure():
    tmod, tparams, jmod, jparams = _lenet_pair((1, 16, 16))
    assert [len(p) for p in tparams] == [len(p) for p in jparams]
    assert [li.attrs for li in tmod.layers] == [li.attrs for li in jmod.layers]
    assert tmod.out_shape == jmod.out_shape
    for tp, jp in zip(tparams, jparams):
        for t, j in zip(tp, jp):
            assert t.dtype == torch.float32 and tuple(t.shape) == j.shape


@pytest.mark.parametrize("size", [28, 16])
def test_lenet_test_mode_forward_matches_reference(size):
    tmod, tparams, jmod, jparams = _lenet_pair((1, size, size))
    x = _normal((4, size * size), 1)
    _close(tmod.predict(tparams, _t(x)), jmod.predict(jparams, _j(x)), **SUM_TOL)


def test_lenet_train_step_matches_reference():
    """One sgd_momentum step on the LeNet spec without its dropout entry
    (the two packages draw dropout masks from different generators):
    loss and updated parameters within 1e-4."""
    tmod, tparams, jmod, jparams = _lenet_pair((1, 16, 16), num_classes=5, drop_dropout=True)
    x = _normal((8, 256), 2)
    y = np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 0, 1, 2]]
    jstep = jmod.make_train_step("sgd_momentum", 0.05)
    tstep = tmod.make_train_step("sgd_momentum", 0.05)
    jnew, jstate, jloss = jstep(jparams, jmod.init_opt_state("sgd_momentum", jparams), *_j(x, y),
                                jax.random.PRNGKey(0), t=1)
    tnew, tstate, tloss = tstep(tparams, tmod.init_opt_state("sgd_momentum", tparams), *_t(x, y),
                                None, t=1)
    _close(tloss, jloss, rtol=1e-4, atol=1e-4)
    _close([t for p in tnew for t in p], [j for p in jnew for j in p], rtol=1e-4, atol=1e-4)
    _close([t for s in tstate for slot in s for t in slot],
           [j for s in jstate for slot in s for j in slot], rtol=1e-4, atol=1e-4)


def test_sequential_rejects_an_unknown_layer_kind():
    with pytest.raises(ValueError, match="unsupported layer kind"):
        Sequential([{"kind": "lstm"}], {"input_shape": (4,)})


def test_sequential_init_is_seeded_and_device_independent_of_draw_order():
    spec, meta = lenet_spec(input_shape=(1, 16, 16), num_classes=5)
    a = Sequential(spec, meta).init(torch.Generator().manual_seed(3))
    b = Sequential(spec, meta).init(torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert [tuple(t.shape) for p in a for t in p] == [(32, 25), (32, 1), (64, 800), (64, 1),
                                                      (1024, 512), (1, 512), (512, 5), (1, 5)]


# ---------------------------------------------------------------------------
# Keras2Plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["lenet", "softmax"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_generate_dml_is_byte_identical(which, optimizer):
    tmake, jmake = (lenet_spec, jlenet_spec) if which == "lenet" else (softmax_spec,
                                                                       jsoftmax_spec)
    assert generate_dml(*tmake(), optimizer, 0.01, 32) == \
        generate_dml(*jmake(), optimizer, 0.01, 32)
    assert generate_dml(*tmake(), optimizer, 0.01, 32) == \
        jgenerate_dml(*jmake(), optimizer, 0.01, 32)


def _fit_softmax(cls, train_algo="minibatch", density=1.0, epochs=3, **kw):
    spec, meta = (softmax_spec if cls is Keras2Plan else jsoftmax_spec)(20, 4)
    x, y = SyntheticClassification(20, 4, density=density).batch(512)
    est = cls(spec, meta, optimizer="sgd", lr=0.5, batch_size=64, epochs=epochs,
              train_algo=train_algo, **kw)
    return est.fit(x, y), x, y


@pytest.mark.parametrize("density,decision", [(1.0, "dense"), (0.05, "sparse")])
def test_keras2plan_softmax_fits_and_decides_the_format_as_the_reference(density, decision):
    est, x, y = _fit_softmax(Keras2Plan, density=density, device="cpu")
    ref, _, _ = _fit_softmax(JKeras2Plan, density=density)
    assert est.format_decisions == ref.format_decisions == {"X": decision}
    if density == 1.0:                     # the reference's fit checks, on dense data
        assert est.history[-1] < est.history[0] * 0.7
        assert est.score(x, y) > 0.6
    np.testing.assert_allclose(est.predict_proba(x[:10]).sum(axis=1), 1.0, rtol=1e-4)
    assert est._last_score_plan == "serial"


@pytest.mark.parametrize("train_algo,epochs", [("minibatch", 3), ("batch", 30)])
def test_keras2plan_softmax_on_reference_weights_follows_the_reference(monkeypatch,
                                                                       train_algo, epochs):
    """Given the reference's initial weights, the port's fit gives the
    reference's loss history and scores (no dropout in this model)."""
    ref, x, _ = _fit_softmax(JKeras2Plan, train_algo=train_algo, epochs=epochs)
    jinit = JSequential(*jsoftmax_spec(20, 4)).init(jax.random.PRNGKey(ref.seed))
    monkeypatch.setattr(Sequential, "init", lambda self, gen, device=None: nn_params_from_numpy(
        jax.tree.map(np.asarray, jinit), torch.float32, device))
    est, _, _ = _fit_softmax(Keras2Plan, train_algo=train_algo, epochs=epochs, device="cpu")
    assert len(est.history) == len(ref.history)
    np.testing.assert_allclose(est.history, ref.history, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(est.predict_proba(x[:32]), ref.predict_proba(x[:32]),
                               rtol=1e-4, atol=1e-5)


def test_keras2plan_trains_lenet_on_the_cpu():
    spec, meta = lenet_spec(input_shape=(1, 16, 16), num_classes=5)
    x, y = train_lenet.synthetic_images(512)
    xt, yt = train_lenet.synthetic_images(128, seed=1)
    est = Keras2Plan(spec, meta, optimizer="sgd_momentum", lr=0.01, batch_size=32, epochs=2,
                     device="cpu")
    est.fit(x, y)
    assert np.isfinite(est.history).all() and len(est.history) == 32
    assert est.history[-1] < est.history[0]
    assert est.score(xt, yt) > 0.6
    assert est.format_decisions == {"X": "dense"}
    assert est.predict(xt[:5]).shape == (5,)


def test_synthetic_images_copy_matches_the_example():
    from examples.train_lenet import synthetic_images as example_images
    for a, b in zip(train_lenet.synthetic_images(20, num_classes=10, size=28, seed=3),
                    example_images(20, num_classes=10, size=28, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_keras2plan_rejects_invalid_algorithms():
    spec, meta = softmax_spec(4, 2)
    with pytest.raises(ValueError):
        Keras2Plan(spec, meta, train_algo="nope", device="cpu")
    with pytest.raises(ValueError):
        Keras2Plan(spec, meta, test_algo="nope", device="cpu")
    with pytest.raises(RuntimeError, match="fit first"):
        Keras2Plan(spec, meta, device="cpu").predict(np.zeros((2, 4), np.float32))
