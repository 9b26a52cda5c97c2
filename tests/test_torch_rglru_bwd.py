"""PyTorch port, the RG-LRU scan's backward: ``kernels/rglru_scan.py``'s
``rglru_scan_bwd_torch`` (the plain version of the ``rglru_scan_bwd``
kernel and the registered gradient of the training forward
``rglru_scan_train``) against ``jax.vjp`` of the reference's gates
(``repro/models/blocks.py::_lru_gates``, fed the pre-activations as its
biases over zero weights) and its associative scan, on the same seeded
inputs. The CUDA kernel runs on the card only (``chip_smoke.py`` phase 3).

Tolerances, float32: each gradient within ``1e-5`` of its largest entry,
plus ``rtol = 1e-5`` (the reference's tree of combines against the
backward's sequential reverse recurrence; the largest difference seen is
~2e-6 of the largest entry). ``c``'s gradient is compared as ``a_log``'s,
``dc * d(c)/d(a_log)`` with ``c = -8 softplus(a_log)``.

The clamp ``max(1 - a^2, 1e-9)``: where ``a`` rounds to 1 in float32 (here
``a_log = -30``, so ``|c r|`` is below 1e-12) the clamp holds and both take
a zero derivative through it. (Near ``|c r|`` ~ 2^-25 an exp may round to 1
or to 1 - 2^-24, and beta moves from 3e-5 to 3e-4: a step in the function
itself, which XLA's compiled exp and PyTorch's take at other points.) At a tie JAX's ``maximum`` gives each side half; in
float32 ``1 - a^2`` is 0 or at least 2^-24, so no tie can occur, and the
backward's half-weight branch is held on its own.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import blocks as JB  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.models.blocks import _lru_decay  # noqa: E402

torch.set_num_threads(2)
GRADS = ("dxb", "dr_pre", "di_pre", "dy_pre", "dc")


def _inputs(b, s, w, seed, clamp=False):
    """xb, r_pre, i_pre, y_pre ~ N(0, 1), a_log = log(1 + 15 u) (the model's
    init) and dy, float32 numpy; ``clamp``: every other channel's a_log is
    -30, where a = exp(c r) rounds to 1 (|c r| < 1e-12)."""
    rng = np.random.default_rng(seed)
    xb, r_pre, i_pre, y_pre, dy = (rng.standard_normal((b, s, w)) for _ in range(5))
    a_log = np.log1p(15 * rng.random(w))
    if clamp:
        a_log[::2] = -30.0
    return [v.astype(np.float32) for v in (xb, r_pre, i_pre, y_pre, a_log, dy)]


def _reference(xb, r_pre, i_pre, y_pre, a_log):
    """y of the reference's block: its gates (``_lru_gates``, the
    pre-activations as biases over zero weights), the associative scan and
    the product with gelu(y_pre)."""
    w = xb.shape[-1]
    zeros = jnp.zeros((w, w), jnp.float32)
    a, gate = JB._lru_gates({"w_r": zeros, "w_i": zeros, "b_r": r_pre, "b_i": i_pre,
                             "a_log": a_log}, xb)
    bt = gate * xb

    def combine(lhs, rhs):
        return (rhs[0] * lhs[0], rhs[0] * lhs[1] + rhs[1])
    _, hseq = lax.associative_scan(combine, (a, bt), axis=1)
    return hseq * jax.nn.gelu(y_pre)


def _port(arrs):
    xb, r_pre, i_pre, y_pre, a_log, dy = (torch.from_numpy(v) for v in arrs)
    c = _lru_decay({"a_log": a_log})
    _y, h_chunks = RG.rglru_scan_train_torch(xb, r_pre, i_pre, y_pre, c)
    return RG.rglru_scan_bwd_torch(xb, r_pre, i_pre, y_pre, c, h_chunks, dy), c


def _close_to_max(got, want, frac=1e-5, rtol=1e-5, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("b,s,w,clamp", [(2, 64, 16, False), (3, 37, 24, False),
                                         (1, 8, 5, False), (2, 50, 12, True)],
                         ids=["chunks-whole", "ragged-S", "one-chunk", "clamp"])
def test_rglru_backward_matches_vjp_of_the_reference(b, s, w, clamp):
    arrs = _inputs(b, s, w, seed=b * s + w, clamp=clamp)
    _, vjp = jax.vjp(jax.jit(_reference), *(jnp.asarray(v) for v in arrs[:5]))
    want = vjp(jnp.asarray(arrs[5]))
    got, c = _port(arrs)
    if clamp:
        a = torch.exp(c * torch.sigmoid(torch.from_numpy(arrs[1])))
        assert bool((a == 1.0).any())           # the clamp holds somewhere
    for name, g, wnt in zip(GRADS[:4], got[:4], want[:4], strict=True):
        _close_to_max(g, np.asarray(wnt), name=name)
    a_log = torch.from_numpy(arrs[4])
    dalog = got[4] * -8.0 * torch.sigmoid(a_log)
    _close_to_max(dalog, np.asarray(want[4]), name="a_log")


def test_training_forward_y_and_chunk_states():
    """``rglru_scan_train_torch``: y is the serving plain version's, bit for
    bit; ``h_chunks[:, k]`` the state after position 8k - 1 (zeros for
    k = 0), at an S that 8 does not divide."""
    arrs = _inputs(2, 29, 6, seed=3)
    xb, r_pre, i_pre, y_pre, a_log, _ = (torch.from_numpy(v) for v in arrs)
    c = _lru_decay({"a_log": a_log})
    y, h_chunks = RG.rglru_scan_train_torch(xb, r_pre, i_pre, y_pre, c)
    want_y, _ = RG.rglru_scan_torch(xb, r_pre, i_pre, y_pre, c)
    assert torch.equal(y, want_y) and tuple(h_chunks.shape) == (2, 4, 6)
    assert torch.all(h_chunks[:, 0] == 0)
    for k in (1, 2, 3):
        _, h = RG.rglru_scan_torch(xb, r_pre, i_pre, y_pre, c,
                                   torch.full((2,), 8 * k, dtype=torch.int32))
        assert torch.equal(h_chunks[:, k], h)


def test_backward_bf16_rounds_only_its_gradients():
    """bfloat16 inputs: the four gradients are the float32 backward on the
    same values, rounded once; dc stays float32 and equal."""
    arrs = _inputs(2, 40, 8, seed=4)
    xb, r_pre, i_pre, y_pre, a_log, dy = (torch.from_numpy(v) for v in arrs)
    c = _lru_decay({"a_log": a_log})
    bf = [t.to(torch.bfloat16) for t in (xb, r_pre, i_pre, y_pre)]
    dyb = dy.to(torch.bfloat16)
    _y, h_chunks = RG.rglru_scan_train_torch(*bf, c)
    got = RG.rglru_scan_bwd_torch(*bf, c, h_chunks, dyb)
    want = RG.rglru_scan_bwd_torch(*(t.float() for t in bf), c, h_chunks, dyb.float())
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert g.dtype == (torch.float32 if name == "dc" else torch.bfloat16), name
        torch.testing.assert_close(g, w.to(g.dtype), atol=0, rtol=0)


def test_half_weight_at_a_tie_of_the_clamp():
    """The backward's weight on the clamped branch: 1 above 1e-9, 0 below,
    1/2 at a tie (JAX's ``maximum``), held through ``u`` values fed in
    directly (float32 arithmetic cannot produce the tie from a)."""
    u = torch.tensor([2e-9, 1e-9, 5e-10, 0.0])
    assert torch.where(u > 1e-9, 1.0, torch.where(u == 1e-9, 0.5, 0.0)).tolist() == \
        [1.0, 0.5, 0.0, 0.0]
    grads = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 1e-9)))(jnp.asarray(u.numpy()))
    assert np.asarray(grads).tolist() == [1.0, 0.5, 0.0, 0.0]
    a = torch.tensor([1.0, 1.0 - 2 ** -24, 0.5], dtype=torch.float32)
    assert (1.0 - a * a).tolist()[:2] == [0.0, pytest.approx(2 ** -23, rel=1e-6)]


def test_training_op_autograd_is_the_backward_and_counts_no_launch_on_the_cpu():
    """``ops.rglru`` under autograd on a CPU tensor takes
    ``rglru_scan_train`` (no kernel launch), returns no state, and its
    registered gradient equals autograd through the plain loop
    (``ops.BACKEND = "torch"``)."""
    arrs = _inputs(2, 45, 10, seed=6)
    grads = {}
    before = (RG.rglru_scan_train.launches, RG.rglru_scan_bwd.launches,
              RG.rglru_scan.launches)
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        try:
            leaves = [torch.from_numpy(v).requires_grad_() for v in arrs[:5]]
            c = _lru_decay({"a_log": leaves[4]})
            y, state = ops.rglru(*leaves[:4], c)
            y.backward(torch.from_numpy(arrs[5]))
        finally:
            ops.BACKEND = "auto"
        assert (state is None) == (backend == "auto")
        grads[backend] = [t.grad for t in leaves]
    assert (RG.rglru_scan_train.launches, RG.rglru_scan_bwd.launches,
            RG.rglru_scan.launches) == before
    for name, g, w in zip(("xb", "r_pre", "i_pre", "y_pre", "a_log"), grads["auto"],
                          grads["torch"], strict=True):
        _close_to_max(g, w.numpy(), name=name)
    with pytest.raises(ValueError, match="lengths"):
        ops.rglru(*leaves[:4], c.detach(), torch.full((2,), 45, dtype=torch.int32))


def test_new_ops_pass_opcheck():
    arrs = _inputs(1, 20, 4, seed=7)
    xb, r_pre, i_pre, y_pre, a_log, dy = (torch.from_numpy(v) for v in arrs)
    c = _lru_decay({"a_log": a_log})
    args = [t.requires_grad_() for t in (xb, r_pre, i_pre, y_pre, c.detach())]
    torch.library.opcheck(torch.ops.repro_torch.rglru_scan_train.default, tuple(args))
    _y, h_chunks = RG.rglru_scan_train_torch(*(t.detach() for t in args))
    torch.library.opcheck(torch.ops.repro_torch.rglru_scan_bwd.default,
                          (*(t.detach() for t in args), h_chunks, dy))


@pytest.mark.parametrize("kind", ["h_chunks shape", "h_chunks dtype", "dy dtype", "dy shape",
                                  "dy strided"])
def test_backward_check_rejects_what_the_kernel_cannot_take(kind):
    arrs = _inputs(2, 20, 16, seed=8)
    xb, r_pre, i_pre, y_pre, a_log, dy = (torch.from_numpy(v) for v in arrs)
    c = _lru_decay({"a_log": a_log})
    _y, h_chunks = RG.rglru_scan_train_torch(xb, r_pre, i_pre, y_pre, c)
    if kind == "h_chunks shape":
        h_chunks = h_chunks[:, :2].contiguous()
    elif kind == "h_chunks dtype":
        h_chunks = h_chunks.double()
    elif kind == "dy dtype":
        dy = dy.to(torch.bfloat16)
    elif kind == "dy shape":
        dy = dy[:, :10].contiguous()
    else:
        dy = dy.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        RG._check_bwd(xb, r_pre, i_pre, y_pre, c, h_chunks, dy)
