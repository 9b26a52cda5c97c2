"""PyTorch port, the SSD scan's backward: ``kernels/ssd_scan.py``'s
``ssd_scan_bwd_torch`` (the plain version of the ``ssd_scan_bwd`` kernel
and the registered gradient of the training forward ``ssd_scan_train``)
against the reference on the same seeded inputs. The CUDA kernel runs on the
card only (``chip_smoke.py`` phase 3 holds it against this plain version).

Tolerances, float32: each gradient within ``1e-4`` of its largest entry,
plus ``rtol = 1e-4``.

- Against ``jax.vjp`` of the reference's ``ssd_chunked_ref``: it sums a
  chunk's products in another order and takes the cumsum in float32.
- Under strong decay (a = -16, the within-chunk cumsum below -5,000)
  against autograd through the sequential scan in float64: the backward
  keeps the cumsum, the sums of cum's gradient and their reverse cumsum in
  float64 (``da`` sums terms of ~2,000 that cancel to ~5, so float32 sums
  of those terms leave it off by their own rounding error), and leaves K's
  diagonal, which cancels exactly, out of those sums. The reference's
  float32 form misses the tolerance there.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

torch.set_num_threads(2)
GRADS = ("dx", "ddt", "da", "db_mat", "dc_mat", "dd")


def _inputs(b, s, h, p, n, seed=0, strong_decay=False):
    """x, dt, a, B, C, d and the output gradient dy as float32 numpy
    arrays (tests/test_torch_ssd.py's inputs, strong decay included)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p))
    if strong_decay:
        u = rng.random((b, s, h))
        dt = np.where(u < 0.8, rng.uniform(6.0, 7.5, (b, s, h)), 0.01 * u)
        a = np.full((h,), -16.0)
    else:
        dt = np.log1p(np.exp(rng.normal(size=(b, s, h))))
        a = -np.exp(rng.normal(size=(h,)))
    bm, cm = rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n))
    d = rng.normal(size=(h,))
    dy = rng.normal(size=(b, s, h, p))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm, d, dy)]


def _port_bwd(arrs, chunk):
    args = [torch.from_numpy(v) for v in arrs[:6]]
    _y, states = SSD.ssd_scan_train_torch(*args, chunk=chunk)
    return SSD.ssd_scan_bwd_torch(*args, states, torch.from_numpy(arrs[6]), chunk=chunk)


def _close_to_max(got, want, frac=1e-4, rtol=1e-4, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * max(np.abs(want).max(), 1e-30), err_msg=name)


# (B, S, H, P, N, chunk): both widths the kernel takes, chunks 16 / 32 / 64,
# B x H not a multiple of a warp or of the SM count
BWD_SHAPES = [(2, 64, 3, 16, 16, 16), (3, 64, 5, 16, 16, 32), (1, 128, 7, 16, 16, 64),
              (2, 64, 3, 64, 128, 16), (1, 96, 3, 64, 128, 32), (3, 128, 2, 64, 128, 64)]


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_backward_matches_vjp_of_the_reference(shape):
    *dims, chunk = shape
    arrs = _inputs(*dims, seed=sum(shape))
    _, vjp = jax.vjp(lambda *a: jref.ssd_chunked_ref(*a, chunk=chunk)[0],
                     *(jnp.asarray(v) for v in arrs[:6]))
    want = vjp(jnp.asarray(arrs[6]))
    got = _port_bwd(arrs, chunk)
    assert [g.dtype for g in got] == [torch.float32] * 6
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert tuple(g.shape) == tuple(w.shape)
        _close_to_max(g, np.asarray(w), name=name)


def _sequential_f64(x, dt, a, b_mat, c_mat, d):
    """The SSD recurrence one position at a time, in float64 (no cumsum)."""
    bsz, s, h, p = x.shape
    state = torch.zeros((bsz, h, p, b_mat.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None, :])
        state = (decay[..., None, None] * state
                 + (dt[:, t, :, None] * x[:, t])[..., None] * b_mat[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_mat[:, t]))
    return torch.stack(ys, dim=1) + d[None, None, :, None] * x


@pytest.mark.parametrize("dims", [(2, 128, 4, 16, 16), (1, 256, 2, 64, 128)],
                         ids=["smoke-width", "full-width"])
def test_strong_decay_backward_matches_float64_sequential_oracle(dims):
    """a = -16, dt to 7.5: the within-chunk cumsum falls below -5,000. The
    backward (float64 cumsum, float64 reverse cumsum of its gradient) stays
    on the float64 sequential scan's gradient; the reference's float32
    chunked form does not."""
    arrs = _inputs(*dims, seed=3, strong_decay=True)
    assert np.cumsum(arrs[1][:, :64] * arrs[2], axis=1).min() < -5000
    leaves = [torch.from_numpy(v).double().requires_grad_() for v in arrs[:6]]
    y = _sequential_f64(*leaves)
    want = torch.autograd.grad(y, leaves, torch.from_numpy(arrs[6]).double())
    got = _port_bwd(arrs, 64)
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert torch.isfinite(g).all()
        _close_to_max(g, w.numpy(), name=name)
    _, vjp = jax.vjp(lambda *a: jref.ssd_chunked_ref(*a, chunk=64)[0],
                     *(jnp.asarray(v) for v in arrs[:6]))
    f32_cum = vjp(jnp.asarray(arrs[6]))
    with pytest.raises(AssertionError):
        for name, g, w in zip(GRADS, f32_cum, want, strict=True):
            _close_to_max(np.asarray(g), w.numpy(), name=name)


def test_backward_bf16_rounds_only_its_gradients():
    """bfloat16 x/B/C/dy: the gradients are formed in float32 and rounded
    once, so they are the float32 backward on the same (bf16) values,
    rounded; ddt, da and dd stay float32 and equal."""
    arrs = _inputs(2, 64, 4, 16, 16, seed=9)
    t = [torch.from_numpy(v) for v in arrs]
    for i in (0, 3, 4, 6):
        t[i] = t[i].to(torch.bfloat16)
    _y, states = SSD.ssd_scan_train_torch(*t[:6])
    got = SSD.ssd_scan_bwd_torch(*t[:6], states, t[6])
    f32 = [v.float() if v.dtype == torch.bfloat16 else v for v in t]
    want = SSD.ssd_scan_bwd_torch(*f32[:6], states, f32[6])
    for name, g, w in zip(GRADS, got, want, strict=True):
        assert g.dtype == (torch.bfloat16 if name in ("dx", "db_mat", "dc_mat")
                           else torch.float32), name
        torch.testing.assert_close(g, w.to(g.dtype), atol=0, rtol=0)


def test_training_forward_states_are_the_chunk_starting_states():
    """``ssd_scan_train_torch``: y is the serving plain version's, bit for
    bit; ``states[:, :, c]`` is the reference's final state after the first
    c chunks (zeros for c = 0)."""
    x, dt, a, bm, cm, d, _dy = _inputs(2, 96, 3, 16, 16, seed=4)
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm, d)]
    y, states = SSD.ssd_scan_train_torch(*t, chunk=32)
    assert torch.equal(y, SSD.ssd_scan_torch(*t, chunk=32))
    assert tuple(states.shape) == (2, 3, 3, 16, 16) and torch.all(states[:, :, 0] == 0)
    for c in (1, 2):
        sl = slice(0, 32 * c)
        _, want = jref.ssd_chunked_ref(jnp.asarray(x[:, sl]), jnp.asarray(dt[:, sl]),
                                       jnp.asarray(a), jnp.asarray(bm[:, sl]),
                                       jnp.asarray(cm[:, sl]), jnp.asarray(d), chunk=32)
        _close_to_max(states[:, :, c], np.asarray(want))


def test_training_op_autograd_is_the_backward_and_counts_no_launch_on_the_cpu():
    """``ops.ssd`` under autograd on a CPU tensor takes ``ssd_scan_train``
    (no kernel launch), whose registered gradient equals autograd through
    the plain forward (``ops.BACKEND = "torch"``)."""
    arrs = _inputs(2, 64, 4, 16, 16, seed=5)
    grads = {}
    before = (SSD.ssd_scan_train.launches, SSD.ssd_scan_bwd.launches, SSD.ssd_scan.launches)
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        try:
            leaves = [torch.from_numpy(v).requires_grad_() for v in arrs[:6]]
            y = ops.ssd(*leaves, chunk=32)
            y.backward(torch.from_numpy(arrs[6]))
        finally:
            ops.BACKEND = "auto"
        grads[backend] = [t.grad for t in leaves]
    assert (SSD.ssd_scan_train.launches, SSD.ssd_scan_bwd.launches,
            SSD.ssd_scan.launches) == before
    for name, g, w in zip(GRADS, grads["auto"], grads["torch"], strict=True):
        _close_to_max(g, w.numpy(), frac=2e-5, rtol=1e-5, name=name)


def test_new_ops_pass_opcheck():
    (x, dt, a, bm, cm, d, dy) = (torch.from_numpy(v) for v in _inputs(1, 32, 2, 16, 16, 6))
    args = [t.requires_grad_() for t in (x, dt, a, bm, cm, d)]
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_train.default, (*args, 16))
    _y, states = SSD.ssd_scan_train_torch(*(t.detach() for t in args), chunk=16)
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_bwd.default,
                          (*(t.detach() for t in args), states, dy, 16))


@pytest.mark.parametrize("kind,error", [
    ("states shape", ValueError), ("states dtype", ValueError), ("dy dtype", ValueError),
    ("dy shape", ValueError), ("dy strided", ValueError), ("P, N", ValueError)])
def test_backward_check_rejects_what_the_kernel_cannot_take(kind, error):
    x, dt, a, bm, cm, d, dy = (torch.from_numpy(v) for v in _inputs(1, 64, 2, 16, 16, 7))
    _y, states = SSD.ssd_scan_train_torch(x, dt, a, bm, cm, d)
    if kind == "states shape":
        states = states[:, :1]
    elif kind == "states dtype":
        states = states.double()
    elif kind == "dy dtype":
        dy = dy.to(torch.bfloat16)
    elif kind == "dy shape":
        dy = dy[:, :32]
    elif kind == "dy strided":
        dy = dy.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        x, dy, states = x[..., :8].contiguous(), dy[..., :8].contiguous(), states[..., :8, :]
    with pytest.raises(error):
        SSD._check_bwd(x, dt, a, bm, cm, d, states.contiguous() if kind != "dy strided"
                       else states, dy, 64)


def test_backward_fits_its_shared_memory_at_both_widths():
    """The chunk pass's block fits one block's shared memory at both widths
    and dtypes."""
    from repro_torch.hw import H100
    for dtype in (torch.float32, torch.bfloat16):
        assert SSD.bwd_smem_bytes(64, 128, dtype) <= H100.vmem_bytes
        assert SSD.bwd_smem_bytes(16, 16, dtype) < SSD.bwd_smem_bytes(64, 128, dtype)
    assert SSD.bwd_smem_bytes(64, 128, torch.bfloat16) < SSD.bwd_smem_bytes(64, 128,
                                                                           torch.float32)


@pytest.mark.parametrize("dims,hpb", [((4, 2048, 64, 64, 128), 16), ((2, 256, 64, 64, 128), 1),
                                      ((8, 2048, 64, 64, 128), 32), ((2, 128, 3, 16, 16), 1),
                                      ((64, 2048, 64, 64, 128), 64)])
def test_head_groups_fill_the_card(dims, hpb):
    """The chunk pass takes the most heads a block that still give
    BWD_WAVES blocks an SM of the H100's 132 (all heads where the (row,
    chunk) blocks alone do)."""
    b, s, h, _p, _n = dims
    assert SSD.heads_per_block(b, s, h) == hpb
    blocks = b * (s // 64) * -(-h // hpb)
    assert blocks >= SSD.BWD_WAVES * 132 or hpb == 1


def test_recurrent_backward_term_counts_the_new_scratch():
    """``core/memory.py``'s recurrent-backward term of Mamba-2 1.3B's
    one-card train step (remat: one layer's saved states) is ``train_bytes``
    of the backward's scratch: the Gram matrices, each chunk's float32
    dS_out (B, H, nc, P, N), the head groups' dB and dC partials and the
    (row, chunk, head) da (float64) and dd partials; no per-head (B, H, S,
    N) partials."""
    from repro_torch.config import InputShape, MeshConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.memory import estimate_memory
    from repro_torch.core.planner import compile_plan
    from repro_torch.hw import H100

    cfg = get_config("mamba2-1.3b")
    b, s, h, p, n = 4, 2048, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert (h, p, n) == (64, 64, 128)
    shape = InputShape("cli", s, b, "train")
    mesh = MeshConfig((1,), ("data",))
    plan = compile_plan(cfg, shape, mesh, TrainConfig())
    est = estimate_memory(cfg, shape, mesh, plan.config, TrainConfig(), H100)
    saved, scratch = SSD.train_bytes(b, s, h, p, n)
    assert est.per_device["recurrent_backward"] == saved + scratch
    nc, groups = s // 64, h // SSD.heads_per_block(b, s, h)
    assert scratch == 4 * (b * nc * 64 * 64 + b * h * nc * p * n + 2 * b * groups * s * n
                           + b * nc * h) + 8 * b * nc * h
    assert saved == 4 * b * h * nc * p * n
    assert scratch < 2 * 4 * b * h * s * n
