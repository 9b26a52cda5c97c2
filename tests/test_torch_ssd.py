"""PyTorch port, SSD kernel layer: the Mamba-2 SSD oracles and the plain
version of the SSD-scan kernel against the JAX package — its jnp oracles and
its Pallas kernel in interpret mode — on the same seeded numpy inputs.

Float32, ``atol = rtol = 1e-4``: the chunked forms sum in another order than
the sequential scan and take the within-chunk cumsum in another order than
XLA (outputs reach ~100 on these inputs; the largest difference seen is
~8e-5). The CUDA kernel itself runs only on the card (``chip_smoke.py``);
here its arithmetic is held through ``ssd_scan_tf32x3_torch`` (its
decomposition: C B^T once per (row, chunk), then 3xTF32 products), and the
wrapper's CPU dispatch, tile choice and pre-launch checks are tested."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd  # noqa: E402
from repro_torch.hw import H100  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
# (B, S, H, P, N, chunk): tests/test_kernels.py's four, then the smoke width
# (mamba2-1.3b-smoke: H 16, P 16, N 16) at S = 32 < 64
SHAPES = [(2, 64, 3, 8, 16, 16), (1, 32, 2, 16, 8, 8), (2, 128, 4, 8, 32, 32),
          (1, 64, 1, 32, 64, 16), (2, 32, 16, 16, 16, 64)]


def _inputs(b, s, h, p, n, seed=0, strong_decay=False):
    """x, dt, a, B, C, d as float32 numpy arrays; dt softplus'd, a < 0.
    ``strong_decay``: a = -16 and dt mostly in [6, 7.5] with one position in
    five near 0, so the within-chunk cumsum falls below -5,000."""
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
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm, d)]


def _t(arrs):
    return [torch.from_numpy(v) for v in arrs]


def _j(arrs):
    return [jnp.asarray(v) for v in arrs]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_oracles_match_reference(shape):
    """``ssd_ref`` (sequential) and ``ssd_chunked_ref``: outputs and final
    states."""
    *dims, chunk = shape
    arrs = _inputs(*dims)
    chunk = min(chunk, dims[1])
    ty, ts = ref.ssd_ref(*_t(arrs))
    jy, js = jref.ssd_ref(*_j(arrs))
    _close(ty, jy)
    _close(ts, js)
    ty, ts = ref.ssd_chunked_ref(*_t(arrs), chunk=chunk)
    jy, js = jref.ssd_chunked_ref(*_j(arrs), chunk=chunk)
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_pallas_interpret(shape):
    """``ssd_scan_torch`` against the reference's Pallas kernel (interpret
    mode) at the same chunk, capped at S as both cap it."""
    *dims, chunk = shape
    arrs = _inputs(*dims, seed=1)
    got = SSD.ssd_scan_torch(*_t(arrs), chunk=chunk)
    want = jssd(*_j(arrs), chunk=chunk, interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_plain_version_bf16_rounds_only_its_output():
    """bfloat16 x/B/C: the plain version computes in float32 and rounds once,
    so its output is the float32 result on the same (bf16) inputs,
    rounded."""
    x, dt, a, bm, cm, d = _t(_inputs(2, 64, 16, 16, 16, seed=2))
    xb, bb, cb = (v.to(torch.bfloat16) for v in (x, bm, cm))
    got = SSD.ssd_scan_torch(xb, dt, a, bb, cb, d)
    want = SSD.ssd_scan_torch(xb.float(), dt, a, bb.float(), cb.float(), d)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


@pytest.mark.parametrize("dims", [(2, 128, 4, 16, 16), (1, 256, 2, 64, 128)],
                         ids=["smoke-width", "full-width"])
def test_strong_decay_plain_version_matches_sequential_oracle(dims):
    """a = -16, dt to 7.5: the within-chunk cumsum falls below -5,000. The
    plain version keeps it in float64, so each exponent cum_i - cum_j keeps
    float32 precision and the result stays on the sequential scan's (which
    never forms such a difference): max error 5e-5 / 3e-4 at outputs of
    ~100. The float32-cumsum chunked form (the reference's) is off by up to
    0.02 / 0.12 (3-8 % of an output near a cancellation), which the module's
    tolerance does not admit."""
    arrs = _inputs(*dims, seed=3, strong_decay=True)
    cum = np.cumsum(arrs[1][:, :64] * arrs[2], axis=1)
    assert cum.min() < -5000
    want, _ = ref.ssd_ref(*_t(arrs))
    got = SSD.ssd_scan_torch(*_t(arrs))
    assert torch.isfinite(got).all()
    _close(got, want.numpy())
    f32_cum, _ = ref.ssd_chunked_ref(*_t(arrs), chunk=64)
    with pytest.raises(AssertionError):
        _close(f32_cum, want.numpy())


def test_ops_ssd_on_cpu_takes_the_plain_version():
    arrs = _t(_inputs(2, 64, 16, 16, 16, seed=4))
    before = SSD.ssd_scan.launches
    want = SSD.ssd_scan_torch(*arrs)
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        try:
            got = ops.ssd(*arrs)
        finally:
            ops.BACKEND = "auto"
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(SSD.ssd_scan(*arrs), want, atol=0, rtol=0)
    assert SSD.ssd_scan.launches == before
    ops.BACKEND = "kernel"
    try:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.ssd(*arrs)
    finally:
        ops.BACKEND = "auto"
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.ssd(*_t(_inputs(1, 96, 2, 16, 16)))


def _bad_case(kind):
    x, dt, a, bm, cm, d = _t(_inputs(1, 128, 4, 64, 128))
    chunk = 64
    if kind == "bf16 x, float32 B":
        x = x.to(torch.bfloat16)
    elif kind == "float16":
        x, bm, cm = (v.half() for v in (x, bm, cm))
    elif kind == "bf16 dt":
        dt = dt.to(torch.bfloat16)
    elif kind == "S % chunk":
        chunk = 48
    elif kind == "chunk > 64":
        chunk = 128
    elif kind == "(P, N) not built":
        x = x[..., :32].contiguous()
    elif kind == "dt shape":
        dt = dt[:, :, :2]
    elif kind == "not contiguous":
        bm = torch.from_numpy(np.asfortranarray(bm.numpy()))
    elif kind == "misaligned":
        x = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    return (x, dt, a, bm, cm, d), chunk


@pytest.mark.parametrize("kind,error", [
    ("bf16 x, float32 B", TypeError), ("float16", TypeError), ("bf16 dt", TypeError),
    ("S % chunk", ValueError), ("chunk > 64", ValueError),
    ("(P, N) not built", ValueError), ("dt shape", ValueError),
    ("not contiguous", ValueError), ("misaligned", ValueError)])
def test_wrapper_check_rejects_what_the_kernel_cannot_take(kind, error):
    """The checks the wrapper makes before a launch, on CPU tensors (the
    launch itself needs the card)."""
    args, chunk = _bad_case(kind)
    with pytest.raises(error):
        SSD._check(*args, chunk)
    ok, chunk = _bad_case("none")
    SSD._check(*ok, chunk)
    with pytest.raises(ValueError, match="CUDA tensors"):
        SSD.ssd_scan(*(t.to("meta") for t in ok))


def test_kernel_tiles_fit_two_blocks_per_sm():
    """The walk's layout (the name is the first design's, which ran two
    blocks per SM; the redesign runs one block of 8 or 16 warps per SM):
    every P tile the wrapper can pick, in both dtypes, fits the opt-in
    shared memory of one block, and the only tile that does not fit (float32
    at the whole P of 64) is never picked. Two 32-column tiles cover P = 64,
    so the (1, 1024) bucket's 64 heads run 128 blocks."""
    for (p, n), tiles in SSD.P_TILES.items():
        for pt in tiles:
            assert p % pt == 0 and pt % 16 == 0
        for dtype in (torch.float32, torch.bfloat16):
            for bsz in (1, 2, 4, 8):
                pt = SSD.p_tile(bsz, 64, p, n, dtype, SSD.H100_SMS)
                assert SSD.smem_bytes(p, n, dtype, pt) <= H100.vmem_bytes
    assert SSD.smem_bytes(64, 128, torch.float32, 64) > H100.vmem_bytes
    assert 1 * 64 * (64 // SSD.p_tile(1, 64, 64, 128, torch.bfloat16, 132)) == 128


@pytest.mark.parametrize("bsz,dtype,sm_count,pt", [
    (1, torch.bfloat16, 132, 32),    # (1, 1024) bucket: 64 whole-P blocks leave SMs idle
    (2, torch.bfloat16, 132, 32),
    (4, torch.bfloat16, 132, 64),    # (4, 2048): 256 whole-P blocks
    (8, torch.bfloat16, 132, 64),    # serving shape
    (8, torch.float32, 132, 32),     # float32's whole-P ring does not fit
    (1, torch.bfloat16, 64, 64),     # a card with as many SMs as heads
])
def test_walk_takes_the_widest_p_tile_that_fills_the_card(bsz, dtype, sm_count, pt):
    assert SSD.p_tile(bsz, 64, 64, 128, dtype, sm_count) == pt
    assert SSD.p_tile(bsz, 16, 16, 16, dtype, sm_count) == 16


def _fp32_tol():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.within, mod.FP32_TOL


# (B, S, H, P, N, chunk): the kernel's two widths at chunks 64, 32 and 16
MODEL_SHAPES = [(1, 128, 2, 64, 128, 64), (1, 128, 2, 64, 128, 32), (1, 64, 2, 64, 128, 16),
                (2, 64, 4, 16, 16, 64), (2, 64, 4, 16, 16, 32), (2, 64, 4, 16, 16, 16)]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_matches_pallas_interpret_and_sequential_oracle(shape):
    """The kernel's decomposition (``ssd_scan_tf32x3_torch``: G = C B^T once
    per (row, chunk), W = (G o L) dt, every product 3xTF32) against the
    reference's Pallas kernel in interpret mode and against ``ssd_ref``."""
    *dims, chunk = shape
    arrs = _inputs(*dims, seed=5)
    got = SSD.ssd_scan_tf32x3_torch(*_t(arrs), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(dims[:3]) + (dims[3],)
    _close(got, jssd(*_j(arrs), chunk=chunk, interpret=True))
    want, _ = ref.ssd_ref(*_t(arrs))
    _close(got, want)


@pytest.mark.parametrize("dims", [(2, 128, 4, 16, 16), (1, 256, 2, 64, 128)],
                         ids=["smoke-width", "full-width"])
def test_kernel_model_strong_decay_matches_sequential_oracle(dims):
    """a = -16, dt to 7.5 (cumsum below -5,000): the kernel's decomposition
    keeps the float64 cumsum and stays on the sequential scan."""
    arrs = _inputs(*dims, seed=3, strong_decay=True)
    want, _ = ref.ssd_ref(*_t(arrs))
    got = SSD.ssd_scan_tf32x3_torch(*_t(arrs))
    assert torch.isfinite(got).all()
    _close(got, want.numpy())


@pytest.mark.parametrize("dims,strong", [((2, 128, 4, 16, 16), False),
                                         ((1, 128, 4, 64, 128), False),
                                         ((1, 256, 2, 64, 128), True)],
                         ids=["smoke-width", "full-width", "full-width-strong-decay"])
def test_kernel_model_meets_fp32_tol_where_plain_tf32_does_not(dims, strong):
    """3xTF32 (hi.hi + hi.lo + lo.hi) in every product is within
    chip_smoke.py's ``FP32_TOL`` of the float64 sequential scan; the hi.hi
    products alone (plain TF32) are not: the tolerance tells them apart."""
    within, tol = _fp32_tol()
    arrs = _t(_inputs(*dims, seed=6, strong_decay=strong))
    exact, _ = ref.ssd_ref(*(t.double() for t in arrs))
    ok, _, _, rms = within(SSD.ssd_scan_tf32x3_torch(*arrs), exact, tol)
    assert ok and rms < tol[2] / 10
    ok, _, _, rms = within(SSD.ssd_scan_tf32x3_torch(*arrs, terms=1), exact, tol)
    assert not ok and rms > 10 * tol[2]
