"""PyTorch port, the matmul and conv2d kernels' layer: the plain versions
against the Pallas kernels in interpret mode (as ``tests/test_kernels.py``
runs them, at its shapes, dtypes and tolerances), the torch oracles against
the jnp ones, the operator dispatch under each backend, and the wrappers'
checks. Inputs come from seeded numpy; bfloat16 inputs are rounded from the
same float32 values in both packages. The CUDA kernels themselves run only
on the card (``chip_smoke.py``)."""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.conv2d_im2col import conv2d_im2col as jconv  # noqa: E402
from repro.kernels.matmul import matmul as jmatmul  # noqa: E402
from repro_torch.kernels import conv2d_im2col as tconv  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

torch.set_num_threads(2)

MATMUL_SHAPES = [(128, 128, 128), (256, 384, 128), (100, 70, 50), (17, 33, 9),
                 (512, 128, 256), (8, 8, 8)]
CONV_SHAPES = [  # n, c, h, w, f, kernel, stride, pad
    (2, 3, 8, 8, 4, 3, 1, 1),
    (1, 1, 12, 12, 8, 5, 2, 2),
    (3, 4, 16, 16, 16, 3, 1, 0),
    (2, 2, 10, 10, 6, 3, 2, 1),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
CONV_TOL = 2e-4


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(arr, torch_dtype, jax_dtype):
    """The same float32 values as a torch tensor and a jax array, both
    rounded to the dtype by round-to-nearest-even."""
    return torch.from_numpy(arr).to(torch_dtype), jnp.asarray(arr).astype(jax_dtype)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_plain_version_matches_pallas_kernel(m, k, n, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    ta, ja = _pair(_normal((m, k), 0), tdt, jdt)
    tb, jb = _pair(_normal((k, n), 1), tdt, jdt)
    got = tmm.matmul_torch(ta, tb)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    _close(got, jmatmul(ja, jb, interpret=True), tol)


@pytest.mark.parametrize("n,c,h,w,f,kern,stride,pad", CONV_SHAPES)
def test_conv2d_plain_version_matches_pallas_kernel(n, c, h, w, f, kern, stride, pad):
    tx, jx = _pair(_normal((n, c, h, w), 0), torch.float32, jnp.float32)
    tw, jw = _pair(_normal((f, c, kern, kern), 1), torch.float32, jnp.float32)
    want = jconv(jx, jw, stride=stride, pad=pad, interpret=True)
    got = tconv.conv2d_torch(tx, tw, stride=stride, pad=pad)
    assert tuple(got.shape) == want.shape
    _close(got, want, CONV_TOL)


def test_conv2d_plain_version_keeps_bfloat16_and_rounds_once():
    """bf16 in, bf16 out, equal to the float32 result on the same inputs
    rounded once."""
    x = torch.from_numpy(_normal((2, 3, 9, 9), 2)).bfloat16()
    w = torch.from_numpy(_normal((5, 3, 3, 3), 3)).bfloat16()
    got = tconv.conv2d_torch(x, w, stride=2, pad=1)
    assert got.dtype == torch.bfloat16
    want = tconv.conv2d_torch(x.float(), w.float(), stride=2, pad=1).bfloat16()
    assert torch.equal(got, want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 significand bits as ``cvt.rna.tf32.f32`` does:
    TF32 values stay, halfway cases go away from zero, carries reach the
    exponent."""
    x = torch.tensor([1.0, -3.0, 1 + 2 ** -10, 1 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 3 * 2 ** -11, 1 + 2 ** -12, 2 - 2 ** -12, 0.0])
    want = torch.tensor([1.0, -3.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10),
                         1 + 2 ** -9, 1.0, 2.0, 0.0])
    assert torch.equal(ref.tf32_round(x), want)


def _conv_case(n, c, h, w, f, kern, stride, pad):
    def run(rng):
        x = torch.from_numpy(rng.standard_normal((n, c, h, w)).astype(np.float32))
        wt = torch.from_numpy((rng.standard_normal((f, c, kern, kern))
                               / math.sqrt(c * kern * kern)).astype(np.float32))
        exact = torch.nn.functional.conv2d(x.double(), wt.double(), stride=stride,
                                           padding=pad)
        return (exact, *(tconv.conv2d_tf32x3_torch(x, wt, stride=stride, pad=pad, terms=t)
                         for t in (3, 1)))
    return run


def _matmul_case(m, k, n):
    def run(rng):
        a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32))
        return (a.double() @ b.double(),
                *(tmm.matmul_tf32x3_torch(a, b, terms=t) for t in (3, 1)))
    return run


@pytest.mark.parametrize("case", [
    _conv_case(2, 32, 14, 14, 64, 5, 1, 2),    # LeNet conv2: K = 800
    _conv_case(8, 16, 32, 32, 32, 3, 1, 1),    # chip_smoke.py's kernel-benchmark shape
    _matmul_case(64, 3136, 512),               # LeNet affine 1 at batch 64: K = 3136
], ids=["lenet-conv2-K800", "kernel-benchmark", "matmul-lenet-affine1-K3136"])
def test_tf32x3_meets_fp32_tol_where_plain_tf32_does_not(case):
    """The float32 conv and matmul kernels' arithmetic (3xTF32: lo.hi +
    hi.lo + hi.hi) is within chip_smoke.py's ``FP32_TOL`` of the float64
    product on inputs made as chip_smoke.py makes them (unit-variance
    outputs), while the hi.hi product alone (plain TF32) is not: the
    tolerance tells the two apart."""
    tol = _chip_smoke().FP32_TOL
    within = _chip_smoke().within
    exact, three, one = case(np.random.default_rng(12))
    assert three.dtype == torch.float32 and three.shape == exact.shape
    ok, _, _, rms = within(three, exact, tol)
    assert ok and rms < tol[2] / 10
    ok, _, _, rms = within(one, exact, tol)
    assert not ok and rms > 10 * tol[2]


# ---------------------------------------------------------------------------
# oracles: torch ref == jnp ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(100, 70, 50), (17, 33, 9), (64, 64, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_ref_matches_jnp(m, k, n, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    ta, ja = _pair(_normal((m, k), 4), tdt, jdt)
    tb, jb = _pair(_normal((k, n), 5), tdt, jdt)
    got = ref.matmul_ref(ta, tb)
    assert got.dtype == tdt
    _close(got, jref.matmul_ref(ja, jb), tol)


@pytest.mark.parametrize("n,c,h,w,f,kern,stride,pad", CONV_SHAPES)
def test_conv2d_ref_matches_jnp(n, c, h, w, f, kern, stride, pad):
    tx, jx = _pair(_normal((n, c, h, w), 6), torch.float32, jnp.float32)
    tw, jw = _pair(_normal((f, c, kern, kern), 7), torch.float32, jnp.float32)
    _close(ref.conv2d_ref(tx, tw, stride=stride, pad=pad),
           jref.conv2d_ref(jx, jw, stride=stride, pad=pad), CONV_TOL)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.fixture
def backend():
    old = ops.BACKEND
    yield
    ops.BACKEND = old


@pytest.mark.parametrize("name", ["auto", "torch", "kernel"])
def test_ops_matmul_under_each_backend(backend, name):
    ta, ja = _pair(_normal((33, 20), 8), torch.float32, jnp.float32)
    tb, jb = _pair(_normal((20, 7), 9), torch.float32, jnp.float32)
    ops.BACKEND = name
    if name == "kernel":
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.matmul(ta, tb)
        return
    _close(ops.matmul(ta, tb), jref.matmul_ref(ja, jb), 2e-5)


@pytest.mark.parametrize("name", ["auto", "torch", "kernel"])
def test_ops_conv2d_under_each_backend(backend, name):
    tx, jx = _pair(_normal((2, 3, 10, 10), 10), torch.float32, jnp.float32)
    tw, jw = _pair(_normal((4, 3, 5, 5), 11), torch.float32, jnp.float32)
    ops.BACKEND = name
    if name == "kernel":
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.conv2d(tx, tw, 2, 2)
        return
    _close(ops.conv2d(tx, tw, 2, 2), jref.conv2d_ref(jx, jw, stride=2, pad=2), CONV_TOL)


def test_ops_rejects_an_unknown_backend(backend):
    ops.BACKEND = "xla"
    with pytest.raises(ValueError, match="BACKEND"):
        ops.matmul(torch.zeros((2, 2)), torch.zeros((2, 2)))


def test_cpu_dispatch_launches_nothing():
    before = (tmm.matmul.launches, tconv.conv2d_im2col.launches)
    tmm.matmul(torch.ones((3, 4)), torch.ones((4, 5)))
    tconv.conv2d_im2col(torch.ones((1, 2, 6, 6)), torch.ones((3, 2, 3, 3)), pad=1)
    assert (tmm.matmul.launches, tconv.conv2d_im2col.launches) == before


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

_A, _B = torch.zeros((6, 4)), torch.zeros((4, 5))


@pytest.mark.parametrize("a,b,error,match", [
    (_A[None], _B, ValueError, r"\(M, K\) @ \(K, N\)"),
    (_A, torch.zeros((3, 5)), ValueError, r"\(M, K\) @ \(K, N\)"),
    (_A.double(), _B.double(), TypeError, "float32 or bfloat16"),
    (_A, _B.bfloat16(), TypeError, "one dtype"),
    (torch.zeros((0, 4)), _B, ValueError, ">= 1"),
    (_A, torch.zeros((5, 4)).T, ValueError, "contiguous"),
    (_A, torch.zeros((4, 5), device="meta"), ValueError, "is on meta"),
], ids=["rank", "inner-dim", "float64", "mixed-dtype", "empty", "strided", "device"])
def test_matmul_check_rejects_what_the_kernel_cannot_take(a, b, error, match):
    tmm._check(_A, _B)                      # the good case passes
    with pytest.raises(error, match=match):
        tmm._check(a, b)


_X, _W = torch.zeros((2, 3, 8, 8)), torch.zeros((4, 3, 3, 3))


@pytest.mark.parametrize("x,w,stride,pad,error,match", [
    (_X[0], _W, 1, 0, ValueError, r"\(N, C, H, W\)"),
    (_X, torch.zeros((4, 2, 3, 3)), 1, 0, ValueError, "square kernel"),
    (_X, torch.zeros((4, 3, 3, 2)), 1, 0, ValueError, "square kernel"),
    (_X.double(), _W.double(), 1, 0, TypeError, "float32 or bfloat16"),
    (_X, _W.bfloat16(), 1, 0, TypeError, "one dtype"),
    (_X, _W, 0, 0, ValueError, "stride >= 1"),
    (_X, _W, 1, -1, ValueError, "pad >= 0"),
    (torch.zeros((2, 3, 2, 2)), _W, 1, 0, ValueError, "empty"),
    (_X.transpose(2, 3), _W, 1, 0, ValueError, "contiguous"),
    (_X, torch.zeros((4, 3, 3, 3), device="meta"), 1, 0, ValueError, "is on meta"),
], ids=["rank", "channels", "non-square", "float64", "mixed-dtype", "stride", "pad",
        "too-small", "strided", "device"])
def test_conv2d_check_rejects_what_the_kernel_cannot_take(x, w, stride, pad, error, match):
    tconv._check(_X, _W, 2, 1)              # the good case passes
    with pytest.raises(error, match=match):
        tconv._check(x, w, stride, pad)


@pytest.mark.parametrize("fn,args", [
    (tmm.matmul, (torch.zeros((2, 2), device="meta"), torch.zeros((2, 2), device="meta"))),
    (tconv.conv2d_im2col, (torch.zeros((1, 1, 4, 4), device="meta"),
                           torch.zeros((1, 1, 3, 3), device="meta"))),
], ids=["matmul", "conv2d_im2col"])
def test_wrappers_refuse_tensors_neither_on_cpu_nor_on_cuda(fn, args):
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        fn(*args)


@pytest.mark.parametrize("m,k,n,sm_count,splits", [
    (64, 3136, 512, 132, 12),      # LeNet affine 1 at batch 64: 4 tiles -> 48 blocks
    (64, 512, 10, 132, 2),         # LeNet affine 2: 1 tile, K too shallow for more
    (10000, 3136, 512, 132, 1),    # scoring set: 316 tiles fill the card
    (1024, 1024, 1024, 132, 3),    # 64 tiles of 128 x 128
    (8, 8, 8, 132, 1),             # too shallow to split
    (64, 3136, 512, 4, 1),         # a card with as many SMs as tiles
])
def test_matmul_splits_the_depth_only_where_tiles_leave_sms_idle(m, k, n, sm_count, splits):
    assert tmm.splits_for(m, n, k, sm_count) == splits


@pytest.mark.parametrize("n,tile", [(10, 32), (32, 32), (33, 64), (64, 64), (65, 128),
                                    (512, 128)])
def test_matmul_tile_covers_n_with_the_fewest_columns(n, tile):
    assert tmm.tile_n(n) == tile


def test_matmul_kernel_names():
    assert tmm.kernel_name(torch.float32) == "repro_mm_tf32x3"
    assert tmm.kernel_name(torch.bfloat16) == "repro_mm_bf16"
