"""PyTorch port, the attention backward: ``kernels/flash_attention.py``'s
``flash_attention_bwd`` (the custom op ``repro_torch::flash_attention_bwd``,
the registered gradient of the training forward ``flash_attention_train``),
its CPU implementation ``attention_bwd_torch`` (the reference's recompute
rule) and ``attention_bwd_tiled`` (the plain version in the CUDA kernel's
tile order and rounding). The CUDA kernel runs on the card only
(``chip_smoke.py`` holds it against both plain versions).

Tolerances, float32:

- ``attention_bwd_tiled`` against ``attention_bwd_torch``: ``chip_smoke.py``'s
  ``FP32_TOL`` (atol 1e-4, rtol 1e-4, error RMS within 1e-5 of the
  reference's): the two differ in summation order and in exp2 of the
  exponent times log2(e) against exp (measured: RMS ratios ~3e-7);
- both against ``jax.vjp`` of the reference's ``_blocked``: ``rtol = 1e-5``
  with an ``atol`` of 1e-5 of the largest entry, as
  ``tests/test_torch_train.py`` holds the training op; the reference takes
  K/V expanded to every head, so its dk/dv are summed over each GQA group
  first.

Tolerance, bfloat16 (head dims 64, 128 and 256, where the kernel's dQ pass
is the TMA + wgmma one, summing over ``bwd_key_tile(d)`` keys a tile): the tiled
version on bfloat16 inputs against ``jax.vjp`` of ``_blocked`` on the same
values in float32: P and dS rounded to bfloat16 where they feed a product
keep each gradient's error RMS within 2^-7 of the reference's, as they keep
it from the tiled version's float32 self.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.models import attention as JATT  # noqa: E402
from repro_torch.hw import H100, H100_SMS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

torch.set_num_threads(2)
FP32_TOL = (1e-4, 1e-4, 1e-5)

CASES = [  # (name, b, hq, hkv, d, sq, sk, causal, window, q_offset)
    ("causal g=2", 2, 4, 2, 32, 50, 50, True, 0, -1),
    ("window g=1", 1, 2, 2, 32, 70, 70, True, 16, -1),
    ("q_offset window g=8", 1, 8, 1, 32, 20, 90, True, 24, 50),
    ("Sq<Sk ragged g=10", 1, 10, 1, 32, 30, 77, True, 0, -1),
    ("bidirectional ragged g=2", 2, 4, 2, 32, 40, 65, False, 0, -1),
    ("rows that see no key g=8", 1, 8, 1, 32, 45, 30, True, 0, -1),
    ("window past the keys g=10", 1, 10, 1, 64, 40, 100, True, 30, 70),
    ("D=128 causal ragged g=4", 1, 4, 1, 128, 150, 150, True, 0, -1),
    ("D=128 bidirectional Sq<Sk ragged g=2", 1, 4, 2, 128, 70, 200, False, 0, -1),
    ("D=64 causal ragged g=2", 1, 4, 2, 64, 150, 150, True, 0, -1),
    ("D=64 bidirectional Sq<Sk ragged g=1", 1, 2, 2, 64, 70, 200, False, 0, -1),
    ("D=256 causal ragged g=2", 1, 2, 1, 256, 150, 150, True, 0, -1),
    ("D=256 q_offset window g=5", 1, 5, 1, 256, 60, 210, True, 100, 130),
]
IDS = [c[0] for c in CASES]


def _inputs(b, hq, hkv, d, sq, sk, causal, window, q_offset, seed=0):
    """q, k, v and dout (kernel layout) from a seeded numpy generator, and
    the plain training forward's out and lse."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                               (b, hq, sq, d)))
    out, lse = FA.flash_attention_train_torch(q, k, v, causal=causal, window=window,
                                              q_offset=q_offset)
    return q, k, v, out, lse, dout


def _within(got, want, tol):
    atol, rtol, rms_limit = tol
    err = (got.double() - want.double()).abs()
    rms = max(float(want.double().pow(2).mean().sqrt()), 1e-30)
    assert not bool((err > atol + rtol * want.double().abs()).any()), float(err.max())
    assert float(err.pow(2).mean().sqrt()) / rms <= rms_limit


@pytest.mark.parametrize("name,b,hq,hkv,d,sq,sk,causal,window,q_offset", CASES, ids=IDS)
def test_tiled_float32_equals_the_plain_rule(name, b, hq, hkv, d, sq, sk, causal, window,
                                             q_offset):
    """In float32 nothing is rounded, so the kernel's order (dQ summed over
    ``BWD_FP32_KEYS`` = 64 keys a tile, the 3xTF32 dQ pass's, more than one
    tile where Sk passes 64) is the plain rule's function: within FP32_TOL,
    and rows that see no key get dq = 0 in both, keys no query sees dk = dv
    = 0."""
    assert FA.bwd_key_tile(d, torch.float32) == FA.BWD_FP32_KEYS
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    args = _inputs(b, hq, hkv, d, sq, sk, **mask)
    want = FA.attention_bwd_torch(*args, **mask)
    got = FA.attention_bwd_tiled(*args, **mask)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _within(g, w, FP32_TOL)
    off = sk - sq if q_offset < 0 else q_offset
    blind = max(0, -off) if causal else 0
    if blind:
        assert not bool(got[0][:, :, :blind].any()) and not bool(want[0][:, :, :blind].any())
    seen = FA._chunk_mask(off + torch.arange(sq), 0, sk, sk, causal, window).any(0)
    for grad in (*got[1:], *want[1:]):
        assert not bool(grad[:, :, ~seen].any())


def _reference(q, k, v, dout, causal, window, q_offset):
    """jax.vjp of the reference's _blocked on the same numpy inputs, model
    layout, K/V expanded; returned in the kernel layout, dk/dv summed over
    each GQA group."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    off = sk - sq if q_offset < 0 else q_offset

    def model(t):
        return jnp.asarray(t.numpy().transpose(0, 2, 1, 3))

    ke, ve = (jnp.repeat(model(t), g, axis=2) for t in (k, v))
    _, vjp = jax.vjp(lambda a, b_, c: JATT._blocked(a, b_, c, causal, window, off),
                     model(q), ke, ve)
    dq, dk, dv = (np.asarray(x) for x in vjp(model(dout)))
    dk, dv = (x.reshape(b, sk, hkv, g, d).sum(3) for x in (dk, dv))
    return tuple(x.transpose(0, 2, 1, 3) for x in (dq, dk, dv))


@pytest.mark.parametrize("name,b,hq,hkv,d,sq,sk,causal,window,q_offset",
                         [CASES[i] for i in (0, 2, 4, 5, 7, 8)],
                         ids=[IDS[i] for i in (0, 2, 4, 5, 7, 8)])
def test_plain_versions_match_the_reference_vjp(name, b, hq, hkv, d, sq, sk, causal, window,
                                                q_offset):
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    args = _inputs(b, hq, hkv, d, sq, sk, **mask, seed=1)
    q, k, v, _out, _lse, dout = args
    want = _reference(q, k, v, dout, causal, window, q_offset)
    for fn in (FA.attention_bwd_torch, FA.attention_bwd_tiled):
        for got, ref in zip(fn(*args, **mask), want, strict=True):
            np.testing.assert_allclose(got.double().numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("name,b,hq,hkv,d,sq,sk,causal,window,q_offset",
                         [CASES[i] for i in (7, 8)], ids=[IDS[i] for i in (7, 8)])
def test_tiled_bfloat16_at_d128_matches_the_reference_vjp(name, b, hq, hkv, d, sq, sk, causal,
                                                          window, q_offset):
    """At D = 128 the bfloat16 tiled version sums dQ over the TMA + wgmma dQ
    pass's key tiles, three or more here, the last ragged: within the
    bfloat16 tolerance of ``jax.vjp`` of ``_blocked`` on the same values."""
    assert sk > 2 * FA.bwd_key_tile(d) and sk % FA.bwd_key_tile(d)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, _out, _lse, dout = _inputs(b, hq, hkv, d, sq, sk, **mask, seed=5)
    q, k, v, dout = (t.to(torch.bfloat16) for t in (q, k, v, dout))
    out, lse = FA.flash_attention_train_torch(q.float(), k.float(), v.float(), **mask)
    got = FA.attention_bwd_tiled(q, k, v, out.to(torch.bfloat16), lse, dout, **mask)
    want = _reference(q.float(), k.float(), v.float(), dout.float(), causal, window, q_offset)
    for g, w in zip(got, want, strict=True):
        w = torch.from_numpy(np.ascontiguousarray(w)).double()
        ratio = float((g.double() - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
        assert ratio < 2.0 ** -7, ratio


def test_backward_tiles_and_shared_memory_per_head_dim():
    """The dQ pass's key tile (the tiled version's order) is 64 at every head
    dim in both dtypes, the TMA + wgmma pass's at D = 64, 128 and 256 in
    bfloat16; every pass's shared memory fits the card's per-block budget
    (float32's D = 128 dK/dV pass within 2 KB of it). In bfloat16, D = 128's larger
    pass is the dK/dV pass: 128-key K and V tiles, two stages of 64-row Q
    and dO tiles with their rows' lse and delta, five mbarriers and the 1 KB
    alignment; D = 64's also the dK/dV pass, at half the width with 192
    keys (three consumers) and three stages; D = 256's the dQ pass:
    128-row Q and dO tiles, three slots of one 64-key K or V tile, seven
    mbarriers and the alignment (its dK/dV pass: one 64-key K and V tile,
    two stages of 64-row Q and dO tiles)."""
    assert {d: FA.bwd_key_tile(d) for d in FA.HEAD_DIMS} == {32: 64, 64: 64, 128: 64, 256: 64}
    for d in (64, 128, 256):
        assert FA.BWD_WGMMA_DQ[d][1] == FA.bwd_key_tile(d)
    dkdv = 1024 + 2 * 32768 + 2 * (2 * 16384 + 512) + 8 * 5
    assert FA.bwd_smem_bytes(128, torch.bfloat16) == dkdv
    dkdv = 1024 + 2 * 24576 + 3 * (2 * 8192 + 512) + 8 * 7
    dq = 1024 + 2 * 24576 + 3 * 2 * 8192 + 8 * 7
    assert FA.bwd_smem_bytes(64, torch.bfloat16) == dkdv == 100920 > dq
    dq = 1024 + 2 * 65536 + 3 * 32768 + 8 * 7
    dkdv = 1024 + 2 * 32768 + 2 * (2 * 32768 + 512) + 8 * 5
    assert FA.bwd_smem_bytes(256, torch.bfloat16) == dq == 230456 > dkdv
    # float32 (3xTF32): swizzled rows of D floats; the dK/dV pass's K and V,
    # its ring of Q and dO tiles with their rows' lse and delta, and P^T and
    # dS^T; the dQ pass's Q and dO, its ring of K and V tiles, and dS. Its
    # dQ key tile is 64 at every head dim.
    assert {d: FA.bwd_key_tile(d, torch.float32) for d in FA.HEAD_DIMS} == {
        32: 64, 64: 64, 128: 64, 256: 64}
    assert all(FA.BWD_FP32_DQ[d][1] == FA.BWD_FP32_KEYS for d in FA.HEAD_DIMS)
    dkdv = 4 * (2 * 64 * 128 + 2 * (2 * 64 * 128 + 2 * 64) + 2 * 64 * 64)
    dq = 4 * (2 * 128 * 128 + 2 * 64 * 128 + 128 * 64)
    assert FA.bwd_smem_bytes(128, torch.float32) == dkdv == 230400 > dq == 229376
    dkdv = 4 * (2 * 32 * 256 + (2 * 64 * 256 + 2 * 64) + 2 * 32 * 64)
    dq = 4 * (2 * 32 * 256 + 2 * 64 * 256 + 32 * 64)
    assert FA.bwd_smem_bytes(256, torch.float32) == dkdv == 213504 > dq
    assert FA.bwd_smem_bytes(64, torch.float32) == 4 * (2 * 128 * 64 + 2 * (2 * 64 * 64 + 128)
                                                        + 2 * 128 * 64) == 197632
    assert FA.bwd_smem_bytes(32, torch.float32) == 132096
    for d in FA.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            assert 0 < FA.bwd_smem_bytes(d, dtype) <= H100.vmem_bytes


def test_check_bwd_raises_past_the_shared_memory_budget():
    """At D = 128 and at D = 256 (whose dQ pass comes within 2 KB of the
    card's per-block budget) the launch's check takes the pass's exact
    shared memory and raises one byte below it."""
    mask = dict(causal=True, window=0, q_offset=-1)
    for d, need in ((128, 133160), (256, 230456)):
        args = [t.to(torch.bfloat16) if t.dim() == 4 else t
                for t in _inputs(1, 4, 2, d, 16, 16, **mask)]
        assert FA.bwd_smem_bytes(d, torch.bfloat16) == need
        FA._check_bwd(*args, hw_smem=need)
        FA._check_bwd(*args)   # the card's own budget
        with pytest.raises(ValueError, match=f"backward kernel needs {need} B of shared memory"):
            FA._check_bwd(*args, hw_smem=need - 1)


def test_kv_splits_divide_query_heads_only_where_blocks_are_few():
    """The dK/dV pass divides a kv head's query heads over blocks at D =
    256 in bfloat16 and at every head dim in float32, only where its blocks
    would not fill the card twice over, at most at the cap and g:
    RecurrentGemma-2B's training shape in bfloat16 (4 x 1 kv head x 32 key
    tiles = 128 blocks on 132 SMs) takes two; in float32 the train-check
    twins' (2, 512, 32/4) (2 x 4 x 8 = 64 blocks, 5 wanted) takes 4, two
    query heads each as 5 would give the longest split, the hybrid twin's
    (2, 512, 10/1, D 256) 5 (32 blocks, 9 wanted: two heads each); a
    shape with enough blocks, one query head a kv head, or
    (bfloat16) another head dim takes one. The count depends on the shape
    and the card only, so a shape always gets the same bits."""
    sms, bf, f32 = H100_SMS, torch.bfloat16, torch.float32
    assert FA.bwd_kv_splits(4, 10, 1, 2048, 256, bf, sms) == 2
    assert FA.bwd_kv_splits(1, 5, 1, 200, 256, bf, sms) == 2
    assert FA.bwd_kv_splits(16, 10, 1, 2048, 256, bf, sms) == 1      # 512 blocks
    assert FA.bwd_kv_splits(4, 4, 4, 2048, 256, bf, sms) == 1        # g = 1
    for d in (32, 64, 128):
        assert FA.bwd_kv_splits(1, 16, 1, 256, d, bf, sms) == 1
    assert FA.bwd_kv_splits(4, 10, 1, 0, 256, bf, sms) == 1
    assert FA.bwd_kv_splits(2, 32, 4, 512, 128, f32, sms) == 4
    assert FA.bwd_kv_splits(2, 10, 1, 512, 256, f32, sms) == 5
    assert FA.bwd_kv_splits(4, 10, 1, 2048, 256, f32, sms) == 2      # 256 blocks
    assert FA.bwd_kv_splits(4, 32, 4, 2048, 128, f32, sms) == 1      # 512 blocks
    assert FA.bwd_kv_splits(2, 16, 16, 512, 64, f32, sms) == 1       # g = 1
    assert FA.bwd_kv_splits(1, 4, 2, 200, 32, f32, sms) == 2         # 2 blocks, g = 2
    assert FA.bwd_kv_splits(2, 32, 4, 0, 128, f32, sms) == 1
    for d in FA.HEAD_DIMS:
        for dtype in (bf, f32):
            splits = FA.bwd_kv_splits(1, 16, 2, 100, d, dtype, sms)
            assert 1 <= splits <= 8 and splits == FA.bwd_kv_splits(1, 16, 2, 100, d, dtype, sms)


def test_kernel_names_per_head_dim_and_dtype():
    """bfloat16 at D = 64, 128 and 256 runs the TMA + wgmma passes, at D =
    32 the mma.sync ones; float32 the 3xTF32 ones at every head dim."""
    for d in FA.HEAD_DIMS:
        names = FA.bwd_kernel_names(d, torch.bfloat16)
        kind = "mma" if d == 32 else "wgmma"
        assert names == (f"flash_bwd_dkdv_{kind}_kernel<{d}>", f"flash_bwd_dq_{kind}_kernel<{d}>")
        assert FA.bwd_kernel_names(d, torch.float32) == (f"flash_bwd_dkdv_tf32x3_kernel<{d}>",
                                                         f"flash_bwd_dq_tf32x3_kernel<{d}>")


@pytest.mark.parametrize("name,b,hq,hkv,d,sq,sk,causal,window,q_offset", CASES[9:], ids=IDS[9:])
def test_tiled_bfloat16_at_d64_and_d256_matches_the_reference_vjp(name, b, hq, hkv, d, sq, sk,
                                                                  causal, window, q_offset):
    """At D = 64 and 256 the bfloat16 tiled version sums dQ over the TMA +
    wgmma dQ pass's key tiles, three or more here, the last ragged (one case
    windowed with q_offset): within the bfloat16 tolerance of ``jax.vjp`` of
    ``_blocked`` on the same values."""
    test_tiled_bfloat16_at_d128_matches_the_reference_vjp(name, b, hq, hkv, d, sq, sk, causal,
                                                          window, q_offset)


def test_tiled_bfloat16_rounds_p_and_ds_only_where_they_feed_a_product():
    """In bfloat16 the tiled version equals its float32 self on the same
    (bfloat16-valued) inputs up to P's and dS's rounding: far below the
    inputs' own rounding, and not zero."""
    mask = dict(causal=True, window=0, q_offset=-1)
    q, k, v, out, lse, dout = _inputs(1, 4, 2, 32, 40, 40, **mask, seed=2)
    bf = tuple(t.to(torch.bfloat16) for t in (q, k, v, out))
    dbf = dout.to(torch.bfloat16)
    got = FA.attention_bwd_tiled(*bf, lse, dbf, **mask)
    exact = FA.attention_bwd_tiled(*(t.float() for t in bf), lse, dbf.float(), **mask)
    for g, w in zip(got, exact, strict=True):
        assert g.dtype == torch.float32
        ratio = float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
        assert 0 < ratio < 2.0 ** -7


def test_wrapper_on_cpu_is_the_plain_rule_and_the_training_ops_gradient():
    """On CPU tensors the wrapper is ``attention_bwd_torch`` bit for bit and
    counts no launch; the training op's gradient reaches it with the
    output's gradient as a transposed view (the model's layout)."""
    mask = dict(causal=True, window=8, q_offset=-1)
    q, k, v, out, lse, dout = _inputs(2, 4, 2, 32, 24, 24, **mask, seed=3)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, **mask)
    want = FA.attention_bwd_torch(q, k, v, out, lse, dout, **mask)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    o, _ = FA.flash_attention_train(tq, tk, tv, **mask)
    view = dout.transpose(1, 2).contiguous().transpose(1, 2)   # not contiguous
    assert not view.is_contiguous()
    o.backward(view)
    for grad, w in zip((tq.grad, tk.grad, tv.grad), want, strict=True):
        assert torch.equal(grad, w)
    assert FA.flash_attention_bwd.launches == before


def test_op_passes_opcheck():
    for mask in ((True, 0, -1), (True, 8, -1), (False, 0, -1), (True, 6, 20)):
        args = _inputs(1, 4, 2, 16, 12, 30, *mask, seed=4)
        torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd.default,
                              (*args, *mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_fake_implementation_gives_the_gradients_shapes(device, dtype):
    """dq takes q's shape and dtype, dk and dv k's and v's, on the inputs'
    device, with no launch."""
    shapes = ((2, 8, 20, 64), (2, 2, 33, 64), (2, 2, 33, 64), (2, 8, 20, 64), (2, 8, 20),
              (2, 8, 20, 64))
    before = FA.flash_attention_bwd.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [torch.empty(s, dtype=torch.float32 if len(s) == 3 else dtype, device=device)
                for s in shapes]
        dq, dk, dv = FA.flash_attention_bwd(*args, causal=True, window=0, q_offset=-1)
    for got, want in ((dq, args[0]), (dk, args[1]), (dv, args[2])):
        assert (got.shape, got.dtype, got.device.type) == (want.shape, dtype, device)
    assert FA.flash_attention_bwd.launches == before


@pytest.mark.parametrize("name,b,hq,hkv,d,sq,sk,causal,window,q_offset", CASES, ids=IDS)
def test_work_bwd_counts_five_products_and_each_tensor_once(name, b, hq, hkv, d, sq, sk, causal,
                                                            window, q_offset):
    """FLOPs: five products of 2 D per unmasked pair of every (row, query
    head), the pairs counted here from the mask itself; bytes: every input
    read once and every gradient written once."""
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    args = tuple(t.to(torch.bfloat16) if t.dim() == 4 else t
                 for t in _inputs(b, hq, hkv, d, sq, sk, **mask))
    off = sk - sq if q_offset < 0 else q_offset
    pairs = int(FA._chunk_mask(off + torch.arange(sq), 0, sk, sk, causal, window).sum())
    work = _build.WORK["repro_torch::flash_attention_bwd"](*args, causal, window, q_offset)
    assert work.flops == 5 * 2 * d * pairs * b * hq == FA.work_bwd(*args, **mask).flops
    grads = FA.flash_attention_bwd(*args, **mask)
    assert work.bytes == sum(t.nbytes for t in (*args, *grads))


def test_check_bwd_raises_on_what_the_kernel_does_not_take():
    """The CUDA launch's checks (they read only shapes, dtypes, strides and
    addresses, so they run here on CPU tensors)."""
    mask = dict(causal=True, window=0, q_offset=-1)
    base = [t.to(torch.bfloat16) if t.dim() == 4 else t
            for t in _inputs(1, 4, 2, 32, 16, 16, **mask)]
    FA._check_bwd(*base)
    bad = {
        "head dim 96": [torch.zeros(1, 4, 16, 96, dtype=torch.bfloat16),
                        torch.zeros(1, 2, 16, 96, dtype=torch.bfloat16),
                        torch.zeros(1, 2, 16, 96, dtype=torch.bfloat16),
                        torch.zeros(1, 4, 16, 96, dtype=torch.bfloat16), base[4],
                        torch.zeros(1, 4, 16, 96, dtype=torch.bfloat16)],
        "dout not contiguous": base[:5] + [base[5].transpose(2, 3).contiguous().transpose(2, 3)],
        "dout in float32": base[:5] + [base[5].float()],
        "lse in bfloat16": base[:4] + [base[4].to(torch.bfloat16), base[5]],
        "out of another shape": base[:3] + [base[3][:, :, :8], base[4], base[5]],
        "float16": [t.half() if t.dim() == 4 else t for t in base],
    }
    for what, args in bad.items():
        with pytest.raises((ValueError, TypeError)):
            FA._check_bwd(*args)
            pytest.fail(what)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(*(t.to("meta") for t in base), **mask)
