"""PyTorch port, kernel layer: the plain versions of the two attention
kernels and the torch oracles against the JAX package — the jnp oracles,
the XLA forms, and the Pallas kernels in interpret mode — on the same
seeded numpy inputs. Float32, ``atol = rtol = 1e-5`` (sums are taken in
another order than XLA's, nothing else differs). The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the wrappers'
CPU dispatch and shape checks are tested, and ``chip_smoke.py``'s bfloat16
check is shown to catch a kernel with a small mask flaw."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.paged_attention import (paged_attention_xla,  # noqa: E402
                                           paged_decode_attention as jpaged)
from repro.models import attention as JATT  # noqa: E402
from repro_torch.hw import H100  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import paged_attention as tpaged  # noqa: E402
from repro_torch.models import attention as TATT  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j, np.float32), **(tol or TOL))


def _attn_inputs(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _paged_case(b=3, hq=4, hkv=2, d=32, page=4, sc=16, seed=0, sentinel=True):
    """Flat slot stacks, shuffled page tables, one sentinel page on the last
    row's last page (never committed at the tested depths)."""
    rng = np.random.default_rng(seed)
    n_pages = -(-sc // page)
    n_phys = b * n_pages
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    k = rng.normal(size=(n_phys * page, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_phys * page, hkv, d)).astype(np.float32)
    tables = rng.permutation(n_phys).reshape(b, n_pages).astype(np.int32)
    if sentinel:
        tables[-1, -1] = n_phys
    return q, k, v, tables


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


# ---------------------------------------------------------------------------
# oracles: torch ref == jnp ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,q_offset", [
    (2, 4, 2, 16, 16, 32, True, 0, None),     # GQA g=2
    (1, 8, 2, 13, 29, 16, True, 0, None),     # unaligned, Sq < Sk
    (2, 4, 4, 16, 16, 32, False, 0, None),    # bidirectional
    (1, 4, 1, 24, 24, 32, True, 3, None),     # tiny window, MQA
    (1, 2, 1, 8, 8, 16, True, 2, 20),         # q_offset past Sk: fully-masked rows
    (1, 2, 2, 1, 40, 32, True, 0, 39),        # single query
])
def test_attention_ref_matches_jnp(b, hq, hkv, sq, sk, d, causal, window, q_offset):
    q, k, v = _attn_inputs(b, hq, hkv, sq, sk, d)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=q_offset)
    got = ref.attention_ref(*_t(q, k, v), causal=causal, window=window,
                            q_offset=q_offset)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)


@pytest.mark.parametrize("sc,page", [(16, 4), (13, 4), (20, 8)])
def test_phys_slots_matches_jnp(sc, page):
    _, _, _, tables = _paged_case(sc=max(sc, 16), page=page)
    want = jref.phys_slots(jnp.asarray(tables), sc, page)
    got = ref.phys_slots(torch.from_numpy(tables), sc, page)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos,window", [([15, 5, 9], 0), ([0, 0, 0], 0),
                                        ([11, 11, 11], 0), ([30, 3, 17], 16)])
def test_paged_decode_ref_matches_jnp(pos, window):
    q, k, v, tables = _paged_case()
    posv = np.asarray(pos, np.int32)
    want = jref.paged_decode_ref(*map(jnp.asarray, (q, k, v, tables, posv)),
                                 page=4, sc=16, window=window)
    got = ref.paged_decode_ref(*_t(q, k, v, tables, posv), page=4, sc=16,
                               window=window)
    _close(got, want)


# ---------------------------------------------------------------------------
# paged decode: plain version == Pallas (interpret) == XLA form == oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [[15, 5, 9], [0, 0, 0], [11, 11, 11], [3, 4, 7]])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2), (4, 4)])
def test_paged_plain_matches_pallas_and_xla(pos, hq, hkv):
    q, k, v, tables = _paged_case(hq=hq, hkv=hkv)
    posv = np.asarray(pos, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, posv)]
    want_pl = jpaged(*jargs, page=4, sc=16, interpret=True)
    want_xla = paged_attention_xla(*jargs, page=4, sc=16)
    want_ref = jref.paged_decode_ref(*jargs, page=4, sc=16)
    got = tpaged.paged_attention_torch(*_t(q, k, v, tables, posv), page=4, sc=16)
    _close(got, want_pl)
    _close(got, want_xla)
    _close(got, want_ref)


@pytest.mark.parametrize("pos", [[15, 5, 9], [0, 3, 11], [16, 40, 9]])
def test_paged_plain_matches_pallas_at_recurrentgemma_group(pos):
    """recurrentgemma-2b's GQA group, 10 query heads on one kv head of 256
    (g * D = 2560), including rows past Sc."""
    q, k, v, tables = _paged_case(hq=10, hkv=1, d=256)
    posv = np.asarray(pos, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, posv)]
    got = tpaged.paged_attention_torch(*_t(q, k, v, tables, posv), page=4, sc=16)
    _close(got, jpaged(*jargs, page=4, sc=16, interpret=True))
    _close(got, jref.paged_decode_ref(*jargs, page=4, sc=16))


def test_paged_plain_rotating_writes():
    """Rows decoded past a rotating window, cache contents written through
    both packages' rotating paged write: the plain version (reduced
    committed-slot mask) equals the Pallas kernel and the literal-rule
    oracle, and the two writes leave identical slot stacks."""
    b, hkv, d, page, sc = 2, 2, 32, 4, 8
    q, k0, v0, tables = _paged_case(b=b, hq=4, hkv=hkv, d=d, page=page, sc=sc,
                                    sentinel=False)
    rng = np.random.default_rng(3)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = _t(k0, v0)
    for p in range(13):  # decode depth wraps the window
        posv = np.full((b,), p, np.int32)
        kn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
        vn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
        jk, jv = JATT.paged_cache_write(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.asarray(posv), jnp.asarray(tables),
                                        page, sc, window=sc)
        TATT.paged_cache_write(tk, tv, *_t(kn, vn, posv, tables), page, sc,
                               window=sc)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    posv = np.full((b,), 12, np.int32)
    want_ref = jref.paged_decode_ref(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                                     jnp.asarray(posv), page=page, sc=sc, window=sc)
    want_pl = jpaged(jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(posv),
                     page=page, sc=sc, interpret=True)
    got = tpaged.paged_attention_torch(torch.from_numpy(q), tk, tv,
                                       *_t(tables, posv), page=page, sc=sc)
    _close(got, want_ref)
    _close(got, want_pl)


def test_paged_cache_write_drops_like_jax():
    """Writes past capacity and writes from free rows (all-sentinel tables)
    are dropped; nothing else in the slot stack changes — slot 0 included."""
    b, hkv, d, page, sc = 3, 2, 8, 4, 8
    _, k0, v0, tables = _paged_case(b=b, hq=2, hkv=hkv, d=d, page=page, sc=sc,
                                    sentinel=False)
    n_phys = k0.shape[0] // page
    tables[1, :] = n_phys                      # a free row
    rng = np.random.default_rng(5)
    kn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    vn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    for pos in ([3, 0, 8], [9, 5, 8], [8, 2, 100]):   # row 0/2 past capacity
        posv = np.asarray(pos, np.int32)
        jk, jv = JATT.paged_cache_write(*map(jnp.asarray, (k0, v0, kn, vn, posv, tables)),
                                        page, sc)
        tk, tv = _t(k0, v0)
        TATT.paged_cache_write(tk, tv, *_t(kn, vn, posv, tables), page, sc)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("pos", [[15, 5, 9], [0, 3, 11]])
def test_paged_gather_kv_matches_jax(pos):
    _, k, v, tables = _paged_case()
    posv = np.asarray(pos, np.int32)
    jke, jve = JATT.paged_gather_kv(*map(jnp.asarray, (k, v, tables)), 4, 16,
                                    pos=jnp.asarray(posv))
    tke, tve = TATT.paged_gather_kv(*_t(k, v, tables), 4, 16, pos=torch.from_numpy(posv))
    np.testing.assert_array_equal(tke.numpy(), np.asarray(jke))
    np.testing.assert_array_equal(tve.numpy(), np.asarray(jve))


def test_dense_cache_write_matches_jax():
    """Vector positions (rows at their own depths, out-of-capacity rows
    dropped) and a scalar position past capacity (clamped, as the
    reference's dynamic-update-slice clamps)."""
    rng = np.random.default_rng(2)
    kc = rng.normal(size=(3, 8, 2, 4)).astype(np.float32)
    kn = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    for pos, window in (([1, 8, 5], 0), ([9, 2, 17], 8)):
        posv = np.asarray(pos, np.int32)
        jk, _ = JATT.cache_write(*map(jnp.asarray, (kc, kc, kn, kn, posv)), window=window)
        tk, tv = _t(kc, kc)
        TATT.cache_write(tk, tv, *_t(kn, kn, posv), window=window)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jk, _ = JATT.cache_write(*map(jnp.asarray, (kc, kc, kn, kn)), jnp.int32(11))
    tk, tv = _t(kc, kc)
    TATT.cache_write(tk, tv, *_t(kn, kn), torch.tensor(11, dtype=torch.int32))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


# ---------------------------------------------------------------------------
# paged decode: the kernels' split plan and order (paged_attention_model)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sc,page", [(16, 4), (13, 4), (100, 16), (1000, 3), (1024, 64),
                                     (2048, 64), (4096, 64)])
@pytest.mark.parametrize("bsz,hkv", [(1, 4), (4, 4), (8, 4), (2, 1), (128, 8)])
def test_paged_split_plan_covers_every_slot_once(bsz, hkv, sc, page):
    """Every slot of [0, min(sc, n_tab * page)) lies in exactly one split,
    the splits are whole 64-slot tiles (paged_mma_kernel) or 128 slots
    (paged_split_kernel), and no planned split lies wholly past the slots."""
    n = min(sc, -(-sc // page) * page)
    for d, dtype in ((128, torch.bfloat16), (32, torch.bfloat16), (40, torch.bfloat16),
                     (128, torch.float32), (256, torch.bfloat16), (256, torch.float32)):
        slots, splits = tpaged.split_plan(bsz, hkv, n, d, dtype)
        if tpaged.kernel_name(d, dtype) == "paged_mma_kernel":
            assert slots % tpaged.TILE_SLOTS == 0
        else:
            assert slots == tpaged.SPLIT_SLOTS
        covered = np.zeros(n, np.int64)
        for s in range(splits):
            covered[s * slots:(s + 1) * slots] += 1
        assert (covered == 1).all() and (splits - 1) * slots < n


def test_paged_split_plan_fills_the_card_at_the_serving_buckets():
    """About two blocks per SM of a 132-SM H100 where the slots allow it:
    the (8, 2048) bucket's 32 (row, kv head) pairs take 8 splits of 256
    slots; the (4, 2048) bucket 16 of 128; the (1, 1024) bucket one 64-slot
    tile per split (64 blocks, as many as its slots allow). At D = 256 one
    block fits an SM: recurrentgemma's (8, 2048) bucket (one kv head) takes
    16 splits of 128 slots, 128 blocks."""
    bf16 = torch.bfloat16
    assert tpaged.split_plan(8, 1, 2048, 256, bf16, 132) == (128, 16)
    assert tpaged.split_plan(1, 1, 4096, 256, bf16, 132) == (64, 64)
    assert tpaged.split_plan(8, 4, 2048, 128, bf16, 132) == (256, 8)
    assert tpaged.split_plan(4, 4, 2048, 128, bf16, 132) == (128, 16)
    assert tpaged.split_plan(1, 4, 1024, 128, bf16, 132) == (64, 16)
    assert tpaged.split_plan(8, 4, 2048, 128, torch.float32, 132) == (128, 16)


def test_paged_kernel_name_follows_dtype_and_head_dim():
    assert tpaged.kernel_name(128, torch.bfloat16) == "paged_mma_kernel"
    assert tpaged.kernel_name(32, torch.bfloat16) == "paged_mma_kernel"
    assert tpaged.kernel_name(256, torch.bfloat16) == "paged_mma_kernel"
    assert tpaged.kernel_name(40, torch.bfloat16) == "paged_split_kernel"
    assert tpaged.kernel_name(128, torch.float32) == "paged_split_kernel"
    smoke = _chip_smoke()
    for name in ("paged_mma_kernel", "paged_split_kernel", "paged_combine_kernel"):
        assert smoke._kernel_family(f"void (anonymous namespace)::{name}<128>(...)") == \
            "paged_decode"


def _paged_committed_case(b, hq, hkv, d, page, sc, pos, seed):
    """Like ``_paged_case``, with a sentinel entry (>= n_phys) on every page
    a row has not committed, as the serving pool leaves them."""
    q, k, v, tables = _paged_case(b=b, hq=hq, hkv=hkv, d=d, page=page, sc=sc, seed=seed,
                                  sentinel=False)
    n_phys = k.shape[0] // page
    for row, p in enumerate(pos):
        tables[row, -(-min(p + 1, sc) // page):] = n_phys + row
    return q, k, v, tables


def _bf16_values(*arrs):
    """float32 arrays holding the bfloat16 roundings of ``arrs``."""
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]


PAGED_MODEL_CASES = {  # name: (b, hq, hkv, d, page, sc, pos)
    "pos=0": (3, 8, 2, 32, 4, 32, [0, 0, 0]),
    "pos=page-1": (3, 8, 2, 32, 4, 32, [3, 3, 3]),
    "pos=page": (3, 8, 2, 32, 4, 32, [4, 4, 4]),
    "pos mixed": (3, 8, 2, 32, 4, 32, [0, 13, 31]),
    "pos>=Sc": (3, 8, 2, 32, 4, 32, [32, 45, 77]),
    "g=16 D=64 page 16": (2, 16, 1, 64, 16, 96, [95, 40]),
    # recurrentgemma's group: 10 query heads on one kv head of 256
    "g=10 D=256 page 16": (2, 10, 1, 256, 16, 64, [63, 20]),
    "g=10 D=256 pos>=Sc": (2, 10, 1, 256, 16, 64, [64, 150]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PAGED_MODEL_CASES))
def test_paged_model_matches_plain_pallas_and_oracle(case, dtype):
    """The kernels' order — per-split partials with P split into bfloat16
    hi + lo, then the combine — against the plain version, the Pallas
    kernel (interpret) and the oracle on the same seeded inputs, with
    sentinel entries on every uncommitted page, at the kernel's own split
    plan and at 8-slot splits (several splits per row). float32 inputs:
    chip_smoke.py's FP32_TOL (the hi + lo split keeps P to 2^-18 relative).
    bfloat16 inputs (the references on the same rounded values in float32):
    the model's output rounded to bfloat16 within PAGED_BF16_TOL."""
    b, hq, hkv, d, page, sc, pos = PAGED_MODEL_CASES[case]
    q, k, v, tables = _paged_committed_case(b, hq, hkv, d, page, sc, pos, seed=7)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    posv = np.asarray(pos, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, posv)]
    wants = {"pallas": jpaged(*jargs, page=page, sc=sc, interpret=True),
             "oracle": jref.paged_decode_ref(*jargs, page=page, sc=sc),
             "plain": tpaged.paged_attention_torch(*_t(q, k, v, tables, posv), page=page,
                                                   sc=sc)}
    smoke = _chip_smoke()
    tol = smoke.FP32_TOL if dtype == "float32" else smoke.PAGED_BF16_TOL
    args = _t(q, k, v, tables, posv)
    if dtype == "bfloat16":
        args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    for split_slots in (None, 8):
        got = tpaged.paged_attention_model(*args, page=page, sc=sc, split_slots=split_slots,
                                           p_terms=2)
        got = got if dtype == "float32" else got.to(torch.bfloat16)
        for name, want in wants.items():
            ok, *readings = smoke.within(got, torch.from_numpy(np.array(want)), tol)
            assert ok, (name, split_slots, readings)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_model_rotating_writes(dtype):
    """Rows decoded past a rotating window through the reference's rotating
    paged write: the kernels' order against the Pallas kernel and the
    literal-rule oracle, as in ``test_paged_model_matches_plain_pallas_and_oracle``."""
    b, hkv, d, page, sc = 2, 2, 32, 4, 16
    q, k, v, tables = _paged_case(b=b, hq=8, hkv=hkv, d=d, page=page, sc=sc, sentinel=False)
    rng = np.random.default_rng(3)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    for p in range(37):  # decode depth wraps the window twice
        posv = np.asarray([p, p + 3], np.int32)
        kn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
        vn = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
        jk, jv = JATT.paged_cache_write(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.asarray(posv), jnp.asarray(tables),
                                        page, sc, window=sc)
    k, v = np.asarray(jk), np.asarray(jv)
    if dtype == "bfloat16":
        q, k, v = _bf16_values(q, k, v)
    jargs = [jnp.asarray(a) for a in (q, k, v, tables, posv)]
    wants = {"pallas": jpaged(*jargs, page=page, sc=sc, interpret=True),
             "oracle": jref.paged_decode_ref(*jargs, page=page, sc=sc, window=sc)}
    smoke = _chip_smoke()
    tol = smoke.FP32_TOL if dtype == "float32" else smoke.PAGED_BF16_TOL
    args = _t(q, k, v, tables, posv)
    if dtype == "bfloat16":
        args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    for split_slots in (None, 4):
        got = tpaged.paged_attention_model(*args, page=page, sc=sc, split_slots=split_slots,
                                           p_terms=2)
        got = got if dtype == "float32" else got.to(torch.bfloat16)
        for name, want in wants.items():
            ok, *readings = smoke.within(got, torch.from_numpy(np.array(want)), tol)
            assert ok, (name, split_slots, readings)


@pytest.mark.parametrize("b,hq,hkv,d,page,sc,pos,seed", [
    (2, 8, 1, 128, 16, 512, [300, 511], 0),      # Yi's g = 8, D = 128
    (1, 8, 1, 128, 64, 1024, [520], 3),          # one row of the (1, 1024) bucket
    (2, 16, 2, 64, 16, 1024, [1000, 700], 1),    # g = 16, D = 64
])
def test_paged_bf16_needs_p_hi_lo_where_rounding_p_alone_fails(b, hq, hkv, d, page, sc, pos,
                                                                seed):
    """On bfloat16 inputs (numpy seed ``seed``), paged_mma_kernel's order
    with P split into hi + lo, its output rounded to bfloat16, stays within
    chip_smoke.py's PAGED_BF16_TOL of the float32 plain version on the same
    inputs; rounding P to bfloat16 alone before P.V (about 2^-9 relative
    per term) does not: an output near zero misses the elementwise rtol."""
    q, k, v, tables = _paged_committed_case(b, hq, hkv, d, page, sc, pos, seed=seed)
    args = _t(q, k, v, tables, np.asarray(pos, np.int32))
    args[:3] = [t.to(torch.bfloat16) for t in args[:3]]
    want = tpaged.paged_attention_torch(*(t.float() for t in args[:3]), *args[3:], page=page,
                                        sc=sc)
    smoke = _chip_smoke()
    model = {terms: tpaged.paged_attention_model(*args, page=page, sc=sc,
                                                 p_terms=terms).to(torch.bfloat16)
             for terms in (1, 2)}
    assert smoke.within(model[2], want, smoke.PAGED_BF16_TOL)[0]
    assert not smoke.within(model[1], want, smoke.PAGED_BF16_TOL)[0]


# ---------------------------------------------------------------------------
# flash attention: plain version == Pallas (interpret)
# ---------------------------------------------------------------------------


FLASH_CASES = [  # b, hq, hkv, sq, sk, d, causal, window, q_offset
    (2, 4, 2, 64, 64, 32, True, 0, -1),
    (1, 8, 2, 128, 128, 64, True, 0, -1),
    (2, 4, 2, 64, 64, 32, True, 16, -1),     # sliding window
    (1, 2, 1, 100, 100, 32, True, 0, -1),    # unaligned
    (1, 4, 1, 32, 96, 32, True, 0, -1),      # Sq < Sk, q_offset = Sk - Sq
    (1, 4, 2, 32, 96, 32, True, 8, 40),      # explicit q_offset + window
    (2, 4, 4, 64, 64, 32, False, 0, -1),     # bidirectional
    # D = 128, the head dim of flash_wgmma_kernel (128-key tiles)
    (1, 2, 1, 256, 256, 128, True, 0, -1),   # two key tiles
    (1, 4, 2, 320, 320, 128, True, 100, -1), # window narrower than a key tile, ragged
    (1, 2, 1, 128, 384, 128, True, 0, -1),   # Sq < Sk over three key tiles
    # D = 256, recurrentgemma's 10 query heads on one kv head, windowed
    (1, 10, 1, 96, 96, 256, True, 32, -1),   # the window cuts inside the prompt
    (1, 10, 1, 40, 136, 256, True, 64, -1),  # Sq < Sk, window, ragged tile
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,q_offset", FLASH_CASES)
def test_flash_plain_matches_pallas(b, hq, hkv, sq, sk, d, causal, window, q_offset):
    q, k, v = _attn_inputs(b, hq, hkv, sq, sk, d, seed=1)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                  q_offset=q_offset, bq=32, bk=32, interpret=True)
    got = tflash.flash_attention_torch(*_t(q, k, v), causal=causal,
                                       window=window, q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,q_offset", FLASH_CASES)
def test_flash_tiled_plain_matches_pallas(b, hq, hkv, sq, sk, d, causal, window,
                                          q_offset, bk):
    """The plain version in the CUDA kernels' order (64-key tiles of
    flash_mma_kernel and flash_wgmma_kernel<64> and <256>, 128-key tiles of
    flash_wgmma_kernel<128>) against the Pallas kernel with the same key
    tile."""
    q, k, v = _attn_inputs(b, hq, hkv, sq, sk, d, seed=2)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                  q_offset=q_offset, bq=32, bk=bk, interpret=True)
    got = tflash.flash_attention_tiled(*_t(q, k, v), causal=causal, window=window,
                                       q_offset=q_offset, bk=bk)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,q_offset", [
    (1, 4, 2, 200, 200, 64, True, 0, -1), (2, 2, 2, 96, 320, 64, False, 0, -1),
    (1, 4, 1, 64, 160, 64, True, 48, -1)])
def test_flash_tiled_slack_leaves_the_function(b, hq, hkv, sq, sk, d, causal, window, q_offset,
                                               dtype):
    """flash_wgmma_kernel<64>'s running max moves only past a slack of 8
    (log2 units, ``RESCALE_SLACK``): the tiled plain version at that slack,
    its D = 64 default, equals the one at slack 0 up to float32 rounding (in
    bfloat16 up to P's rounding, which the slack moves), and both equal
    Pallas at the same key tile. Scores scaled x4 so that rows do pass the
    slack mid-row."""
    q, k, v = _attn_inputs(b, hq, hkv, sq, sk, d, seed=11)
    q = q * 4.0
    tq, tk, tv = (t.to(dtype) for t in _t(q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset, bk=64)
    assert tflash.RESCALE_SLACK[64] == 8.0
    lazy = tflash.flash_attention_tiled(tq, tk, tv, **kw)
    assert torch.equal(lazy, tflash.flash_attention_tiled(tq, tk, tv, slack=8.0, **kw))
    eager = tflash.flash_attention_tiled(tq, tk, tv, slack=0.0, **kw)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=4e-3, rtol=2 ** -7)
    np.testing.assert_allclose(lazy.numpy(), eager.numpy(), **tol)
    if dtype == torch.float32:
        want = jflash(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                      q_offset=q_offset, bq=32, bk=64, interpret=True)
        _close(lazy, want)


def test_flash_key_tile_follows_the_kernels():
    """128-key tiles where flash_wgmma_kernel<128> runs (bfloat16, D = 128),
    64 where flash_wgmma_kernel<64> and <256> and flash_mma_kernel (D = 32)
    do; the tiled plain version defaults to them. At D = 64 a bfloat16 block
    takes the 16 KB Q tile, two stages of 8 KB K and V tiles, 9 mbarriers
    and 1 KB of alignment (50,248 bytes: two blocks an SM, each with the
    1 KB the card reserves, fit its 228 KB). At D = 256 the 64 KB Q tile,
    two stages of 32 KB K and V tiles, 9 mbarriers and 1 KB of alignment
    (197,704 bytes, one block an SM); a float32 block (flash_tf32x3_kernel:
    128-row Q tiles, 64-key tiles in two stages; at D = 256 64-row tiles, one
    stage and the row statistics of two warps a row group) 229,376 bytes at
    D = 128 and 214,016 at D = 256; every block fits the H100's opt-in
    shared memory."""
    assert tflash.HEAD_DIMS == (32, 64, 128, 256)
    assert [tflash.key_tile(d) for d in tflash.HEAD_DIMS] == [64, 64, 128, 64]
    assert tflash.key_tile(256) == 64
    assert [tflash.kernel_name(d, torch.bfloat16) for d in tflash.HEAD_DIMS] == [
        "flash_mma_kernel", "flash_wgmma_kernel<64>", "flash_wgmma_kernel<128>",
        "flash_wgmma_kernel<256>"]
    assert [tflash.kernel_name(d, torch.float32) for d in tflash.HEAD_DIMS] == [
        f"flash_tf32x3_kernel<{d}>" for d in tflash.HEAD_DIMS]
    assert tflash.smem_bytes(64, torch.bfloat16) == 1024 + 16384 + 4 * 8192 + 8 * 9 == 50_248
    assert 2 * (tflash.smem_bytes(64, torch.bfloat16) + 1024) <= 228 * 1024
    assert tflash.smem_bytes(128, torch.bfloat16) == 1024 + 32768 * 7 + 8 * 13
    assert tflash.smem_bytes(256, torch.bfloat16) == 1024 + 65536 + 4 * 32768 + 8 * 9 \
        == 197_704
    assert tflash.smem_bytes(256, torch.float32) == 4 * (64 * 256 + 2 * 64 * 256 + 64 * 64
                                                          + 2 * 2 * 64) == 214_016
    assert tflash.smem_bytes(128, torch.float32) == 4 * (128 * 128 + 2 * 2 * 64 * 128 + 128 * 64) \
        == 229_376
    for d in tflash.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            assert tflash.smem_bytes(d, dtype) <= H100.vmem_bytes
    assert 2 * tflash.smem_bytes(256, torch.bfloat16) > H100.vmem_bytes   # one block an SM
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _attn_inputs(1, 2, 1, 200, 200, 128, seed=5))
    assert torch.equal(tflash.flash_attention_tiled(q, k, v),
                       tflash.flash_attention_tiled(q, k, v, bk=128))
    assert tflash.exp2_scale(128) == float(np.float32(np.float32(128 ** -0.5)
                                                      * np.float32(np.log2(np.e))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flaw", ["lost tail mask", "window one key too wide"])
def test_bf16_flash_check_catches_a_flawed_kernel(flaw):
    """chip_smoke.py's bfloat16 flash check passes a kernel whose only error
    is its output rounding, and fails a kernel with a small mask flaw."""
    smoke = _chip_smoke()
    tol = smoke.FLASH_BF16_TOL
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _attn_inputs(1, 4, 1, 1000, 1000, 128, seed=3))
    if flaw == "lost tail mask":
        # the 24 zero keys of the padded last tile join every row of a
        # 1000-key bidirectional pass, scaling the rows by ~1.5 %
        mask = dict(causal=False)
        pad = torch.zeros((1, 1, 24, 128), dtype=torch.bfloat16)
        flawed = tflash.flash_attention_tiled(q, torch.cat([k, pad], 2),
                                              torch.cat([v, pad], 2), **mask)
    else:
        mask = dict(causal=True, window=256)
        flawed = tflash.flash_attention_tiled(q, k, v, causal=True, window=257)
    want = tflash.flash_attention_tiled(q, k, v, **mask)
    assert smoke.within(want.to(torch.bfloat16), want, tol)[0]
    ok, _, _, rms_ratio = smoke.within(flawed.to(torch.bfloat16), want, tol)
    assert not ok and rms_ratio > 2 * tol[2]


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (64, 64, True, 16, 0),       # window shorter than the sequence: _blocked
    (40, 2500, True, 0, 2460),   # three KV chunks with a ragged tail
    (32, 1100, False, 0, 0),     # bidirectional over two chunks
])
def test_model_attention_cpu_operators_match_jax(sq, sk, causal, window, q_offset):
    """The model-level attention on the CPU (``_einsum`` / ``_blocked``, K/V
    in kv-head form, expanded inside) against the reference's, which takes
    K/V already expanded to all heads."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    want = JATT.attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                          jnp.repeat(jnp.asarray(v), 2, axis=2), causal=causal,
                          window=window, q_offset=q_offset)
    got = TATT.attention(*_t(q, k, v), causal=causal, window=window, q_offset=q_offset)
    direct = TATT._blocked(*_t(q, np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)),
                           causal, window, q_offset)
    _close(got, want)
    _close(direct, want)


# ---------------------------------------------------------------------------
# dispatch and the wrappers' checks
# ---------------------------------------------------------------------------


def test_ops_dispatch_on_cpu_takes_plain_version(monkeypatch):
    q, k, v = _t(*_attn_inputs(1, 4, 2, 16, 16, 32))
    pq, pk, pv, tables = _paged_case()
    posv = np.asarray([15, 5, 9], np.int32)
    paged_args = _t(pq, pk, pv, tables, posv)
    before = (tflash.flash_attention.launches, tpaged.paged_decode_attention.launches)
    for backend in ("auto", "torch"):
        monkeypatch.setattr(ops, "BACKEND", backend)
        _close(ops.attention(q, k, v), ref.attention_ref(q, k, v))
        _close(ops.paged_attention(*paged_args, page=4, sc=16),
               ref.paged_decode_ref(*paged_args, page=4, sc=16))
    assert (tflash.flash_attention.launches,
            tpaged.paged_decode_attention.launches) == before
    monkeypatch.setattr(ops, "BACKEND", "kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(*paged_args, page=4, sc=16)


def test_paged_wrapper_check_rejects_what_the_kernel_cannot_take():
    q, k, v, tables, posv = _t(*_paged_case(), np.asarray([15, 5, 9], np.int32))
    tpaged._check(q, k, v, tables, posv, 4, 16)          # the good case passes
    with pytest.raises(TypeError, match="int32"):
        tpaged._check(q, k, v, tables.long(), posv, 4, 16)
    with pytest.raises(TypeError, match="int32"):
        tpaged._check(q, k, v, tables, posv.long(), 4, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tpaged._check(q.double(), k.double(), v.double(), tables, posv, 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        tpaged._check(q, k.transpose(0, 1).contiguous().transpose(0, 1), v,
                      tables, posv, 4, 16)
    with pytest.raises(ValueError, match="exceeds"):
        tpaged._check(q, k, v, tables, posv, 4, 17)
    # recurrentgemma's g = 10, D = 256 (g * D = 2560) is taken
    wide_q, wide_k, *_ = _paged_case(hq=10, hkv=1, d=256)
    tpaged._check(*_t(wide_q, wide_k, wide_k), tables, posv, 4, 16)
    big = torch.zeros((3, 1, 32, 128))
    with pytest.raises(ValueError, match="g <= 16"):
        tpaged._check(big, torch.zeros((64, 1, 128)), torch.zeros((64, 1, 128)),
                      tables, posv, 4, 16)


def test_flash_wrapper_check_rejects_what_the_kernel_cannot_take():
    q, k, v = _t(*_attn_inputs(1, 4, 2, 16, 16, 32))
    tflash._check(q, k, v, 232_448)
    with pytest.raises(ValueError, match="head dims"):
        tflash._check(q[..., :24].contiguous(), k[..., :24].contiguous(),
                      v[..., :24].contiguous(), 232_448)
    with pytest.raises(ValueError, match="shared memory"):
        tflash._check(q, k, v, 1024)
    assert tflash.smem_bytes(128, torch.bfloat16) <= 232_448
    assert tflash.smem_bytes(128, torch.float32) <= 232_448
    with pytest.raises(TypeError, match="one dtype"):
        tflash._check(q, k.to(torch.bfloat16), v, 232_448)
    with pytest.raises(ValueError, match="contiguous"):
        tflash._check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 232_448)
