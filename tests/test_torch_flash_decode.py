"""PyTorch port, the one-row attention op ``repro_torch::flash_decode``
(``kernels/flash_attention.py``) and its route (``models/attention.py``):
one query row a batch row against K/V in the model's ``(B, Sk, Hkv, D)``
layout, read in place.

- The op's plain version, which is its CPU implementation, against the
  reference's ``repro.models.attention.attention`` (its CPU operator
  ``_einsum``; the reference takes K/V expanded to the query heads) and
  ``repro.kernels.ref.attention_ref``, on inputs made with numpy from a
  seed: g in {1, 2, 4}, ragged Sk, causal, window and ``q_offset``.
  float32 at ``atol = rtol = 1e-5`` (sums in another order); bfloat16 on
  the same bfloat16 inputs at ``BF16_TOL``: each package computes in
  float32 and rounds its output once to bfloat16, so the two may differ by
  one bfloat16 ulp (2^-7 of the value).
- ``attention`` at one query row equals the reference's on the CPU, and on
  fake ``cuda`` tensors it records one ``flash_decode`` node over the K/V
  as they are: no transpose, no copy.
- ``make_fx`` of a full-width Whisper-medium decode step (the (8, 448)
  bucket, page 64, bfloat16) on fake ``cuda`` tensors: one
  ``flash_decode`` node per decoder layer, no ``flash_attention`` node and
  no allocation the size of a layer's cross K or V.

The CUDA kernel itself runs on the card only (``chip_smoke.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.kernels import ref as JREF  # noqa: E402
from repro.models import attention as JATT  # noqa: E402
from repro_torch.analysis import plan_audit  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_loop import make_decode_step  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)

CASES = [  # b, hq, hkv, sk, d, causal, window, q_offset
    (2, 4, 4, 37, 32, False, 0, -1),        # g = 1, bidirectional, ragged
    (2, 4, 4, 130, 64, False, 0, -1),       # g = 1 past one 128-key split
    (2, 4, 2, 300, 32, True, 0, -1),        # g = 2, causal at the last key
    (1, 8, 2, 300, 64, True, 0, 100),       # g = 4, causal inside the first split
    (2, 8, 2, 300, 32, True, 48, 200),      # g = 4, a window ending at q_offset
    (2, 4, 2, 1, 64, False, 0, -1),         # one key
    (1, 4, 1, 260, 32, False, 64, -1),      # g = 4, a window over the last 64 keys
]


def _inputs(b, hq, hkv, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, 1, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _qpos(sk, q_offset):
    return sk - 1 if q_offset < 0 else q_offset


def _to(arr, dtype):
    return torch.from_numpy(arr).to(dtype)


def _jnp(arr, dtype):
    return jnp.asarray(arr, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sk,d,causal,window,q_offset", CASES)
def test_plain_version_matches_the_reference(b, hq, hkv, sk, d, causal, window, q_offset,
                                             dtype):
    """The op on a CPU tensor (its plain version) against the reference's
    ``attention`` (K/V expanded to the query heads, as its callers hand
    them) and ``attention_ref`` (kv-head form)."""
    q, k, v = _inputs(b, hq, hkv, sk, d, seed=sk + hq)
    got = FA.flash_decode(_to(q[:, 0], dtype), _to(k, dtype), _to(v, dtype), causal=causal,
                          window=window, q_offset=q_offset)
    assert got.shape == (b, hq, d) and got.dtype == dtype
    g = hq // hkv
    pos = _qpos(sk, q_offset)
    want = JATT.attention(_jnp(q, dtype), _jnp(np.repeat(k, g, axis=2), dtype),
                          _jnp(np.repeat(v, g, axis=2), dtype), causal=causal, window=window,
                          q_offset=pos)
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32)[:, 0], **tol)
    want_ref = JREF.attention_ref(_jnp(q.transpose(0, 2, 1, 3), dtype),
                                  _jnp(k.transpose(0, 2, 1, 3), dtype),
                                  _jnp(v.transpose(0, 2, 1, 3), dtype), causal=causal,
                                  window=window, q_offset=pos)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want_ref, np.float32)[:, :, 0],
                               **tol)


def test_rows_that_see_no_key_give_zeros():
    """A window that ends before the first key (q_offset past every key by
    more than the window) leaves the row nothing: zeros, as the flash
    kernels give."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 2, 20, 32, seed=5))
    got = FA.flash_decode(q[:, 0], k, v, causal=True, window=4, q_offset=40)
    assert FA.decode_range(20, True, 4, 40) == (37, 37)
    assert torch.equal(got, torch.zeros_like(got))


def test_decode_range_and_work_count_the_keys_a_row_sees():
    """``[lo, hi)`` of the causal and window masks at one query row, the
    splits over it, and ``work``: q.k and p.v over those keys for every
    query head, q and those K/V rows read once, the output written once."""
    assert FA.decode_range(1500, False, 0, -1) == (0, 1500)
    assert FA.decode_range(1500, True, 0, 700) == (0, 701)
    assert FA.decode_range(1500, True, 100, 700) == (601, 701)
    assert FA.decode_range(1500, False, 64, -1) == (1436, 1500)
    # Whisper's 8 rows x 16 kv heads on 132 SMs: four splits of 375 keys
    # (512 blocks, one wave of four an SM); one row: 24 splits of 63 keys
    assert FA.decode_splits(0, 1500, 128, 132) == (4, 375)
    assert FA.decode_splits(0, 1500, 16, 132) == (24, 63)
    assert [FA.decode_splits(0, n, 128, 132) for n in (0, 1, 64, 65)] == [
        (1, 1), (1, 1), (1, 64), (2, 33)]
    q = torch.empty((8, 16, 64), dtype=torch.bfloat16)
    k = torch.empty((8, 1500, 16, 64), dtype=torch.bfloat16)
    work = FA.work_decode(q, k, k, False, 0, -1)
    assert work.flops == 4 * 64 * 1500 * 8 * 16
    assert work.bytes == 2 * (2 * 8 * 16 * 64 + 2 * 8 * 1500 * 16 * 64)   # 49.2 MB
    assert FA.work_decode(q, k, k, True, 100, 700).flops == 4 * 64 * 100 * 8 * 16


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 5)])
def test_attention_at_one_row_matches_the_reference(causal, q_offset):
    """``models/attention.py::attention`` at one query row on the CPU
    against the reference's, g = 2."""
    q, k, v = _inputs(2, 4, 2, 70, 32, seed=9)
    got = ATT.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                        q_offset=q_offset)
    want = JATT.attention(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=2)),
                          jnp.asarray(np.repeat(v, 2, axis=2)), causal=causal,
                          q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    off = ops.attention_decode(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(off.numpy(), np.asarray(want)[:, 0], **TOL)


def _allocating_calls(gm, numel: int):
    """The call nodes of ``gm`` that allocate a tensor of at least ``numel``
    elements (views, in-place writes and tuple elements allocate nothing)."""
    out = []
    for n in gm.graph.nodes:
        if n.op != "call_function" or plan_audit.aliases_input(n):
            continue
        sizes = [t.numel() for t in plan_audit.tensors(n.meta.get("val"))]
        if sizes and max(sizes) >= numel:
            out.append(plan_audit.op_name(n))
    return out


def test_one_row_call_on_cuda_reads_kv_in_place():
    """On fake ``cuda`` tensors a one-row ``attention`` call is one
    ``flash_decode`` node over K/V as they are; a two-row call still takes
    ``flash_attention``, through transposed copies."""
    b, sk, h, d = 2, 300, 4, 64
    with FakeTensorMode():
        k = torch.empty((b, sk, h, d), dtype=torch.bfloat16, device="cuda")
        v = torch.empty_like(k)
        q1 = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device="cuda")
        q2 = torch.empty((b, 2, h, d), dtype=torch.bfloat16, device="cuda")
    def call(q, k, v):
        return ATT.attention(q, k, v, causal=False)

    one = plan_audit.trace_step(call, [q1, k, v]).gm
    assert plan_audit.kernel_counts(one) == {"repro_torch::flash_decode": 1}
    assert _allocating_calls(one, b * sk * h * d) == []
    two = plan_audit.trace_step(call, [q2, k, v]).gm
    assert plan_audit.kernel_counts(two) == {"repro_torch::flash_attention": 1}
    assert len(_allocating_calls(two, b * sk * h * d)) == 2       # k and v transposed


def test_full_width_whisper_decode_step_reads_the_cross_cache_in_place():
    """``make_fx`` of a full-width Whisper-medium decode step (24 decoder
    layers, bfloat16, the (8, 448) bucket, page 64) on fake ``cuda``
    tensors: one ``repro_torch::paged_decode_attention`` (self-attention)
    and one ``repro_torch::flash_decode`` (the cross read) node per layer,
    no ``flash_attention`` node, and no node that allocates a tensor the
    size of one layer's cross K or V (8 x 1500 x 16 x 64)."""
    cfg = get_config("whisper-medium")
    model = build_model(cfg, dtype=torch.bfloat16)
    args = plan_audit.step_inputs(model, "decode", 8, 448, device="cuda")
    trace = plan_audit.trace_step(
        make_decode_step(model, page=64, seq_len=448, decode_kernel="paged"), args)
    assert plan_audit.kernel_counts(trace.gm) == {
        "repro_torch::paged_decode_attention": cfg.num_layers,
        "repro_torch::flash_decode": cfg.num_layers}
    cross = 8 * cfg.encoder_seq * cfg.num_kv_heads * cfg.head_dim
    assert args[1]["x.k"].shape[1:] == (8, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    assert _allocating_calls(trace.gm, cross) == []
