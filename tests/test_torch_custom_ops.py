"""PyTorch port, the kernels as ``torch.library`` custom ops
(``repro_torch/kernels/*.py``, ``kernels/_build.py``).

Each of the thirteen wrappers calls the custom op ``repro_torch::<name>``: on a
CPU tensor its CPU implementation is the kernel's plain version (held equal
here, element for element, to calling the plain version directly), on a
fake tensor its fake implementation gives the output's shape, dtype and
device only — on a fake ``cuda`` device too, in this CPU-only build — and
``make_fx`` records the op as one node. The CUDA implementations (the
launches) run on the card only (``chip_smoke.py``). Each kernel's
``work(...)`` (FLOPs and bytes, read by ``chip_smoke.py``'s bounds and by
the cost audit) is held to the counts ``chip_smoke.py`` wrote out before it
read ``work``, so phase 3's bounds print the same numbers; the training
forward ``flash_attention_train``, which came later, to the flash count plus
its float32 ``lse``; the one-row ``flash_decode`` to q.k and p.v over the
keys its row sees, with q and those K/V rows read once; the SSD and RG-LRU
training forwards to their serving counts plus the chunk states they
write, and their backward ops (the attention backward ``flash_attention_bwd``
too: five products of 2 D FLOPs per unmasked pair) to the counts their
modules state (each input read once, each gradient written once).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro_torch.analysis import plan_audit  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import conv2d_im2col as CONV  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import matmul as MM  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import rglru_scan as RG  # noqa: E402
from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.serve_loop import make_decode_step  # noqa: E402

torch.set_num_threads(2)


def _randn(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


def _paged_args(dtype=torch.float32):
    b, hq, hkv, d, page, sc = 3, 4, 2, 16, 4, 16
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(rng.permutation(b * 4).reshape(b, 4).astype(np.int32))
    return ((_randn(1, b, 1, hq, d, dtype=dtype), _randn(2, b * 4 * page, hkv, d, dtype=dtype),
             _randn(4, b * 4 * page, hkv, d, dtype=dtype), tables,
             torch.tensor([15, 5, 9], dtype=torch.int32)), dict(page=page, sc=sc))


def _ssd_args():
    b, s, h, p, n = 2, 32, 2, 16, 16
    dt = torch.nn.functional.softplus(_randn(5, b, s, h))
    return ((_randn(6, b, s, h, p), dt, -torch.rand(h, generator=torch.Generator().manual_seed(7)),
             _randn(8, b, s, n), _randn(9, b, s, n), torch.ones(h)), dict(chunk=16))


def _rglru_args():
    b, s, w = 2, 12, 8
    return ((*(_randn(10 + i, b, s, w) for i in range(4)),
             torch.rand(w, generator=torch.Generator().manual_seed(14)) * 0.1,
             torch.tensor([12, 5], dtype=torch.int32)), {})


def _ssd_bwd_args():
    (x, dt, a, bm, cm, d), kw = _ssd_args()
    _y, states = SSD.ssd_scan_train_torch(x, dt, a, bm, cm, d, **kw)
    return (x, dt, a, bm, cm, d, states, _randn(15, *x.shape)), kw


def _flash_bwd_args():
    q, k, v = _randn(34, 2, 4, 10, 32), _randn(35, 2, 2, 14, 32), _randn(36, 2, 2, 14, 32)
    mask = dict(causal=True, window=6, q_offset=-1)
    out, lse = FA.flash_attention_train_torch(q, k, v, **mask)
    return (q, k, v, out, lse, _randn(37, 2, 4, 10, 32)), mask


def _rglru_bwd_args():
    args = _rglru_args()[0][:5]
    _y, h_chunks = RG.rglru_scan_train_torch(*args)
    return (*args, h_chunks, _randn(16, *args[0].shape)), {}


# (op name, wrapper, plain version, args, kwargs)
CASES = [
    ("paged_decode_attention", PA.paged_decode_attention, PA.paged_attention_torch,
     *_paged_args()),
    ("flash_attention", FA.flash_attention, FA.flash_attention_torch,
     (_randn(20, 2, 4, 10, 32), _randn(21, 2, 2, 14, 32), _randn(22, 2, 2, 14, 32)),
     dict(causal=True, window=6, q_offset=-1)),
    ("flash_attention_train", FA.flash_attention_train, FA.flash_attention_train_torch,
     (_randn(23, 2, 4, 10, 32), _randn(24, 2, 2, 14, 32), _randn(25, 2, 2, 14, 32)),
     dict(causal=True, window=6, q_offset=-1)),
    ("flash_attention_bwd", FA.flash_attention_bwd, FA.attention_bwd_torch, *_flash_bwd_args()),
    ("flash_decode", FA.flash_decode, FA.flash_decode_torch,
     (_randn(26, 2, 4, 32), _randn(27, 2, 14, 2, 32), _randn(28, 2, 14, 2, 32)),
     dict(causal=True, window=6, q_offset=9)),
    ("ssd_scan", SSD.ssd_scan, SSD.ssd_scan_torch, *_ssd_args()),
    ("rglru_scan", RG.rglru_scan, RG.rglru_scan_torch, *_rglru_args()),
    ("ssd_scan_train", SSD.ssd_scan_train, SSD.ssd_scan_train_torch, *_ssd_args()),
    ("ssd_scan_bwd", SSD.ssd_scan_bwd, SSD.ssd_scan_bwd_torch, *_ssd_bwd_args()),
    ("rglru_scan_train", RG.rglru_scan_train, RG.rglru_scan_train_torch,
     _rglru_args()[0][:5], {}),
    ("rglru_scan_bwd", RG.rglru_scan_bwd, RG.rglru_scan_bwd_torch, *_rglru_bwd_args()),
    ("matmul", MM.matmul, MM.matmul_torch, (_randn(30, 7, 5), _randn(31, 5, 3)), {}),
    ("conv2d_im2col", CONV.conv2d_im2col, CONV.conv2d_torch,
     (_randn(32, 2, 3, 9, 9), _randn(33, 4, 3, 3, 3)), dict(stride=2, pad=1)),
]
IDS = [c[0] for c in CASES]


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


def test_every_wrapper_is_a_registered_custom_op_with_work():
    """Thirteen ops in the ``repro_torch`` namespace, each with a ``work``."""
    assert sorted(_build.WORK) == sorted(f"repro_torch::{n}" for n in IDS)
    for name in IDS:
        op = getattr(torch.ops.repro_torch, name).default
        assert op._schema.name == f"repro_torch::{name}"
        assert not op._schema.is_mutable        # every kernel writes only its outputs
    assert {fn.__name__ for fn in _build.COUNTED} >= set(IDS)


@pytest.mark.parametrize("name,wrapper,plain,args,kwargs", CASES, ids=IDS)
def test_cpu_implementation_is_the_plain_version(name, wrapper, plain, args, kwargs):
    """On a CPU tensor the op runs the plain version (bit for bit) and the
    wrapper's launch count does not move."""
    before = wrapper.launches
    got, want = wrapper(*args, **kwargs), plain(*args, **kwargs)
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert wrapper.launches == before


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("name,wrapper,plain,args,kwargs", CASES, ids=IDS)
def test_fake_implementation_matches_the_plain_version(device, name, wrapper, plain, args,
                                                       kwargs):
    """Under fake tensors the op gives the plain version's shape and dtype on
    the inputs' device, and ``make_fx`` records it as one node."""
    want = _leaves(plain(*args, **kwargs))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in args]
    got = _leaves(wrapper(*fake, **kwargs))
    for g, w in zip(got, want, strict=True):
        assert (tuple(g.shape), g.dtype, g.device.type) == (tuple(w.shape), w.dtype, device)
    gm = make_fx(lambda *a: wrapper(*a, **kwargs), tracing_mode="fake")(*fake)
    calls = [n for n in gm.graph.nodes if n.op == "call_function"
             and plan_audit.is_kernel(n)]
    assert [plan_audit.op_name(n) for n in calls] == [f"repro_torch::{name}"]


def test_fake_cuda_runs_no_kernel_and_counts_no_launch():
    """A fake ``cuda`` call reaches the fake implementation, not the launch:
    no library is built and no launch is counted."""
    args, kwargs = _paged_args(torch.bfloat16)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in args]
        before = PA.paged_decode_attention.launches
        out = PA.paged_decode_attention(*fake, **kwargs)
    assert out.device.type == "cuda" and PA.paged_decode_attention.launches == before
    assert not _build._LIBS


# each case's arguments in its op's order (positional, as the graph holds them)
OP_ARGS = {
    "paged_decode_attention": lambda a, k: (*a, k["page"], k["sc"]),
    "flash_attention": lambda a, k: (*a, k["causal"], k["window"], k["q_offset"]),
    "flash_attention_train": lambda a, k: (*a, k["causal"], k["window"], k["q_offset"]),
    "flash_attention_bwd": lambda a, k: (*a, k["causal"], k["window"], k["q_offset"]),
    "flash_decode": lambda a, k: (*a, k["causal"], k["window"], k["q_offset"]),
    "ssd_scan": lambda a, k: (*a, k["chunk"]),
    "rglru_scan": lambda a, k: (*a, None),
    "ssd_scan_train": lambda a, k: (*a, k["chunk"]),
    "ssd_scan_bwd": lambda a, k: (*a, k["chunk"]),
    "rglru_scan_train": lambda a, k: a,
    "rglru_scan_bwd": lambda a, k: a,
    "matmul": lambda a, k: a,
    "conv2d_im2col": lambda a, k: (*a, k["stride"], k["pad"]),
}


def _former_counts(name, op_args):
    """(FLOPs, bytes) as ``chip_smoke.py``'s phase 3 wrote them out beside
    each bound before it read them from ``work``."""
    if name == "paged_decode_attention":
        q, k, _v, tables, posv, _page, sc = op_args
        b, _, hq, d = q.shape
        hkv = k.shape[1]
        slots = sum(min(int(p) + 1, sc) for p in posv.tolist())
        item = q.element_size()
        return 4 * hq * d * slots, (slots * hkv * d * 2 * item + 2 * b * hq * d * item
                                    + tables.numel() * 4 + b * 4)
    if name == "flash_attention_train":
        flops, nbytes = _former_counts("flash_attention", op_args)
        q = op_args[0]
        return flops, nbytes + 4 * q.shape[0] * q.shape[1] * q.shape[2]
    if name == "flash_attention_bwd":
        flops, _ = _former_counts("flash_attention", (*op_args[:3], *op_args[6:]))
        q, k = op_args[:2]
        lse = op_args[4]
        # S, dP, dV, dK and dQ against flash's q.k and p.v; q, k, v, out and
        # dout read, dq, dk and dv written, lse read
        return flops // 2 * 5, (4 * (q.numel() + k.numel()) * q.element_size()
                                + lse.numel() * lse.element_size())
    if name == "flash_decode":
        q, k, _v, causal, window, q_offset = op_args
        b, hq, d = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        qpos = sk - 1 if q_offset < 0 else q_offset
        lo = max(0, qpos - window + 1) if window > 0 else 0
        keys = max(0, (min(sk, qpos + 1) if causal else sk) - lo)
        return 4 * d * keys * b * hq, (2 * q.numel() + 2 * b * hkv * keys * d) * q.element_size()
    if name == "ssd_scan_train":
        flops, nbytes = _former_counts("ssd_scan", op_args)
        x, b_mat, chunk = op_args[0], op_args[3], op_args[6]
        b, s, h, p = x.shape
        return flops, nbytes + 4 * b * h * (s // chunk) * p * b_mat.shape[-1]
    if name == "ssd_scan_bwd":
        x, dt, _a, b_mat, _c, _d, states, _dy, chunk = op_args
        b, s, h, p = x.shape
        n, nc, item = b_mat.shape[-1], s // chunk, x.element_size()
        # Gram pass; per (row, head, chunk) D, dx's intra product, A1^T C,
        # A1 B (c x c) and dS B, dS^T x, S^T dy, the dS update (c x P x N)
        flops = b * nc * 2 * chunk * chunk * n + b * h * nc * (
            2 * 2 * chunk * chunk * p + 2 * 2 * chunk * chunk * n + 4 * 2 * chunk * p * n)
        return flops, (3 * x.numel() * item + 2 * dt.numel() * 4
                       + 4 * b_mat.numel() * item + states.numel() * 4 + 4 * h * 4)
    if name == "rglru_scan_train":
        flops, nbytes = _former_counts("rglru_scan", op_args)
        b, s, w = op_args[0].shape
        return flops, nbytes + 4 * b * -(-s // RG.SCAN_CHUNK) * w
    if name == "rglru_scan_bwd":
        b, s, w = op_args[0].shape
        elems = b * s * w
        return 60 * elems, 9 * 2 * elems + 4 * op_args[5].numel() + 8 * w
    if name == "flash_attention":
        q, k, _v, causal, window, q_offset = op_args
        b, hq, sq, d = q.shape
        sk = k.shape[2]
        qpos = (sk - sq if q_offset < 0 else q_offset) + np.arange(sq)
        hi = np.minimum(sk - 1, qpos) if causal else np.full(sq, sk - 1)
        lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(sq, np.int64)
        pairs = int(np.maximum(0, hi - lo + 1).sum())
        return 4 * d * pairs * b * hq, (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if name == "ssd_scan":
        x, dt, _a, b_mat = op_args[:4]
        b, s, h, p = x.shape
        n = b_mat.shape[-1]
        chunk = min(op_args[6], s)      # phase 3 calls at the default, 64
        nc = s // chunk
        return (b * nc * 2 * chunk * chunk * n + b * h * nc * (2 * chunk * chunk * p
                                                              + 4 * chunk * n * p),
                2 * x.numel() * x.element_size() + dt.numel() * 4
                + 2 * b_mat.numel() * b_mat.element_size() + 2 * h * 4)
    if name == "rglru_scan":
        b, s, w = op_args[0].shape
        elems = b * s * w
        return 26 * elems, 5 * 2 * elems + 4 * w + 4 * b + 4 * b * w
    if name == "matmul":
        (m, k), n = op_args[0].shape, op_args[1].shape[1]
        return 2 * m * n * k, (m * k + k * n + m * n) * op_args[0].element_size()
    x, w, stride, pad = op_args
    out = CONV.conv2d_torch(x.float(), w.float(), stride=stride, pad=pad)
    n, f, ho, wo = out.shape
    c, k = w.shape[1], w.shape[2]
    return 2 * n * ho * wo * f * c * k * k, (x.numel() + w.numel() + out.numel()) * x.element_size()


@pytest.mark.parametrize("name,wrapper,plain,args,kwargs", CASES, ids=IDS)
def test_work_equals_the_counts_chip_smoke_used(name, wrapper, plain, args, kwargs):
    """``work`` on the op's own arguments gives the FLOPs and bytes
    ``chip_smoke.py``'s bounds used before, on bfloat16 inputs as phase 3
    times them (the paged count over the committed slots it passes), so its
    bounds print the same numbers."""
    bf16 = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in args)
    op_args = OP_ARGS[name](bf16, kwargs)
    extra = {}
    if name == "paged_decode_attention":
        extra["slots"] = sum(min(int(p) + 1, kwargs["sc"]) for p in bf16[4].tolist())
    got = _build.WORK[f"repro_torch::{name}"](*op_args, **extra)
    assert tuple(got) == _former_counts(name, op_args)


# the backward ops' arguments and gradients in the model dtype (the rest float32)
MODEL_DTYPE_ARGS = {"ssd_scan_bwd": (0, 3, 4, 7), "rglru_scan_bwd": (0, 1, 2, 3, 6),
                    "flash_attention_bwd": (0, 1, 2, 3, 5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(MODEL_DTYPE_ARGS))
def test_backward_work_moves_each_input_and_output_once(name, dtype):
    """A backward kernel's byte count, which its bound comes from, is its
    arguments read once and its gradients written once, counted here from
    the tensors the CPU op takes and returns."""
    _n, wrapper, _p, args, kwargs = CASES[IDS.index(name)]
    args = tuple(t.to(dtype) if i in MODEL_DTYPE_ARGS[name] else t for i, t in enumerate(args))
    out = wrapper(*args, **kwargs)
    moved = sum(t.nbytes for t in (*args, *out))
    assert _build.WORK[f"repro_torch::{name}"](*OP_ARGS[name](args, kwargs)).bytes == moved


def test_full_width_yi_decode_step_holds_32_paged_kernel_nodes():
    """``make_fx`` of a full-width Yi-6B decode step (32 layers, bfloat16,
    the (8, 2048) bucket, page 64) on fake ``cuda`` tensors: one
    ``repro_torch::paged_decode_attention`` node per attention layer, and
    no weight allocated."""
    model = build_model(get_config("yi-6b"), dtype=torch.bfloat16)
    args = plan_audit.step_inputs(model, "decode", 8, 2048, device="cuda")
    trace = plan_audit.trace_step(
        make_decode_step(model, page=64, seq_len=2048, decode_kernel="paged"), args)
    assert plan_audit.kernel_counts(trace.gm) == {"repro_torch::paged_decode_attention": 32}
    assert all(t.device.type == "cuda" for t in plan_audit.tensors(args))
