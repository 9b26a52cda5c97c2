"""PyTorch port, hybrid family: recurrentgemma's RG-LRU and windowed local
attention through both packages on the same weights (the reference's
``init_params``, converted by ``repro_torch.interop``) and the same seeded
numpy inputs, from the RG-LRU gates up to ``PlanServer.handle`` and the
serving engine.

Configurations: ``recurrentgemma-2b-smoke`` (pattern ``rr``: no attention
layer, the attention stack has zero layers), and its widths with the
patterns ``rra`` (3 layers) and ``ra`` (2 layers), window 32, prompts longer
than the window; ``window_size=8`` for the rotating wrap across pages.

Tolerances:

- float32 RG-LRU gates, block outputs and handed-off state:
  ``rtol = 1e-5`` (the reference's ``associative_scan`` associates the
  recurrence differently from the sequential loop), ``atol = 1e-5``;
- float32 whole-model logits and caches: ``atol = rtol = 1e-4`` (several
  layers of matmuls summed in another order); greedy token streams must be
  identical;
- bfloat16 gates: as float32 (both packages round each bf16 projection
  once from a float32 sum, and the gates are float32 from there);
- bfloat16 block outputs and logits within ``3e-2`` (as the SSM slice's):
  the packages round their other bf16 intermediates at their own places;
- the scan's plain version against a float64 sequential oracle on the same
  float32 gates: ``rtol = 1e-5`` and ``atol = 1e-6`` of the state's peak,
  under normal, strong (a ~ 0) and weak (a ~ 1) decay; the same for its
  version in the kernel's chunked order, at chunk lengths 1, 16, 64 and S.
"""

import io
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.engine import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.kv_cache import KVCachePool as JaxPool  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as TRG  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime.engine import ServingEngine, VirtualClock  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.kv_cache import KVCachePool  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402
from test_torch_engine import (LIFECYCLE, Side, _private_tables,  # noqa: E402
                               assert_equal_runs, first_new, first_new_pair)

torch.set_num_threads(2)
ARCH = "recurrentgemma-2b-smoke"
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
COUNTERS = ("pages_leased", "pages_freed", "pages_denied", "rows_leased",
            "rows_reused", "handoff_writes", "arenas_created", "arenas_reused",
            "pages_reclaimed", "peak_pages")
# weight scale of the serving tests: varied greedy streams from the
# all-ones prompts of PlanServer's prompt pass
SERVE_SCALE = 4.0
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _reference_tables_not_aliased():
    """The reference's ``CacheArena.tables`` may alias its numpy page table
    on the CPU (``tests/test_torch_serve.py``): a private copy at upload."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
        yield


def _cfgs(pattern: str = "rr", window: int = 0):
    """(reference config, port config) of the smoke widths with ``pattern``
    as many layers as it has letters, and the window (0: the smoke's 32)."""
    kw = dict(block_pattern=pattern, num_layers=len(pattern))
    if window:
        kw["window_size"] = window
    return jax_config(ARCH).replace(**kw), get_config(ARCH).replace(**kw)


def _models(pattern: str = "rr", dtype_name: str = "float32", window: int = 0):
    """(jax model, jax params, torch model, torch params), built once."""
    key = (pattern, dtype_name, window)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(pattern, window)
        jdt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
        tdt = torch.float32 if dtype_name == "float32" else torch.bfloat16
        jm = jax_build(jcfg, dtype=jdt)
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = build_model(tcfg, dtype=tdt)
        tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tdt, "cpu")
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _prompts(lengths, seed=1):
    rng = np.random.default_rng(seed)
    vocab = jax_config(ARCH).vocab_size
    return (rng.integers(0, vocab, (len(lengths), max(lengths))).astype(np.int32),
            np.asarray(lengths, np.int32))


def _rlayer0(jp, tp):
    return ({k[2:]: v[0] for k, v in jp.items() if k.startswith("r.")},
            {k[2:]: v[0] for k, v in tp.items() if k.startswith("r.")})


def _dtypes(name):
    return (jnp.float32, torch.float32) if name == "float32" else (jnp.bfloat16,
                                                                  torch.bfloat16)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_gates_match_reference(dtype):
    _jm, jp, _tm, tp = _models("rr", dtype)
    jl, tl = _rlayer0(jp, tp)
    jdt, tdt = _dtypes(dtype)
    w = get_config(ARCH).lru_width
    xb = np.random.default_rng(3).normal(size=(2, 24, w)).astype(np.float32)
    ja, jg = JB._lru_gates(jl, jnp.asarray(xb, jdt))
    ta, tg = TB._lru_gates(tl, torch.from_numpy(xb).to(tdt))
    assert ta.dtype == tg.dtype == torch.float32
    np.testing.assert_allclose(_f32(ta), _f32(ja), **BLOCK_TOL)
    np.testing.assert_allclose(_f32(tg), _f32(jg), **BLOCK_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_apply_and_decode_match_reference(dtype):
    """One RG-LRU block at mixed prompt lengths: its output, the state it
    hands off (``h`` at each row's own ``lengths - 1``, the raw conv tail)
    and three decode steps from that state, each updating the cache in
    place."""
    _jm, jp, tm, tp = _models("rr", dtype)
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jl, tl = _rlayer0(jp, tp)
    jdt, tdt = _dtypes(dtype)
    tol = BLOCK_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 40, cfg.d_model)).astype(np.float32)
    lens = np.asarray([40, 5, 23], np.int32)
    japply = jax.jit(lambda p, x, n: JB.rglru_block_apply(jcfg, p, x, lengths=n,
                                                           want_cache=True))
    jdecode = jax.jit(lambda p, x, c: JB.rglru_block_decode(jcfg, p, x, c, None))
    jout, _, jc = japply(jl, jnp.asarray(x, jdt), jnp.asarray(lens))
    tout, tc = TB.rglru_block_apply(cfg, tl, torch.from_numpy(x).to(tdt),
                                    lengths=torch.from_numpy(lens), want_cache=True)
    assert tout.dtype == tdt
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    assert set(tc) == set(jc) == {"h", "conv"}
    assert tc["h"].dtype == torch.float32 and tc["conv"].dtype == tdt
    for k in jc:
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **tol)
    assert torch.equal(TB.rglru_block_apply(cfg, tl, torch.from_numpy(x).to(tdt)), tout)
    held = {k: v.data_ptr() for k, v in tc.items()}
    for _ in range(3):
        xs = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jdecode(jl, jnp.asarray(xs, jdt), jc)
        to = TB.rglru_block_decode(cfg, tl, torch.from_numpy(xs).to(tdt), tc)
        np.testing.assert_allclose(_f32(to), _f32(jo), **tol)
        for k in jc:
            np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **tol)
    assert {k: v.data_ptr() for k, v in tc.items()} == held


def _scan_inputs(decay: str, b=3, s=64, w=48, seed=4):
    rng = np.random.default_rng(seed)
    xb, r_pre, i_pre, y_pre = (rng.normal(size=(b, s, w)).astype(np.float32)
                               for _ in range(4))
    a_log = {"normal": np.log1p(15 * rng.uniform(size=w)),    # the "ssm_a" init
             "strong": np.full(w, 10.0),                      # a = exp(-80 r)
             "weak": np.full(w, -30.0)}[decay]                # a = 1 in float32
    if decay == "strong":
        r_pre = np.abs(r_pre) + 3.0                           # r > 0.95: a < 1e-33
    c = TB._lru_decay({"a_log": torch.from_numpy(a_log.astype(np.float32))})
    return [torch.from_numpy(v) for v in (xb, r_pre, i_pre, y_pre)] + [c]


def _oracle64(xb, r_pre, i_pre, y_pre, c, decay):
    """(hseq, y) of a float64 sequential loop over the float32 gates."""
    a, gate = TRG.lru_gates_torch(r_pre, i_pre, c)
    if decay == "strong":
        assert float(a.max()) < 1e-30
    if decay == "weak":
        assert bool((a == 1.0).all())
    a64, bt64 = a.double(), (gate * xb.float()).double()
    yb64 = torch.nn.functional.gelu(y_pre.float(), approximate="tanh").double()
    h = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float64)
    hseq = []
    for t in range(a.shape[1]):
        h = a64[:, t] * h + bt64[:, t]
        hseq.append(h)
    hseq = torch.stack(hseq, 1)
    return hseq, hseq * yb64


@pytest.mark.parametrize("decay", ["normal", "strong", "weak"])
def test_scan_plain_version_matches_float64_oracle(decay):
    """The plain version's float32 recurrence against a float64 sequential
    loop over the same float32 gates, y unrounded and the state at each
    row's ``lengths - 1`` (clamped: a 0 and an over-long length)."""
    xb, r_pre, i_pre, y_pre, c = _scan_inputs(decay)
    lengths = torch.tensor([64, 0, 200], dtype=torch.int32)
    y, h_last = TRG.rglru_scan_torch(xb, r_pre, i_pre, y_pre, c, lengths,
                                     out_dtype=torch.float32)
    hseq, want_y = _oracle64(xb, r_pre, i_pre, y_pre, c, decay)
    atol = 1e-6 * float(hseq.abs().max())
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-5, atol=atol)
    want_last = hseq[torch.arange(3), torch.tensor([63, 0, 63])]
    np.testing.assert_allclose(h_last.numpy(), want_last.numpy(), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("chunk", [1, 8, 16, 64, 100])
@pytest.mark.parametrize("decay", ["normal", "strong", "weak"])
def test_chunked_scan_matches_float64_oracle(decay, chunk):
    """The plain version in the kernel's chunked order (the kernel's chunk
    is 8) against the float64 sequential loop: S = 100 (not a multiple of
    8, 16 or 64; 100 is one chunk),
    each row's state at ``lengths - 1`` for lengths 0, 1, at a chunk's last
    position (16, 64), at a chunk's first (17, 65) and past S."""
    xb, r_pre, i_pre, y_pre, c = _scan_inputs(decay, b=7, s=100)
    lengths = torch.tensor([0, 1, 16, 17, 64, 65, 300], dtype=torch.int32)
    y, h_last = TRG.rglru_scan_chunked_torch(xb, r_pre, i_pre, y_pre, c, lengths,
                                             out_dtype=torch.float32, chunk=chunk)
    hseq, want_y = _oracle64(xb, r_pre, i_pre, y_pre, c, decay)
    atol = 1e-6 * float(hseq.abs().max())
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-5, atol=atol)
    want_last = hseq[torch.arange(7), torch.tensor([0, 0, 15, 16, 63, 64, 99])]
    np.testing.assert_allclose(h_last.numpy(), want_last.numpy(), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype,chunk", [("float32", 8), ("float32", 7), ("bfloat16", 8)])
def test_chunked_scan_in_the_block_matches_reference(monkeypatch, dtype, chunk):
    """One RG-LRU block with its recurrence run in the kernel's chunked
    order, against the reference's ``rglru_block_apply`` (its
    ``lax.associative_scan``) on the interop weights: the output and the
    state handed off at each row's ``lengths - 1`` (positions 39, 4 and
    22: in the last, the first and a middle chunk)."""
    _jm, jp, _tm, tp = _models("rr", dtype)
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jl, tl = _rlayer0(jp, tp)
    jdt, tdt = _dtypes(dtype)
    tol = BLOCK_TOL if dtype == "float32" else BF16_TOL
    monkeypatch.setattr(ops, "rglru", lambda *args: TRG.rglru_scan_chunked_torch(
        *args, chunk=chunk))
    x = np.random.default_rng(2).normal(size=(3, 40, cfg.d_model)).astype(np.float32)
    lens = np.asarray([40, 5, 23], np.int32)
    jout, _, jc = JB.rglru_block_apply(jcfg, jl, jnp.asarray(x, jdt), lengths=jnp.asarray(lens),
                                       want_cache=True)
    tout, tc = TB.rglru_block_apply(cfg, tl, torch.from_numpy(x).to(tdt),
                                    lengths=torch.from_numpy(lens), want_cache=True)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    np.testing.assert_allclose(_f32(tc["h"]), _f32(jc["h"]), **tol)


# (B, S) of the prompt passes chip_smoke.py drives at W = 2560: phase 3's
# kernel cases, phase 10's buckets (and phase 4's engine trace, (8, 256)),
# phase 11's buckets; the chunks a block takes, planned for 132 SMs
PLANNED_CHUNKS = {(8, 2048): 16, (1, 4096): 32, (2, 512): 32, (3, 1001): 32,
                  (8, 256): 16, (1, 128): 16, (1, 1024): 32, (4, 2048): 32}


@pytest.mark.parametrize("b,s", sorted(PLANNED_CHUNKS))
def test_chunk_plan_for_the_smoke_phases(b, s):
    """``chunk_plan`` at the shapes the card runs: chunks of the kernel's
    ``SCAN_CHUNK`` positions, a power of two of them a block, at most
    ``SCAN_MAX_CHUNKS``; at least ``SCAN_THREADS_PER_SM`` threads an SM
    where that many chunks fit in S, and one tile of chunks no longer than
    twice S. chip_smoke.py's float32 case has an S that is a multiple of
    neither the chunk nor a tile."""
    w, sms = 2560, 132
    chunk, chunks = TRG.chunk_plan(b, s, w, sms)
    assert chunk == TRG.SCAN_CHUNK == 8
    assert chunks == PLANNED_CHUNKS[(b, s)]
    assert chunks & (chunks - 1) == 0 and 1 <= chunks <= TRG.SCAN_MAX_CHUNKS
    threads = b * w * chunks
    assert (threads >= TRG.SCAN_THREADS_PER_SM * sms or chunks == TRG.SCAN_MAX_CHUNKS
            or chunks * chunk >= s)
    assert chunks * chunk < 2 * s
    assert 1001 % chunk and 1001 % (chunk * PLANNED_CHUNKS[(3, 1001)])
    assert TRG.chunk_plan(1, 10, 16, sms) == (8, 2)      # one tile covers S
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flaw", ["exact gelu", "state one step late",
                                  "carry dropped at one chunk boundary"])
def test_bf16_scan_check_catches_a_flawed_kernel(flaw):
    """chip_smoke.py's bfloat16 check of the scan kernel (y against the
    plain version's unrounded float32 y) passes a kernel whose only error
    is y's rounding, and fails one with the erf gelu in place of the tanh
    one, with y formed from the state one position late, or with the
    chunks after position 128 started from h = 0 (the carry into one chunk
    lost)."""
    smoke = _chip_smoke()
    xb, r_pre, i_pre, y_pre, c = _scan_inputs("normal", b=2, s=256, w=64)
    args = [t.to(torch.bfloat16) for t in (xb, r_pre, i_pre, y_pre)] + [c]
    want, _ = TRG.rglru_scan_torch(*args, out_dtype=torch.float32)
    good, _ = TRG.rglru_scan_torch(*args)
    assert smoke.within(good, want, smoke.RGLRU_BF16_TOL)[0]
    a, gate = TRG.lru_gates_torch(args[1], args[2], c)
    bt = gate * args[0].float()
    h, hseq = torch.zeros(2, 64), []
    for t in range(256):
        h = a[:, t] * h + bt[:, t]
        hseq.append(h)
    hseq = torch.stack(hseq, 1)
    if flaw == "exact gelu":
        flawed = hseq * torch.nn.functional.gelu(args[3].float())
    elif flaw == "carry dropped at one chunk boundary":
        head, tail = ([t[:, :128] for t in args[:4]] + [c], [t[:, 128:] for t in args[:4]] + [c])
        flawed = torch.cat([TRG.rglru_scan_chunked_torch(*part, chunk=8)[0]
                            for part in (head, tail)], 1)
        assert smoke.within(TRG.rglru_scan_chunked_torch(*args, chunk=8)[0], want,
                            smoke.RGLRU_BF16_TOL)[0]
    else:
        late = torch.cat([torch.zeros(2, 1, 64), hseq[:, :-1]], 1)
        flawed = late * torch.nn.functional.gelu(args[3].float(), approximate="tanh")
    assert not smoke.within(flawed.to(torch.bfloat16), want, smoke.RGLRU_BF16_TOL)[0]


def test_scan_wrapper_dispatch_and_checks(monkeypatch):
    """On the CPU the wrapper and ``ops.rglru`` run the plain version and
    launch nothing; ``ops.BACKEND='kernel'`` raises for a CPU tensor; the
    wrapper's checks raise on what the kernel does not take."""
    xb, r_pre, i_pre, y_pre, c = _scan_inputs("normal", b=2, s=8, w=16)
    lengths = torch.tensor([8, 3], dtype=torch.int32)
    before = TRG.rglru_scan.launches
    want = TRG.rglru_scan_torch(xb, r_pre, i_pre, y_pre, c, lengths)
    for got in (TRG.rglru_scan(xb, r_pre, i_pre, y_pre, c, lengths),
                ops.rglru(xb, r_pre, i_pre, y_pre, c, lengths)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TRG.rglru_scan.launches == before
    monkeypatch.setattr(ops, "BACKEND", "kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru(xb, r_pre, i_pre, y_pre, c, lengths)
    TRG._check(xb, r_pre, i_pre, y_pre, c, lengths)
    with pytest.raises(ValueError, match="must match xb"):
        TRG._check(xb, r_pre.to(torch.bfloat16), i_pre, y_pre, c, lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TRG._check(*(t.double() for t in (xb, r_pre, i_pre, y_pre)), c, lengths)
    with pytest.raises(ValueError, match="c must be"):
        TRG._check(xb, r_pre, i_pre, y_pre, c[:4], lengths)
    with pytest.raises(ValueError, match="lengths must be"):
        TRG._check(xb, r_pre, i_pre, y_pre, c, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        t = xb.transpose(1, 2).contiguous().transpose(1, 2)
        TRG._check(t, r_pre, i_pre, y_pre, c, lengths)
    for chunks in (0, TRG.SCAN_MAX_CHUNKS + 1):
        with pytest.raises(ValueError, match=f"chunks={chunks}"):
            TRG._check(xb, r_pre, i_pre, y_pre, c, lengths, chunks)


# ---------------------------------------------------------------------------
# the model: apply, prefill + handoff, decode
# ---------------------------------------------------------------------------


def test_weights_carry_through_interop():
    """``Model.init_params(PRNGKey)`` of the reference, converted: the
    port's own spec (keys, shapes, dtypes, both stacks of ``rra``) and the
    same values."""
    for dtype in ("float32", "bfloat16"):
        _jm, jp, tm, tp = _models("rra", dtype)
        assert list(tp) == list(tm.sb.shapes()) == list(jp)
        for k, (shape, dt) in tm.sb.shapes().items():
            assert tuple(tp[k].shape) == shape == tuple(jp[k].shape) and tp[k].dtype == dt
            np.testing.assert_array_equal(_f32(tp[k]), _f32(jp[k]))
        assert [k for k, _p, _i in tm.layers()] == list("rra")


@pytest.mark.parametrize("pattern,lengths", [("rra", [45, 38, 20]), ("rr", [40, 17, 32]),
                                             ("rra", [64, 1, 50])])
def test_prefill_logits_and_cache_match_reference(pattern, lengths):
    """Prefill at mixed lengths, prompts past the window of 32: last logits
    and every handed-off entry (attention K/V in their rotated slots, the
    RG-LRU state and conv tails; the ``rr`` pattern's zero-layer attention
    entries), then the full-sequence logits of ``apply``."""
    jm, jp, tm, tp = _models(pattern)
    toks, lens = _prompts(lengths)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=96)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=96)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    assert list(tc) == list(jc) == list(tm.cache_entries(len(lengths), 96))
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape)
        assert tc[k].dtype == tm.cache_entries(len(lengths), 96)[k][2]
        np.testing.assert_allclose(_f32(tc[k]), _f32(jc[k]), **TOL)
    jfull, _ = jm.apply(jp, jnp.asarray(toks))
    tfull, aux = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(_f32(tfull), _f32(jfull), **TOL)
    assert float(aux) == 0.0


def test_bf16_prefill_logits_within_tolerance():
    jm, jp, tm, tp = _models("rra", "bfloat16")
    toks, lens = _prompts([45, 38, 20])
    jl, _ = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens))
    assert tl.dtype == torch.bfloat16 and tc["r.h"].dtype == torch.float32
    assert np.isfinite(_f32(tl)).all()
    np.testing.assert_allclose(_f32(tl), _f32(jl), **BF16_TOL)


def test_decode_steps_match_reference_and_a_longer_prefill():
    """Four dense decode steps after the handoff equal the reference's
    (logits and greedy tokens); each step's logits equal the last logits of
    a prefill one token longer, past the window (positions 45 -> 49 with a
    window of 32)."""
    jm, jp, tm, tp = _models("rra")
    toks, lens = _prompts([45, 38, 20])
    ext = np.concatenate([toks, np.zeros((3, 8), np.int32)], axis=1)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=64)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                        cache_len=64)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    jstep = jax.jit(jm.decode_step)
    for i in range(4):
        ext[np.arange(3), lens + i] = tt[:, 0].numpy()
        jlg, jc = jstep(jp, jc, jt, jnp.asarray(lens + i))
        tlg, tc = tm.decode_step(tp, tc, tt, torch.from_numpy(lens + i))
        np.testing.assert_allclose(_f32(tlg), _f32(jlg), **TOL)
        longer, _ = tm.prefill(tp, torch.from_numpy(ext), lengths=torch.from_numpy(lens + i + 1))
        np.testing.assert_allclose(_f32(tlg[:, -1]), _f32(longer), **TOL)
        jt = jnp.argmax(jlg[:, -1:], -1).astype(jnp.int32)
        tt = torch.argmax(tlg[:, -1:], -1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("window,lengths,seq,page,steps", [
    (0, [12, 9], 64, 16, 4),       # prompts inside the window (tests/test_paging.py)
    (0, [45, 38], 64, 16, 3),      # prompts longer than the window: pre-rotated pages
    (8, [5, 3], 32, 4, 12),        # window 8 wraps across pages of 4 slots
])
def test_paged_decode_equals_dense_and_reference(window, lengths, seq, page, steps):
    """The reference's paged cases on pattern ``ra``: the same handoff
    written into a paged arena and decoded under each paged read (paged,
    gather, ref; each in its own arena, updated in place) and through the
    dense cache, every step's logits equal to the reference's paged decode,
    tokens from the reference."""
    jm, jp, tm, tp = _models("ra", window=window)
    toks, lens = _prompts(lengths, seed=5)
    b = len(lengths)
    jl, jdense = jm.prefill(jp, jnp.asarray(toks), lengths=jnp.asarray(lens), cache_len=seq)
    _, tdense = tm.prefill(tp, torch.from_numpy(toks), lengths=torch.from_numpy(lens),
                           cache_len=seq)

    def admitted(pool):
        arena = pool.acquire(b, seq)
        rows = pool.alloc_rows(arena, b)
        for r, ln in zip(rows, lengths):
            pool.admit_row(arena, r, prompt=ln, span=ln + steps + 1)
        return arena, rows

    jpool = JaxPool(jm, page_size=page)
    ja, jrows = admitted(jpool)
    jpool.write_rows(ja, jrows, jdense)
    ports = {}
    for kern in ("paged", "gather", "ref"):
        pool = KVCachePool(tm, "cpu", page_size=page)
        arena, rows = admitted(pool)
        assert rows == jrows
        pool.write_rows(arena, rows, tdense)
        for k in ja.cache:
            np.testing.assert_allclose(_f32(arena.cache[k]), _f32(ja.cache[k]), **TOL)
        ports[kern] = (pool, arena)
    tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    pos = lens.copy()
    jcache = ja.cache
    for step in range(steps):
        for r, p in zip(jrows, pos):
            jpool.ensure_decode_slots(ja, [r], int(p))
        want, jcache = jm.decode_step(jp, jcache, tok, jnp.asarray(pos), tables=ja.tables,
                                      page=page, seq_len=seq)
        ttok, tpos = torch.from_numpy(np.asarray(tok)), torch.from_numpy(pos)
        for kern, (pool, arena) in ports.items():
            for r, p in zip(jrows, pos):
                pool.ensure_decode_slots(arena, [r], int(p))
            got, _ = tm.decode_step(tp, arena.cache, ttok, tpos, tables=arena.tables,
                                    page=page, seq_len=seq, decode_kernel=kern)
            np.testing.assert_allclose(_f32(got), _f32(want), **TOL,
                                       err_msg=f"{kern} step {step}")
        got, _ = tm.decode_step(tp, tdense, ttok, tpos)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL, err_msg=f"dense step {step}")
        tok = jnp.argmax(want[:, -1:], axis=-1).astype(jnp.int32)
        pos = pos + 1
    for pool, _arena in ports.values():
        assert pool.metrics.pages_leased == jpool.metrics.pages_leased


@pytest.mark.parametrize("pattern,page", [("ra", 16), ("rr", 16), ("rra", 64)])
def test_mixed_arena_params_match_reference(pattern, page):
    """A hybrid arena holds paged attention K/V beside per-row RG-LRU state:
    pages charged per page, state per row, as the reference charges them
    (``rr``: zero attention layers, pages of zero bytes)."""
    jm, _jp, tm, _tp = _models(pattern)
    jpool, tpool = JaxPool(jm, page_size=page), KVCachePool(tm, "cpu", page_size=page)
    for batch, seq in ((1, 64), (2, 128), (4, 256)):
        jp_, tp_ = jpool._arena_params(batch, seq), tpool._arena_params(batch, seq)
        assert tp_[1:] == tuple(jp_[1:])
        for span in (1, 40, seq):
            assert tpool.span_pages(seq, span) == jpool.span_pages(seq, span)
            assert tpool.member_bytes(seq, batch, span) == jpool.member_bytes(seq, batch, span)
    w = get_config(ARCH).lru_width
    n_r = pattern.count("r")
    assert tpool._arena_params(2, 128)[4] == n_r * (w * 4 + 3 * w * 4)


# ---------------------------------------------------------------------------
# serving: PlanServer.handle and the engine
# ---------------------------------------------------------------------------


def _servers(pattern="ra", **config):
    """The reference's server on pattern ``pattern`` with its seeded weights
    scaled by ``SERVE_SCALE``, and the port's (on the CPU) with the same."""
    jcfg, tcfg = _cfgs(pattern)
    common = dict(dtype="float32", page_size=16, **config)
    jsrv = JaxPlanServer(jcfg, config=JaxEngineConfig(**common))
    scale = np.float32(SERVE_SCALE)
    jsrv.params = {k: jnp.asarray(np.asarray(v) * scale) if np.asarray(v).std() else v
                   for k, v in jsrv.params.items()}
    srv = PlanServer(tcfg, config=EngineConfig(**common), device="cpu")
    srv.params = interop.params_from_numpy({k: np.asarray(v) for k, v in jsrv.params.items()},
                                           torch.float32, "cpu")
    return jsrv, srv


@pytest.mark.parametrize("pattern,kernel", [("ra", "paged"), ("ra", "gather"), ("ra", "auto"),
                                            ("rr", "auto")])
def test_plan_server_handle_matches_reference(pattern, kernel):
    """Requests 1x40, 2x100, 1x70 (8 tokens each, prompts past the window):
    tokens, buckets, pool counters, ``peak_bytes`` and ``live_bytes`` equal
    to the reference's, and the plans too where the decode kernel is forced
    (under ``auto`` each package prices the operators on its own hardware
    figures: H100 and TPU v5e)."""
    jsrv, srv = _servers(pattern, prefill=True, decode_kernel=kernel)
    for batch, context in ((1, 40), (2, 100), (1, 70)):
        jout = jsrv.handle(JaxRequest(batch, context, new_tokens=8))
        out = srv.handle(ServeRequest(batch, context, new_tokens=8))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["finish_reason"] == jout["finish_reason"]
        if kernel != "auto" or pattern == "rr":
            assert out["plan"].explain_axes() == jout["plan"].explain_axes()
        if pattern == "rr":
            assert out["plan"].explain_axes()["decode_kernel"] == "none"
    jm, m = jsrv.pool.metrics, srv.pool.metrics
    for name in COUNTERS:
        assert getattr(m, name) == getattr(jm, name), name
    assert m.peak_bytes == jm.peak_bytes > 0
    assert srv.pool.live_bytes() == jsrv.pool.live_bytes() == 0


def test_engine_lifecycle_trace_matches_reference():
    """A step-driven trace on pattern ``ra`` through both engines (one
    arena, sanitizer on): a group, mid-decode joins, a cancel of an active
    and of a queued request, an EOS and a stop-sequence exit; streams,
    records, scheduler and pool counters equal."""
    config = dict(decode_kernel="paged", sanitize=True, pool_max_arenas=1)
    jsrv, srv = _servers("ra", **config)
    probe = Side(ServingEngine(srv, clock=VirtualClock()), ServeRequest).apply(LIFECYCLE)
    stops = {}
    for op in LIFECYCLE:
        if op[0] == "submit" and len(op) > 5:
            stream = probe.streams()[op[1]][0].tolist()
            stops[op[1]] = (first_new(stream)[1] if op[5] == "eos"
                            else tuple(first_new_pair(stream)[1]))
    _, srv = _servers("ra", **config)
    port = Side(ServingEngine(srv, clock=VirtualClock()), ServeRequest).apply(LIFECYCLE,
                                                                              stops)
    ref = Side(JaxEngine(jsrv, clock=JaxVirtualClock()), JaxRequest).apply(LIFECYCLE, stops)
    assert_equal_runs(ref, port)
    reasons = {n: h.result["finish_reason"] for n, h in port.handles.items()}
    assert reasons == dict(a="cancelled", b="length", c="length", d="eos", e="stop",
                           f="length", g="cancelled", h="length")
    assert port.engine.metrics.joins >= 3


@pytest.mark.parametrize("mode", [
    ["--stream", "--prefill", "--requests", "2", "--tokens", "3", "--shapes", "2x100,1x40"],
    ["--batch", "2", "--context", "40", "--tokens", "4"],
    ["--scheduler", "--requests", "4", "--tokens", "3", "--arrival-rate", "50",
     "--shapes", "1x40,2x60", "--sanitize"],
])
def test_serve_cli_runs_the_hybrid_smoke_arch(monkeypatch, mode):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-2b-smoke``
    in the stream, single-shot and scheduler modes, on the CPU."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu", *mode])
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve_cli.main()
    out = buf.getvalue()
    if "--stream" in mode:
        assert ARCH in out and out.count("req[") == 2 and "handoffs=2" in out
    elif "--scheduler" in mode:
        assert ARCH in out and out.count("req[") == 4 and "scheduler:" in out
    else:
        assert "decoded 4 tokens x 2 seqs" in out
