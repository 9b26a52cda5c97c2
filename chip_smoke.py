"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught):

1. device   — the card's name and power limit (nvidia-smi), its SM count and
              opt-in shared memory beside the port's H100 spec;
2. build    — every CUDA kernel of the port built from ``src/repro_torch``
              with nvcc, one process per source, all at once;
3. kernels  — each kernel against its plain PyTorch version on the card, in
              float32 and bfloat16, at the shapes the serving path gives it
              and at the smaller widths the kernels take, with CUDA-event
              timings (median) and the bound for its work; the SSD scan also
              under strong decay and against the sequential-scan oracle;
4. serve-check — Yi-6B widths cut to 2 layers, float32, through
              ``PlanServer``: identical token streams under the paged,
              gather and ref decode kernels;
5. serve    — full Yi-6B (32 layers, bfloat16, random weights from a seeded
              generator) serving three requests through ``PlanServer``, with
              every kernel's launch count checked against the layer count;
              then each request once more (in its bucket, with 8 or more
              new tokens) under ``torch.profiler`` for the device's busy
              time and idle share in prefill and decode;
6. serve-check-ssm — Mamba-2 1.3B widths cut to 2 layers, float32, through
              ``PlanServer``: identical token streams with the SSD kernel
              and with its plain version, and the prefill -> decode handoff
              equal to a prefill one token longer;
7. serve-ssm — full Mamba-2 1.3B (48 layers, bfloat16, seeded random
              weights) serving the same three requests, the SSD kernel's
              launches checked against the layer count, then traced.

Before the last line it prints one JSON ``kernels`` line and the card's
``nvidia-smi`` name and power limit; the last line is the JSON ``ok`` line.
It exits non-zero without printing a result when no CUDA device is present
or when the port's sources are not beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
# (atol, rtol, limit on the error's RMS over the reference's RMS). A
# kernel's error passes where |got - want| <= atol + rtol * |want|.
# float32: sums in another order only (RMS ratio ~6e-7 between the flash
# plain versions).
FP32_TOL = (1e-4, 1e-4, 1e-5)
# bfloat16: the kernel's output is held against its plain version computed
# in float32 on the same bfloat16 inputs, unrounded, in the kernel's own
# order where the kernel rounds inside (flash rounds P to bfloat16 per
# 64-key tile). What remains is the output's own rounding, at most half an
# ulp (2^-8 relative; ~1.6e-3 as an RMS ratio), and for flash the few P
# values that float32 summation order rounds the other way: in a row with
# few keys one such P moves the row by up to ~1e-3 (the kernel modelled in
# float64 on the CPU at the serving shape). A kernel that loses its
# ragged-tail mask scales a 1000-key row by ~1.5 %: errors up to ~5e-3 past
# the rtol term and an RMS ratio of ~1.4e-2, caught by both limits.
PAGED_BF16_TOL = (1e-5, 2.0 ** -8, 2.0 ** -8)
FLASH_BF16_TOL = (2e-3, 2.0 ** -8, 2.0 ** -8)
# SSD: the kernel computes in float32 on the bfloat16 inputs and rounds only
# its output, so the plain version on float32 copies of the same inputs is
# its reference; atol covers float32 summation order where an output sits
# near zero (terms of size ~10-100 summed over 64 positions and 128 state
# entries: ~1e-5).
SSD_BF16_TOL = (1e-4, 2.0 ** -8, 2.0 ** -8)
# the serving requests of both models: (batch, context), 32 new tokens each
SERVE_REQUESTS = ((1, 512), (4, 1000), (8, 2000))
CHECK_REQUESTS = ((2, 300), (1, 100), (3, 64))
# fewest new tokens of a traced request (more where fewer would change its
# bucket): per-step device time needs a few steps, and the profiler's
# post-processing grows with every traced event
TRACE_NEW_TOKENS = 8
_T0 = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n== {name} == (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls;
    ``flush`` (a large buffer) is rewritten before each call so the call
    finds the L2 cache cold, as it does between layers on the serving path."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def within(got, want, tol) -> tuple:
    """(ok, max abs error, max error over the reference's RMS, error RMS
    over the reference's RMS) of ``got`` against ``want`` under ``tol``."""
    import torch

    atol, rtol, rms_limit = tol
    want = want.float()
    err = (got.float() - want).abs()
    ref_rms = max(float(want.pow(2).mean().sqrt()), 1e-30)
    max_err = float(err.max())
    rms_ratio = float(err.pow(2).mean().sqrt()) / ref_rms
    ok = (not bool((err > atol + rtol * want.abs()).any()) and rms_ratio <= rms_limit
          and bool(torch.isfinite(got).all()))
    return ok, max_err, max_err / ref_rms, rms_ratio


def check_close(name, got, want, tol) -> float:
    """Holds ``got`` against ``want`` under ``tol`` = (atol, rtol, RMS
    ratio limit), printing the readings; returns the max abs error."""
    ok, max_err, max_ratio, rms_ratio = within(got, want, tol)
    print(f"  {name}: max_abs_err={max_err:.3e} max_err/ref_rms={max_ratio:.3e} "
          f"err_rms/ref_rms={rms_ratio:.3e} tol(atol={tol[0]:g}, rtol={tol[1]:g}, "
          f"rms={tol[2]:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_err


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    from repro_torch import hw

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    info = hw.probe(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"card: {info}")
    print(f"port spec: {hw.H100}")
    if info["capability"] != "9.0":
        fail(f"kernels are built for sm_90a, the card reports {info['capability']}")
    optin = info["smem_per_block_optin"]
    if optin is not None and optin < hw.H100.vmem_bytes:
        print(f"  note: opt-in shared memory {optin} B is below the spec's "
              f"{hw.H100.vmem_bytes} B")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_scan as SSD

    phase("build")
    t0 = time.perf_counter()
    out = _build.build_all()
    _build.library("paged_decode", PA._bind)
    _build.library("flash_attention", FA._bind)
    _build.library("ssd_scan", SSD._bind)
    print(f"built {sorted(p.name for p in out.glob('*.so'))} into {out} "
          f"in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, seed):
    """Flat slot stacks, shuffled page tables, sentinel entries on every page
    a row has not committed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_tab = -(-sc // page)
    n_phys = b * n_tab
    q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((n_phys * page, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((n_phys * page, hkv, d), generator=gen, device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    tables = rng.permutation(n_phys).reshape(b, n_tab).astype(np.int32)
    for row, p in enumerate(pos):
        committed = -(-min(p + 1, sc) // page)
        tables[row, committed:] = n_phys
    return (q, k, v, torch.tensor(tables, device="cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def _flash_pairs(sq, sk, causal, window, q_offset) -> int:
    """Unmasked (query, key) pairs — the work the masks leave."""
    off = sk - sq if q_offset < 0 else q_offset
    qpos = off + np.arange(sq)
    hi = np.minimum(sk - 1, qpos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    import torch

    from repro_torch import hw

    peak = hw.H100.peak_flops if dtype == torch.bfloat16 else hw.H100_FP32_FLOPS
    t_bytes = nbytes / hw.H100.hbm_bandwidth * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import paged_decode_ref
    from repro_torch.models.attention import paged_cache_write

    phase("kernels")
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    results = {}

    def plain_paged(q, k, v, tables, posv, page, sc):
        # float32 copies of the inputs: the kernel computes in float32 and
        # rounds only its output
        return PA.paged_attention_torch(q.float(), k.float(), v.float(), tables, posv,
                                        page=page, sc=sc)

    def check_paged(name, b, hq, hkv, d, page, sc, pos, dtype, seed):
        q, k, v, tables, posv = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, seed)
        got = PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc)
        want = plain_paged(q, k, v, tables, posv, page, sc)
        torch.cuda.synchronize()
        tol = FP32_TOL if dtype == torch.float32 else PAGED_BF16_TOL
        return check_close(f"paged {str(dtype)[6:]} {name}", got, want, tol)

    # -- paged decode: B=8, Hq=32, Hkv=4, D=128, page 64, Sc=4096 ----------
    b, hq, hkv, d, page, sc = 8, 32, 4, 128, 64, 4096
    pos_cases = {
        "pos=0": [0] * b,
        "pos=page-1": [page - 1] * b,
        "pos=page": [page] * b,
        "pos mixed": [0, 63, 64, 1000, 2047, 3000, 4095, 4103],
        "pos>=Sc": [sc + 7 * i for i in range(b)],
    }
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, PAGED_BF16_TOL)):
        for name, pos in pos_cases.items():
            check_paged(name, b, hq, hkv, d, page, sc, pos, dtype, 1)
        # rotating writes: rows past a window of Sc wrap into their own pages
        pos = [sc + 5, sc + 900, 2 * sc - 1, sc + 64, sc + 63, sc, 3 * sc + 17, sc + 2000]
        q, k, v, tables, posv = _paged_inputs(b, hq, hkv, d, page, sc, pos, dtype, 2)
        gen = torch.Generator(device="cuda").manual_seed(3)
        for step in range(3):
            kn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda").to(dtype)
            vn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda").to(dtype)
            paged_cache_write(k, v, kn, vn, posv - 2 + step, tables, page, sc, window=sc)
        got = PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc)
        want = plain_paged(q, k, v, tables, posv, page, sc)
        lit = paged_decode_ref(q.float(), k.float(), v.float(), tables, posv, page=page,
                               sc=sc, window=sc)
        torch.cuda.synchronize()
        check_close(f"paged {str(dtype)[6:]} rotating writes", got, want, tol)
        check_close(f"paged {str(dtype)[6:]} rotating writes vs literal-rule oracle",
                    got, lit, tol)
        # the smaller head dims the kernel takes (yi-6b-smoke has D=32, g=2)
        for dd in (32, 64):
            check_paged(f"D={dd} g=2 page 16", 2, 4, 2, dd, 16, 64, [5, 70], dtype, 6)

    # the serving path's shape: the (8, 2000) request mid-decode, bucket 2048
    sc_main = 2048
    pos = [2000 + 4 * i for i in range(b)]
    q, k, v, tables, posv = _paged_inputs(b, hq, hkv, d, page, sc_main, pos,
                                          torch.bfloat16, 4)
    got = PA.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc_main)
    want = plain_paged(q, k, v, tables, posv, page, sc_main)
    err = check_close("paged bfloat16 serving shape (B=8, Sc=2048)", got, want,
                      PAGED_BF16_TOL)
    ms = cuda_ms(lambda: PA.paged_decode_attention(q, k, v, tables, posv, page=page,
                                                   sc=sc_main), flush=flush)
    plain_ms = cuda_ms(lambda: PA.paged_attention_torch(q, k, v, tables, posv, page=page,
                                                        sc=sc_main), flush=flush)
    slots = sum(min(p + 1, sc_main) for p in pos)
    item = 2
    nbytes = (slots * hkv * d * 2 * item + 2 * b * hq * d * item
              + tables.numel() * 4 + b * 4)
    bound, by = _bound_ms(nbytes, 4 * hq * d * slots, torch.bfloat16)
    print(f"  paged timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB committed K/V + q/out)")
    results["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention.py:130",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None)
    del q, k, v, tables, posv, got, want

    def plain_flash(q, k, v, **mask):
        # float32: the plain version the port runs on the CPU; bfloat16: the
        # plain version in the kernel's order, rounding P as the kernel does
        if q.dtype == torch.float32:
            return FA.flash_attention_torch(q, k, v, **mask)
        return FA.flash_attention_tiled(q, k, v, **mask)

    # -- flash attention: B=2, Hq=32, Hkv=4, D=128 ---------------------------
    flash_cases = [  # (name, b, hq, hkv, d, sq, sk, causal, window, q_offset)
        ("S=2048 causal", 2, 32, 4, 128, 2048, 2048, True, 0, -1),
        ("S=1000 causal (ragged)", 2, 32, 4, 128, 1000, 1000, True, 0, -1),
        ("S=2048 window=256", 2, 32, 4, 128, 2048, 2048, True, 256, -1),
        ("Sq=512 Sk=2048 q_offset=-1", 2, 32, 4, 128, 512, 2048, True, 0, -1),
        ("Sq=512 Sk=2048 q_offset=700 window=256", 2, 32, 4, 128, 512, 2048, True, 256,
         700),
        ("S=1000 bidirectional", 2, 32, 4, 128, 1000, 1000, False, 0, -1),
        # the smaller head dims the kernel is built for (yi-6b-smoke: D=32)
        ("D=32 S=100 causal", 2, 4, 2, 32, 100, 100, True, 0, -1),
        ("D=32 S=100 bidirectional", 2, 4, 2, 32, 100, 100, False, 0, -1),
        ("D=64 S=100 causal", 2, 4, 2, 64, 100, 100, True, 0, -1),
    ]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
        for name, b, hq, hkv, d, sq, sk, causal, window, off in flash_cases:
            q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            got = FA.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
            want = plain_flash(q, k, v, causal=causal, window=window, q_offset=off)
            torch.cuda.synchronize()
            check_close(f"flash {str(dtype)[6:]} {name}", got, want, tol)
            del q, k, v, got, want

    # the serving path's shape: the (8, 2000) request's prompt pass, bucket 2048
    b, hq, hkv, d, s = 8, 32, 4, 128, 2048
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    got = FA.flash_attention(q, k, v, causal=True)
    want = plain_flash(q, k, v, causal=True)
    err = check_close("flash bfloat16 serving shape (B=8, S=2048, causal)", got, want,
                      FLASH_BF16_TOL)
    del got, want
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True), flush=flush)
    plain_ms = cuda_ms(lambda: FA.flash_attention_torch(q, k, v, causal=True), flush=flush)
    # yardstick only, never called by the port: the library's fused
    # attention on the same inputs, K/V expanded to all heads beforehand
    ke, ve = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                     flush=flush)
    pairs = _flash_pairs(s, s, True, 0, -1)
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2
    bound, by = _bound_ms(nbytes, 4 * d * pairs * b * hq, torch.bfloat16)
    print(f"  flash timing: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.3f} ms, bound {bound:.4f} ms ({by}; "
          f"{4 * d * pairs * b * hq / 1e9:.1f} GFLOP)")
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms)
    del q, k, v, ke, ve
    results["ssd_scan"] = ssd_kernel_cases(flush)
    del flush
    torch.cuda.empty_cache()
    return results


def _ssd_inputs(b, s, h, p, n, dtype, seed, strong_decay=False):
    """x, B, C ~ N(0, 1) in ``dtype``; dt softplus'd normals and a the
    model's init (-(1 + 15 u)), both float32; d ones. ``strong_decay``: a =
    -16 and dt mostly in [5.5, 7] with one position in five near 0, so the
    within-chunk cumsum falls below -5,000 while some near-diagonal L
    entries stay near 1."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
    bm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    cm = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    if strong_decay:
        u = torch.rand((b, s, h), generator=gen, device="cuda")
        big = 5.5 + 1.5 * torch.rand((b, s, h), generator=gen, device="cuda")
        dt = torch.where(u < 0.8, big, 0.01 * u)
        a = torch.full((h,), -16.0, device="cuda")
    else:
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
        a = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device="cuda"))
    d = torch.ones((h,), device="cuda")
    return x, dt, a, bm, cm, d


def _ssd_work(x, dt, b_mat) -> tuple:
    """(bytes, operations) of one SSD scan: each input read once and y
    written once; C B^T once per (row, chunk) and, per (row, head, chunk),
    the masked score product, the inter-chunk product and the state update."""
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(64, s)
    nc = s // chunk
    flops = b * nc * 2 * chunk * chunk * n + b * h * nc * (2 * chunk * chunk * p
                                                           + 4 * chunk * n * p)
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
              + 2 * b_mat.numel() * b_mat.element_size() + 2 * h * 4)
    return nbytes, flops


def ssd_kernel_cases(flush) -> dict:
    """The SSD scan kernel against its plain version (and the sequential
    oracle) on the card, each case timed; returns the kernels-line entry of
    the serving shape in bfloat16 (the (8, 2000) request's prompt pass)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SSD

    def run_case(label, args, want, tol) -> dict:
        got = SSD.ssd_scan(*args)
        torch.cuda.synchronize()
        err = check_close(label, got, want, tol)
        del got
        ms = cuda_ms(lambda: SSD.ssd_scan(*args), flush=flush)
        plain_ms = cuda_ms(lambda: SSD.ssd_scan_torch(*args), flush=flush)
        nbytes, flops = _ssd_work(args[0], args[1], args[3])
        bound, by = _bound_ms(nbytes, flops, args[0].dtype)
        print(f"    timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)

    cases = [  # (name, b, s, h, p, n, strong decay)
        ("serving shape (B=8, S=2048)", 8, 2048, 64, 64, 128, False),
        ("B=1 S=1024", 1, 1024, 64, 64, 128, False),
        ("S=16 (chunk 16)", 2, 16, 64, 64, 128, False),
        ("smoke width (2, 32, 16, 16, 16), chunk 32", 2, 32, 16, 16, 16, False),
        ("strong decay (a=-16, dt to 7)", 2, 256, 64, 64, 128, True),
        ("strong decay, smoke width", 2, 128, 16, 16, 16, True),
    ]
    serving = None
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, SSD_BF16_TOL)):
        for name, b, s, h, p, n, strong in cases:
            args = _ssd_inputs(b, s, h, p, n, dtype, 7, strong_decay=strong)
            if strong:
                cum = torch.cumsum((args[1] * args[2]).double()[:, :64], dim=1)
                name += f", cum down to {float(cum.min()):.0f}"
            # float32 copies of the inputs: the kernel computes in float32
            # and rounds only its output
            want = SSD.ssd_scan_torch(*(t.float() for t in args))
            result = run_case(f"ssd {str(dtype)[6:]} {name}", args, want, tol)
            if dtype == torch.bfloat16 and (b, s) == (8, 2048):
                serving = result
            del args, want
    # the sequential-scan oracle, float32, at both widths
    for b, s, h, p, n in ((2, 128, 64, 64, 128), (2, 64, 16, 16, 16)):
        args = _ssd_inputs(b, s, h, p, n, torch.float32, 8)
        want, _state = ref.ssd_ref(*args)
        run_case(f"ssd float32 ({b}, {s}, {h}, {p}, {n}) vs sequential oracle", args, want,
                 FP32_TOL)
        del args, want
    print(f"  ssd timing at the serving shape, bfloat16: kernel {serving['ms']:.4f} ms, plain "
          f"{serving['plain_ms']:.4f} ms, bound {serving['bound_ms']:.4f} ms "
          f"({serving['bound_by']}); no single library call")
    return dict(name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:91", library_ms=None, **serving)


# ---------------------------------------------------------------------------
# 4. serve-check and 5. serve
# ---------------------------------------------------------------------------


def phase_serve_check():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine_config import EngineConfig
    from repro_torch.runtime.serve_loop import PlanServer, ServeRequest

    phase("serve-check: Yi-6B widths, 2 layers, float32, paged == gather == ref")
    cfg = get_config("yi-6b").replace(num_layers=2)
    streams, logits = {}, {}
    params = None
    for kernel in ("paged", "gather", "ref"):
        srv = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=True,
                                                  page_size=64, decode_kernel=kernel,
                                                  seed=SEED))
        if params is None:
            params = srv.params
        srv.params = params
        outs = [srv.handle(ServeRequest(batch, ctx, new_tokens=8))
                for batch, ctx in CHECK_REQUESTS]
        streams[kernel] = [o["tokens"].cpu().numpy() for o in outs]
        logits[kernel] = [o["last_logits"].float() for o in outs]
        print(f"  {kernel}: {[s.tolist() for s in streams[kernel]]}")
        del srv
    for kernel in ("gather", "ref"):
        for a, c in zip(streams["paged"], streams[kernel]):
            if not np.array_equal(a, c):
                fail(f"token streams differ between paged and {kernel}")
        for a, c in zip(logits["paged"], logits[kernel]):
            if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
                fail(f"final logits differ between paged and {kernel}")
    print("  token streams identical across paged, gather and ref")
    del params, logits
    torch.cuda.empty_cache()


def phase_serve():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.runtime.engine_config import EngineConfig
    from repro_torch.runtime.serve_loop import PlanServer, ServeRequest

    cfg = get_config("yi-6b")
    phase(f"serve: {cfg.name}, {cfg.num_layers} layers, bfloat16, page 64, paged decode")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              decode_kernel="paged", seed=SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.params.values())
    print(f"  weights: {n_params / 1e9:.2f} B parameters, random from seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()

    FA.flash_attention.launches = 0
    PA.paged_decode_attention.launches = 0
    requests = [ServeRequest(b, c, new_tokens=32) for b, c in SERVE_REQUESTS]
    outs = [srv.handle(r) for r in requests]
    launches = {"flash_attention": FA.flash_attention.launches,
                "paged_decode_attention": PA.paged_decode_attention.launches}
    report_requests(cfg, requests, outs)
    steps = sum(o["decode_steps"] for o in outs)
    want = {"flash_attention": cfg.num_layers * len(requests),
            "paged_decode_attention": cfg.num_layers * steps}
    print(f"  launches {launches} (expected {want}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    trace_decode(srv, requests)
    del srv
    torch.cuda.empty_cache()
    return launches


def report_requests(cfg, requests, outs) -> None:
    """Checks each served request's tokens and logits and prints its
    prefill ms, decode ms/step and tokens per second."""
    import torch

    for req, out in zip(requests, outs):
        steps = out["decode_steps"]
        tok = out["tokens"]
        if tuple(tok.shape) != (req.batch, req.new_tokens):
            fail(f"request {req.batch}x{req.context}: tokens {tuple(tok.shape)}")
        if not bool(torch.isfinite(out["last_logits"]).all()):
            fail(f"request {req.batch}x{req.context}: non-finite logits")
        if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
            fail(f"request {req.batch}x{req.context}: token out of the vocabulary")
        dec_ms = out["decode_s"] * 1e3 / max(1, steps)
        print(f"  req {req.batch}x{req.context} -> bucket={out['bucket']} "
              f"prefill {out['prefill_s'] * 1e3:.1f} ms | decode {dec_ms:.2f} ms/step "
              f"({steps} steps, {req.batch * steps / out['decode_s']:.1f} tok/s) | "
              f"total {out['latency_s'] * 1e3:.1f} ms, "
              f"{req.batch * req.new_tokens / out['latency_s']:.1f} tok/s")


# ---------------------------------------------------------------------------
# 6. serve-check-ssm and 7. serve-ssm
# ---------------------------------------------------------------------------


def phase_serve_check_ssm():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.runtime.engine_config import EngineConfig
    from repro_torch.runtime.serve_loop import PlanServer, ServeRequest

    phase("serve-check-ssm: Mamba-2 1.3B widths, 2 layers, float32, SSD kernel == plain")
    cfg = get_config("mamba2-1.3b").replace(num_layers=2)
    srv = PlanServer(cfg, config=EngineConfig(dtype="float32", prefill=True, page_size=64,
                                              seed=SEED))
    streams, logits = {}, {}
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        launches0 = SSD.ssd_scan.launches
        outs = [srv.handle(ServeRequest(batch, ctx, new_tokens=8))
                for batch, ctx in CHECK_REQUESTS]
        streams[backend] = [o["tokens"].cpu().numpy() for o in outs]
        logits[backend] = [o["last_logits"].float() for o in outs]
        launched = SSD.ssd_scan.launches - launches0
        print(f"  {backend}: {[s.tolist() for s in streams[backend]]} "
              f"({launched} ssd_scan launches)")
        if launched != (cfg.num_layers * len(CHECK_REQUESTS) if backend == "auto" else 0):
            fail(f"ops.BACKEND={backend!r}: {launched} ssd_scan launches")
    ops.BACKEND = "auto"
    for a, c in zip(streams["auto"], streams["torch"]):
        if not np.array_equal(a, c):
            fail("token streams differ between the SSD kernel and its plain version")
    for a, c in zip(logits["auto"], logits["torch"]):
        if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
            fail("final logits differ between the SSD kernel and its plain version")
    print("  token streams identical with the kernel and with its plain version")

    # handle() prompts with all ones, which this tied-embedding model at
    # random weights echoes; random prompts at mixed lengths hold the kernel
    # inside the model: prefill logits and handed-off state, kernel vs plain
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 320), generator=gen, device="cuda",
                           dtype=torch.int32)
    lens = torch.tensor([300, 177], dtype=torch.int32, device="cuda")
    pre = {}
    for backend in ("auto", "torch"):
        ops.BACKEND = backend
        pre[backend] = srv.model.prefill(srv.params, tokens, lengths=lens)
    ops.BACKEND = "auto"
    for name, a, c in (("logits", pre["auto"][0], pre["torch"][0]),
                       ("state", pre["auto"][1]["l.state"], pre["torch"][1]["l.state"])):
        diff, rms = float((a - c).abs().max()), float(c.pow(2).mean().sqrt())
        print(f"  random prompts (300, 177): prefill {name} kernel vs plain, max abs "
              f"difference {diff:.3e} (RMS {rms:.3f})")
        if not torch.allclose(a, c, atol=1e-3, rtol=1e-3):
            fail(f"prefill {name} differ between the SSD kernel and its plain version")
    del pre

    # handoff: a prefill of T tokens then one decode step on token T equals
    # the last logits of a prefill of the T + 1 tokens (rows padded to 320)
    t = 300
    full = torch.full((2,), t, dtype=torch.int32, device="cuda")
    _, cache = srv.model.prefill(srv.params, tokens, lengths=full)
    step, _ = srv.model.decode_step(srv.params, cache, tokens[:, t:t + 1], full)
    want, _ = srv.model.prefill(srv.params, tokens, lengths=full + 1)
    err = float((step[:, -1] - want).abs().max())
    rms = float(want.pow(2).mean().sqrt())
    print(f"  handoff: decode after a {t}-token prefill vs a {t + 1}-token prefill, "
          f"max abs logit difference {err:.3e} (logit RMS {rms:.3f})")
    if not torch.allclose(step[:, -1], want, atol=1e-3, rtol=1e-3):
        fail("prefill -> decode handoff disagrees with the longer prefill")
    del srv, cache, logits
    torch.cuda.empty_cache()


def phase_serve_ssm():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.runtime.engine_config import EngineConfig
    from repro_torch.runtime.serve_loop import PlanServer, ServeRequest

    cfg = get_config("mamba2-1.3b")
    phase(f"serve-ssm: {cfg.name}, {cfg.num_layers} layers, bfloat16, page 64, SSD kernel")
    t0 = time.perf_counter()
    srv = PlanServer(cfg, config=EngineConfig(dtype="bfloat16", prefill=True, page_size=64,
                                              seed=SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.params.values())
    print(f"  weights: {n_params / 1e9:.2f} B parameters, random from seed {SEED}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    srv.handle(ServeRequest(1, 16, new_tokens=2))     # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()

    FA.flash_attention.launches = 0
    PA.paged_decode_attention.launches = 0
    SSD.ssd_scan.launches = 0
    requests = [ServeRequest(b, c, new_tokens=32) for b, c in SERVE_REQUESTS]
    outs = [srv.handle(r) for r in requests]
    launches = {"ssd_scan": SSD.ssd_scan.launches,
                "flash_attention": FA.flash_attention.launches,
                "paged_decode_attention": PA.paged_decode_attention.launches}
    report_requests(cfg, requests, outs)
    want = {"ssd_scan": cfg.num_layers * len(requests), "flash_attention": 0,
            "paged_decode_attention": 0}
    print(f"  launches {launches} (expected {want}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; pool peak "
          f"{srv.pool.metrics.peak_bytes / 2**20:.1f} MiB of recurrent state")
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    trace_decode(srv, requests)
    del srv
    torch.cuda.empty_cache()
    return {"ssd_scan": launches["ssd_scan"]}


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _kernel_family(name: str) -> str:
    low = name.lower()
    if "paged_split" in name or "paged_combine" in name:
        return "paged_decode"
    if "ssd_scan" in name:
        return "ssd"
    if "flash_" in name:
        return "flash"
    if any(s in low for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def trace_decode(srv, requests) -> None:
    """Device time under ``torch.profiler``: each request served once more,
    in its own bucket, with as few new tokens as that allows (at least
    ``TRACE_NEW_TOKENS``).
    ``PlanServer.handle`` names its prefill and decode phases as spans that
    end after the device has finished them; a phase's device time is the
    union of the device events that start inside its span, its idle share
    the rest of the span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import DECODE_SPAN, PREFILL_SPAN, ServeRequest

    print("  trace (torch.profiler, each request served once more in its bucket, "
          f"with at least {TRACE_NEW_TOKENS} new tokens):")
    for full in requests:
        bucket = srv.buckets(full.batch, srv.request_span(full))
        n = next(n for n in range(TRACE_NEW_TOKENS, full.new_tokens + 1)
                 if srv.buckets(full.batch, full.context + n) == bucket)
        req = ServeRequest(full.batch, full.context, new_tokens=n)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = srv.handle(req)
        events = prof.events()
        spans = {e.name: e.time_range for e in events
                 if e.name in (PREFILL_SPAN, DECODE_SPAN) and e.device_type == DeviceType.CPU}
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.name not in (PREFILL_SPAN, DECODE_SPAN)]
        shape = f"{req.batch}x{req.context}"
        if len(spans) < 2 or not dev:
            print(f"    req {shape}: not measured (spans {sorted(spans)}, {len(dev)} device "
                  f"events in the trace)")
            continue
        for span, n in ((PREFILL_SPAN, 1), (DECODE_SPAN, out["decode_steps"])):
            lo, hi = spans[span].start, spans[span].end
            inside = [e for e in dev if lo <= e.time_range.start < hi]
            busy = _busy_us((e.time_range.start, min(e.time_range.end, hi)) for e in inside)
            fam, names = {}, {}
            for e in inside:
                dur = e.time_range.end - e.time_range.start
                key = _kernel_family(e.name)
                fam[key] = fam.get(key, 0.0) + dur
                names[e.name] = names.get(e.name, 0.0) + dur
            by_kind = ", ".join(f"{k} {v / n / 1e3:.3f}"
                                for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
            top = "; ".join(f"{k[:48]} {v / n / 1e3:.3f}"
                            for k, v in sorted(names.items(), key=lambda kv: -kv[1])[:3])
            unit = "ms" if n == 1 else f"ms/step over {n} steps"
            print(f"    req {shape} bucket={out['bucket']} {span.split('.')[1]}: span "
                  f"{(hi - lo) / n / 1e3:.3f} {unit}, device busy {busy / n / 1e3:.3f}, idle "
                  f"share {1 - busy / (hi - lo):.3f}, {len(inside) / n:.0f} device events; "
                  f"device time by kind: {by_kind}; top kernels: {top}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_serve_check()
    launches = phase_serve()
    phase_serve_check_ssm()
    launches.update(phase_serve_ssm())
    for name, n in launches.items():
        kernels[name]["launches"] = n
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{key: kernels[n][key] for key in order}
                        for n in ("paged_decode_attention", "flash_attention", "ssd_scan")]}
    for entry in line["kernels"]:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if entry[key] is not None and not math.isfinite(entry[key]):
                fail(f"{entry['name']}: {key} is not finite")
    print(f"\nall phases passed in {time.perf_counter() - t0:.1f} s "
          f"({time.perf_counter() - _T0:.1f} s since start)")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
