"""One kernel of one source tree, timed on the card at its serving path's
shapes, for comparing two trees in one run.

    python3 tools/kernel_ab.py --kernel {paged_decode,ssd_scan,ssd_scan_bwd,rglru_scan_bwd,
                                         flash_d64,cross_read,flash_bwd,flash_fp32}
        [--tree DIR] [--label NAME] [--flush-modes write read none]
        [--dtype {bfloat16,float32}]

``--tree`` is the root of a checkout of this repository (default: this
one); its ``src/repro_torch`` and its ``chip_smoke.py`` are imported, and
its kernels are built into its own ``build/`` directory. For each shape:
bfloat16 inputs from a fixed seed (the tree's ``chip_smoke.py`` input
builders), the result held against the float32 plain version under the
kernel's ``chip_smoke.py`` tolerance (a backward's every gradient under
``_bwd_tol``), then the CUDA-event median of 20 calls
and the profiler device time per call of the kernel's family, the L2
flushed before every call. One JSON line per shape, with the card's name
and power limit. Run trees in turns, one process each (parent, change,
change, parent), to compare them on one card.

Kernels and shapes:

- ``paged_decode``: Yi-6B widths (Hq 32, Hkv 4, D 128, page 64), the
  (8, 2000) request mid-decode in its (8, 2048) bucket and the (1, 512)
  request in its (1, 1024) bucket.
- ``ssd_scan``: the serving SSD scan (the Gram pass and the walk) at
  Mamba-2 1.3B's widths, the (8, 2048) and (1, 1024) buckets.
- ``ssd_scan_bwd``: the SSD backward at Mamba-2 1.3B's training shape
  (4, 2048, 64, 64, 128), from the tree's own training forward's chunk
  states (``chip_smoke.py`` phase 3's inputs and dy).
- ``rglru_scan_bwd``: the RG-LRU backward at RecurrentGemma-2B's training
  shape (4, 2048, 2560), from the tree's own training forward's carries.
- ``flash_d64``: bfloat16 flash attention at head dim 64, Whisper-medium's
  encoder (8, 16, 1500, 64, bidirectional) and its two training shapes
  (cross: 448 queries over 1500 keys; self: causal at 448), each held
  against the tree's ``flash_attention_tiled`` at the tree's own key tile.
- ``cross_read``: the whole ``models/attention.py::attention`` call of
  Whisper's decode tick, one query row (8, 1, 16, 64) over the cross K/V
  (8, 1500, 16, 64) in the model's layout, ``causal=False``: whatever the
  tree does inside it (transposed copies and the flash kernel, or the
  one-row kernel), so both trees time the same public function. Its
  ``device_ms`` sums every kernel the call launches, the copies included.
- ``flash_bwd``: the attention backward in the training shapes: head dim
  128, causal, Yi-6B (4, 2048, 32/4 heads), InternVL2-2B (4, 2304: 2048
  after a 256-token prefix, 16/8) and Qwen3-MoE (4, 2048, 64/4); head dim
  256, RecurrentGemma-2B (4, 2048, 10/1, window 2048); head dim 64,
  Whisper-medium's encoder (8, 1500, 16/16, bidirectional), decoder
  self-attention (8, 448, causal) and cross attention (448 queries over
  1500 keys); from the tree's own training forward's out and lse, each
  gradient held under ``_bwd_tol`` against the tree's
  ``attention_bwd_tiled`` (its own dQ key tile). With ``--dtype float32``
  the float32 train-check twins' attention instead: Yi-6B's (2, 512,
  32/4 heads of 128, causal), RecurrentGemma-2B's (2, 512, 10/1 of 256,
  window 2048) and Whisper-medium's encoder (2, 1500, 16/16 of 64,
  bidirectional), held against the tree's plain rule
  ``attention_bwd_torch``.
- ``flash_fp32``: the float32 training forward (``flash_attention_train``,
  out and lse) at the float32 train-check twins' attention shapes (those
  of ``flash_bwd --dtype float32``), out and lse held at ``FP32_TOL``
  against the tree's plain training forward ``flash_attention_train_torch``.

The flush is ``chip_smoke.py``'s (96 MB of zeros written, which leaves the
L2 full of dirty lines that the kernel's reads must write back first);
``--flush-modes write read none`` adds the device time after a flush that
only reads 96 MB (a clean L2 without the call's data) and with no flush at
all (the call's data warm in the 50 MB L2 where it fits).
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def _close(cs, tol):
    """check(got, want) -> (ok, max abs error, error RMS over the
    reference's) under one tolerance."""
    def check(got, want):
        ok, max_err, _, rms_ratio = cs.within(got, want, tol)
        return ok, max_err, rms_ratio
    return check


def _grads_close(cs, dtype):
    """check for a backward's gradients: each under ``chip_smoke.py``'s
    ``_bwd_tol``; the worst max error and RMS ratio."""
    def check(got, want):
        res = [cs.within(g, w, cs._bwd_tol(w, dtype, g.dtype == torch.float32))
               for g, w in zip(got, want)]
        return all(r[0] for r in res), max(r[1] for r in res), max(r[3] for r in res)
    return check


def paged_decode_cases(cs, pa):
    """(label, call, plain, check, bound_ms) at Yi-6B's decode shapes."""
    hq, hkv, d, page = 32, 4, 128, 64
    for label, b, sc, pos in (("serving (8, 2048)", 8, 2048, [2000 + 4 * i for i in range(8)]),
                              ("bucket (1, 1024)", 1, 1024, [527])):
        q, k, v, tables, posv = cs._paged_inputs(b, hq, hkv, d, page, sc, pos,
                                                 torch.bfloat16, 4)
        slots = sum(min(p + 1, sc) for p in pos)
        nbytes = slots * hkv * d * 2 * 2 + 2 * b * hq * d * 2 + tables.numel() * 4 + b * 4
        bound, _ = cs._bound_ms(nbytes, 4 * hq * d * slots, torch.bfloat16)
        yield (label,
               lambda: pa.paged_decode_attention(q, k, v, tables, posv, page=page, sc=sc),
               lambda: pa.paged_attention_torch(q.float(), k.float(), v.float(), tables, posv,
                                                page=page, sc=sc),
               _close(cs, cs.PAGED_BF16_TOL), bound)


def ssd_scan_cases(cs, ssd):
    """(label, call, plain, check, bound_ms) at Mamba-2 1.3B's prompt
    buckets."""
    for label, dims in (("serving (8, 2048)", (8, 2048, 64, 64, 128)),
                        ("bucket (1, 1024)", (1, 1024, 64, 64, 128))):
        inputs = cs._ssd_inputs(*dims, torch.bfloat16, 7)
        work = ssd.work(*inputs)
        bound, _ = cs._bound_ms(work.bytes, work.flops, torch.bfloat16)
        yield (label, lambda: ssd.ssd_scan(*inputs),
               lambda: ssd.ssd_scan_torch(*(t.float() for t in inputs)),
               _close(cs, cs.SSD_BF16_TOL), bound)


def ssd_scan_bwd_cases(cs, ssd):
    """(label, call, plain, check, bound_ms) at Mamba-2 1.3B's training
    shape, bfloat16, from the tree's own training forward's chunk states."""
    inputs = cs._ssd_inputs(*cs.SSD_TRAIN_SHAPE, torch.bfloat16, 31)
    gen = torch.Generator(device="cuda").manual_seed(32)
    dy = torch.randn(inputs[0].shape, generator=gen, device="cuda").to(torch.bfloat16)
    _, states = ssd.ssd_scan_train(*inputs)
    work = ssd.work_bwd(*inputs, states, dy)
    bound, _ = cs._bound_ms(work.bytes, work.flops, torch.bfloat16)
    yield ("training (4, 2048)", lambda: ssd.ssd_scan_bwd(*inputs, states, dy),
           lambda: ssd.ssd_scan_bwd_torch(*(t.float() for t in inputs), states, dy.float()),
           _grads_close(cs, torch.bfloat16), bound)


def rglru_scan_bwd_cases(cs, rg):
    """(label, call, plain, check, bound_ms) at RecurrentGemma-2B's training
    shape, bfloat16, from the tree's own training forward's carries."""
    *inputs, _lengths = cs._rglru_inputs(*cs.RGLRU_TRAIN_SHAPE, torch.bfloat16, 41)
    gen = torch.Generator(device="cuda").manual_seed(42)
    dy = torch.randn(cs.RGLRU_TRAIN_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    _, h_chunks = rg.rglru_scan_train(*inputs)
    work = rg.work_bwd(*inputs, h_chunks, dy)
    bound, _ = cs._bound_ms(work.bytes, work.flops, torch.bfloat16)
    yield ("training (4, 2048)", lambda: rg.rglru_scan_bwd(*inputs, h_chunks, dy),
           lambda: rg.rglru_scan_bwd_torch(*(t.float() for t in inputs), h_chunks, dy.float()),
           _grads_close(cs, torch.bfloat16), bound)


def flash_d64_cases(cs, fa):
    """(label, call, plain, check, bound_ms) at Whisper-medium's head-dim-64
    shapes, bfloat16."""
    gen = torch.Generator(device="cuda").manual_seed(64)
    for label, (sq, sk, causal) in (("encoder (8, 1500)", (1500, 1500, False)),
                                    ("cross train (8, 448 x 1500)", (448, 1500, False)),
                                    ("decoder train (8, 448) causal", (448, 448, True))):
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
                   for sh in ((8, 16, sq, 64), (8, 16, sk, 64), (8, 16, sk, 64)))
        flops, nbytes = fa.work(q, k, v, causal, 0, -1)
        bound, _ = cs._bound_ms(nbytes, flops, torch.bfloat16)
        yield (label, lambda: fa.flash_attention(q, k, v, causal=causal),
               lambda: fa.flash_attention_tiled(q, k, v, causal=causal),
               _close(cs, cs.FLASH_BF16_TOL), bound)


def cross_read_cases(cs, att):
    """(label, call, plain, check, bound_ms) of ``attention`` at Whisper's
    decode-tick cross read, bfloat16, against the float32 reference form."""
    gen = torch.Generator(device="cuda").manual_seed(65)
    q = torch.randn((8, 1, 16, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((8, 1500, 16, 64), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    bound, _ = cs._bound_ms(nbytes, 4 * 64 * 1500 * 8 * 16, torch.bfloat16)
    yield ("cross read (8, 1 x 1500, 16, 64)", lambda: att.attention(q, k, v, causal=False),
           lambda: att._einsum(q.float(), k.float(), v.float(), causal=False, window=0,
                               q_offset=0),
           _close(cs, cs.FLASH_BF16_TOL), bound)


# the float32 train-check twins' attention (--dtype float32)
FLASH_BWD_FP32_SHAPES = (
    ("Yi-6B train-check (2, 512, 32/4, D 128, causal)", (2, 32, 4, 128, 512, 512, True, 0)),
    ("RecurrentGemma-2B train-check (2, 512, 10/1, D 256, window 2048)",
     (2, 10, 1, 256, 512, 512, True, 2048)),
    ("Whisper-medium train-check encoder (2, 1500, 16/16, D 64, bidirectional)",
     (2, 16, 16, 64, 1500, 1500, False, 0)))


def flash_bwd_cases(cs, fa, dtype=torch.bfloat16):
    """(label, call, plain, check, bound_ms) of the attention backward at the
    training shapes, bfloat16: head dim 128 (Yi-6B, InternVL2-2B, Qwen3-MoE,
    causal), 256 (RecurrentGemma-2B, window 2048) and 64 (Whisper-medium's
    encoder, decoder self-attention and cross attention); float32: the
    train-check twins' shapes (``FLASH_BWD_FP32_SHAPES``) against the plain
    rule, the bound the smaller of float32's and 3xTF32's."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    shapes = FLASH_BWD_FP32_SHAPES if dtype == torch.float32 else (
            ("Yi-6B training (4, 2048, 32/4)", (4, 32, 4, 128, 2048, 2048, True, 0)),
            ("InternVL2-2B training (4, 2304, 16/8)", (4, 16, 8, 128, 2304, 2304, True, 0)),
            ("Qwen3-MoE training (4, 2048, 64/4)", (4, 64, 4, 128, 2048, 2048, True, 0)),
            ("RecurrentGemma-2B training (4, 2048, 10/1, D 256, window 2048)",
             (4, 10, 1, 256, 2048, 2048, True, 2048)),
            ("Whisper-medium encoder (8, 1500, 16/16, D 64, bidirectional)",
             (8, 16, 16, 64, 1500, 1500, False, 0)),
            ("Whisper-medium decoder (8, 448, 16/16, D 64, causal)",
             (8, 16, 16, 64, 448, 448, True, 0)),
            ("Whisper-medium cross (8, 448 x 1500, 16/16, D 64)",
             (8, 16, 16, 64, 448, 1500, False, 0)))
    plain = fa.attention_bwd_torch if dtype == torch.float32 else fa.attention_bwd_tiled
    for label, (b, hq, hkv, d, sq, sk, causal, window) in shapes:
        mask = dict(causal=causal, window=window, q_offset=-1)
        q, k, v, dout = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                         for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                                    (b, hq, sq, d)))
        out, lse = fa.flash_attention_train(q, k, v, **mask)
        args = (q, k, v, out, lse, dout)
        flops, nbytes = fa.work_bwd(*args, causal, window, -1)
        bound, _ = cs._bound_ms(nbytes, flops, dtype, tf32x3=True)
        yield (label, lambda args=args, mask=mask: fa.flash_attention_bwd(*args, **mask),
               lambda args=args, mask=mask: plain(*args, **mask), _grads_close(cs, dtype), bound)


def flash_fp32_cases(cs, fa):
    """(label, call, plain, check, bound_ms) of the float32 training forward
    at the float32 train-check twins' shapes; out and lse each at
    FP32_TOL."""
    gen = torch.Generator(device="cuda").manual_seed(34)

    def check(got, want):
        res = [cs.within(g, w, cs.FP32_TOL) for g, w in zip(got, want)]
        return all(r[0] for r in res), max(r[1] for r in res), max(r[3] for r in res)

    for label, (b, hq, hkv, d, sq, sk, causal, window) in FLASH_BWD_FP32_SHAPES:
        mask = dict(causal=causal, window=window, q_offset=-1)
        q, k, v = (torch.randn(sh, generator=gen, device="cuda")
                   for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        flops, nbytes = fa.work_train(q, k, v, causal, window, -1)
        bound, _ = cs._bound_ms(nbytes, flops, torch.float32, tf32x3=True)
        yield (label, lambda q=q, k=k, v=v, mask=mask: fa.flash_attention_train(q, k, v, **mask),
               lambda q=q, k=k, v=v, mask=mask: fa.flash_attention_train_torch(q, k, v, **mask),
               check, bound)


# kernel: (its module under repro_torch, its family in a trace or None for
# every kernel the call launches, cases)
KERNELS = {"paged_decode": ("kernels.paged_attention", "paged_decode", paged_decode_cases),
           "ssd_scan": ("kernels.ssd_scan", "ssd", ssd_scan_cases),
           "ssd_scan_bwd": ("kernels.ssd_scan", "ssd", ssd_scan_bwd_cases),
           "rglru_scan_bwd": ("kernels.rglru_scan", "rglru", rglru_scan_bwd_cases),
           "flash_d64": ("kernels.flash_attention", "flash", flash_d64_cases),
           "cross_read": ("models.attention", None, cross_read_cases),
           "flash_bwd": ("kernels.flash_attention", "flash_bwd", flash_bwd_cases),
           "flash_fp32": ("kernels.flash_attention", "flash", flash_fp32_cases)}


def call_device_ms(cs, call, family, flush) -> tuple:
    """(device ms per call, {kernel: ms}) of ``family``'s kernels, or with
    ``family`` None of every kernel ``call`` launches (the flush's own
    fill, timed alone the same way, left out)."""
    if family is not None:
        return cs.device_ms(call, family, flush)
    fill = cs.traced_kernels(lambda: None, calls=10, flush=flush)
    times = cs.traced_kernels(call, calls=10, flush=flush)
    mine = {k: t for k, t in times.items() if k not in fill}
    return (sum(mine.values()) if mine else None), mine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--flush-modes", nargs="+", default=["write"],
                    choices=("write", "read", "none"))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the inputs' dtype of --kernel flash_bwd")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    # the tree's own chip_smoke.py and sources, chosen here at run time
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(tree))
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs  # lint: allow-local-import

    module, family, cases = KERNELS[args.kernel]
    mod = importlib.import_module(f"repro_torch.{module}")
    if not Path(mod.__file__).resolve().is_relative_to(tree):
        print(f"kernel_ab: imported {mod.__file__}, not from {tree}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    reader = torch.zeros(24 << 20, dtype=torch.float32, device="cuda")   # 96 MB

    class ReadFlush:
        """Stands in for the flush buffer: ``zero_()`` reads 96 MB instead."""

        def zero_(self):
            reader.sum()

    flushes = {"write": flush, "read": ReadFlush(), "none": None}
    if args.kernel == "flash_bwd":
        cases = functools.partial(cases, dtype=getattr(torch, args.dtype))
    for label, call, plain, check, bound in cases(cs, mod):
        ok, max_err, rms_ratio = check(call(), plain())
        event_ms = cs.cuda_ms(call, flush=flush)
        dev_ms, names = call_device_ms(cs, call, family, flush)
        by_flush = {mode: call_device_ms(cs, call, family, flushes[mode])[0]
                    for mode in args.flush_modes}
        print(json.dumps({"tree": args.label or str(tree), "kernel": args.kernel,
                          "shape": label, "ok": ok, "max_abs_err": max_err,
                          "err_rms_ratio": rms_ratio, "event_ms": event_ms,
                          "device_ms": dev_ms, "device_ms_by_flush": by_flush,
                          "kernels": {cs._short(n): t for n, t in names.items()},
                          "bound_ms": bound, "card": smi}), flush=True)
        if not ok:
            print(f"kernel_ab: {args.kernel} {label} disagrees with the plain version",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
