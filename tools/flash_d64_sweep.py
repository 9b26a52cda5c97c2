"""The designs of the two head-dim-64 attention kernels, timed side by side
on the card at Whisper-medium's shapes.

    python3 tools/flash_d64_sweep.py [--variants carry slim2_fast ...]
        [--decode-splits 64 128 256 ...]

``csrc/flash_attention.cu`` takes the shape of ``flash_wgmma_kernel<64>``
(bfloat16 flash attention at D = 64) from the macro ``FLASH_D64_SHAPE``:
keys per tile, K/V ring stages, consumer and producer registers, blocks an
SM, whether the producer is one warp (no setmaxnreg) and whether the
softmax is the FAST one (``ex2.approx.ftz``, each row's quad summed once at
the end, the running max moved only past a slack of 8 in log2 units). The
port builds its default. This tool compiles the source once per variant
below with the port's nvcc flags and ``-Xptxas -v``, the macro defined in
a header it pre-includes (nvcc splits ``-D`` values at commas), all nvcc
processes at once, into ``build/flash_d64_sweep/<variant>/`` (gitignored),
and prints each variant's registers, spills and ptxas notes of
``flash_wgmma_kernel<64>``; a variant whose registers after setmaxnreg
would not fit what its block holds is not run. Then, at Whisper's encoder
shape (8, 16, 1500, 64, bidirectional) and its two training shapes (cross:
448 queries over 1500 keys; self: causal at 448), bfloat16 inputs from a
fixed seed: each variant's output held against ``flash_attention_tiled``
at the variant's key tile and slack under ``chip_smoke.py``'s
``FLASH_BF16_TOL``, then its profiler device time per call with the L2
flushed (``chip_smoke.device_ms``), the variants in turns (forward order,
then reversed), beside ``scaled_dot_product_attention`` on the same
inputs.

``--decode-splits`` times ``flash_decode`` (the port's own build) at
Whisper's cross read, (8, 16, 1, 64) over (8, 1500, 16, 64), at each split
size given, through the C entry point (the wrapper's split is
``decode_splits``), each checked against the plain version.

One JSON line per variant (or split) and shape, with the card's name and
power limit. Exits non-zero where a variant does not build or disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

# name: (keys per tile, stages, consumer registers, producer registers,
#        blocks an SM, a one-warp producer, the FAST softmax)
Y, N = True, False
VARIANTS = {
    "carry": (128, 3, 232, 40, 1, N, N),        # D = 128's design at D = 64
    "carry_fast": (128, 3, 232, 40, 1, N, Y),
    "deep_ring": (128, 4, 232, 40, 1, N, N),    # a fourth stage
    "two_blocks": (64, 2, 104, 24, 2, N, N),    # two blocks an SM, setmaxnreg
    "two_blocks_fast": (64, 2, 104, 24, 2, N, Y),
    "slim2": (64, 2, 0, 0, 2, Y, N),            # two blocks, 288 threads, 112 registers each
    "slim2_fast": (64, 2, 0, 0, 2, Y, Y),       # the port's default
    "slim2_fast_3st": (64, 3, 0, 0, 2, Y, Y),
}
SHAPES = {  # name: (b, h, d, sq, sk, causal)
    "whisper encoder": (8, 16, 64, 1500, 1500, False),
    "whisper cross train": (8, 16, 64, 448, 1500, False),
    "whisper decoder train": (8, 16, 64, 448, 448, True),
}


def build(names) -> dict:
    """name -> (loaded library, ptxas lines of flash_wgmma_kernel<64>) of
    the variants that build and whose registers fit; any other is reported
    and left out."""
    src = _build.CSRC / "flash_attention.cu"
    procs = {}
    for name in names:
        out = ROOT / "build" / "flash_d64_sweep" / name
        out.mkdir(parents=True, exist_ok=True)
        shape = ", ".join(str(x).lower() if isinstance(x, bool) else str(x)
                          for x in VARIANTS[name])
        header = out / "shape.h"
        header.write_text(f"#define FLASH_D64_SHAPE {shape}\n")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-include", str(header),
               "-o", str(out / "libflash_attention.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "built": False, "log": log[-3000:]}), flush=True)
            continue
        info, regs = "not reported", None
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "flash_wgmma_kernelILi64E" in line:
                info = " | ".join(x.strip() for x in lines[i + 1:i + 4])
                m = re.search(r"Used (\d+) registers", info)
                regs = int(m.group(1)) if m else None
                break
        # ptxas's notes on the kernel, such as wgmma serialised (C7515)
        notes = [x.strip() for x in lines if "flash_wgmma_kernelILi64E" in x
                 and "Compiling entry" not in x and "Function properties" not in x]
        if notes:
            info += " | " + " | ".join(notes)
        _bn, _st, creg, preg, _blocks, slim, _fast = VARIANTS[name]
        # setmaxnreg.inc waits for registers that setmaxnreg.dec has freed:
        # the consumers' rise must fit in what the producer gives back
        if regs is None or (not slim and (regs - preg) * 128 < (creg - regs) * 256):
            print(json.dumps({"variant": name, "built": True, "run": False, "ptxas": info}),
                  flush=True)
            continue
        lib = ctypes.CDLL(str(ROOT / "build" / "flash_d64_sweep" / name
                              / "libflash_attention.so"))
        FA._bind(lib)
        libs[name] = (lib, info)
    return libs


def run(lib, q, k, v, causal: bool) -> torch.Tensor:
    """One launch of ``lib``'s flash_attention entry, as the port's wrapper
    makes it (``FA._run``)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                              1, b, hq, hkv, sq, sk, d, causal, 0, sk - sq, 1.0 / d ** 0.5,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--decode-splits", nargs="*", type=int, default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_d64_sweep: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    libs = build(args.variants)
    bad = len(args.variants) - len(libs)
    for name, (_lib, regs) in libs.items():
        print(json.dumps({"variant": name, "shape": VARIANTS[name], "ptxas": regs}), flush=True)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(64)
    for label, (b, h, d, sq, sk, causal) in SHAPES.items():
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
                   for sh in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))
        flops, nbytes = FA.work(q, k, v, causal, 0, -1)
        bound, by = cs._bound_ms(nbytes, flops, torch.bfloat16)
        # yardstick only: the library's fused attention on the same inputs,
        # its device time where its kernels' names read as flash, else
        # CUDA events
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        sdpa_dev, sdpa_names = cs.device_ms(sdpa, "flash", flush)
        sdpa_events = cs.cuda_ms(sdpa, flush=flush)
        errs, times = {}, {n: [] for n in libs}
        for name, (lib, _regs) in libs.items():
            want = FA.flash_attention_tiled(q, k, v, causal=causal, bk=VARIANTS[name][0],
                                            slack=8.0 if VARIANTS[name][6] else 0.0)
            got = run(lib, q, k, v, causal)
            torch.cuda.synchronize()
            ok, err, _, _ = cs.within(got, want, cs.FLASH_BF16_TOL)
            errs[name] = (ok, err)
            bad += not ok
            del want, got
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                lib = libs[name][0]
                times[name].append(cs.device_ms(lambda: run(lib, q, k, v, causal), "flash",
                                                flush)[0])
        for name in libs:
            ms = [t for t in times[name] if t is not None]
            print(json.dumps({"variant": name, "shape": label, "ok": errs[name][0],
                              "max_abs_err": errs[name][1], "device_ms": times[name],
                              "device_ms_median": statistics.median(ms) if ms else None,
                              "sdpa_device_ms": sdpa_dev, "sdpa_event_ms": sdpa_events,
                              "sdpa_kernels": [cs._short(n) for n in sdpa_names],
                              "bound_ms": bound, "bound_by": by,
                              "tflops": flops / 1e9 / statistics.median(ms) if ms else None,
                              "card": smi}), flush=True)
        del q, k, v
    bad += decode_splits(args.decode_splits, smi, flush, gen)
    return 1 if bad else 0


def decode_splits(splits, smi, flush, gen) -> int:
    """flash_decode at Whisper's cross read at each split size; returns the
    number of splits whose output disagrees with the plain version."""
    b, hq, hkv, sk, d = 8, 16, 16, 1500, 64
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    want = FA.flash_decode_torch(q.float(), k.float(), v.float(), causal=False)
    work = FA.work_decode(q, k, v, False, 0, -1)
    bound, by = cs._bound_ms(work.bytes, work.flops, torch.bfloat16)
    lib = _build.library("flash_attention", FA._bind)
    counters = torch.zeros(b * hkv, dtype=torch.int32, device="cuda")
    bad = 0
    for split in splits:
        n_splits = -(-sk // split)

        def call():
            pa = torch.empty((b, hkv, n_splits, 1, d), dtype=torch.float32, device="cuda")
            pm = torch.empty((b, hkv, n_splits, 1, 2), dtype=torch.float32, device="cuda")
            out = torch.empty_like(q)
            err = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   pa.data_ptr(), pm.data_ptr(), counters.data_ptr(), 1, b, hkv,
                                   1, d, k.stride(0), k.stride(1), k.stride(2), 0, sk, split,
                                   n_splits, 1.0 / d ** 0.5,
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"flash_decode launch failed: cudaError_t {err}")
            return out

        ok, err, _, _ = cs.within(call(), want, cs.PAGED_BF16_TOL)
        bad += not ok
        dev, names = cs.device_ms(call, "flash", flush)
        print(json.dumps({"decode_split": split, "splits": n_splits, "ok": ok,
                          "max_abs_err": err, "device_ms": dev,
                          "kernels": {cs._short(n): t for n, t in names.items()},
                          "bound_ms": bound, "bound_by": by, "card": smi}), flush=True)
    return bad


if __name__ == "__main__":
    sys.exit(main())
