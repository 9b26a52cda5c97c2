"""Variants of the head-dim-128 attention backward (the TMA + wgmma passes of
``csrc/flash_attention_bwd.cu``), timed side by side on the card at the
training shapes that run them.

    python3 tools/flash_bwd_sweep.py [--variants port exp2f dq_128_keys ...]

Each variant is the port's source with a few lines replaced (``VARIANTS``:
the exponential, the products' grouping, the ring depths, the dQ pass's key
tile, the register split). This tool writes each one under
``build/flash_bwd_sweep/<variant>/`` (gitignored), compiles them all at once
with the port's nvcc flags, ``-Xptxas -v`` and the source directory on the
include path, and prints the registers, spills and ptxas notes (such as
wgmma serialised, C7511) of the two wgmma kernels. Then, at Yi-6B's (4,
2048, 32/4 heads), InternVL2-2B's (4, 2304, 16/8) and Qwen3-MoE's (4, 2048,
64/4) causal training shapes, bfloat16 inputs from a fixed seed and the
port's training forward's out and lse: each variant's gradients held
against ``attention_bwd_tiled`` under ``chip_smoke.py``'s ``_bwd_tol``,
then its profiler device time per call with the L2 flushed
(``chip_smoke.device_ms``), the variants in turns (forward order, then
reversed). One JSON line per variant and shape, with the card's name and
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

DKDV = "static constexpr int BN = 128, BM = 64, STAGES = 2;"
DQ = "static constexpr int BM = 128, BN = 64, STAGES = 2;"
# name: {text of the port's source: its replacement}, every occurrence
VARIANTS = {
    "port": {},
    # 2^x by exp2f (a range check and two scalings around ex2.approx)
    "exp2f": {"ex2_ftz(fmaf(": "exp2f(fmaf("},
    # a tile's S and dP in one group, the exponentials after both
    "one_group": {"      wgmma_commit();\n      product_ss(dp, ": "      product_ss(dp, ",
                  "      wgmma_wait<1>();\n      fence_regs(s);":
                      "      wgmma_wait<0>();\n      fence_regs(s);"},
    "dkdv_3_stages": {DKDV: DKDV.replace("STAGES = 2", "STAGES = 3")},
    "dkdv_4_stages": {DKDV: DKDV.replace("STAGES = 2", "STAGES = 4")},
    "dq_3_stages": {DQ: DQ.replace("STAGES = 2", "STAGES = 3")},
    "dq_128_keys": {DQ: DQ.replace("BN = 64", "BN = 128")},
    "regs_232_40": {"constexpr int CONSUMER_REGS = 240;": "constexpr int CONSUMER_REGS = 232;",
                    "constexpr int PRODUCER_REGS = 24;": "constexpr int PRODUCER_REGS = 40;"},
}
SHAPES = {  # name: (b, hq, hkv, s), causal, D = 128
    "Yi-6B (4, 2048, 32/4)": (4, 32, 4, 2048),
    "InternVL2-2B (4, 2304, 16/8)": (4, 16, 8, 2304),
    "Qwen3-MoE (4, 2048, 64/4)": (4, 64, 4, 2048),
}
KERNELS = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")


def build(names) -> dict:
    """name -> (loaded library, ptxas lines of the two wgmma kernels) of the
    variants that build; any other is reported and left out."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name].items():
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        out = ROOT / "build" / "flash_bwd_sweep" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "flash_attention_bwd.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-o", str(out / "libflash_attention_bwd.so"), str(out / "flash_attention_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "built": False, "log": log[-3000:]}), flush=True)
            continue
        lines = log.splitlines()
        info = {}
        for kernel in KERNELS:
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and kernel in line:
                    info[kernel] = " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                              if re.search(r"registers|spill", x))
            notes = [x.strip() for x in lines if kernel in x and re.search(r"\(C75\d\d\)", x)]
            if notes:
                info[kernel] = info.get(kernel, "") + " | " + " | ".join(
                    re.sub(r" in function .*", "", n) for n in notes)
        lib = ctypes.CDLL(str(ROOT / "build" / "flash_bwd_sweep" / name
                              / "libflash_attention_bwd.so"))
        FA._bind_bwd(lib)
        libs[name] = (lib, info)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    libs = build(args.variants)
    bad = len(args.variants) - len(libs)
    for name, (_lib, info) in libs.items():
        print(json.dumps({"variant": name, "ptxas": info}), flush=True)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(33)
    for label, (b, hq, hkv, s) in SHAPES.items():
        q, k, v, dout = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
                         for sh in ((b, hq, s, 128), (b, hkv, s, 128), (b, hkv, s, 128),
                                    (b, hq, s, 128)))
        out, lse = FA.flash_attention_train(q, k, v, causal=True)
        args_ = (q, k, v, out, lse, dout)
        flops, nbytes = FA.work_bwd(*args_, True, 0, -1)
        bound, by = cs._bound_ms(nbytes, flops, torch.bfloat16)
        want = FA.attention_bwd_tiled(*args_, causal=True)
        checks, times = {}, {n: [] for n in libs}

        def call():
            return FA.flash_attention_bwd(*args_, causal=True)

        for name, (lib, _info) in libs.items():
            _build._LIBS["flash_attention_bwd"] = lib
            got = call()
            res = [cs.within(g, w, cs._bwd_tol(w, torch.bfloat16, False))
                   for g, w in zip(got, want)]
            checks[name] = (all(r[0] for r in res), max(r[1] for r in res))
            bad += not checks[name][0]
            del got
        del want
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                _build._LIBS["flash_attention_bwd"] = libs[name][0]
                times[name].append(cs.device_ms(call, "flash_bwd", flush))
        for name in libs:
            ms = [t for t, _ in times[name] if t is not None]
            print(json.dumps({
                "variant": name, "shape": label, "ok": checks[name][0],
                "max_abs_err": checks[name][1], "device_ms": [t for t, _ in times[name]],
                "device_ms_median": statistics.median(ms) if ms else None,
                "kernels": [{cs._short(n): round(t, 4) for n, t in kn.items()}
                            for _, kn in times[name]],
                "bound_ms": bound, "bound_by": by, "card": smi}), flush=True)
        del q, k, v, dout, out, lse, args_
        torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
