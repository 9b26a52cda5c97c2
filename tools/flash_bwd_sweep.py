"""Variants of the attention backward's passes (the bfloat16 TMA + wgmma
passes and the float32 3xTF32 passes of ``csrc/flash_attention_bwd.cu``),
timed side by side on the card at the training shapes that run them.

    python3 tools/flash_bwd_sweep.py [--variants port d256_splits_1 d64_c2 ...]
        [--shapes ...] [--dtype {bfloat16,float32}]

Each variant is the port's source with a few lines replaced (``VARIANTS``:
the per-head-dim shapes ``hb::Shape<D>`` or ``f3::Shape<D>``, the
exponential), and may also change the wrapper's settings in
``kernels/flash_attention.py`` (the dK/dV pass's query-head splits, the
tiles its checks read). This tool writes each one under
``build/flash_bwd_sweep/<variant>/`` (gitignored), compiles them all at once
with the port's nvcc flags, ``-Xptxas -v`` and the source directory on the
include path, and prints the registers, spills and ptxas notes (such as
wgmma serialised, C7511) of the dK/dV and dQ kernels. Then at each training
shape of the dtype (``--dtype``, bfloat16 by default) and of the head dims a
variant changes, inputs from a fixed seed and the port's training forward's
out and lse: bfloat16 at D = 128 Yi-6B's (4, 2048, 32/4 heads),
InternVL2-2B's (4, 2304, 16/8), Qwen3-MoE's (4, 2048, 64/4), causal; D =
256 RecurrentGemma-2B's (4, 2048, 10/1, window 2048); D = 64
Whisper-medium's encoder (8, 1500, 16/16, bidirectional), decoder (8, 448,
causal) and cross (448 x 1500) shapes; float32 the train-check twins'
attention (2, 512: Yi-6B's 32/4 heads of 128 causal, RecurrentGemma-2B's
10/1 of 256 under its window; Whisper-medium's encoder over 1500 frames)
and Yi-6B's (4, 2048). Each variant's gradients are held against
``attention_bwd_tiled`` (bfloat16) or the plain rule ``attention_bwd_torch``
(float32) under ``chip_smoke.py``'s ``_bwd_tol``, and two calls must give the
same bits; then its profiler device time per call with the L2 flushed
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

PORT_SHAPES = {64: "3, 160, 192, 3, true, 3, false",
               128: "2, 240, 128, 2, false, 2, false",
               256: "2, 240, 64, 2, false, 3, true"}
# f3::Shape<D>: the dK/dV pass's (keys a block, query rows a tile, stages,
# m-tiles a warp) and the dQ pass's (query rows a block, keys a tile,
# stages, m-tiles a warp)
FP32_PORT_SHAPES = {32: "128, 64, 2, 1, 128, 64, 2, 1", 64: "128, 64, 2, 2, 128, 64, 2, 2",
                    128: "64, 64, 2, 2, 128, 64, 1, 1", 256: "32, 64, 1, 1, 32, 64, 1, 1"}


def shape(d: int, args: str, ports=PORT_SHAPES) -> dict:
    """The text substitution that gives hb::Shape<d> (or, with ports =
    FP32_PORT_SHAPES, f3::Shape<d>) these arguments (hb: consumers, their
    registers; the dK/dV pass's keys a block, stages, DEFER_DV; the dQ
    pass's ring depth, APART)."""
    line = "template <> struct Shape<{}> : ShapeOf<{}> {{}};"
    return {line.format(d, ports[d]): line.format(d, args)}


def fp32_shape(d: int, args: str) -> dict:
    return shape(d, args, FP32_PORT_SHAPES)


BF, F32 = torch.bfloat16, torch.float32
# name: (dtype, head dims it changes, {text of the port's source: its
# replacement}, {wrapper setting: {head dim: value}})
VARIANTS = {
    "port": (BF, (64, 128, 256), {}, {}),
    # D = 256: the dK/dV pass's query heads in one block a kv head, or up
    # to three; dV's product deferred until dS^T is formed
    "d256_splits_1": (BF, (256,), {}, {"BWD_KV_SPLITS": {256: 1}}),
    "d256_splits_3": (BF, (256,), {}, {"BWD_KV_SPLITS": {256: 3}}),
    "d256_defer_dv": (BF, (256,), shape(256, "2, 240, 64, 2, true, 3, true"), {}),
    # D = 64: two consumers at 240 registers (128 keys or rows a block)
    # without and with dV's product deferred; three with two-stage rings
    "d64_c2": (BF, (64,), shape(64, "2, 240, 128, 2, false, 2, false"),
               {"BWD_WGMMA_DKDV": {64: (128, 64, 2)}, "BWD_WGMMA_DQ": {64: (128, 64, 2)}}),
    "d64_c2_defer_dv": (BF, (64,), shape(64, "2, 240, 128, 2, true, 2, false"),
                        {"BWD_WGMMA_DKDV": {64: (128, 64, 2)},
                         "BWD_WGMMA_DQ": {64: (128, 64, 2)}}),
    "d64_c3_2_stages": (BF, (64,), shape(64, "3, 160, 192, 2, true, 2, false"),
                        {"BWD_WGMMA_DKDV": {64: (192, 64, 2)},
                         "BWD_WGMMA_DQ": {64: (192, 64, 2)}}),
    # D = 128: dV's product deferred
    "d128_defer_dv": (BF, (128,), shape(128, "2, 240, 128, 2, true, 2, false"), {}),
    # every head dim: 2^x by exp2f (a range check and two scalings around
    # ex2.approx)
    "exp2f": (BF, (64, 128, 256), {"ex2_ftz(fmaf(": "exp2f(fmaf("}, {}),
    # float32 (3xTF32): the port; the dK/dV pass's query heads in one block
    # a kv head (no waves wanted), or split where the blocks would not fill
    # the card once (rather than twice)
    "fp32_port": (F32, (32, 64, 128, 256), {}, {}),
    "fp32_no_split": (F32, (64, 128, 256), {}, {"BWD_KV_WAVES": 0}),
    "fp32_one_wave": (F32, (64, 128, 256), {}, {"BWD_KV_WAVES": 1}),
    # D = 128: one m-tile a warp in the dK/dV pass; two in the dQ pass (at
    # 128 rows a block, or at 64 with a two-stage ring); 32-key dK/dV
    # blocks (two key groups, four parts); 32-row query tiles; a one-stage
    # dK/dV ring; 64-row dQ blocks with a two-stage ring
    "fp32_d128_kv_m1": (F32, (128,), fp32_shape(128, "64, 64, 2, 1, 128, 64, 1, 1"), {}),
    "fp32_d128_dq_m2": (F32, (128,), fp32_shape(128, "64, 64, 2, 2, 128, 64, 1, 2"), {}),
    "fp32_d128_dq_bm64_m2": (F32, (128,), fp32_shape(128, "64, 64, 2, 2, 64, 64, 2, 2"),
                             {"BWD_FP32_DQ": {128: (64, 64, 2)}}),
    "fp32_d128_kv_bn32": (F32, (128,), fp32_shape(128, "32, 64, 2, 1, 128, 64, 1, 1"),
                          {"BWD_FP32_DKDV": {128: (32, 64, 2)}}),
    "fp32_d128_kv_bm32": (F32, (128,), fp32_shape(128, "64, 32, 2, 2, 128, 64, 1, 1"),
                          {"BWD_FP32_DKDV": {128: (64, 32, 2)}}),
    "fp32_d128_kv_1_stage": (F32, (128,), fp32_shape(128, "64, 64, 1, 2, 128, 64, 1, 1"),
                             {"BWD_FP32_DKDV": {128: (64, 64, 1)}}),
    "fp32_d128_dq_bm64": (F32, (128,), fp32_shape(128, "64, 64, 2, 2, 64, 64, 2, 1"),
                          {"BWD_FP32_DQ": {128: (64, 64, 2)}}),
    # D = 64: one m-tile a warp; 64-key dK/dV blocks and 64-row dQ blocks
    # (four key or row groups, two parts)
    "fp32_d64_m1": (F32, (64,), fp32_shape(64, "128, 64, 2, 1, 128, 64, 2, 1"), {}),
    "fp32_d64_64": (F32, (64,), fp32_shape(64, "64, 64, 2, 1, 64, 64, 2, 1"),
                    {"BWD_FP32_DKDV": {64: (64, 64, 2)}, "BWD_FP32_DQ": {64: (64, 64, 2)}}),
    # D = 256: 64-row dQ blocks with 32-key tiles; two m-tiles a warp in
    # the dQ pass
    "fp32_d256_dq_bm64": (F32, (256,), fp32_shape(256, "32, 64, 1, 1, 64, 32, 1, 1"),
                          {"BWD_FP32_DQ": {256: (64, 32, 1)}}),
    "fp32_d256_dq_m2": (F32, (256,), fp32_shape(256, "32, 64, 1, 1, 32, 64, 1, 2"), {}),
}
SHAPES = {  # name: (dtype, b, hq, hkv, d, sq, sk, causal, window)
    "Yi-6B (4, 2048, 32/4)": (BF, 4, 32, 4, 128, 2048, 2048, True, 0),
    "InternVL2-2B (4, 2304, 16/8)": (BF, 4, 16, 8, 128, 2304, 2304, True, 0),
    "Qwen3-MoE (4, 2048, 64/4)": (BF, 4, 64, 4, 128, 2048, 2048, True, 0),
    "RecurrentGemma-2B (4, 2048, 10/1, window 2048)": (BF, 4, 10, 1, 256, 2048, 2048, True, 2048),
    "Whisper-medium encoder (8, 1500, 16/16)": (BF, 8, 16, 16, 64, 1500, 1500, False, 0),
    "Whisper-medium decoder (8, 448, 16/16, causal)": (BF, 8, 16, 16, 64, 448, 448, True, 0),
    "Whisper-medium cross (8, 448 x 1500, 16/16)": (BF, 8, 16, 16, 64, 448, 1500, False, 0),
    "float32 Yi-6B train-check (2, 512, 32/4)": (F32, 2, 32, 4, 128, 512, 512, True, 0),
    "float32 RecurrentGemma-2B train-check (2, 512, 10/1, window 2048)":
        (F32, 2, 10, 1, 256, 512, 512, True, 2048),
    "float32 Whisper-medium train-check encoder (2, 1500, 16/16)":
        (F32, 2, 16, 16, 64, 1500, 1500, False, 0),
    "float32 Yi-6B (4, 2048, 32/4)": (F32, 4, 32, 4, 128, 2048, 2048, True, 0),
}
KERNELS = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
           "flash_bwd_dkdv_tf32x3_kernel", "flash_bwd_dq_tf32x3_kernel")
SETTINGS = ("BWD_KV_SPLITS", "BWD_WGMMA_DKDV", "BWD_WGMMA_DQ", "BWD_FP32_DKDV", "BWD_FP32_DQ",
            "BWD_KV_WAVES")
PORT = {name: getattr(FA, name) for name in SETTINGS}


def apply(name: str) -> None:
    """The wrapper's settings as the variant has them (the port's where it
    changes none)."""
    for setting in SETTINGS:
        value = VARIANTS[name][3].get(setting, PORT[setting])
        if isinstance(value, dict):
            value = {**PORT[setting], **value}
        setattr(FA, setting, value)


def build(names) -> dict:
    """name -> (loaded library, ptxas lines of the wgmma kernels) of the
    variants that build; any other is reported and left out."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][2].items():
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
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m and any(k in m.group(1) for k in KERNELS):
                kernel = next(k for k in KERNELS if k in m.group(1))
                d = re.search(r"ILi(\d+)E", m.group(1))
                key = f"{kernel}<{d.group(1) if d else '?'}>"
                info[key] = " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                       if re.search(r"registers|spill", x))
        notes = [re.sub(r" in function .*", "", x.strip()) for x in lines
                 if re.search(r"\(C75\d\d\)", x) and any(k in x for k in KERNELS)]
        if notes:
            info["notes"] = sorted(set(notes))
        lib = ctypes.CDLL(str(ROOT / "build" / "flash_bwd_sweep" / name
                              / "libflash_attention_bwd.so"))
        FA._bind_bwd(lib)
        libs[name] = (lib, info)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=None, choices=list(VARIANTS),
                    help="default: every variant of --dtype")
    ap.add_argument("--shapes", nargs="+", default=None, choices=list(SHAPES),
                    help="default: every shape of --dtype")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    args.variants = args.variants or [n for n, v in VARIANTS.items() if v[0] == dtype]
    args.shapes = args.shapes or [n for n, v in SHAPES.items() if v[0] == dtype]
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
    for label in args.shapes:
        dt, b, hq, hkv, d, sq, sk, causal, window = SHAPES[label]
        mine = [n for n in libs if VARIANTS[n][0] == dt and d in VARIANTS[n][1]]
        if not mine:
            continue
        mask = dict(causal=causal, window=window, q_offset=-1)
        q, k, v, dout = (torch.randn(sh, generator=gen, device="cuda").to(dt)
                         for sh in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                                    (b, hq, sq, d)))
        out, lse = FA.flash_attention_train(q, k, v, **mask)
        args_ = (q, k, v, out, lse, dout)
        flops, nbytes = FA.work_bwd(*args_, causal, window, -1)
        bound, by = cs._bound_ms(nbytes, flops, dt, tf32x3=True)
        plain = FA.attention_bwd_torch if dt == F32 else FA.attention_bwd_tiled
        checks, times = {}, {n: [] for n in mine}

        def call():
            return FA.flash_attention_bwd(*args_, **mask)

        for name in mine:
            _build._LIBS["flash_attention_bwd"] = libs[name][0]
            apply(name)
            got = call()
            want = plain(*args_, **mask)
            again = call()
            res = [cs.within(g, w, cs._bwd_tol(w, dt, False)) for g, w in zip(got, want)]
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            checks[name] = (all(r[0] for r in res) and same, max(r[1] for r in res))
            bad += not checks[name][0]
            del got, want, again
        for order in (mine, list(reversed(mine))):
            for name in order:
                _build._LIBS["flash_attention_bwd"] = libs[name][0]
                apply(name)
                times[name].append(cs.device_ms(call, "flash_bwd", flush))
        apply("port")
        for name in mine:
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
