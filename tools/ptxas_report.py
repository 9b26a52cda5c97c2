"""Registers, stack and spills of every kernel of the port's CUDA sources, as
``ptxas -v`` reports them for ``sm_90a``.

    python3 tools/ptxas_report.py [--sources flash_attention paged_decode ...]

Compiles each ``src/repro_torch/kernels/csrc/<name>.cu`` (all of them by
default) with the port's own nvcc flags (``kernels/_build.py``) plus
``-Xptxas -v``, one nvcc process per source, all at once, into a scratch
directory under ``build/`` (gitignored), and prints one line per kernel
instantiation: registers, stack frame and spill bytes, demangled where
``c++filt`` is present. Needs nvcc (the machine with the card); exits
non-zero if a source does not compile.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")


def parse(log: str):
    """(mangled name, registers, stack bytes, spill store bytes, spill load
    bytes) per kernel entry in a ``ptxas -v`` log."""
    out, name, frame = [], None, (0, 0, 0)
    for line in log.splitlines():
        if m := ENTRY.search(line):
            name, frame = m.group(1), (0, 0, 0)
        elif (m := FRAME.search(line)) and name:
            frame = tuple(int(g) for g in m.groups())
        elif (m := USED.search(line)) and name:
            out.append((name, int(m.group(1)), *frame))
            name = None
    return out


def demangle(names):
    if not names or shutil.which("c++filt") is None:
        return list(names)
    res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    got = res.stdout.splitlines()
    return [re.sub(r"\(anonymous namespace\)::|void ", "", g).split("(")[0] for g in got] \
        if len(got) == len(names) else list(names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", nargs="*", default=None,
                    help="source stems under csrc/ (default: every .cu)")
    args = ap.parse_args()
    stems = args.sources or [p.stem for p in sorted(_build.CSRC.glob("*.cu"))]
    out_dir = ROOT / "build" / "ptxas_report"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = []
    for stem in stems:
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out_dir / f"lib{stem}.so"),
               str(_build.CSRC / f"{stem}.cu")]
        procs.append((stem, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    failed = False
    for stem, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{stem}: nvcc exit {proc.returncode}\n{log}")
            failed = True
            continue
        rows = parse(log)
        print(f"== {stem}.cu: {len(rows)} kernels")
        for name, (_m, regs, stack, st, ld) in zip(demangle([r[0] for r in rows]), rows):
            print(f"  {name}: {regs} registers, {stack} bytes stack, spill {st} stores / "
                  f"{ld} loads")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
