"""Build and load the port's CUDA kernels (nvcc into shared libraries + ctypes).

Every ``csrc/*.cu`` source compiles to its own shared library with a plain C
interface — no PyTorch headers, so one source takes seconds, not minutes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

All sources build together, one ``nvcc`` process each, at the first call of
:func:`library` in a process. The outputs land in
``build/repro_torch_kernels/<hash of the sources>/`` at the repository root,
so an edited source rebuilds and an unchanged one is reused. A failed build
raises with the compiler's output; nothing falls back to a plain version.
Each C entry point returns its ``cudaError_t`` (0 on success), which the
kernel wrappers check after every launch.

Each kernel is a ``torch.library`` custom op, ``repro_torch::<name>``
(:func:`kernel_op`): its CPU implementation is the plain version, its CUDA
implementation the launch through ctypes, and its fake implementation gives
the output's shape, dtype and device only, so ``make_fx`` and
``FakeTensorMode`` trace each kernel as one graph node, on a fake ``cuda``
device too (``repro_torch.analysis``). Beside each op, :data:`WORK` holds
its ``work(...)``: the FLOPs and bytes one call must do and move, read by the
cost audit and by ``chip_smoke.py``'s bounds.

Each public wrapper counts its launches in ``fn.launches`` and registers
itself in :data:`COUNTED` through :func:`counted`; a CUDA graph's capture and
replays adjust the counts of every registered wrapper
(``runtime/graph_step.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

# every kernel wrapper that counts its launches in ``fn.launches``
COUNTED: List[Callable] = []

NAMESPACE = "repro_torch"


class Work(NamedTuple):
    """What one kernel call must do: its FLOPs, and the bytes it must move
    (each input read once, each output written once)."""

    flops: float
    bytes: float


# "repro_torch::<name>" -> the op's work(...), called with the op's own
# arguments (real or fake tensors)
WORK: Dict[str, Callable[..., Work]] = {}


def counted(fn: Callable) -> Callable:
    """Registers ``fn`` as a kernel wrapper that adds one to
    ``fn.launches`` where it launches its kernel; the count starts at 0."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def kernel_op(name: str, work: Callable[..., Work], launch: Callable,
              fake: Callable) -> Callable:
    """Decorator: the annotated plain function becomes the custom op
    ``repro_torch::<name>`` (no argument mutated; every kernel writes only
    outputs it allocates) with the plain function as its CPU
    implementation, ``launch`` as its CUDA implementation and ``fake`` as
    its fake implementation; ``work`` goes into :data:`WORK`. Returns the
    op, called like the plain function."""
    def wrap(plain: Callable) -> Callable:
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", plain, mutates_args=(),
                                     device_types="cpu")
        op.register_kernel("cuda")(launch)
        op.register_fake(fake)
        WORK[f"{NAMESPACE}::{name}"] = work
        return op
    return wrap


def require_cpu_or_cuda(t: torch.Tensor, what: str) -> None:
    """A wrapper runs its plain version on a CPU tensor and its kernel on a
    CUDA tensor (real or fake); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA tensors, got {t.device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def build_dir() -> Path:
    """Output directory keyed by a hash of every source and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source not yet built, all ``nvcc`` processes at once.
    Returns the build directory; raises if any compile fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu`` (every source
    is built on the first call in a process). ``bind`` declares the entry
    points' argtypes/restype once, at load — ctypes would otherwise pass
    every argument as a 32-bit int and cut the pointers."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out = build_all()
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            bind(lib)
            _LIBS[name] = lib
        return lib
