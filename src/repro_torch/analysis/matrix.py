"""The audit matrix: one definition of the smoke grid (port of
``repro/analysis/matrix.py``).

The three statistics passes (``plan_audit``, ``memory_audit``,
``cost_audit``) walk the same (arch x dtype x kind x bucket x forced decode
kernel) grid, defined once here:

- the smoke constants (``SMOKE_ARCHS`` / ``SMOKE_DTYPES`` /
  ``SMOKE_BUCKETS`` / ``PAGE_SIZE`` / ``POOL_ARENAS`` / ``REPORT_PATH``);
- :func:`smoke_cells`, the canonical cell iterator — decode cells under
  both forced physical operators, prefill cells only for handoff-capable
  families, each yielded as a :class:`Cell` on a ``device`` (default
  ``"cuda"``: the card's path, traced with fake tensors, so no card and no
  weights are needed);
- :func:`merge_report`, the shared report writer: every pass lands its
  section(s) in ``build/ANALYSIS_report_torch.json`` in place, preserving
  what the other passes wrote (and surviving a corrupt or non-dict file).
  The root ``ANALYSIS_report.json`` is the reference's and is never
  written here.

Import-light on purpose: the model registry, no tracing machinery.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model

# one arch per serving family (attention / SSD / RG-LRU hybrid), both
# serving dtypes, two buckets spanning the pow2 grid
SMOKE_ARCHS = ("yi-6b-smoke", "mamba2-1.3b-smoke", "recurrentgemma-2b-smoke")
SMOKE_DTYPES = ("bfloat16", "float32")
SMOKE_BUCKETS = ((1, 64), (4, 128))
PAGE_SIZE = 64
POOL_ARENAS = 4            # what PlanServer provisions by default
# beside the kernel builds, under the repository root's build/
REPORT_PATH = str(Path(__file__).resolve().parents[3] / "build" / "ANALYSIS_report_torch.json")
DEVICE = "cuda"            # the card's path, on fake tensors

# decode cells are audited under both forced physical operators so every
# read path is traced and asserted; prefill has no decode-attention
# operator to choose
DECODE_KERNELS = ("paged", "gather")


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a serving dtype name."""
    return torch.float32 if dtype == "float32" else torch.bfloat16


@dataclass(frozen=True)
class Cell:
    """One audit-matrix cell: the coordinates every pass keys records by.
    ``where`` is the reference's label (the device is not part of it)."""

    arch: str
    dtype: str
    kind: str                  # "decode" | "prefill"
    batch: int
    seq: int
    forced_kernel: str = "auto"
    device: str = DEVICE

    @property
    def where(self) -> str:
        w = f"{self.arch}/{self.dtype}/{self.kind}/b{self.batch}s{self.seq}"
        if self.kind == "decode" and self.forced_kernel != "auto":
            w += f"/{self.forced_kernel}"
        return w


def supports_prefill(arch: str, dtype: str) -> bool:
    """Whether the family prefills in-band (modality frontends hand off)."""
    return build_model(get_config(arch), dtype=torch_dtype(dtype)).supports_handoff


def smoke_cells(archs: Sequence[str] = SMOKE_ARCHS,
                dtypes: Sequence[str] = SMOKE_DTYPES,
                buckets: Sequence[Tuple[int, int]] = SMOKE_BUCKETS,
                kinds: Sequence[str] = ("decode", "prefill"),
                kernels: Sequence[str] = DECODE_KERNELS,
                device: str = DEVICE) -> Iterator[Cell]:
    """The canonical enumeration every audit pass walks."""
    for arch in archs:
        for dtype in dtypes:
            for kind in kinds:
                if kind == "prefill" and not supports_prefill(arch, dtype):
                    continue   # modality frontends prefill out of band
                cell_kernels = kernels if kind == "decode" else ("auto",)
                for batch, seq in buckets:
                    for dk in cell_kernels:
                        yield Cell(arch, dtype, kind, batch, seq, dk, device)


def matrix_meta(archs: Sequence[str] = SMOKE_ARCHS,
                dtypes: Sequence[str] = SMOKE_DTYPES,
                buckets: Sequence[Tuple[int, int]] = SMOKE_BUCKETS,
                **extra: Any) -> Dict[str, Any]:
    """The ``matrix`` header each pass embeds in its report section."""
    meta: Dict[str, Any] = {
        "archs": list(archs),
        "dtypes": list(dtypes),
        "buckets": [list(b) for b in buckets],
    }
    meta.update(extra)
    return meta


def merge_report(path: str, updates: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``updates`` into the shared analysis report, preserving every
    section some other pass wrote. A corrupt, unreadable or non-dict file
    on disk is replaced rather than crashing the gate — the report is
    evidence, not state the auditors depend on. Returns the merged document
    (what now sits on disk)."""
    p = Path(path)
    report: Dict[str, Any] = {}
    if p.exists():
        try:
            prior = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            prior = None
        if isinstance(prior, dict):
            report = prior
    report.update(updates)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(report, indent=2))
    return report
