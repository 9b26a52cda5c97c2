"""Analysis passes of the PyTorch port (port of ``repro/analysis``):

- :mod:`repro_torch.analysis.plan_audit`, :mod:`~repro_torch.analysis.memory_audit`
  and :mod:`~repro_torch.analysis.cost_audit` trace every compiled decode and
  prefill step of the audit matrix (:mod:`~repro_torch.analysis.matrix`) into
  an aten graph on fake tensors — on a fake ``cuda`` device by default, the
  card's path, each kernel one custom-op node — and check the planner's
  memory and cost statistics, the in-place cache update and the kernel
  choices against it; on the card the memory auditor also holds measured
  peaks against the traced floor and the plan's estimate;
- :mod:`repro_torch.analysis.lint`: AST rules for the runtime's conventions;
- :mod:`repro_torch.analysis.sanitize`: per-tick recounts of the live pool,
  engine and router (``EngineConfig(sanitize=True)``).

This ``__init__`` stays import-light: ``runtime.engine`` imports the
sanitizer, and the auditors import the runtime, so nothing here may import
either.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class Finding:
    """One analysis finding, shared by all passes.

    ``rule`` is the stable identifier (what waivers and tests key on),
    ``where`` locates it (an object path for the sanitizer), and ``detail``
    is the human-readable explanation."""

    rule: str
    where: str
    detail: str
    data: Dict = field(default_factory=dict, compare=False)

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.detail}"
