"""Analysis passes of the PyTorch port (port of ``repro/analysis``).

So far the runtime sanitizer (:mod:`repro_torch.analysis.sanitize`), which
the serving engine and the router run under ``EngineConfig(sanitize=True)``; the linter
and the plan, memory and cost auditors come with ``ROADMAP.md`` Queue A 12.

This ``__init__`` stays import-light: ``runtime.engine`` imports the
sanitizer, so nothing here may import the runtime.
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
