"""Architecture registry: ``--arch <id>`` resolves through here.

A copy of ``repro.configs`` (the port imports nothing of the JAX package);
``tests/test_torch_boundaries.py`` holds every config equal to the original.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig, reduced_config

# arch id -> module name
_ARCH_MODULES = {
    "whisper-medium": "whisper_medium",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama3-405b": "llama3_405b",
    "yi-6b": "yi_6b",
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "dbrx-132b": "dbrx_132b",
    "internvl2-2b": "internvl2_2b",
    "granite-8b": "granite_8b",
    "phi3-medium-14b": "phi3_medium_14b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return reduced_config(get_config(arch[: -len("-smoke")]))
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.make_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
