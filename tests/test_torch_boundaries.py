"""PyTorch port, package boundaries: the port and ``chip_smoke.py`` import
neither JAX nor the JAX package; the port's copied configs stay equal to
the reference's; entry points refuse to fall back to the CPU silently; and
what this slice does not port yet says so instead of half-working."""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden_imports(text: str):
    """``"line: module"`` for every absolute import of jax, jaxlib or the
    JAX package ``repro`` (``repro_torch`` and relative imports pass)."""
    out = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        out += [f"{node.lineno}: {n}" for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return out


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    assert path.exists(), path
    assert _forbidden_imports(path.read_text()) == []


def test_import_scan_catches_violations():
    text = ("import jax.numpy as jnp\nfrom repro.config import X\n"
            "from repro import kernels\nimport repro_torch\n"
            "from repro_torch.config import ModelConfig\nfrom . import y\n"
            "def f():\n    import jaxlib\n")
    assert _forbidden_imports(text) == ["1: jax.numpy", "2: repro.config",
                                        "3: repro", "8: jaxlib"]


def test_arch_registry_matches_reference():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", [a + s for a in JAX_ARCH_IDS for s in ("", "-smoke")])
def test_config_copy_equals_reference(arch):
    ours, ref = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.layer_pattern() == ref.layer_pattern()


def test_plan_server_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_loop.PlanServer(get_config("yi-6b-smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_loop.resolve_device(None)
    assert serve_loop.resolve_device("cpu") == torch.device("cpu")


def test_unported_parts_raise_and_name_their_slice():
    with pytest.raises(NotImplementedError, match="slice 2"):
        EngineConfig(decode_kernel="auto")
    with pytest.raises(NotImplementedError, match="slice 3"):
        build_model(get_config("recurrentgemma-2b-smoke"))
    assert build_model(get_config("mamba2-1.3b-smoke")).is_ssm   # ported
    with pytest.raises(NotImplementedError, match="slice 6"):
        build_model(get_config("qwen3-moe-235b-a22b-smoke"))
