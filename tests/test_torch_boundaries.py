"""PyTorch port, package boundaries: the port, ``chip_smoke.py`` and the
port's ``tools/`` scripts import neither JAX nor the JAX package; the
port's copied configs stay equal to the reference's; the serving CLI's
defaults are the reference launcher's; entry points refuse to fall back to
the CPU silently; and what this slice does not port yet says so instead of
half-working."""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config_module  # noqa: E402
from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import lenet as jax_lenet  # noqa: E402
from repro.configs import softmax_classifier as jax_softmax  # noqa: E402
from repro_torch import config as port_config_module  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, lenet, softmax_classifier  # noqa: E402
from repro_torch.frontend import Keras2Plan  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))


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


def test_import_scan_covers_the_engine_slice():
    for name in ("runtime/engine.py", "runtime/scheduler.py", "runtime/metrics.py",
                 "runtime/engine_config.py", "analysis/__init__.py", "analysis/sanitize.py",
                 "launch/serve.py", "runtime/router.py", "launch/serve_engine.py",
                 "launch/serve_batched.py", "launch/serve_router.py"):
        assert ROOT / "src" / "repro_torch" / name in PORT_FILES, name


def test_import_scan_covers_the_training_slice():
    for name in ("data/pipeline.py", "checkpoint/checkpoint.py", "core/ir.py",
                 "runtime/train_loop.py", "launch/train.py", "launch/train_lm.py",
                 "launch/quickstart.py"):
        assert ROOT / "src" / "repro_torch" / name in PORT_FILES, name
    assert ROOT / "tools" / "train_init_sweep.py" in PORT_FILES


def test_import_scan_covers_the_multi_device_slice():
    for name in ("core/sharding.py", "core/parfor.py", "core/comm.py", "core/__init__.py",
                 "launch/mesh.py", "launch/ranks.py", "runtime/__init__.py"):
        assert ROOT / "src" / "repro_torch" / name in PORT_FILES, name
    assert ROOT / "tools" / "gloo_cuda_probe.py" in PORT_FILES


@pytest.mark.parametrize("arch", ["mamba2-1.3b-smoke", "recurrentgemma-2b-smoke"])
def test_train_cli_on_the_recurrent_archs_loads_no_jax(arch):
    """The launcher's run of each family that trains since the SSM/hybrid
    slice, in a fresh interpreter: no module of JAX or of the JAX package
    is loaded on its way (the import scan above covers the files; this
    covers what the run pulls in)."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "from repro_torch.launch import train\n"
            f"train.main(['--arch', '{arch}', '--device', 'cpu', '--steps', '1', "
            "'--batch', '2', '--seq', '16'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


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


@pytest.mark.parametrize("name,args", [
    ("INPUT_SHAPES", None), ("SINGLE_POD_MESH", None), ("MULTI_POD_MESH", None),
    ("SINGLE_DEVICE_MESH", None), ("mesh_config", (False,)), ("mesh_config", (True,)),
    ("TrainConfig", ())])
def test_planner_config_copy_equals_reference(name, args):
    """The shapes, meshes and training defaults the planner reads."""
    ours, ref = getattr(port_config_module, name), getattr(jax_config_module, name)
    if args is not None:
        ours, ref = ours(*args), ref(*args)
    if isinstance(ours, dict):
        assert {k: dataclasses.asdict(v) for k, v in ours.items()} == \
            {k: dataclasses.asdict(v) for k, v in ref.items()}
    else:
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        if hasattr(ours, "num_devices"):
            assert (ours.num_devices, ours.data_axes, ours.data_parallelism,
                    ours.model_parallelism) == (ref.num_devices, ref.data_axes,
                                                ref.data_parallelism,
                                                ref.model_parallelism)


def _reference_flags(launcher: str) -> dict:
    """{option: its add_argument call} of a reference launcher's parser,
    read from its source (``repro/launch/<launcher>``), which stays as it
    is."""
    return {node.args[0].value: node
            for node in ast.walk(ast.parse((ROOT / "src/repro/launch" / launcher).read_text()))
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            and node.args and isinstance(node.args[0], ast.Constant)}


def _reference_cli_default(option: str, launcher: str = "serve.py"):
    """The default of ``option`` in the reference launcher's parser (a
    ``store_true`` flag's is False)."""
    node = _reference_flags(launcher).get(option)
    if node is None:
        raise AssertionError(f"{option} not in the reference launcher's parser")
    kws = {kw.arg: kw.value for kw in node.keywords}
    if "default" not in kws and ast.literal_eval(kws["action"]) == "store_true":
        return False
    return ast.literal_eval(kws["default"])


@pytest.mark.parametrize("option,dest", [("--decode-kernel", "decode_kernel"),
                                         ("--cache-capacity", "cache_capacity"),
                                         ("--pool-arenas", "pool_arenas"),
                                         ("--recompile-margin", "recompile_margin")])
def test_serve_cli_plan_cache_defaults_follow_the_reference(option, dest):
    default = getattr(serve_cli.build_parser().parse_args([]), dest)
    assert default == _reference_cli_default(option)
    assert default == getattr(EngineConfig(), dest)


@pytest.mark.parametrize("option", [
    "--batch", "--context", "--pool-max-arenas", "--pool-max-bytes", "--scheduler",
    "--arrival-rate", "--max-group-batch", "--join-mid-decode", "--slo-ms",
    "--bucket-select", "--replicas", "--placement", "--drain-replica", "--eos-id",
    "--cancel-after", "--sanitize"])
def test_serve_cli_engine_defaults_follow_the_reference(option):
    """The single-shot and ``--scheduler`` modes' flags; those that are
    ``EngineConfig`` fields default to its value too."""
    dest = option[2:].replace("-", "_")
    default = getattr(serve_cli.build_parser().parse_args([]), dest)
    assert default == _reference_cli_default(option)
    if dest in {f.name for f in dataclasses.fields(EngineConfig)}:
        assert default == getattr(EngineConfig(), dest)


def test_train_cli_has_the_reference_flags_and_device():
    ours = {a for action in train_cli.build_parser()._actions for a in action.option_strings
            if a.startswith("--")}
    assert ours == set(_reference_flags("train.py")) | {"--device", "--help"}


@pytest.mark.parametrize("option", ["--arch", "--steps", "--batch", "--seq", "--optimizer",
                                    "--lr", "--log-every", "--checkpoint", "--dtype"])
def test_train_cli_defaults_follow_the_reference(option):
    dest = option[2:].replace("-", "_")
    default = getattr(train_cli.build_parser().parse_args([]), dest)
    assert default == _reference_cli_default(option, "train.py")
    assert train_cli.build_parser().parse_args([]).device == "cuda"


def test_engine_config_defaults_and_checks_follow_the_reference():
    """Every field the reference's ``EngineConfig`` has (but ``donate``, which
    the port leaves out) with its default, and the same refusals."""
    from repro.runtime.engine_config import EngineConfig as JaxEngineConfig

    ref = dataclasses.asdict(JaxEngineConfig())
    assert ref.pop("donate") is True
    assert dataclasses.asdict(EngineConfig()) == ref
    for bad in (dict(dtype="float16"), dict(bucket_select="lifo"), dict(placement="x"),
                dict(replicas=0), dict(cache_capacity=0), dict(recompile_margin=-1),
                dict(page_size=-1), dict(decode_kernel="fused"), dict(pool_arenas=0),
                dict(pool_max_bytes=-1), dict(max_group_batch=0), dict(slo_ms=-1)):
        with pytest.raises(ValueError):
            JaxEngineConfig(**bad)
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    args = serve_cli.build_parser().parse_args(
        ["--no-cache", "--max-group-batch", "4", "--no-join-mid-decode", "--sanitize"])
    cfg = EngineConfig.from_args(args)
    assert (cfg.enable_cache, cfg.max_group_batch, cfg.join_mid_decode, cfg.sanitize) == \
        (False, 4, False, True)


@pytest.mark.parametrize("port,ref,kwargs", [
    (lenet, jax_lenet, {}),
    (lenet, jax_lenet, {"input_shape": (1, 16, 16), "num_classes": 5}),
    (softmax_classifier, jax_softmax, {}),
    (softmax_classifier, jax_softmax, {"num_features": 20, "num_classes": 4}),
], ids=["lenet", "lenet-16x16", "softmax", "softmax-20x4"])
def test_nn_spec_copy_equals_reference(port, ref, kwargs):
    assert port.make_spec(**kwargs) == ref.make_spec(**kwargs)


def test_plan_server_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_loop.PlanServer(get_config("yi-6b-smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_loop.resolve_device(None)
    assert serve_loop.resolve_device("cpu") == torch.device("cpu")


def test_keras2plan_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, meta = softmax_classifier.make_spec(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Keras2Plan(spec, meta)
    assert Keras2Plan(spec, meta, device="cpu").device == torch.device("cpu")


def test_unported_parts_raise_and_name_their_slice():
    # the planner is ported: "auto" is the default and accepted
    assert EngineConfig().decode_kernel == "auto"
    assert EngineConfig(decode_kernel="auto").decode_kernel == "auto"
    with pytest.raises(ValueError, match="decode_kernel"):
        EngineConfig(decode_kernel="fused")
    # the hybrid family is ported (slice 3): both stacks, full and reduced
    for arch, kinds in (("recurrentgemma-2b", "rra"), ("recurrentgemma-2b-smoke", "rr")):
        model = build_model(get_config(arch))
        assert "".join(k for k, _p, _i in model.layers())[:3] == kinds
        assert {k.split(".")[0] for k in model.sb.shapes()} >= {"r", "a"}
    assert build_model(get_config("mamba2-1.3b-smoke")).is_ssm   # ported
    # the moe family is ported: its configs build, full and reduced
    for arch in ("qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b-smoke", "dbrx-132b",
                 "dbrx-132b-smoke"):
        assert "l.e_wg" in build_model(get_config(arch)).sb.entries
    # the vlm and audio families are ported: their configs build, full and
    # reduced, the audio family with its encoder (e.), decoder (d.) and
    # cross (x*) leaves
    for arch in ("internvl2-2b", "internvl2-2b-smoke"):
        model = build_model(get_config(arch))
        assert "l.wq" in model.sb.entries and not model.supports_handoff
    for arch in ("whisper-medium", "whisper-medium-smoke"):
        keys = set(build_model(get_config(arch)).sb.entries)
        assert {"e.wq", "e.wi", "d.xwq", "d.xwk", "d.xwv", "d.xwo", "d.xln"} <= keys
    # a family the port does not know still raises
    with pytest.raises(NotImplementedError, match="no family"):
        build_model(get_config("yi-6b-smoke").replace(family="diffusion"))
    # parfor is ported: Keras2Plan takes a mesh (remote scoring:
    # tests/test_torch_parfor.py), at construction and through set
    spec, meta = softmax_classifier.make_spec(4, 2)
    mesh = object()
    assert Keras2Plan(spec, meta, mesh=mesh, device="cpu").mesh is mesh
    assert Keras2Plan(spec, meta, device="cpu").set(mesh=mesh).mesh is mesh
    # the engine and the router are ported: several replicas build a router
    from repro_torch.runtime.router import EngineRouter

    client = EngineConfig(replicas=2).build_client(get_config("yi-6b-smoke"), device="cpu")
    assert isinstance(client, EngineRouter) and len(client.replicas) == 2
