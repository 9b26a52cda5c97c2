"""PyTorch port, data, checkpoints, the logical operator graph and the
quickstart twin (``repro_torch/{data,checkpoint}``, ``core/ir.py``,
``launch/quickstart.py``) against the reference.

- ``SyntheticLM``, ``SyntheticClassification`` and ``make_batch``: the
  arrays byte-equal to the reference's (the same numpy generators), the
  vision and encoder-decoder extras too;
- checkpoints: the same ``arrays.npz`` + ``manifest.json`` format and keys,
  so a checkpoint either package writes loads in the other (float32
  exactly; bfloat16 through float32, exact), with the reference's mismatch
  errors;
- ``build_op_graph(...).table()`` equal to the reference's for every arch
  (full and smoke) and every reference shape;
- the quickstart on the CPU (accuracy above 0.8, the reference's gate),
  and its generated DML script equal to the reference's text, which
  ``chip_smoke.py`` pins for its run on the card.
"""

import hashlib
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as jax_config_module  # noqa: E402
from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.ir import build_op_graph as jax_op_graph  # noqa: E402
from repro.data import SyntheticClassification as JaxClassification  # noqa: E402
from repro.data import SyntheticLM as JaxLM  # noqa: E402
from repro.data import TokenDatasetSpec as JaxSpec  # noqa: E402
from repro.data import make_batch as jax_make_batch  # noqa: E402
from repro.frontend.keras2plan import generate_dml as jax_generate_dml  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.config import InputShape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ir import build_op_graph  # noqa: E402
from repro_torch.data import (SyntheticClassification, SyntheticLM,  # noqa: E402
                              TokenDatasetSpec, make_batch)
from repro_torch.launch import quickstart  # noqa: E402

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (97, 16, 8, 3, 0), (64000, 33, 3, 0, 5), (512, 128, 2, 1, 11)])
def test_synthetic_lm_is_byte_equal(vocab, seq, batch, seed, step):
    ours = SyntheticLM(TokenDatasetSpec(vocab, seq, batch, seed)).batch(step)
    ref = JaxLM(JaxSpec(vocab, seq, batch, seed)).batch(step)
    for k in ("tokens", "targets"):
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes()


@pytest.mark.parametrize("density", [1.0, 0.3])
def test_synthetic_classification_is_byte_equal(density):
    ours = SyntheticClassification(50, 10, seed=2, density=density).batch(64, step=3)
    ref = JaxClassification(50, 10, seed=2, density=density).batch(64, step=3)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium", "internvl2-2b",
                                  "mamba2-1.3b"])
def test_make_batch_is_byte_equal(arch):
    cfg, jcfg = get_config(arch + "-smoke"), jax_config(arch + "-smoke")
    shape = InputShape("t", 16, 2, "train")
    jshape = jax_config_module.InputShape("t", 16, 2, "train")
    ours = make_batch(cfg, shape, step=4, dtype=torch.float32, device="cpu")
    ref = jax_make_batch(jcfg, jshape, step=4, dtype=jnp.float32)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        want = np.asarray(v)
        got = ours[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _params(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax_build(jax_config("yi-6b-smoke"), dtype=jdt).init_params(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, dtype, "cpu")
    return jp, tp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_checkpoint_written_by_the_port_loads_in_the_reference(tmp_path, dtype):
    jp, tp = _params(dtype)
    save_checkpoint(str(tmp_path / "ck"), tp, step=7, extra={"arch": "yi-6b-smoke"})
    restored, step = jax_load(str(tmp_path / "ck"), jp)
    assert step == 7
    for k in jp:
        assert restored[k].dtype == jp[k].dtype
        np.testing.assert_array_equal(np.asarray(restored[k], np.float32),
                                      np.asarray(jp[k], np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_checkpoint_written_by_the_reference_loads_in_the_port(tmp_path, dtype):
    jp, tp = _params(dtype)
    jax_save(str(tmp_path / "ck"), jp, step=3)
    like = {k: torch.zeros_like(v) for k, v in tp.items()}
    restored, step = load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 3
    for k in tp:
        assert restored[k].dtype == dtype and torch.equal(restored[k], tp[k]), k


def test_checkpoint_nested_structures_round_trip(tmp_path):
    tree = {"layers": {"w": torch.ones((3, 3))},
            "opt": (torch.zeros(2), torch.arange(2, dtype=torch.float32)),
            "ids": [torch.arange(4, dtype=torch.int32)]}
    save_checkpoint(str(tmp_path / "ck"), tree, step=1)
    restored, _ = load_checkpoint(str(tmp_path / "ck"), tree)
    assert isinstance(restored["opt"], tuple) and isinstance(restored["ids"], list)
    assert torch.equal(restored["opt"][1], tree["opt"][1])
    assert restored["ids"][0].dtype == torch.int32
    # the reference reads the same file with the same keys
    jtree = {"layers": {"w": jnp.ones((3, 3))}, "opt": (jnp.zeros(2), jnp.arange(2.0)),
             "ids": [jnp.arange(4, dtype=jnp.int32)]}
    jrestored, _ = jax_load(str(tmp_path / "ck"), jtree)
    np.testing.assert_array_equal(jrestored["opt"][1], np.arange(2.0))


def test_checkpoint_mismatch_raises_the_reference_errors(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"a": torch.ones(3)})
    jax_save(str(tmp_path / "jck"), {"a": jnp.ones(3)})
    for path in ("ck", "jck"):
        p = str(tmp_path / path)
        messages = []
        for like_t, like_j in (({"b": torch.ones(3)}, {"b": jnp.ones(3)}),
                               ({"a": torch.ones(4)}, {"a": jnp.ones(4)})):
            with pytest.raises(ValueError) as ours:
                load_checkpoint(p, like_t)
            with pytest.raises(ValueError) as ref:
                jax_load(p, like_j)
            assert str(ours.value).replace("torch.Size([4])", "(4,)") == str(ref.value)
            messages.append(str(ours.value))
        assert messages[0].startswith("checkpoint mismatch: missing={'b'} extra={'a'}")


class _SecondOfTwoRanks:
    """The parts of a 1-D ("data",) DeviceMesh that a restore reads, as rank 1
    of 2 sees them (many ranks: tests/test_torch_ckpt_sharded.py)."""

    mesh_dim_names = ("data",)
    shape = (2,)

    def get_coordinate(self):
        return [1]


def test_checkpoint_restore_with_shardings_names_its_slice(tmp_path):
    """``shardings`` restores each rank's block: rank 1 of 2 gets the second
    half of a tensor split on dim 0 and the second columns of one split on
    dim 1; a tensor whose sharding is None comes back whole."""
    from repro_torch.core.sharding import PartitionSpec, sharding_of

    full = {"a": torch.arange(6.0), "b": torch.arange(12.0).reshape(3, 4), "c": torch.ones(3)}
    save_checkpoint(str(tmp_path / "ck"), full)
    mesh = _SecondOfTwoRanks()
    shards = {"a": sharding_of(mesh, PartitionSpec("data")),
              "b": sharding_of(mesh, PartitionSpec(None, "data")), "c": None}
    like = {"a": torch.zeros(3), "b": torch.zeros(3, 4), "c": torch.zeros(3)}
    got, _step = load_checkpoint(str(tmp_path / "ck"), like, shardings=shards)
    assert torch.equal(got["a"], full["a"][3:]) and torch.equal(got["b"], full["b"][:, 2:])
    assert torch.equal(got["c"], full["c"]) and got["b"].is_contiguous()
    with pytest.raises(ValueError, match="block"):
        load_checkpoint(str(tmp_path / "ck"), dict(like, a=torch.zeros(4)), shardings=shards)


# ---------------------------------------------------------------------------
# the logical operator graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [a + s for a in ARCH_IDS for s in ("", "-smoke")])
def test_op_graph_table_equals_reference(arch):
    for shape in jax_config_module.INPUT_SHAPES.values():
        port_shape = InputShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        ours = build_op_graph(get_config(arch), port_shape)
        ref = jax_op_graph(jax_config(arch), shape)
        assert ours.table() == ref.table()
        assert (ours.total_flops, ours.total_bytes) == (ref.total_flops, ref.total_bytes)
        assert [o.name for o in ours.dominant(3)] == [o.name for o in ref.dominant(3)]


# ---------------------------------------------------------------------------
# the quickstart twin
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_dml_script_equals_the_reference_and_chip_smoke_pin():
    want = jax_generate_dml(quickstart.SPEC, quickstart.META, quickstart.HYPERS["optimizer"],
                            quickstart.HYPERS["lr"], quickstart.HYPERS["batch_size"])
    model = quickstart.Keras2Plan(quickstart.SPEC, quickstart.META, device="cpu",
                                  **quickstart.HYPERS)
    assert model.dml_script == want
    pin = _chip_smoke().QUICKSTART_DML_SHA256
    assert hashlib.sha256(want.encode()).hexdigest() == pin


def test_quickstart_runs_on_the_cpu(capsys):
    model, acc = quickstart.main(["--device", "cpu"])
    assert acc > 0.8 and model.device.type == "cpu"
    assert len(model.history) == 2 * quickstart.TRAIN_ROWS // quickstart.HYPERS["batch_size"]
    assert "OK" in capsys.readouterr().out


def test_quickstart_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
