"""PyTorch port, checkpoints of sharded state (``checkpoint/checkpoint.py``
with ``shardings=``) across ranks and packages.

A checkpoint written by 2 (or 4) gloo CPU ranks, each holding its FSDP
blocks of ``yi-6b-smoke``'s parameters (``tests/_torch_ranks.py``), holds
the full arrays in the reference's format: it loads in the reference and in
one process of the port, equal to the weights the ranks were given. The
reverse: a checkpoint the reference wrote restores onto the ranks, each
rank's tensors the block its sharding names, from block-shaped or
full-shaped templates. Over a ``("data", "model")`` mesh of (2, 2) under
``FSDP_TP`` (blocks split over both axes): the ranks' checkpoint loads in
the reference and in one process, and restores each rank its own 2-D
blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"


def _weights():
    jm = jax_build(jax_config(ARCH), dtype=jnp.float32)
    return jm, {k: np.asarray(v) for k, v in jm.init_params(jax.random.PRNGKey(5)).items()}


@pytest.mark.parametrize("world", [2, 4])
def test_checkpoint_written_by_ranks_loads_in_reference_and_one_process(tmp_path, world):
    jm, params = _weights()
    path = str(tmp_path / "ck")
    shapes = run_ranks("ckpt_save_case", world, tmp_path, ARCH, params, path)
    # the ranks held blocks (FSDP), not whole tensors
    assert any(shapes[0][k] != v.shape for k, v in params.items())
    ref, step = jax_load(path, jm.param_specs())
    assert step == 7
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v, err_msg=k)
    ours, step = load_checkpoint(path, {k: torch.zeros(v.shape) for k, v in params.items()})
    assert step == 7
    for k, v in params.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("full_templates", [False, True], ids=["block-like", "full-like"])
def test_reference_checkpoint_restores_each_rank_its_block(tmp_path, full_templates):
    _jm, params = _weights()
    path = str(tmp_path / "ck")
    jax_save(path, {k: jnp.asarray(v) for k, v in params.items()}, step=3)
    outs = run_ranks("ckpt_load_case", 2, tmp_path, ARCH, path, full_templates)
    split = 0
    for out in outs:
        assert out["step"] == 3
        for k, v in params.items():
            block = v[tuple(slice(a, b) for a, b in out["slices"][k])]
            np.testing.assert_array_equal(out["blocks"][k], block, err_msg=k)
            split += block.shape != v.shape
    assert split > 0


def test_fsdp_tp_checkpoint_round_trip_on_a_2x2_mesh(tmp_path):
    jm, params = _weights()
    path = str(tmp_path / "ck")
    outs = run_ranks("ckpt_tp_case", 4, tmp_path, ARCH, params, path, (2, 2))
    # the blocks split over both mesh axes: wq over data (embed) and model (heads)
    assert outs[0]["shapes"]["l.wq"] == (2, 64, 2, 32)
    ref, step = jax_load(path, jm.param_specs())
    ours, our_step = load_checkpoint(path, {k: torch.zeros(v.shape) for k, v in params.items()})
    assert step == our_step == 11
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v, err_msg=k)
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    for out in outs:
        assert out["step"] == 11
        for k, v in params.items():
            block = v[tuple(slice(a, b) for a, b in out["slices"][k])]
            assert block.shape == out["shapes"][k], k
            np.testing.assert_array_equal(out["blocks"][k], block, err_msg=k)
    # the four ranks hold four different blocks of wq
    assert len({tuple(map(tuple, o["slices"]["l.wq"])) for o in outs}) == 4
