"""PyTorch port, the vocab-parallel cross-entropy of the train step over a
model axis (``models/common.softmax_xent_vocab``) on 2 and 4 gloo CPU
ranks: each rank its vocab block of the logits; the loss and the block's
gradient against the reference's ``softmax_xent_logits`` and ``jax.grad``
of it, and the collectives it makes (the max, then the sums of
exponentials and the target logit together).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402

from repro.models.common import softmax_xent_logits as jax_xent  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_xent_equals_reference(tmp_path, world):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 64)).astype(np.float32) * 4
    targets = rng.integers(0, 64, (3, 5)).astype(np.int32)
    want, want_grad = jax.value_and_grad(jax_xent)(jnp.asarray(logits), jnp.asarray(targets))
    outs = run_ranks("vocab_xent_case", world, tmp_path, logits, targets)
    v = 64 // world
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["loss"], float(want), rtol=1e-6)
        np.testing.assert_allclose(out["grad"], np.asarray(want_grad)[..., r * v:(r + 1) * v],
                                   rtol=1e-5, atol=1e-7)
        assert out["calls"] == {"all_reduce": 2}
