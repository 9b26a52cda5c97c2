"""PyTorch port, the collectives of the multi-device paths
(``core/comm.py``) on 2 and 4 gloo CPU ranks (``tests/_torch_ranks.py``).

Each op against numpy on every rank's inputs: ``all_reduce_`` (sum, max),
``all_gather_dim`` and ``reduce_scatter_dim`` along every dim, and
``AllGatherDim``, whose backward is the reduce-scatter of the gradient
summed over the ranks; the call counter counts each call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import run_ranks  # noqa: E402


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_equal_numpy(tmp_path, world):
    outs = run_ranks("comm_case", world, tmp_path)
    mine = [o["mine"] for o in outs]
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["sum"], sum(mine), rtol=1e-6)
        np.testing.assert_array_equal(out["max"], np.maximum.reduce(mine))
        for d in range(3):
            np.testing.assert_array_equal(out["gather"][d], np.concatenate(mine, d))
            n = mine[rank].shape[d]
            want = np.take(np.concatenate([sum(mine)] * world, d), range(rank * n, (rank + 1) * n),
                           axis=d)
            np.testing.assert_allclose(out["scatter"][d], want, rtol=1e-6)
        # d/d(shard) of sum(full * index) summed over both ranks' losses
        full_shape = list(mine[0].shape)
        full_shape[1] *= world
        index = np.arange(np.prod(full_shape)).reshape(full_shape)
        n = mine[0].shape[1]
        np.testing.assert_allclose(out["grad"], world * index[:, rank * n:(rank + 1) * n],
                                   rtol=1e-12)
        assert out["calls"] == {"all_reduce": 2, "all_gather": 4, "reduce_scatter": 4}
