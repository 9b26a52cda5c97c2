"""PyTorch port, the collectives of the multi-device paths
(``core/comm.py``) on 2 and 4 gloo CPU ranks (``tests/_torch_ranks.py``).

Each op against numpy on every rank's inputs: ``all_reduce_`` (sum, max),
``all_gather_dim`` and ``reduce_scatter_dim`` along every dim, and
``AllGatherDim``, whose backward is the reduce-scatter of the gradient
summed over the ranks; the call counter counts each call. The model axis's
autograd pairs (``CopyToGroup``, ``ReduceFromGroup``, ``ReduceScatterDim``,
``AllGatherSlice``, ``SliceDim``): each one's output and the gradient of
``sum(out * w_r)`` summed over the ranks' losses, and the calls each makes.
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


def _blocks(t, axis, world):
    return np.split(t, world, axis=axis)


@pytest.mark.parametrize("world", [2, 4])
def test_model_axis_collectives_forward_and_gradient(tmp_path, world):
    outs = run_ranks("comm_tp_case", world, tmp_path)
    mine = [o["mine"] for o in outs]
    total = sum(mine)
    # each rank's weights: arange over its output's shape, plus 1000 * rank
    def w(shape, r):
        return np.arange(np.prod(shape), dtype=np.float64).reshape(shape) + 1000 * r

    for r, out in enumerate(outs):
        shape = mine[r].shape
        got = out["copy_to"]
        np.testing.assert_array_equal(got["out"], mine[r])
        np.testing.assert_array_equal(got["grad"], sum(w(shape, q) for q in range(world)))
        assert got["calls"] == {"all_reduce": 1}
        got = out["reduce_from"]
        np.testing.assert_array_equal(got["out"], total)
        np.testing.assert_array_equal(got["grad"], w(shape, r))
        assert got["calls"] == {"all_reduce": 1}
        got = out["reduce_scatter"]
        np.testing.assert_array_equal(got["out"], _blocks(total, 1, world)[r])
        small = _blocks(mine[r], 1, world)[0].shape
        np.testing.assert_array_equal(got["grad"], np.concatenate(
            [w(small, q) for q in range(world)], 1))
        assert got["calls"] == {"reduce_scatter": 1, "all_gather": 1}
        got = out["gather_slice"]
        np.testing.assert_array_equal(got["out"], np.concatenate(mine, 2))
        big = np.concatenate(mine, 2).shape
        np.testing.assert_array_equal(got["grad"], _blocks(w(big, r), 2, world)[r])
        assert got["calls"] == {"all_gather": 1}
        got = out["slice"]
        np.testing.assert_array_equal(got["out"], _blocks(mine[r], 0, world)[r])
        small = _blocks(mine[r], 0, world)[0].shape
        np.testing.assert_array_equal(got["grad"], np.concatenate(
            [w(small, q) for q in range(world)], 0))
        assert got["calls"] == {"all_gather": 1}
        got = out["gather"]
        big = np.concatenate(mine, 1).shape
        np.testing.assert_array_equal(got["out"], np.concatenate(mine, 1))
        np.testing.assert_array_equal(got["grad"], _blocks(sum(w(big, q) for q in range(world)),
                                                           1, world)[r])
        assert got["calls"] == {"all_gather": 1, "reduce_scatter": 1}
