"""PyTorch port, parfor (``core/parfor.py``) and remote scoring through
``Keras2Plan(mesh=...)`` against the reference.

``choose_parfor_plan`` makes the reference's decisions on the same meshes
(a stand-in with the reference's ``devices``, ``axis_names`` and name ->
size ``shape``). Remote parfor runs on 2 and 4 gloo CPU ranks
(``tests/_torch_ranks.py``): every rank's gathered rows equal the
reference's parfor output on the same inputs (``rtol = 1e-5``; float32
products in another order), the body's ``make_fx`` trace holds no
collective and the mean-reduced parfor's exactly one, and
``Keras2Plan(mesh=...).predict_proba`` on LeNet equals the reference's
on the same weights (``rtol = 1e-5``, ``atol = 1e-6``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402

from repro.configs.lenet import make_spec as jlenet_spec  # noqa: E402
from repro.frontend import Keras2Plan as JKeras2Plan  # noqa: E402
from repro.nn.module import Sequential as JSequential  # noqa: E402
from repro_torch.configs.lenet import make_spec as lenet_spec  # noqa: E402

torch.set_num_threads(2)
# the modules (each package's core/__init__ exports a function of the name)
parfor = importlib.import_module("repro_torch.core.parfor")
jax_parfor = importlib.import_module("repro.core.parfor")


class _Mesh:
    """The attributes of a mesh that both packages' plan choice reads."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)


MESHES = [((1,), ("data",)), ((2,), ("data",)), ((4,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 4), ("pod", "data")), ((2, 2, 2), ("pod", "data", "model")),
          ((1, 8), ("data", "model"))]


@pytest.mark.parametrize("shape,names", MESHES)
def test_choose_parfor_plan_makes_the_reference_decisions(shape, names):
    mesh = _Mesh(shape, names)
    for rows in (0, 1, 2, 3, 4, 6, 8, 12, 16, 64, 65, 2048):
        assert parfor.choose_parfor_plan(rows, mesh) == \
            jax_parfor.choose_parfor_plan(rows, mesh), rows
    assert parfor.choose_parfor_plan(64, None) == jax_parfor.choose_parfor_plan(64, None)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((64, 16)).astype(np.float32),
            rng.standard_normal((16, 8)).astype(np.float32))


def _reference(x, w):
    def score(rows):
        return jax.nn.softmax(rows @ w, axis=-1)

    def summed(rows):
        return jnp.sum(rows @ w, axis=-1, keepdims=True)

    local, plan = jax_parfor.parfor(score, jnp.asarray(x))
    mean, _ = jax_parfor.parfor(summed, jnp.asarray(x), reduce="mean")
    total, _ = jax_parfor.parfor(summed, jnp.asarray(x), reduce="sum")
    return np.asarray(local), plan, np.asarray(mean), np.asarray(total)


@pytest.mark.parametrize("reduce", [None, "sum", "mean"])
def test_local_parfor_equals_reference(reduce):
    x, w = _inputs()
    tw = torch.from_numpy(w)
    got, plan = parfor.parfor(lambda r: torch.softmax(r @ tw, dim=-1), torch.from_numpy(x),
                              reduce=reduce)
    want, jplan = jax_parfor.parfor(lambda r: jax.nn.softmax(r @ w, axis=-1), jnp.asarray(x),
                                    reduce=reduce)
    assert plan == jplan == "local"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_remote_parfor_equals_reference_with_a_collective_free_body(tmp_path, world):
    x, w = _inputs()
    local, _plan, mean, total = _reference(x, w)
    outs = run_ranks("parfor_case", world, tmp_path, x, w)
    n = x.shape[0] // world
    for rank, out in enumerate(outs):
        assert out["plan"] == "remote"
        np.testing.assert_allclose(out["full"], local, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(out["local"], local[rank * n:(rank + 1) * n], rtol=1e-5,
                                   atol=1e-7)
        # "avoids shuffling": no collective in the body; the reduction's one
        assert out["body_collectives"] == 0
        assert out["mean_collectives"] == 1
        np.testing.assert_allclose(out["mean"], mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["sum"], total, rtol=1e-5, atol=1e-4)


def test_count_collectives_reads_functional_and_inplace_c10d_names():
    code = ("all_reduce = torch.ops._c10d_functional.all_reduce.default(x, 'sum', '0')\n"
            "w = torch.ops._c10d_functional.wait_tensor.default(all_reduce)\n"
            "g = torch.ops._c10d_functional.all_gather_into_tensor.default(x, 2, '0')\n"
            "r = torch.ops._c10d_functional.reduce_scatter_tensor.default(x, 'sum', 2, '0')\n"
            "a = torch.ops._c10d_functional.all_to_all_single.default(x, [1], [1], '0')\n"
            "b = torch.ops._c10d_functional.broadcast.default(x, 0, '0')\n"
            "c = torch.ops.c10d.allreduce_.default([x], pg, op, None, False)\n"
            "d = torch.ops.c10d._allgather_base_.default(o, x, pg, False, -1)\n"
            "e = torch.ops.c10d.reduce_scatter_.default([o], [[x]], pg, op, False, -1)\n"
            "f = torch.ops.aten.all.default(x)\n")
    assert parfor.count_collectives(code) == 8
    assert parfor.count_collectives("torch.ops.aten.mm.default(a, b)") == 0


def _lenet_weights():
    jspec, jmeta = jlenet_spec(input_shape=(1, 16, 16), num_classes=5)
    jparams = JSequential(jspec, jmeta).init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    return jspec, jmeta, jax.tree.map(np.asarray, jparams), x


@pytest.mark.parametrize("world", [2, 4])
def test_keras2plan_remote_scoring_equals_reference(tmp_path, world):
    jspec, jmeta, jparams, x = _lenet_weights()
    ref = JKeras2Plan(jspec, jmeta)
    ref.params = jax.tree.map(jnp.asarray, jparams)
    want = ref.predict_proba(x)
    spec, meta = lenet_spec(input_shape=(1, 16, 16), num_classes=5)
    outs = run_ranks("keras_case", world, tmp_path, spec, meta, jparams, x)
    for out in outs:
        assert out["plan"] == "remote"
        np.testing.assert_allclose(out["probs"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["probs"], out["serial"], rtol=1e-5, atol=1e-6)
