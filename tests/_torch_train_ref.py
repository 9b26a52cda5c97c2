"""The reference's single-device train steps and the checks that hold the
port's sharded steps to them (``tests/test_torch_train_sharded*.py``).

Tolerances are ``tests/test_torch_train.py``'s: loss ``rtol = 1e-5``,
grad_norm ``rtol = 1e-3``; parameters under SGD ``rtol = atol = 1e-5``,
under Adam every element within ``2 * steps * lr`` and the error's RMS
within 3e-3 of the parameter's.
"""

import jax
import jax.numpy as jnp
import numpy as np

from repro import config as jax_config_module
from repro.configs import get_config as jax_config
from repro.core.strategies import PlanConfig as JaxPlan
from repro.core.strategies import Strategy as JaxStrategy
from repro.data import make_batch as jax_make_batch
from repro.models.model import build_model as jax_build
from repro.runtime import train_loop as jax_train_loop

ARCH = "yi-6b-smoke"
STEPS, SEQ, BATCH = 3, 32, 8
JAX_MESH = jax_config_module.MeshConfig((1,), ("data",))
DP, FSDP = "data_parallel", "fsdp_tensor_parallel"
# (strategy, optimizer, lr, grad_clip, microbatches)
CASES = [(s, "sgd", 1e-3, clip, m) for s in (DP, FSDP) for clip in (1.0, 0.0) for m in (1, 2)]
CASES += [(FSDP, "adam", 1e-4, 1.0, 2), (DP, "adam", 1e-4, 1.0, 1)]


def case_id(case):
    s, opt, _lr, clip, m = case
    return f"{'dp' if s == DP else 'fsdp'}-{opt}-clip{clip:g}-micro{m}"


_REF = {}


def reference(arch, opt, lr, clip, micro, steps=STEPS, batch=BATCH, seq=SEQ, cut=(),
              gain=None):
    """The reference's single-device trajectory: per-step metrics and the
    final parameters; and its initial parameters. ``cut`` replaces config
    fields; ``gain`` scales the attention norms' gains (``ln1``, ``xln``) of
    the init."""
    key = (arch, opt, lr, clip, micro, steps, batch, seq, tuple(cut), gain)
    if key not in _REF:
        jcfg = jax_config(arch).replace(**dict(cut))
        jm = jax_build(jcfg, dtype=jnp.float32)
        jp = jm.init_params(jax.random.PRNGKey(0))
        if gain is not None:
            jp = {k: v * gain if k.endswith((".ln1", ".xln")) else v for k, v in jp.items()}
        init = {k: np.asarray(v) for k, v in jp.items()}
        plan = JaxPlan(strategy=JaxStrategy.LOCAL, microbatches=micro)
        train = jax_config_module.TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip)
        step = jax.jit(jax_train_loop.make_train_step(jm, plan, JAX_MESH, train))
        state = jax_train_loop.init_opt_state(opt, jp, plan)
        shape = jax_config_module.InputShape("t", seq, batch, "train")
        mets = []
        for i in range(steps):
            b = jax_make_batch(jcfg, shape, step=i, dtype=jnp.float32)
            jp, state, met = step(jp, state, b, jnp.int32(i))
            mets.append({k: float(v) for k, v in met.items()})
        _REF[key] = (init, mets, {k: np.asarray(v) for k, v in jp.items()})
    return _REF[key]


def check_case(got, want_mets, want_params, opt, lr, steps=STEPS):
    for g, w in zip(got["metrics"], want_mets, strict=True):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["xent"], w["xent"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
    for k, want in want_params.items():
        have = got["params"][k]
        if opt == "sgd":
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(have, want, rtol=0, atol=2 * steps * lr, err_msg=k)
            rms = np.sqrt(((have - want) ** 2).mean() / max((want ** 2).mean(), 1e-30))
            assert rms <= 3e-3, (k, rms)


def check_blocks(outs, case, world, init):
    """Every rank ran the plan asked for; under FSDP each holds a block of
    each split parameter (a 1/world slice of one dim), under DP all of it."""
    strategy = case[0]
    for out in outs:
        name, over_data, batch_axes = out["plan"]
        assert name == strategy and over_data == (strategy == FSDP)
        assert batch_axes == ("data",)
        split = 0
        for k, shape in out["local_shapes"].items():
            full = init[k].shape
            if shape != full:
                diff = [i for i, (a, b) in enumerate(zip(shape, full)) if a != b]
                assert len(diff) == 1 and shape[diff[0]] * world == full[diff[0]], k
                split += 1
        assert (split > 0) == (strategy == FSDP)




def check_blocks_2d(outs, mesh_shape, arch, cut=()):
    """Every rank holds, of each parameter, the block the reference's own
    sharding rules (``repro.core.sharding.spec_for``) give it under the
    plan it ran, on the ``("data", "model")`` mesh: each dim the rules
    split over an axis is 1/size of the whole."""
    from repro.core.sharding import spec_for as jax_spec_for

    mesh = jax_config_module.MeshConfig(tuple(mesh_shape), ("data", "model"))
    jm = jax_build(jax_config(arch).replace(**dict(cut)), dtype=jnp.float32)
    specs, axes = jm.param_specs(), jm.param_axes()
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for out in outs:
        name, over_data, batch_axes, tp, ep, seq_shard = out["plan"]
        plan = JaxPlan(strategy=JaxStrategy(name), batch_axes=batch_axes, tensor_parallel=tp,
                       params_over_data=over_data, expert_parallel=ep,
                       seq_shard_checkpoints=seq_shard)
        split = 0
        for k, spec in specs.items():
            want = list(spec.shape)
            for i, entry in enumerate(jax_spec_for(tuple(spec.shape), axes[k], plan, mesh)):
                for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                    want[i] //= sizes[a]
            assert out["local_shapes"][k] == tuple(want), (k, out["local_shapes"][k], want)
            split += tuple(want) != tuple(spec.shape)
        assert split > 0
