"""Gloo CPU ranks for the port's multi-device tests.

:func:`run_ranks` runs one of the functions below on ``world`` CPU ranks
through the port's launcher (``repro_torch.launch.ranks``): each rank a
process with one thread in one gloo group, joined through a file
rendezvous in the test's ``tmp_path`` (no TCP port: several xdist workers
run at once), and each rank's pickled return value comes back to the
parent. The ranks import torch and the port only, never JAX or the JAX
package: the parent computes the references.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import ranks  # noqa: E402


def run_ranks(fn: str, world: int, tmp_path, *args, timeout: int = 240) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank in a
    process of its own inside one gloo group."""
    work = Path(tmp_path) / f"{fn}-{world}-{len(list(Path(tmp_path).iterdir()))}"
    return ranks.run_ranks(globals()[fn], world, work, "cpu", *args, timeout=timeout)


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def parfor_case(rank, world, x, w):
    """Remote parfor of a softmax scoring body on ``x`` (the same rows on
    every rank): the gathered rows, the plan, the collectives in a trace of
    the body and of the mean-reduced parfor, and the mean."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.parfor import count_collectives, parfor
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh("cpu")
    x, w = torch.from_numpy(x), torch.from_numpy(w)

    def score(rows):
        return torch.softmax(rows @ w, dim=-1)

    def summed(rows):
        return torch.sum(rows @ w, dim=-1, keepdim=True)

    remote, plan = parfor(score, x, mesh=mesh)
    full = remote.full_tensor()
    body = make_fx(lambda rows: parfor(score, rows, mesh=mesh)[0])(x).code
    mean, _ = parfor(summed, x, mesh=mesh, reduce="mean")
    total, _ = parfor(summed, x, mesh=mesh, reduce="sum")
    reduced = make_fx(lambda rows: parfor(summed, rows, mesh=mesh, reduce="mean")[0])(x).code
    return {"plan": plan, "full": full.numpy(), "local": remote.to_local().numpy(),
            "body_collectives": count_collectives(body),
            "mean_collectives": count_collectives(reduced), "mean": mean.numpy(),
            "sum": total.numpy()}


def keras_case(rank, world, spec, meta, params, x):
    """``Keras2Plan(mesh=...).predict_proba`` on given weights."""
    import torch

    from repro_torch.frontend import Keras2Plan
    from repro_torch.interop import nn_params_from_numpy
    from repro_torch.launch.mesh import make_local_mesh

    est = Keras2Plan(spec, meta, mesh=make_local_mesh("cpu"), device="cpu")
    est.params = nn_params_from_numpy(params, torch.float32, "cpu")
    probs = est.predict_proba(x)
    serial = Keras2Plan(spec, meta, device="cpu")
    serial.params = est.params
    return {"plan": est._last_score_plan, "probs": probs, "serial": serial.predict_proba(x)}


def _plan(arch, strategy, world, batch, seq, **replace):
    from repro_torch.config import InputShape, MeshConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.planner import compile_plan

    mesh_cfg = MeshConfig((world,), ("data",))
    shape = InputShape("t", seq, batch, "train")
    plan = compile_plan(get_config(arch), shape, mesh_cfg, TrainConfig(force_strategy=strategy),
                        dtype="float32").config
    return plan.replace(**replace), mesh_cfg


def train_case(rank, world, arch, params, cases, steps, batch, seq):
    """For each case (strategy, optimizer, lr, clip, microbatches):
    ``steps`` steps of ``make_train_step`` over the ranks from ``params``
    (full float32 arrays), each rank holding what the plan gives it; per
    step loss, xent and grad_norm, and the full parameters after the last
    step (gathered)."""
    import torch

    from repro_torch.config import InputShape, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import (init_opt_state, make_train_step, shard_params,
                                                train_shardings)

    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch.float32)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    device_mesh = make_local_mesh("cpu")
    out = []
    for strategy, opt, lr, clip, micro in cases:
        plan, mesh_cfg = _plan(arch, strategy, world, batch, seq, microbatches=micro,
                               opt_state_dtype="float32")
        local = shard_params(full, model, plan, mesh_cfg)
        state = init_opt_state(opt, local, plan)
        step = make_train_step(model, plan, mesh_cfg,
                               TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip))
        mets = []
        for i in range(steps):
            b = make_batch(cfg, InputShape("t", seq, batch, "train"), step=i,
                           dtype=torch.float32, device="cpu")
            local, state, met = step(local, state, b, i)
            mets.append({k: float(v) for k, v in met.items()})
        shapes = {k: tuple(v.shape) for k, v in local.items()}
        (_s, _p, shards), _o = train_shardings(model, plan, mesh_cfg, TrainConfig(), device_mesh)
        gathered = {k: shards[k].gather(v) for k, v in local.items()}
        out.append({"plan": (plan.strategy.value, plan.params_over_data, plan.batch_axes),
                    "metrics": mets, "local_shapes": shapes,
                    "params": {k: v.numpy() for k, v in gathered.items()} if rank == 0 else None})
    return out


def ckpt_save_case(rank, world, arch, params, path):
    """Writes ``params`` (full, the same on every rank) as FSDP blocks through
    ``save_checkpoint(shardings=)``; returns this rank's block shapes."""
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import shard_params, train_shardings

    model = build_model(get_config(arch), dtype=torch.float32)
    plan, mesh_cfg = _plan(arch, "fsdp_tensor_parallel", world, 4, 16)
    local = shard_params({k: torch.from_numpy(v) for k, v in params.items()}, model, plan,
                         mesh_cfg)
    (_s, _p, shards), _o = train_shardings(model, plan, mesh_cfg, TrainConfig(),
                                           make_local_mesh("cpu"))
    save_checkpoint(path, local, step=7, shardings=shards)
    return {k: tuple(v.shape) for k, v in local.items()}


def ckpt_load_case(rank, world, arch, path, full_templates):
    """Restores a checkpoint onto the FSDP layout through
    ``load_checkpoint(shardings=)``, with block-shaped or full-shaped
    templates; returns this rank's blocks and the step."""
    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.sharding import named_sharding
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import shard_params, train_shardings

    model = build_model(get_config(arch), dtype=torch.float32)
    plan, mesh_cfg = _plan(arch, "fsdp_tensor_parallel", world, 4, 16)
    (_s, _p, shards), _o = train_shardings(model, plan, mesh_cfg, TrainConfig(),
                                           make_local_mesh("cpu"))
    zeros = {k: torch.zeros(v.shape) for k, v in model.param_specs().items()}
    like = zeros if full_templates else shard_params(zeros, model, plan, mesh_cfg)
    axes = model.param_axes()
    for k, v in zeros.items():      # named_sharding gives train_shardings' layout
        named = named_sharding(shards[k].mesh, tuple(v.shape), axes[k], plan, mesh_cfg)
        assert named.placements == shards[k].placements and named.spec == shards[k].spec, k
    restored, step = load_checkpoint(path, like, shardings=shards)
    coords = {k: [[s.start, s.stop] for s in _slices(shards[k], v.shape)]
              for k, v in zeros.items()}
    return {"step": step, "blocks": {k: v.numpy() for k, v in restored.items()},
            "slices": coords}


def _slices(named, shape):
    from repro_torch.core.sharding import shard_slices

    return shard_slices(shape, named.placements, named.mesh.shape, named.mesh.get_coordinate())


def train_cli_case(rank, world, argv):
    """``launch/train.py``'s entry over the ranks (the process group is
    already up, as under torchrun): its per-step losses."""
    from repro_torch.launch import train

    run = train.main(argv)
    return {"losses": [h["loss"] for h in run.timer.history],
            "plan": run.plan.config.strategy.value}


def comm_case(rank, world):
    """``core/comm.py``'s collectives on this rank's tensors, and
    ``AllGatherDim``'s backward."""
    import torch

    from repro_torch.core import comm

    comm.reset_stats()
    gen = torch.Generator().manual_seed(rank)
    # small integers: every sum is exact whatever order the backend adds in
    a = torch.randint(-64, 64, (3, 4, 6), generator=gen).float()
    out = {"sum": comm.all_reduce_(a.clone()).numpy(),
           "max": comm.all_reduce_(a.clone(), "max").numpy(),
           "gather": {d: comm.all_gather_dim(a, d).numpy() for d in range(3)},
           "scatter": {d: comm.reduce_scatter_dim(torch.cat([a] * world, d), d).numpy()
                       for d in range(3)},
           "mine": a.numpy()}
    shard = a.clone().requires_grad_()
    full = comm.AllGatherDim.apply(shard.double(), 1, None)
    (full * torch.arange(full.numel()).reshape(full.shape)).sum().backward()
    out["grad"] = shard.grad.numpy()
    out["calls"] = dict(comm.STATS["calls"])
    return out


def _plan_2d(arch, strategy, mesh_shape, batch, seq, cut=(), **replace):
    from dataclasses import replace as dc_replace

    from repro_torch.config import InputShape, MeshConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.planner import compile_plan

    mesh_cfg = MeshConfig(tuple(mesh_shape), ("data", "model"))
    cfg = dc_replace(get_config(arch), **dict(cut))
    shape = InputShape("t", seq, batch, "train")
    plan = compile_plan(cfg, shape, mesh_cfg, TrainConfig(force_strategy=strategy),
                        dtype="float32").config
    return cfg, plan.replace(**replace), mesh_cfg


def tp_train_case(rank, world, arch, params, cases, steps, batch, seq, mesh_shape, cut=()):
    """``train_case`` over a ``("data", "model")`` mesh of ``mesh_shape``;
    each case (strategy, optimizer, lr, clip, microbatches, seq_shard):
    ``seq_shard`` sets the plan's ``seq_shard_checkpoints``; ``cut``
    replaces config fields. Also the plan's model-axis fields, and the
    collective calls of the run."""
    import torch

    from repro_torch.config import InputShape, TrainConfig
    from repro_torch.core import comm
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import (init_opt_state, make_train_step, shard_params,
                                                train_shardings)

    full = {k: torch.from_numpy(v) for k, v in params.items()}
    device_mesh = make_local_mesh("cpu", mesh_shape[1])
    out = []
    for strategy, opt, lr, clip, micro, seq_shard in cases:
        cfg, plan, mesh_cfg = _plan_2d(arch, strategy, mesh_shape, batch, seq, cut,
                                       microbatches=micro, opt_state_dtype="float32",
                                       seq_shard_checkpoints=seq_shard)
        model = build_model(cfg, dtype=torch.float32)
        local = shard_params(full, model, plan, mesh_cfg)
        state = init_opt_state(opt, local, plan)
        step = make_train_step(model, plan, mesh_cfg,
                               TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip))
        mets = []
        comm.reset_stats()
        for i in range(steps):
            b = make_batch(cfg, InputShape("t", seq, batch, "train"), step=i,
                           dtype=torch.float32, device="cpu")
            local, state, met = step(local, state, b, i)
            mets.append({k: float(v) for k, v in met.items()})
        calls = dict(comm.STATS["calls"])
        shapes = {k: tuple(v.shape) for k, v in local.items()}
        (_s, _p, shards), _o = train_shardings(model, plan, mesh_cfg, TrainConfig(), device_mesh)
        gathered = {k: shards[k].gather(v) for k, v in local.items()}
        out.append({"plan": (plan.strategy.value, plan.params_over_data, plan.batch_axes,
                             plan.tensor_parallel, plan.expert_parallel,
                             plan.seq_shard_checkpoints),
                    "metrics": mets, "local_shapes": shapes, "calls": calls,
                    "params": {k: v.numpy() for k, v in gathered.items()} if rank == 0 else None})
    return out


def comm_tp_case(rank, world):
    """The model axis's autograd collectives (``core/comm.py``) on this
    rank's tensors: each op's output and the gradient of ``sum(out * w)``
    with this rank's weights ``w``, and the calls they made."""
    import torch

    from repro_torch.core import comm

    gen = torch.Generator().manual_seed(rank)
    # small integers in float64: every sum is exact in any order
    a = torch.randint(-64, 64, (4, 8, 6), generator=gen).double()
    ops = {"copy_to": lambda t: comm.CopyToGroup.apply(t, None),
           "reduce_from": lambda t: comm.ReduceFromGroup.apply(t, None),
           "reduce_scatter": lambda t: comm.ReduceScatterDim.apply(t, 1, None),
           "gather_slice": lambda t: comm.AllGatherSlice.apply(t, 2, None),
           "slice": lambda t: comm.SliceDim.apply(t, 0, None),
           "gather": lambda t: comm.AllGatherDim.apply(t, 1, None)}
    out = {"mine": a.numpy()}
    for name, op in ops.items():
        comm.reset_stats()
        x = a.clone().requires_grad_()
        y = op(x)
        w = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) + 1000 * rank
        (y * w).sum().backward()
        out[name] = {"out": y.detach().numpy(), "grad": x.grad.numpy(),
                     "calls": dict(comm.STATS["calls"])}
    return out


def vocab_xent_case(rank, world, logits, targets):
    """``softmax_xent_vocab`` on this rank's vocab block of ``logits`` (the
    whole array on every rank): the loss and the block's gradient."""
    import torch

    from repro_torch.core import comm
    from repro_torch.models.common import softmax_xent_vocab

    v = logits.shape[-1] // world
    block = torch.from_numpy(logits[..., rank * v:(rank + 1) * v].copy()).requires_grad_()
    comm.reset_stats()
    loss = softmax_xent_vocab(block, torch.from_numpy(targets), rank * v, None)
    loss.backward()
    return {"loss": float(loss), "grad": block.grad.numpy(), "calls": dict(comm.STATS["calls"])}


def ckpt_tp_case(rank, world, arch, params, path, mesh_shape):
    """``params`` (full, the same on every rank) as this rank's FSDP_TP
    blocks on a ``("data", "model")`` mesh, written through
    ``save_checkpoint(shardings=)`` and read back through
    ``load_checkpoint(shardings=)`` from zero blocks: the blocks' shapes,
    the restored blocks, and each block's slices of the whole tensors."""
    import torch

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.config import TrainConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import shard_params, train_shardings

    cfg, plan, mesh_cfg = _plan_2d(arch, "fsdp_tensor_parallel", mesh_shape, 4, 16)
    model = build_model(cfg, dtype=torch.float32)
    local = shard_params({k: torch.from_numpy(v) for k, v in params.items()}, model, plan,
                         mesh_cfg)
    (_s, _p, shards), _o = train_shardings(model, plan, mesh_cfg, TrainConfig(),
                                           make_local_mesh("cpu", mesh_shape[1]))
    save_checkpoint(path, local, step=11, shardings=shards)
    zeros = {k: torch.zeros_like(v) for k, v in local.items()}
    restored, step = load_checkpoint(path, zeros, shardings=shards)
    return {"shapes": {k: tuple(v.shape) for k, v in local.items()}, "step": step,
            "blocks": {k: v.numpy() for k, v in restored.items()},
            "slices": {k: [[s.start, s.stop] for s in _slices(shards[k], v.shape)]
                       for k, v in params.items()}}


def tp_serve_case(rank, world, arch, params, cases, mesh_shape, cut, tokens, lengths,
                  cache_len, n_new, extra=None):
    """Serving under a ``("data", "model")`` mesh of ``mesh_shape``: for each
    case ``(name, plan fields, decode)`` this rank's prompt pass
    (``make_prefill`` under the plan: its rows and, under context-parallel
    prefill, its block of the prompt) and ``n_new`` greedy decode ticks
    (``make_decode_step``) from the handed-off cache, ``decode`` "dense" or
    the paged "paged" / "gather" read of the same cache as slot stacks.
    A family without a handoff returns the last position's logits and
    decodes from a zero cache (an encoder-decoder's cross K/V from
    ``build_cross_cache``) at positions from 0. Returns per case this
    rank's rows' first logits, each tick's logits, the stream, the cache
    block shapes and the collective calls."""
    from dataclasses import replace as dc_replace

    import torch

    from repro_torch.config import MeshConfig
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.core.strategies import PlanConfig, Strategy
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill, serve_ctx
    from repro_torch.runtime.train_loop import batch_specs, local_block, shard_params

    torch.set_num_threads(1)
    cfg = dc_replace(get_config(arch), **dict(cut))
    model = build_model(cfg, dtype=torch.float32)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh_cfg = MeshConfig(tuple(mesh_shape), ("data", "model"))
    groups = mesh_groups(mesh_cfg, "cpu")
    out = []
    for name, fields, decode in cases:
        plan = PlanConfig(**dict(dict(strategy=Strategy.DP_TP, batch_axes=("data",),
                                      cache_batch_axes=("data",), tensor_parallel=True,
                                      remat=False), **dict(fields)))
        local = shard_params(full, model, plan, mesh_cfg, rank)
        batch = {"tokens": torch.from_numpy(tokens), "lengths": torch.from_numpy(lengths)}
        batch.update({k: torch.from_numpy(v) for k, v in (extra or {}).items()})
        specs = batch_specs(batch, plan, mesh_cfg)
        mine = {k: local_block(v, specs[k], mesh_cfg, rank) for k, v in batch.items()}
        ctx = serve_ctx(plan, mesh_cfg, groups, "cpu")
        comm.reset_stats()
        with torch.no_grad():
            prefill_calls = None
            if model.supports_handoff:
                first, cache = make_prefill(model, plan=plan, mesh_cfg=mesh_cfg, groups=groups,
                                            device="cpu")(local, mine)
                prefill_calls = dict(comm.STATS["calls"])
                pos = mine["lengths"].clone()
            else:
                prompt = {k: v for k, v in mine.items() if k != "lengths"}
                first = make_prefill(model, plan=plan, mesh_cfg=mesh_cfg, groups=groups,
                                     device="cpu")(local, prompt)[0]
                prefill_calls = dict(comm.STATS["calls"])
                rows = first.shape[0]
                cache = model.init_cache(tokens.shape[0], cache_len, "cpu", ctx)
                if cfg.is_encdec:
                    cache.update(model.build_cross_cache(local, mine["frames"], ctx))
                pos = torch.zeros((rows,), dtype=torch.int32)
            shapes = {k: tuple(v.shape) for k, v in cache.items()}
            page, tables = 0, None
            if decode != "dense":
                page = 8
                kv_key = next(k for k in cache if model.is_paged_cache_key(k))
                rows, sc = cache[kv_key].shape[1], cache[kv_key].shape[2]
                for k in [k for k in cache if model.is_paged_cache_key(k)]:
                    cache[k] = cache[k].reshape(cache[k].shape[0], rows * sc, *cache[k].shape[3:])
                tables = torch.arange(rows * (sc // page), dtype=torch.int32).view(rows, -1)
            step = make_decode_step(model, page=page, seq_len=cache_len,
                                    decode_kernel=decode if decode != "dense" else "gather",
                                    plan=plan, mesh_cfg=mesh_cfg, groups=groups, device="cpu")
            tok = torch.argmax(first, dim=-1).to(torch.int32)[:, None]
            stream, logits = [tok], []
            comm.reset_stats()
            for _ in range(n_new):
                args = (local, cache, tok, pos) + ((tables,) if tables is not None else ())
                lg, cache = step(*args)
                logits.append(lg[:, -1].numpy())
                tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
                stream.append(tok)
                pos = pos + 1
            decode_calls = {k: v / n_new for k, v in comm.STATS["calls"].items()}
        out.append({"name": name, "first": first.numpy(), "logits": logits,
                    "stream": torch.cat(stream, dim=1).numpy(), "cache_shapes": shapes,
                    "prefill_calls": prefill_calls, "decode_calls": decode_calls,
                    "cache_group": None if ctx is None or ctx.cache_group is None
                    else comm.world_size(ctx.cache_group)})
    return out


def dryrun_count_case(rank, world, arch, mesh_shape, cases, batch, seq):
    """Each case ``(kind, config fields)``: one train step, prompt pass or
    decode tick of ``arch`` in float32 on this rank of a ``("data",
    "model")`` mesh under the plan ``_torch_dryrun_plans.plan_of`` builds,
    from seeded weights; the collective calls, bytes and traffic it made
    (``comm.STATS``)."""
    import torch

    from repro_torch.config import MeshConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_loop import make_decode_step, make_prefill, serve_ctx
    from repro_torch.runtime.train_loop import (batch_specs, init_opt_state, local_block,
                                                make_train_step, shard_params)
    from _torch_dryrun_plans import plan_of

    torch.set_num_threads(1)
    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch.float32)
    mesh_cfg = MeshConfig(tuple(mesh_shape), ("data", "model"))
    groups = mesh_groups(mesh_cfg, "cpu")
    full = model.init_params(torch.Generator().manual_seed(0))
    out = []
    for kind, fields in cases:
        plan = plan_of(cfg, kind, fields, mesh_cfg, batch, seq)
        local = shard_params(full, model, plan.config, mesh_cfg, rank)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(1, cfg.vocab_size, (batch, seq), generator=gen, dtype=torch.int32)
        with torch.set_grad_enabled(kind == "train"):
            if kind == "train":
                train = TrainConfig()
                state = init_opt_state(train.optimizer, local, plan.config)
                step = make_train_step(model, plan.config, mesh_cfg, train)
                b = make_batch(cfg, plan.shape, step=0, dtype=torch.float32, device="cpu")
                step(local, state, b, 0)        # the first call makes the mesh's groups
                comm.reset_stats()
                step(local, state, b, 1)
            elif kind == "prefill":
                full_batch = {"tokens": tokens,
                              "lengths": torch.full((batch,), seq, dtype=torch.int32)}
                specs = batch_specs(full_batch, plan.config, mesh_cfg)
                mine = {k: local_block(v, specs[k], mesh_cfg, rank) for k, v in full_batch.items()}
                prefill = make_prefill(model, plan=plan.config, mesh_cfg=mesh_cfg, groups=groups,
                                       device="cpu")
                comm.reset_stats()
                prefill(local, mine)
            else:
                dec = plan.config.replace(seq_axes=())
                ctx = serve_ctx(dec, mesh_cfg, groups, "cpu", model)
                cache = model.init_cache(batch, seq, "cpu", ctx)
                step = make_decode_step(model, plan=plan.config, mesh_cfg=mesh_cfg,
                                        groups=groups, device="cpu")
                rows = cache[next(iter(cache))].shape[1]
                comm.reset_stats()
                step(local, cache, tokens[:rows, :1].contiguous(), torch.tensor(3, dtype=torch.int32))
        out.append({k: dict(c) for k, c in comm.STATS.items()})
    return out


def pod_train_case(rank, world, arch, params, cases, steps, batch, seq, mesh_shape):
    """``tp_train_case`` over a ``("pod", "data", "model")`` mesh of
    ``mesh_shape`` (pod and data together the data axes): per case the
    plan's fields, the per-step metrics, the collective calls, and on rank
    0 the parameters gathered from every rank's blocks."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.config import InputShape, MeshConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.core.planner import compile_plan
    from repro_torch.data import make_batch
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import (init_opt_state, make_train_step, shard_params,
                                                train_shardings)

    axes = ("pod", "data", "model")
    cfg = get_config(arch)
    model = build_model(cfg, dtype=torch.float32)
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh_cfg = MeshConfig(tuple(mesh_shape), axes)
    device_mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=axes)
    shape = InputShape("t", seq, batch, "train")
    out = []
    for strategy, opt, lr, clip, micro, seq_shard in cases:
        plan = compile_plan(cfg, shape, mesh_cfg, TrainConfig(force_strategy=strategy),
                            dtype="float32").config
        plan = plan.replace(microbatches=micro, opt_state_dtype="float32",
                            seq_shard_checkpoints=seq_shard)
        local = shard_params(full, model, plan, mesh_cfg)
        state = init_opt_state(opt, local, plan)
        step = make_train_step(model, plan, mesh_cfg,
                               TrainConfig(optimizer=opt, learning_rate=lr, grad_clip=clip))
        mets = []
        comm.reset_stats()
        for i in range(steps):
            b = make_batch(cfg, shape, step=i, dtype=torch.float32, device="cpu")
            local, state, met = step(local, state, b, i)
            mets.append({k: float(v) for k, v in met.items()})
        calls = dict(comm.STATS["calls"])
        (_s, _p, shards), _o = train_shardings(model, plan, mesh_cfg, TrainConfig(), device_mesh)
        gathered = {k: shards[k].gather(v) for k, v in local.items()}
        out.append({"plan": (plan.strategy.value, plan.params_over_data, plan.batch_axes,
                             plan.tensor_parallel, plan.seq_shard_checkpoints),
                    "metrics": mets, "calls": calls,
                    "params": {k: v.numpy() for k, v in gathered.items()} if rank == 0 else None})
    return out
