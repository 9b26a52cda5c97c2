"""PyTorch port, plan cache and dynamic recompilation
(``repro_torch/core/plan_cache.py`` and ``PlanServer``'s entries): the
behaviour cases of ``tests/test_plan_cache.py`` against the port — bucket
rounding, LRU order, hit/miss counters, compile-once, exactly one recompile
on a memory breach and none within the margin, rebucketing that reuses the
target entry, convergence — and one mixed request stream through the port's
``PlanServer(device="cpu")`` and the reference's, on ``yi-6b-smoke`` and
``mamba2-1.3b-smoke`` with the same weights (``interop``) and the same
hardware figures, with a memory breach forced on one bucket: per request
equal tokens, bucket, ``plan.explain_axes()``, ``recompiled``,
``recompile_reasons``, ``watermark_bytes`` and ``pool_bytes``, and equal
``PlanCacheMetrics`` counters (``compile_seconds``, a time, is not
compared)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as jax_config_module  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import cost as jax_cost  # noqa: E402
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.config import (SINGLE_DEVICE_MESH, SINGLE_POD_MESH, HardwareSpec,  # noqa: E402
                                InputShape)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost as port_cost  # noqa: E402
from repro_torch.core.plan_cache import (BucketPolicy, CacheEntry, PlanCache,  # noqa: E402
                                         PlanKey, bucket_pow2, recompile_reasons)
from repro_torch.core.planner import PlanCompiler, compile_plan  # noqa: E402
from repro_torch.core.strategies import RuntimeStats  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.metrics import PlanCacheMetrics  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402

torch.set_num_threads(2)
CFG = get_config("yi-6b-smoke")
JAX_HW = jax_config_module.TPU_V5E
PORT_HW = HardwareSpec(**dataclasses.asdict(JAX_HW))
COUNTERS = ("hits", "misses", "evictions", "compiles", "recompiles", "hit_rate")


def _key(batch=2, seq=128, kind="decode"):
    return PlanKey.for_request(CFG, SINGLE_DEVICE_MESH, "float32",
                               InputShape("t", seq, batch, kind))


def _entry(key):
    return CacheEntry(key=key, plan=compile_plan(CFG, key.bucket_shape(), SINGLE_DEVICE_MESH))


# ---------------------------------------------------------------------------
# bucket rounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,minimum,want", [
    (1, 1, 1), (2, 1, 2), (3, 1, 4), (4, 1, 4), (5, 1, 8), (1000, 1, 1024),
    (1, 16, 16), (17, 16, 32), (0, 1, 1)])
def test_bucket_pow2(n, minimum, want):
    assert bucket_pow2(n, minimum=minimum) == want


def test_plan_key_buckets_request_shapes():
    k = PlanKey.for_request(CFG, SINGLE_DEVICE_MESH, "float32",
                            InputShape("r", 100, 3, "decode"),
                            BucketPolicy(min_batch=1, min_seq=16))
    assert (k.batch_bucket, k.seq_bucket) == (4, 128)
    bs = k.bucket_shape()
    assert (bs.global_batch, bs.seq_len, bs.kind) == (4, 128, "decode")
    assert _key(4, 65) == _key(3, 128)
    assert k != PlanKey.for_request(CFG, SINGLE_POD_MESH, "float32",
                                    InputShape("r", 100, 3, "decode"))
    assert k != dataclasses.replace(k, dtype="bfloat16")
    assert k.rebucket(InputShape("g", 300, 5, "decode")) == _key(8, 512)


# ---------------------------------------------------------------------------
# LRU + counters
# ---------------------------------------------------------------------------


def test_lru_eviction_order():
    cache = PlanCache(capacity=2)
    ka, kb, kc = _key(1, 64), _key(2, 128), _key(4, 256)
    cache.put(ka, _entry(ka))
    cache.put(kb, _entry(kb))
    cache.get(ka)                      # A is now most-recently used
    cache.put(kc, _entry(kc))          # evicts B (least-recently used)
    assert kb not in cache and ka in cache and kc in cache
    assert cache.keys() == [ka, kc]
    assert cache.metrics.evictions == 1 and len(cache) == 2
    with pytest.raises(ValueError, match="capacity"):
        PlanCache(capacity=0)


def test_hit_miss_counters():
    cache = PlanCache(capacity=4)
    k = _key()
    assert cache.get(k) is None
    cache.put(k, _entry(k))
    assert cache.get(k) is not None and cache.get(k) is not None
    m = cache.metrics
    assert (m.hits, m.misses, m.lookups) == (2, 1, 3)
    assert m.hit_rate == pytest.approx(2 / 3)
    assert m.as_dict()["hit_rate"] == pytest.approx(2 / 3)
    assert PlanCacheMetrics().hit_rate == 0.0


def test_get_or_compile_compiles_once():
    cache = PlanCache(capacity=4)
    k = _key()
    calls = []

    def compile_fn():
        calls.append(1)
        return _entry(k)

    e1 = cache.get_or_compile(k, compile_fn)
    e2 = cache.get_or_compile(k, compile_fn)
    assert e1 is e2 and len(calls) == 1
    assert cache.metrics.compiles == 1 and e1.hits == 1


# ---------------------------------------------------------------------------
# dynamic recompilation
# ---------------------------------------------------------------------------


def test_memory_breach_triggers_exactly_one_recompile():
    cache = PlanCache(capacity=4)
    compiler = PlanCompiler()
    k = _key(2, 128)
    old = cache.put(k, _entry(k))
    old.step_fn = object()
    stats = RuntimeStats(shape=k.bucket_shape(),
                         watermark_bytes=2.0 * old.plan.memory.total)
    built = []
    new, reasons = cache.refresh(k, stats, compiler, margin=0.25,
                                 build_step=lambda plan: built.append(plan) or object())
    assert reasons and "watermark" in reasons[0]
    assert cache.metrics.recompiles == 1 and new is not old
    # only the statistics changed: the entry keeps its step (and graphs)
    assert new.step_fn is old.step_fn and built == []
    cache.metrics.hits = 0
    assert cache.get(k) is new
    assert new.plan.memory.total >= stats.watermark_bytes
    again, reasons2 = cache.refresh(k, stats, compiler, margin=0.25)
    assert reasons2 == () and again is new
    assert cache.metrics.recompiles == 1


def test_no_recompile_within_margin():
    cache = PlanCache(capacity=4)
    k = _key(2, 128)
    e = cache.put(k, _entry(k))
    stats = RuntimeStats(shape=k.bucket_shape(), watermark_bytes=1.1 * e.plan.memory.total)
    same, reasons = cache.refresh(k, stats, PlanCompiler(), margin=0.25)
    assert same is e and reasons == ()
    assert cache.metrics.recompiles == 0


def test_shape_outgrowing_bucket_recompiles_into_larger_bucket():
    cache = PlanCache(capacity=4)
    k = _key(2, 128)
    cache.put(k, _entry(k))
    grown = InputShape("grown", 300, 2, "decode")
    built = []
    new, reasons = cache.refresh(k, RuntimeStats(shape=grown), PlanCompiler(),
                                 build_step=lambda plan: built.append(plan) or object())
    assert reasons and "exceeds compiled bucket" in reasons[0]
    assert new.key.seq_bucket == 512 and new.plan.shape.seq_len >= 512
    assert built == [new.plan]          # a new bucket builds a new step
    cache.metrics.misses = 0
    assert cache.get(new.key) is new
    assert k not in cache
    none, reasons2 = cache.refresh(k, RuntimeStats(shape=grown), PlanCompiler())
    assert none is None and reasons2 == ()
    assert cache.metrics.recompiles == 1


def test_rebucket_reuses_existing_target_entry():
    cache = PlanCache(capacity=4)
    small, big = _key(2, 128), _key(2, 512)
    cache.put(small, _entry(small))
    target = cache.put(big, _entry(big))
    target.step_fn = object()
    got, reasons = cache.refresh(small, RuntimeStats(shape=InputShape("g", 300, 2, "decode")),
                                 PlanCompiler())
    assert reasons and got is target and got.step_fn is target.step_fn
    assert small not in cache
    assert cache.metrics.recompiles == 0


def test_recompile_converges_even_when_strategy_escalates():
    compiler = PlanCompiler()
    prior = compiler.compile(get_config("granite-8b"), InputShape("t", 2048, 32, "decode"),
                             SINGLE_POD_MESH)
    watermark = 50.0 * prior.memory.total
    stats = RuntimeStats(shape=prior.shape, watermark_bytes=watermark)
    new = compiler.recompile(prior, stats)
    assert new.memory.total >= watermark
    assert recompile_reasons(new, stats) == ()


def test_recompile_reasons_predicate():
    plan = compile_plan(CFG, InputShape("t", 128, 2, "decode"), SINGLE_DEVICE_MESH)
    assert recompile_reasons(plan, RuntimeStats(shape=plan.shape,
                                                watermark_bytes=plan.memory.total)) == ()
    breach = RuntimeStats(shape=plan.shape, watermark_bytes=plan.memory.total * 3)
    assert len(recompile_reasons(plan, breach)) == 1
    pool = RuntimeStats(shape=plan.shape,
                        cache_pool_bytes=3 * plan.memory.per_device["kv_cache"])
    assert "kv-cache pool" in recompile_reasons(plan, pool)[0]


def test_recompile_scales_estimates_monotonically():
    compiler = PlanCompiler()
    prior = compiler.compile(CFG, InputShape("t", 128, 2, "decode"), SINGLE_DEVICE_MESH)
    stats = RuntimeStats(shape=prior.shape, watermark_bytes=4.0 * prior.memory.total)
    new = compiler.recompile(prior, stats)
    assert new.memory.total == pytest.approx(4.0 * prior.memory.total, rel=0.3)
    assert any("dynamic recompilation" in n for n in new.config.notes)


# ---------------------------------------------------------------------------
# PlanServer against the reference's
# ---------------------------------------------------------------------------


def _private_tables(self):
    if self._tables_dirty:
        self._tables = jnp.asarray(self._tables_np.copy())
        self._tables_dirty = False
    return self._tables


@pytest.fixture
def as_the_reference(monkeypatch):
    """The reference's page-table upload can alias the host table on the
    CPU (``tests/test_torch_serve.py`` shows the race): it gets a private
    copy. The port gets the reference's paged-dispatch figure."""
    monkeypatch.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
    monkeypatch.setattr(port_cost, "PAGED_STEP_LATENCY_S", jax_cost.PAGED_STEP_LATENCY_S)


# (batch, context, new tokens): four buckets, each decode and prefill key
# twice or more, more keys than the cache holds
STREAM = ((1, 40, 4), (2, 100, 4), (1, 40, 4), (4, 60, 3), (1, 200, 4), (2, 100, 4),
          (1, 40, 5), (4, 60, 3))
BREACH_AT = 2           # before this request, the (1, 40) bucket's estimate shrinks


@pytest.mark.parametrize("arch", ["yi-6b-smoke", "mamba2-1.3b-smoke"])
def test_plan_server_mixed_stream_equals_reference(arch, as_the_reference):
    kw = dict(dtype="float32", prefill=True, page_size=16, cache_capacity=5)
    jsrv = JaxPlanServer(jax_config(arch), jax_config_module.SINGLE_DEVICE_MESH,
                         hw=JAX_HW, config=JaxEngineConfig(**kw))
    srv = PlanServer(get_config(arch), SINGLE_DEVICE_MESH, hw=PORT_HW,
                     config=EngineConfig(**kw), device="cpu")
    srv.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.params.items()}, torch.float32, "cpu")
    recompiled = []
    for i, (batch, context, new) in enumerate(STREAM):
        if i == BREACH_AT:
            # force a memory breach: both servers' cached statistics for the
            # bucket shrink, so the observed watermark exceeds them (one
            # lookup each, counted alike)
            for s in (jsrv, srv):
                entry = s.decode_entry(batch, context + new)
                entry.plan.memory = entry.plan.memory.scaled(1e-3)
        jout = jsrv.handle(JaxRequest(batch, context, new_tokens=new))
        out = srv.handle(ServeRequest(batch, context, new_tokens=new))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["plan"].explain_axes() == jout["plan"].explain_axes()
        assert out["recompiled"] == jout["recompiled"]
        assert out["recompile_reasons"] == tuple(jout["recompile_reasons"])
        assert out["watermark_bytes"] == pytest.approx(jout["watermark_bytes"], rel=1e-12)
        assert out["pool_bytes"] == jout["pool_bytes"]
        recompiled.append(out["recompiled"])
    assert recompiled == [i == BREACH_AT for i in range(len(STREAM))]
    jm, m = jsrv.metrics.as_dict(), srv.metrics.as_dict()
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert m["recompiles"] == 1 and m["evictions"] > 0 and m["hits"] > 0
    assert srv.pool.live_bytes() == jsrv.pool.live_bytes() == 0
    assert "plan_cache: hits=" in srv.summary() and "kv_pool:" in srv.summary()


def test_plan_server_cache_off_always_compiles():
    srv = PlanServer(CFG, config=EngineConfig(enable_cache=False), device="cpu")
    a = srv.handle(ServeRequest(1, 40, new_tokens=2))
    b = srv.handle(ServeRequest(1, 40, new_tokens=2))
    assert srv.metrics.compiles == 2 and srv.metrics.hits == 0
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["recompiled"] is False and a["recompile_reasons"] == ()


def test_decode_and_prefill_entries_share_the_cache():
    srv = PlanServer(CFG, config=EngineConfig(prefill=True, cache_capacity=8), device="cpu")
    d, p = srv.decode_entry(2, 100), srv.prefill_entry(2, 100)
    assert (d.key.kind, p.key.kind) == ("decode", "prefill")
    assert (d.key.batch_bucket, d.key.seq_bucket) == (p.key.batch_bucket, p.key.seq_bucket)
    assert srv.decode_entry(2, 120) is d and srv.metrics.compiles == 2
    tok, kv = srv.prefill_first_token(2, 100)
    assert tok.shape == (2, 1) and set(kv) == {"l.k", "l.v"}
    logits, _ = srv.run_prefill(p)
    assert logits.shape == (2, CFG.vocab_size)


def test_evicted_arena_and_new_weights_drop_the_decode_graphs(monkeypatch):
    """A decode step's graphs are keyed by arena: the pool's eviction of an
    arena drops them from every step the server built, and new weights
    drop them all (``runtime/graph_step.py``)."""
    from repro_torch.runtime import serve_loop

    class Probe:
        def __init__(self, step_fn, device):
            self.dropped, self.cleared = [], 0

        def drop(self, arena):
            self.dropped.append(arena)

        def clear(self):
            self.cleared += 1

    monkeypatch.setattr(serve_loop, "build_decode_step", Probe)
    srv = PlanServer(CFG, config=EngineConfig(page_size=16), device="cpu")
    probe = srv.decode_entry(1, 40).step_fn
    arenas = []
    for seq in (32, 64, 128, 256, 512):          # the pool keeps 4 free arenas
        arenas.append(srv.pool.acquire(1, seq, demand_bytes=0.0))
        srv.pool.release(arenas[-1])
    assert probe.dropped == arenas[:1] and srv.pool.metrics.arenas_evicted == 1
    srv.params = dict(srv.params)
    assert probe.cleared == 1
