"""PyTorch port, serving layer: ``PlanServer.handle`` against the
reference's on ``yi-6b-smoke`` (float32, ``prefill=True``, page 16, the
paged decode kernel), with the port's parameters set from the reference
server's. Token streams, buckets and the KV pool's counters must be equal.
``handle`` prompts with all ones, so its token stream is a weak check on
its own; the strong token-equivalence check on random prompts lives in
``test_torch_model.py``, and this file checks pool accounting and the
wiring end to end.

The reference's ``CacheArena.tables`` uploads its host page table with
``jnp.asarray``, which on the CPU may alias the numpy buffer; the host then
rewrites that buffer (rows freed to the sentinel) while asynchronously
dispatched decode steps still read it, so the reference's own token stream
varies from run to run. A fixture gives the reference a private copy of
the table at upload — its intended semantics — for this module only, and
``test_reference_page_table_upload_race`` keeps the fault itself in view."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.runtime import kv_cache as jax_kv_cache  # noqa: E402
from repro.runtime.engine_config import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serve_loop import PlanServer as JaxPlanServer  # noqa: E402
from repro.runtime.serve_loop import ServeRequest as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime.engine_config import EngineConfig  # noqa: E402
from repro_torch.runtime.serve_loop import PlanServer, ServeRequest  # noqa: E402

torch.set_num_threads(2)
ARCH = "yi-6b-smoke"
COUNTERS = ("pages_leased", "pages_freed", "pages_denied", "rows_leased",
            "rows_reused", "handoff_writes", "arenas_created", "arenas_reused",
            "pages_reclaimed", "peak_pages")
_SERVERS = {}
_REFERENCE_TABLES = jax_kv_cache.CacheArena.tables   # as shipped, unpatched


def _private_tables(self):
    if self._tables_dirty:
        self._tables = jnp.asarray(self._tables_np.copy())
        self._tables_dirty = False
    return self._tables


@pytest.fixture(autouse=True, scope="module")
def _reference_tables_not_aliased():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_kv_cache.CacheArena, "tables", property(_private_tables))
        yield


def _aligned_copy(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` whose buffer starts on a 64-byte boundary."""
    buf = np.empty(a.size + 64 // a.itemsize, a.dtype)
    start = (-buf.ctypes.data % 64) // a.itemsize
    out = buf[start:start + a.size].reshape(a.shape)
    out[...] = a
    return out


@pytest.mark.parametrize("upload", ["reference", "private copy"])
def test_reference_page_table_upload_race(upload):
    """The fault the fixture works around, made deterministic: with a host
    page table on a 64-byte boundary, the reference's ``CacheArena.tables``
    hands the device a view of the host buffer, and freeing a row then
    rewrites the table that an already dispatched decode step reads. The
    fixture's private copy does not move. When the reference's upload
    copies, the "reference" case fails: the fixture can go then."""
    from repro.models.model import build_model as jax_build
    from repro.runtime.kv_cache import KVCachePool as JaxPool

    pool = JaxPool(jax_build(jax_config(ARCH), dtype=jnp.float32), page_size=16)
    arena = pool.acquire(2, 64, demand_bytes=0.0)
    rows = pool.admit_request_rows(arena, 2, prompt=15, span=50)
    arena._tables_np = _aligned_copy(arena._tables_np)
    arena._sync_tables()
    upload_fn = _REFERENCE_TABLES.fget if upload == "reference" else _private_tables
    on_device = upload_fn(arena)
    before = np.array(on_device)
    pool.free_rows(arena, rows)                    # rows' entries -> sentinel
    moved = not np.array_equal(np.array(on_device), before)
    assert moved == (upload == "reference")


def _jax_server(prefill: bool, page: int = 16):
    if (prefill, page) not in _SERVERS:
        cfg = JaxEngineConfig(dtype="float32", prefill=prefill, page_size=page,
                              decode_kernel="paged")
        _SERVERS[prefill, page] = JaxPlanServer(jax_config(ARCH), config=cfg)
    return _SERVERS[prefill, page]


def _port_server(jsrv, **kw):
    cfg = EngineConfig(dtype="float32", prefill=jsrv.prefill,
                       page_size=jsrv.page_size, **kw)
    srv = PlanServer(get_config(ARCH), config=cfg, device="cpu")
    srv.params = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.params.items()}, torch.float32, "cpu")
    return srv


@pytest.mark.parametrize("prefill,page", [(True, 16), (False, 16), (True, 0)])
def test_plan_server_matches_jax(prefill, page):
    """page 0 is the row-granular (unpaged) arena path."""
    jsrv = _jax_server(prefill, page)
    srv = _port_server(jsrv, decode_kernel="paged")
    for batch, context in ((1, 40), (2, 100), (1, 40)):
        jout = jsrv.handle(JaxRequest(batch, context))
        out = srv.handle(ServeRequest(batch, context))
        np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
        assert out["bucket"] == tuple(jout["bucket"])
        assert out["finish_reason"] == jout["finish_reason"]
    jm, m = jsrv.pool.metrics, srv.pool.metrics
    for name in COUNTERS:
        assert getattr(m, name) == getattr(jm, name), name
    assert m.peak_bytes == jm.peak_bytes
    assert srv.pool.live_bytes() == jsrv.pool.live_bytes() == 0


@pytest.mark.parametrize("kernel", ["gather", "ref"])
def test_decode_kernels_serve_identical_streams(kernel):
    jsrv = _jax_server(True)
    paged, other = _port_server(jsrv), _port_server(jsrv, decode_kernel=kernel)
    for batch, context in ((1, 40), (3, 70)):
        a = paged.handle(ServeRequest(batch, context, new_tokens=6))
        b = other.handle(ServeRequest(batch, context, new_tokens=6))
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"].numpy())
        assert a["tokens"].shape == (batch, 6)
        assert torch.isfinite(a["last_logits"]).all()


def test_handle_names_its_phases_in_a_profiler_trace():
    """``chip_smoke.py`` reads the device's idle share inside these spans."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import DECODE_SPAN, PREFILL_SPAN

    srv = _port_server(_jax_server(True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = srv.handle(ServeRequest(1, 40, new_tokens=3))
    spans = {e.name: e.time_range for e in prof.events()
             if e.name in (PREFILL_SPAN, DECODE_SPAN)}
    assert set(spans) == {PREFILL_SPAN, DECODE_SPAN}
    assert spans[PREFILL_SPAN].end <= spans[DECODE_SPAN].start
    assert out["decode_steps"] == 2


def test_eos_stops_early_and_reclaims_pages():
    """A row stops at its first eos token; the request finishes when every
    row has stopped and its pages count as reclaimed."""
    jsrv = _jax_server(True)
    srv = _port_server(jsrv)
    full = srv.handle(ServeRequest(1, 40, new_tokens=8))["tokens"][0].tolist()
    eos = full[2]
    out = srv.handle(ServeRequest(1, 40, new_tokens=8, eos_id=eos))
    assert out["finish_reason"] == "eos"
    assert out["tokens"][0].tolist() == full[:full.index(eos) + 1]
    assert srv.pool.metrics.pages_reclaimed > 0
    stop = tuple(full[3:5])
    out = srv.handle(ServeRequest(1, 40, new_tokens=8, stop=(stop,)))
    got = out["tokens"][0].tolist()
    assert got[-2:] == list(stop) and got == full[:len(got)]


def test_pool_budgets_and_on_demand_pages_match_jax():
    """Arena budgets (deny, evict, force) and on-demand page grants across
    page boundaries: the port's pool makes the reference's decisions, keeps
    its page tables and counts what it counts."""
    from repro.models.model import build_model as jax_build
    from repro.runtime.kv_cache import KVCachePool as JaxPool
    from repro_torch.models.model import build_model
    from repro_torch.runtime.kv_cache import KVCachePool

    jm = jax_build(jax_config(ARCH), dtype=jnp.float32)
    tm = build_model(get_config(ARCH), dtype=torch.float32)
    for kw in (dict(max_arenas=1), dict(max_bytes=3 * 16 * 2 * 2 * 32 * 4 * 2)):
        jp, tp = JaxPool(jm, page_size=16, **kw), KVCachePool(tm, "cpu", page_size=16, **kw)
        steps = [("acquire", (2, 64), dict(demand_bytes=0.0)),
                 ("acquire", (1, 32), dict(demand_bytes=1e9)),
                 ("acquire", (1, 32), dict(force=True)),
                 ("release", None, {}), ("release", None, {}),
                 ("acquire", (4, 128), dict(demand_bytes=0.0)),
                 ("acquire", (2, 64), dict(demand_bytes=0.0))]
        jheld, theld = [], []           # leased arenas, oldest first
        for op, arg, opts in steps:
            if op == "acquire":
                ja, ta = jp.acquire(*arg, **opts), tp.acquire(*arg, **opts)
                assert (ja is None) == (ta is None), (kw, op, arg)
                if ja is not None:
                    jheld.append(ja)
                    theld.append(ta)
            else:
                jp.release(jheld.pop(0))
                tp.release(theld.pop(0))
            assert tp.metrics.as_dict() == jp.metrics.as_dict(), (kw, op, arg)
        ja, ta = jheld[-1], theld[-1]
        jrows = jp.admit_request_rows(ja, 2, prompt=15, span=50)
        trows = tp.admit_request_rows(ta, 2, prompt=15, span=50)
        assert jrows == trows
        for pos in range(15, 50):
            jp.ensure_decode_slots(ja, jrows, pos)
            tp.ensure_decode_slots(ta, trows, pos)
            np.testing.assert_array_equal(ta.tables.numpy(), np.asarray(ja.tables))
        assert tp.live_bytes() == jp.live_bytes()
        jp.free_rows(ja, jrows[:1], early=True)
        tp.free_rows(ta, trows[:1], early=True)
        assert tp.metrics.as_dict() == jp.metrics.as_dict()
        assert tp.live_bytes() == jp.live_bytes()
