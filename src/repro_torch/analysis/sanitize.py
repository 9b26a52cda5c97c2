"""Runtime sanitizer: per-tick structural assertions over the live serving
stack (port of ``repro/analysis/sanitize.py``).

A from-scratch recount of the invariants the pool, the engine and the router
maintain incrementally. Every check walks raw structures (``_row_pages``, the
allocator's free set, the host page table, member row lists) and rebuilds
the derived quantity (``live_bytes``, page counts, handle liveness)
independently, so drift in the incremental bookkeeping fails the tick it
happens in instead of surfacing ticks later as a corrupted decode.

Enabled with ``EngineConfig(sanitize=True)`` (or ``serve.py --sanitize``):
:class:`~repro_torch.runtime.engine.ServingEngine` and
:class:`~repro_torch.runtime.router.EngineRouter` then run
:func:`assert_engine` / :func:`assert_router` at the end of every tick and
after every cancel/withdraw/drain, raising :class:`SanitizeError` on the
first violating tick. The checks are Python walks over host-side metadata — no device sync.

This module imports nothing from ``repro_torch.runtime`` (the engine imports
*it*); every check duck-types its subject.
"""

from __future__ import annotations

from typing import Iterable, List

from repro_torch.analysis import Finding


class SanitizeError(AssertionError):
    """One or more sanitizer invariants failed this tick."""

    def __init__(self, findings: Iterable[Finding]):
        self.findings = list(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(f"sanitizer: {len(self.findings)} violation(s)\n"
                         f"{lines}")


def _f(rule: str, where: str, detail: str, **data) -> Finding:
    return Finding(rule=rule, where=where, detail=detail, data=data)


# ---------------------------------------------------------------------------
# arena / pool
# ---------------------------------------------------------------------------


def check_arena(arena, where: str) -> List[Finding]:
    """Structural invariants of one :class:`CacheArena`: row free-list
    sanity, page-lease disjointness, allocator/page-table agreement."""
    out: List[Finding] = []
    free = list(arena._free)
    if len(free) != len(set(free)):
        out.append(_f("row-double-free", where,
                      f"duplicate rows in free list {sorted(free)}"))
    bad = [r for r in free if not 0 <= r < arena.batch]
    if bad:
        out.append(_f("row-range", where, f"free rows out of range {bad}"))
    leased_rows = set(range(arena.batch)) - set(free)

    if not (arena.page and arena.n_pages):
        return out

    alloc = arena.allocator
    seen = {}
    for row, pages in arena._row_pages.items():
        if row not in leased_rows:
            out.append(_f("page-orphan", where,
                          f"row {row} holds {len(pages)} page(s) but is "
                          f"on the free list"))
        for p in pages:
            if not 0 <= p < arena.n_pages:
                out.append(_f("page-range", where,
                              f"row {row} holds out-of-range page {p}"))
            elif p in seen:
                out.append(_f("page-double-lease", where,
                              f"page {p} leased to rows {seen[p]} and "
                              f"{row}"))
            elif p in alloc._free_set:
                out.append(_f("page-double-lease", where,
                              f"page {p} leased to row {row} but also on "
                              f"the allocator free list"))
            seen[p] = row

    # conservation: every physical page is either free or leased once
    n_accounted = len(alloc._free_set) + sum(
        len(p) for p in arena._row_pages.values())
    if n_accounted != arena.n_pages:
        out.append(_f("page-leak", where,
                      f"{arena.n_pages} pages, {n_accounted} accounted "
                      f"(free {len(alloc._free_set)} + leased "
                      f"{n_accounted - len(alloc._free_set)})"))
    res = sum(arena._row_reserved.values())
    if alloc.reserved != res:
        out.append(_f("reserve-drift", where,
                      f"allocator reserves {alloc.reserved} page(s), rows "
                      f"reserve {res}"))
    if alloc.reserved > len(alloc._free_set):
        out.append(_f("reserve-overcommit", where,
                      f"{alloc.reserved} reserved > "
                      f"{len(alloc._free_set)} free"))
    for name, keys in (("_row_reserved", arena._row_reserved),
                       ("_row_slots", arena._row_slots)):
        stray = set(keys) - set(arena._row_pages)
        if stray:
            out.append(_f("page-orphan", where,
                          f"{name} tracks rows {sorted(stray)} with no "
                          f"page lease"))

    # page-table agreement: leased pages appear in the row's table prefix,
    # everything past the lease is the unallocated sentinel
    for row in range(arena.batch):
        tab = arena._tables_np[row]
        pages = arena._row_pages.get(row, [])
        want = list(pages) + [arena.n_pages] * (arena.max_pages - len(pages))
        if list(tab) != want:
            out.append(_f("table-drift", where,
                          f"row {row} table {list(tab)} != leased pages "
                          f"{pages} + sentinel"))
    return out


def recount_live_bytes(pool) -> float:
    """``KVCachePool.live_bytes`` rebuilt from raw structures: committed
    pages (leased + reserved) plus leased rows' per-row state for paged
    arenas, the full arena footprint otherwise."""
    total = 0.0
    for a in pool._leased:
        if a.page:
            # page-mode accounting also covers arenas with zero paged
            # entries (pure-recurrent families): all row state, no pages
            pages = sum(len(p) for p in a._row_pages.values())
            pages += sum(a._row_reserved.values())
            total += pages * a.page_nbytes
            total += (a.batch - len(a._free)) * a.row_nbytes
        else:
            total += a.nbytes
    return total


def check_pool(pool, where: str = "pool") -> List[Finding]:
    """Pool-level invariants: every arena's structure, lease/free-list
    disjointness, and ``live_bytes()`` vs. a from-scratch recount."""
    out: List[Finding] = []
    for i, a in enumerate(pool._leased):
        out.extend(check_arena(a, f"{where}.leased[{i}]"))
    for i, a in enumerate(pool._pooled):
        aw = f"{where}.pooled[{i}]"
        out.extend(check_arena(a, aw))
        if a.rows_used:
            out.append(_f("arena-leak", aw,
                          f"pooled arena still has {a.rows_used} leased "
                          f"row(s)"))
        if a.page and a.n_pages and a._row_pages:
            out.append(_f("page-leak", aw,
                          f"pooled arena still holds "
                          f"{sum(len(p) for p in a._row_pages.values())} "
                          f"page(s)"))
    both = set(id(a) for a in pool._leased) & set(id(a) for a in pool._pooled)
    if both:
        out.append(_f("arena-double-lease", where,
                      f"{len(both)} arena(s) both leased and pooled"))
    live = pool.live_bytes()
    recount = recount_live_bytes(pool)
    if abs(live - recount) > max(1.0, 1e-6 * max(live, recount)):
        out.append(_f("live-bytes-drift", where,
                      f"live_bytes()={live:.0f} but recount={recount:.0f}",
                      live=live, recount=recount))
    if pool.max_bytes and live - pool.max_bytes > 1.0:
        out.append(_f("byte-budget-breach", where,
                      f"live {live:.0f} > budget {pool.max_bytes:.0f}"))
    return out


# ---------------------------------------------------------------------------
# engine / router
# ---------------------------------------------------------------------------


def check_engine(engine, where: str = "engine") -> List[Finding]:
    """Engine-level invariants on top of the pool checks: group rows match
    live members exactly, and the handle map tracks in-flight work only
    (no leaked handles after retire, no untracked live requests)."""
    out = check_pool(engine.server.pool, where=f"{where}.pool")
    queued = {qr.rid for qr in engine.queue.pending}
    member_rids = set()
    live_rids = set(queued)
    for gi, g in enumerate(engine.active):
        gw = f"{where}.active[{gi}]"
        rows: dict = {}
        for m in g.members:
            member_rids.add(m.qr.rid)
            if m.done:
                continue
            live_rids.add(m.qr.rid)
            for r in m.rows:
                if r in rows:
                    out.append(_f("row-double-lease", gw,
                                  f"row {r} held by rids {rows[r]} and "
                                  f"{m.qr.rid}"))
                rows[r] = m.qr.rid
        leased = set(range(g.arena.batch)) - set(g.arena._free)
        if set(rows) != leased:
            out.append(_f("row-lease-drift", gw,
                          f"members hold rows {sorted(rows)} but arena "
                          f"leases {sorted(leased)}"))
    for rid in engine.handles:
        if rid not in queued and rid not in member_rids:
            out.append(_f("handle-leak", where,
                          f"handle for rid {rid} is neither queued nor in "
                          f"an active group"))
    for rid in sorted(live_rids):
        if rid not in engine.handles:
            out.append(_f("handle-missing", where,
                          f"live rid {rid} has no tracked handle"))
    if (engine._events.maxlen is not None
            and len(engine._events) > engine._events.maxlen):
        out.append(_f("event-buffer-leak", where,
                      f"{len(engine._events)} events exceed the "
                      f"{engine._events.maxlen} cap"))
    return out


def check_router(router, where: str = "router") -> List[Finding]:
    """Fleet-level invariants: every replica's engine, plus router-handle
    placement (a live handle points at exactly one replica engine that
    still tracks it) and the router's bounded event buffer."""
    out: List[Finding] = []
    for r in router.replicas:
        out.extend(check_engine(r.engine, where=f"{where}.replica[{r.idx}]"))
    for rid, h in router.handles.items():
        if h.rid != rid:
            out.append(_f("handle-leak", where, f"handle keyed {rid} carries rid {h.rid}"))
        if h.done:
            out.append(_f("handle-leak", where,
                          f"finished rid {rid} still tracked (terminal event not "
                          f"forwarded?)"))
            continue
        if h.inner is None or h.replica is None:
            out.append(_f("handle-missing", where, f"live rid {rid} has no replica placement"))
            continue
        eng = h.replica.engine
        queued = {qr.rid for qr in eng.queue.pending}
        members = {m.qr.rid for g in eng.active for m in g.members}
        if rid not in queued and rid not in members:
            out.append(_f("handle-missing", where,
                          f"rid {rid} placed on replica {h.replica.idx} but that engine "
                          f"does not hold it"))
    if router._events.maxlen is not None and len(router._events) > router._events.maxlen:
        out.append(_f("event-buffer-leak", where,
                      f"{len(router._events)} events exceed the {router._events.maxlen} cap"))
    return out


# ---------------------------------------------------------------------------
# entry points the runtime calls
# ---------------------------------------------------------------------------


def assert_engine(engine) -> None:
    """Raise :class:`SanitizeError` if any engine invariant fails."""
    found = check_engine(engine)
    if found:
        raise SanitizeError(found)


def assert_router(router) -> None:
    """Raise :class:`SanitizeError` if any fleet invariant fails."""
    found = check_router(router)
    if found:
        raise SanitizeError(found)
