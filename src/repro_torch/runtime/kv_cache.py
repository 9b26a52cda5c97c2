"""Row-addressable, block-granular (paged) KV-cache pool for serving.

Port of ``repro/runtime/kv_cache.py``:

- :class:`CacheArena` — one bucket-shaped cache whose batch rows are
  individually leasable, rows at different depths side by side.
- :class:`BlockAllocator` — free list of fixed-size pages inside an arena's
  flat slot stack; a row's page table maps logical slot ``i`` to physical
  slot ``table[i // page] * page + i % page``.
- :class:`KVCachePool` — leases arenas to requests, recycles fully-freed
  ones, scatters prefill-produced cache rows into leased arenas (the
  prefill→decode handoff write) and accounts page-exact live bytes.

Row and page bookkeeping is host-side (numpy); the device holds the slot
stacks and an int32 page table. Each paged arena owns one device table for
its whole life, copied over in place from the host table when that changed
(a captured decode graph reads the table at the address it was captured
with). The handoff write updates the arena's tensors in place. Recurrent state
(the SSM family's SSD state and conv tails) keeps its per-row layout in a
paged arena: a pure-recurrent arena has no pages, no allocator and no page
table, and its rows are charged ``row_nbytes`` each.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class PoolMetrics:
    """Pool-level accounting (the reference's counters, one to one)."""

    arenas_created: int = 0
    arenas_reused: int = 0      # leases served from the free pool
    arenas_denied: int = 0      # acquire refused by budget
    arenas_evicted: int = 0     # free arenas dropped (LRU cap / budget)
    rows_leased: int = 0
    rows_reused: int = 0        # leased rows whose arena had a prior tenant
    handoff_writes: int = 0     # prefill→decode row scatters
    peak_bytes: float = 0.0
    pages_leased: int = 0       # page-grant churn (cumulative)
    pages_freed: int = 0
    pages_denied: int = 0       # admissions refused for lack of pages
    pages_reclaimed: int = 0    # pages given back by early exits
    peak_pages: int = 0         # max concurrently committed pages

    def as_dict(self) -> Dict[str, float]:
        return dict(self.__dict__)


class BlockAllocator:
    """Free-list allocator over an arena's physical pages.

    ``reserve``/``alloc(from_reserve=True)`` split admission-time capacity
    checks from on-demand page grants: a row reserves every page its span
    can need when admitted, then draws from that reservation as its
    position crosses page boundaries. Free pages live in a min-heap
    (lowest-index-first grants) mirrored by a set for O(1) double-free
    detection."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._heap: List[int] = list(range(n_pages))  # already heap-ordered
        self._free_set = set(self._heap)
        self.reserved = 0

    @property
    def free_count(self) -> int:
        return len(self._free_set)

    @property
    def available(self) -> int:
        """Pages admittable to new tenants (free minus reservations)."""
        return len(self._free_set) - self.reserved

    def alloc(self, n: int, *, from_reserve: bool = False) -> Optional[List[int]]:
        if from_reserve:
            if n > self.reserved or n > len(self._free_set):
                return None
            self.reserved -= n
        elif n > self.available:
            return None
        pages = [heapq.heappop(self._heap) for _ in range(n)]
        self._free_set.difference_update(pages)
        return pages

    def reserve(self, n: int) -> bool:
        if n > self.available:
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        self.reserved = max(0, self.reserved - n)

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p in self._free_set:
                raise ValueError(f"page {p} double-freed")
            heapq.heappush(self._heap, p)
            self._free_set.add(p)


class CacheArena:
    """One bucket-shaped cache whose batch rows are individually leasable.

    In paged mode (``page > 0``) with paged entries (``n_pages > 0``) the
    arena owns a :class:`BlockAllocator` over ``n_pages`` physical pages and
    a ``(batch, max_pages)`` int32 page table whose unallocated entries hold
    the sentinel ``n_pages`` (reads through it are masked, writes through it
    are dropped). A paged arena with no paged entries (pure-recurrent
    families) has neither: rows are its only granularity and ``tables`` is
    None."""

    def __init__(self, batch: int, seq: int, cache: Dict[str, torch.Tensor],
                 nbytes: float, *, page: int = 0, sc: int = 0,
                 n_pages: int = 0, page_nbytes: float = 0.0,
                 row_nbytes: float = 0.0, rotating: bool = False,
                 paged_keys: Sequence[str] = ()):
        self.batch = batch
        self.seq = seq
        self.cache = cache
        self.nbytes = nbytes            # full-capacity bytes (dense charge)
        self.generation = 0             # completed leases of this arena
        self._free: List[int] = list(range(batch))
        self.page = page
        self.sc = sc                    # logical cache slots per row
        self.n_pages = n_pages
        self.page_nbytes = page_nbytes  # bytes of one page across the stack
        self.row_nbytes = row_nbytes    # per-row bytes of non-paged entries
        self.rotating = rotating        # rotating-window slot semantics
        self.paged_keys = tuple(paged_keys)
        self.paging = bool(page and n_pages)    # pages, allocator, page table
        self.allocator = BlockAllocator(n_pages) if self.paging else None
        self.max_pages = max(1, -(-sc // page)) if page else 0
        self._row_pages: Dict[int, List[int]] = {}
        self._row_reserved: Dict[int, int] = {}
        self._row_slots: Dict[int, int] = {}   # valid slots per row
        self._tables_np = (np.full((batch, self.max_pages), n_pages, np.int32)
                           if self.paging else None)
        self._tables: Optional[torch.Tensor] = (
            torch.empty(self._tables_np.shape, dtype=torch.int32, device=self.device)
            if self.paging else None)
        self._tables_dirty = self.paging

    @property
    def device(self) -> torch.device:
        return next(iter(self.cache.values())).device

    # -- row bookkeeping ---------------------------------------------------
    @property
    def rows_free(self) -> int:
        return len(self._free)

    @property
    def rows_used(self) -> int:
        return self.batch - len(self._free)

    def alloc_rows(self, n: int) -> Optional[List[int]]:
        """Lease ``n`` rows (lowest-index first); None if not enough free."""
        if n > len(self._free):
            return None
        self._free.sort()
        rows, self._free = self._free[:n], self._free[n:]
        return rows

    def free_rows(self, rows: Sequence[int]) -> None:
        for r in rows:
            if r in self._free:
                raise ValueError(f"row {r} double-freed")
            self._free.append(r)

    # -- paging ------------------------------------------------------------
    @property
    def pages_leased(self) -> int:
        return sum(len(p) for p in self._row_pages.values())

    @property
    def pages_committed(self) -> int:
        """Leased plus reserved pages — the arena's committed capacity."""
        if self.allocator is None:
            return 0
        return self.pages_leased + self.allocator.reserved

    def span_pages(self, span: int) -> int:
        """Pages a row occupying ``span`` logical slots needs end to end."""
        if not self.paging:
            return 0
        return -(-min(max(1, span), self.sc) // self.page)

    def live_nbytes(self) -> float:
        """Page-exact committed bytes: leased and reserved pages plus the
        per-row (recurrent) bytes of leased rows; the full arena when not
        paged."""
        if not self.page:
            return self.nbytes
        return (self.pages_committed * self.page_nbytes
                + self.rows_used * self.row_nbytes)

    def used_slots(self) -> int:
        return sum(self._row_slots.values())

    @property
    def tables(self) -> Optional[torch.Tensor]:
        """The arena's device page table: one tensor for the arena's life,
        brought up to date in place when admissions, page grants or releases
        changed the host table. The copy is a blocking one from pageable
        memory on the current stream: it runs after every tick already
        queued there (which read the table as it was) and returns once the
        host table has been read, so the host may rewrite it at once. None
        for an arena with no paged entries."""
        if self._tables_dirty:
            self._tables.copy_(torch.from_numpy(self._tables_np))
            self._tables_dirty = False
        return self._tables

    def admit_row(self, row: int, prompt: int, span: int,
                  eager: bool = False) -> List[int]:
        """Commit a row's paging state: lease the pages covering its initial
        valid slots (the prompt plus the first decode write — or the whole
        span with ``eager``) and reserve the rest of its span. Returns the
        leased pages."""
        if not self.paging:
            return []
        total = self.span_pages(span)
        init_slots = min(span, self.sc) if eager else min(prompt + 1, self.sc)
        init_pages = min(total, -(-init_slots // self.page))
        if self.allocator.available < total:
            raise RuntimeError(
                f"KV page invariant violated: row {row} needs {total} pages "
                f"but arena {self.batch}x{self.seq} has only "
                f"{self.allocator.available} available "
                f"({self.allocator.free_count} free, "
                f"{self.allocator.reserved} reserved)")
        pages = self.allocator.alloc(init_pages)
        self.allocator.reserve(total - init_pages)
        self._row_pages[row] = list(pages)
        self._row_reserved[row] = total - init_pages
        self._row_slots[row] = init_slots
        self._tables_np[row, :len(pages)] = pages
        self._tables_dirty = True
        return pages

    def ensure_slot(self, row: int, lslot: int) -> Optional[int]:
        """Grant the page covering logical slot ``lslot`` to ``row`` from its
        admission-time reservation (no-op when already granted). Returns the
        newly granted physical page, if any."""
        if not self.paging:
            return None
        lp = lslot // self.page
        pages = self._row_pages.get(row)
        if pages is None:
            raise RuntimeError(f"row {row} decodes without page admission")
        self._row_slots[row] = min(self.sc, max(self._row_slots[row], lslot + 1))
        if lp < len(pages):
            return None
        if lp != len(pages):
            raise RuntimeError(
                f"row {row} skipped a page boundary: wants logical page "
                f"{lp}, holds {len(pages)}")
        got = self.allocator.alloc(1, from_reserve=True)
        if got is None:
            raise RuntimeError(
                f"KV page reservation invariant violated: row {row} has no "
                f"reserved page left for logical page {lp}")
        pages.append(got[0])
        self._row_reserved[row] -= 1
        self._tables_np[row, lp] = got[0]
        self._tables_dirty = True
        return got[0]

    def reserved_for(self, rows: Sequence[int]) -> int:
        """Undrawn span-reservation pages still held for ``rows``."""
        return sum(self._row_reserved.get(r, 0) for r in rows)

    def release_row_pages(self, rows: Sequence[int]) -> int:
        """Return rows' pages (and outstanding reservations) to the
        allocator; returns how many leased pages were freed."""
        if not self.paging:
            return 0
        freed = 0
        for r in rows:
            pages = self._row_pages.pop(r, None)
            if pages is None:
                continue
            self.allocator.free(pages)
            self.allocator.unreserve(self._row_reserved.pop(r, 0))
            self._row_slots.pop(r, None)
            self._tables_np[r, :] = self.n_pages
            freed += len(pages)
        if freed:
            self._tables_dirty = True
        return freed

    def phys_slots(self, rows: Sequence[int], sc: Optional[int] = None) -> np.ndarray:
        """(len(rows), sc) physical slot per logical slot, with out-of-range
        slots for unallocated pages (host-side, for the handoff write)."""
        sc = self.sc if sc is None else sc
        tab = self._tables_np[np.asarray(list(rows), np.int64)]
        i = np.arange(sc)
        phys = tab[:, np.minimum(i // self.page, self.max_pages - 1)].astype(np.int64)
        return phys * self.page + (i % self.page)[None, :]


class KVCachePool:
    """Single owner of decode-cache construction for a serving session.

    ``max_arenas`` / ``max_bytes`` (0 = unbounded) cap the pool;
    ``acquire(..., force=True)`` overrides the cap so a server with nothing
    in flight can always make progress. Fully-freed arenas are kept for
    recycling up to ``max_free`` buckets (LRU-evicted beyond that).
    ``page_size > 0`` turns on block-granular paging: attention K/V become a
    flat per-arena slot stack and ``live_bytes`` is page-exact."""

    def __init__(self, model, device, *, max_arenas: int = 0,
                 max_bytes: float = 0.0, max_free: int = 4, page_size: int = 0):
        self.model = model
        # called with each arena the pool evicts, before its buffers go
        # (the server drops the decode graphs captured on it)
        self.on_evict: List[Callable[[CacheArena], None]] = []
        self.device = torch.device(device)
        self.max_arenas = max_arenas
        self.max_bytes = max_bytes
        self.max_free = max(1, max_free)
        self.page_size = max(0, int(page_size))
        self.metrics = PoolMetrics()
        self._leased: List[CacheArena] = []
        self._pooled: List[CacheArena] = []       # LRU: least recent first
        self._params: Dict[tuple, tuple] = {}     # (b, s) -> paging params

    @property
    def paged(self) -> bool:
        return self.page_size > 0

    # -- sizing ------------------------------------------------------------
    def arena_bytes(self, batch: int, seq: int) -> float:
        """Exact bytes of one dense (batch, seq) arena."""
        return float(sum(math.prod(shape) * dt.itemsize for shape, _a, dt
                         in self.model.cache_entries(batch, seq).values()))

    def _arena_params(self, batch: int, seq: int):
        """(entries, sc, n_pages, page_nbytes, row_nbytes, nbytes) of a paged
        arena: paged entries are charged per page, the others per row."""
        key = (batch, seq)
        if key not in self._params:
            ent, n_pages, sc = self.model.paged_cache_entries(batch, seq,
                                                              self.page_size)
            page_nbytes = row_nbytes = total = 0.0
            for k, (shape, _a, dt) in ent.items():
                nb = math.prod(shape) * dt.itemsize
                total += nb
                if self.model.is_paged_cache_key(k):
                    page_nbytes += nb / max(1, n_pages)
                else:
                    row_nbytes += nb / batch
            self._params[key] = (ent, sc, n_pages, page_nbytes, row_nbytes, total)
        return self._params[key]

    def span_pages(self, seq: int, span: int) -> int:
        """Pages one row of a ``seq``-bucket arena needs for ``span``."""
        if not self.paged:
            return 0
        _ent, sc, n_pages = self._arena_params(1, seq)[:3]
        if not n_pages:
            return 0
        return -(-min(max(1, span), sc) // self.page_size)

    def member_bytes(self, seq: int, batch_rows: int, span: int) -> float:
        """Page-exact bytes one request commits (the admission unit): its
        rows' recurrent bytes plus its span's pages per row."""
        if not self.paged:
            return 0.0
        page_nbytes, row_nbytes = self._arena_params(1, seq)[3:5]
        return batch_rows * (row_nbytes + self.span_pages(seq, span) * page_nbytes)

    def live_bytes(self) -> float:
        """Bytes committed to requests (page-exact when paged)."""
        return sum(a.live_nbytes() for a in self._leased)

    def bytes_room(self) -> float:
        """Byte budget headroom for further commitments (inf: unbounded)."""
        if not self.max_bytes:
            return math.inf
        return max(0.0, self.max_bytes - self.live_bytes())

    def total_bytes(self) -> float:
        """Leased plus pooled-free bytes (a fully-freed paged arena commits
        no pages, so holding it for recycling charges nothing)."""
        return self.live_bytes() + sum(a.live_nbytes() for a in self._pooled
                                       if not a.page)

    @property
    def arena_count(self) -> int:
        return len(self._leased) + len(self._pooled)

    def occupancy(self) -> float:
        """Fraction of leased-arena rows holding live requests."""
        total = sum(a.batch for a in self._leased)
        used = sum(a.rows_used for a in self._leased)
        return used / total if total else 0.0

    def slot_utilization(self) -> float:
        """Fraction of leased page slots holding valid cache entries (the
        internal-fragmentation complement, at page-grant granularity)."""
        leased = sum(a.pages_leased for a in self._leased) * self.page_size
        used = sum(a.used_slots() for a in self._leased)
        return used / leased if leased else 1.0

    def pages_live(self) -> int:
        return sum(a.pages_committed for a in self._leased)

    # -- lease lifecycle ---------------------------------------------------
    def _evict_free(self, count: int = 1) -> int:
        """Drop up to ``count`` least-recently-released free arenas (their
        device buffers go with them, after the ``on_evict`` callbacks).
        Returns how many were evicted."""
        n = min(count, len(self._pooled))
        if n:
            for arena in self._pooled[:n]:
                for hook in self.on_evict:
                    hook(arena)
            del self._pooled[:n]
            self.metrics.arenas_evicted += n
        return n

    def _budget_blocks(self, nbytes: float) -> bool:
        if self.max_arenas and self.arena_count >= self.max_arenas:
            return True
        return bool(self.max_bytes and self.total_bytes() + nbytes > self.max_bytes)

    def can_acquire(self, batch: int, seq: int,
                    demand_bytes: Optional[float] = None) -> bool:
        pooled = any((a.batch, a.seq) == (batch, seq) for a in self._pooled)
        if self.paged:
            need = (demand_bytes if demand_bytes is not None
                    else self.member_bytes(seq, batch, seq))
            if self.max_bytes and self.live_bytes() + need > self.max_bytes:
                return False
            if pooled:
                return True
            if self.max_arenas and len(self._leased) >= self.max_arenas:
                return False
            return True
        if pooled:
            return True
        nbytes = self.arena_bytes(batch, seq)
        if not self._budget_blocks(nbytes):
            return True
        # free arenas of other buckets are evictable — only *leased* memory
        # can genuinely refuse a lease
        if self.max_arenas and len(self._leased) >= self.max_arenas:
            return False
        if self.max_bytes and self.live_bytes() + nbytes > self.max_bytes:
            return False
        return True

    def _build_arena(self, batch: int, seq: int) -> CacheArena:
        if not self.paged:
            return CacheArena(batch, seq, self.model.init_cache(batch, seq, self.device),
                              self.arena_bytes(batch, seq))
        ent, sc, n_pages, page_nbytes, row_nbytes, nbytes = self._arena_params(batch, seq)
        cache = {k: torch.zeros(s, dtype=d, device=self.device)
                 for k, (s, _a, d) in ent.items()}
        return CacheArena(batch, seq, cache, nbytes, page=self.page_size, sc=sc,
                          n_pages=n_pages, page_nbytes=page_nbytes,
                          row_nbytes=row_nbytes,
                          rotating=self.model.decode_window(seq) > 0,
                          paged_keys=[k for k in ent if self.model.is_paged_cache_key(k)])

    def acquire(self, batch: int, seq: int, *, zero: bool = False,
                force: bool = False,
                demand_bytes: Optional[float] = None) -> Optional[CacheArena]:
        """Lease a (batch, seq) arena: recycle a fully-freed one of the same
        bucket, else build one — evicting idle free arenas first if they
        stand between the lease and the budget (None when still refused and
        not ``force``). ``zero`` clears recycled state for tenants that
        decode from a zero cache; ``demand_bytes`` is what a paged lease
        commits at once."""
        arena = next((a for a in self._pooled if (a.batch, a.seq) == (batch, seq)),
                     None)
        if self.paged and not force:
            need = demand_bytes if demand_bytes is not None else 0.0
            blocked = bool(self.max_bytes and self.live_bytes() + need > self.max_bytes)
            if arena is None and self.max_arenas:
                while self.arena_count >= self.max_arenas and self._evict_free():
                    pass
                blocked = blocked or self.arena_count >= self.max_arenas
            if blocked:
                self.metrics.arenas_denied += 1
                return None
        if arena is not None:
            self._pooled.remove(arena)
            if zero:
                for t in arena.cache.values():
                    t.zero_()
            self.metrics.arenas_reused += 1
        else:
            if not self.paged:
                nbytes = self.arena_bytes(batch, seq)
                while self._budget_blocks(nbytes) and self._evict_free():
                    pass
                if not force and self._budget_blocks(nbytes):
                    self.metrics.arenas_denied += 1
                    return None
            arena = self._build_arena(batch, seq)
            self.metrics.arenas_created += 1
        self._leased.append(arena)
        self.metrics.peak_bytes = max(self.metrics.peak_bytes, self.total_bytes())
        return arena

    def alloc_rows(self, arena: CacheArena, n: int) -> Optional[List[int]]:
        rows = arena.alloc_rows(n)
        if rows is not None:
            self.metrics.rows_leased += n
            if arena.generation:
                self.metrics.rows_reused += n
        return rows

    def admit_request_rows(self, arena: CacheArena, n_rows: int, *, prompt: int,
                           span: int, eager: bool = False) -> List[int]:
        """The one paged-row admission sequence: lease ``n_rows`` rows and
        commit each one's pages (prompt-covering pages now, the rest of the
        span reserved — everything with ``eager``)."""
        rows = self.alloc_rows(arena, n_rows)
        if rows is None:
            raise RuntimeError(
                f"KV pool row invariant violated: request needs {n_rows} rows "
                f"but arena {arena.batch}x{arena.seq} has only {arena.rows_free} "
                f"free ({arena.rows_used} leased)")
        for r in rows:
            self.admit_row(arena, r, prompt=prompt, span=span, eager=eager)
        return rows

    def admit_row(self, arena: CacheArena, row: int, *, prompt: int, span: int,
                  eager: bool = False) -> None:
        if not arena.page:
            return
        pages = arena.admit_row(row, prompt, span, eager=eager)
        self.metrics.pages_leased += len(pages)
        self.metrics.peak_pages = max(self.metrics.peak_pages, self.pages_live())
        self.metrics.peak_bytes = max(self.metrics.peak_bytes, self.total_bytes())

    def ensure_decode_slots(self, arena: CacheArena, rows: Sequence[int],
                            pos: int) -> None:
        """Grant the page covering the next write position to ``rows``
        (no-op off a page boundary; draws from admission reservations)."""
        if not arena.paging:
            return
        if not arena.rotating and pos >= arena.sc:
            return  # out-of-capacity writes drop; nothing to grant
        lslot = pos % arena.sc if arena.rotating else pos
        granted = sum(arena.ensure_slot(r, lslot) is not None for r in rows)
        if granted:
            self.metrics.pages_leased += granted
            self.metrics.peak_pages = max(self.metrics.peak_pages, self.pages_live())

    def free_rows(self, arena: CacheArena, rows: Sequence[int], *,
                  early: bool = False) -> None:
        """Return rows (and their pages + undrawn span reservation) to the
        arena. ``early``: the tenant stopped before its full span (eos /
        stop), so the released capacity counts as reclaimed."""
        arena.free_rows(rows)
        undrawn = arena.reserved_for(rows) if early else 0
        freed = arena.release_row_pages(rows)
        self.metrics.pages_freed += freed
        if early:
            self.metrics.pages_reclaimed += freed + undrawn

    def release(self, arena: CacheArena) -> None:
        """Return a leased arena to the free pool (LRU-capped at
        ``max_free``)."""
        self._leased.remove(arena)
        self.metrics.pages_freed += arena.release_row_pages(list(arena._row_pages))
        arena._free = list(range(arena.batch))
        arena.generation += 1
        self._pooled.append(arena)
        if len(self._pooled) > self.max_free:
            self._evict_free(len(self._pooled) - self.max_free)

    # -- the handoff write -------------------------------------------------
    def write_rows(self, arena: CacheArena, rows: Sequence[int],
                   cache: Dict[str, Any],
                   src_rows: Optional[Sequence[int]] = None) -> None:
        """Scatter rows of a prefill-populated dense cache (same bucket
        shape, every leaf ``(L, B, ...)``) into ``rows`` of the arena, in
        place. Paged entries go through the rows' page tables; slots on
        pages a row never committed are dropped (masked on the host, so no
        write lands anywhere)."""
        rows_l = list(rows)
        src_l = list(src_rows) if src_rows is not None else list(range(len(rows_l)))
        if set(cache) != set(arena.cache):
            raise ValueError(
                f"cache keys {sorted(cache)} != arena keys {sorted(arena.cache)}")
        dev = arena.device
        src_idx = torch.tensor(src_l, dtype=torch.long, device=dev)
        rows_idx = torch.tensor(rows_l, dtype=torch.long, device=dev)
        phys_sc, dst_idx, src_flat_idx = -1, None, None
        for k, v in arena.cache.items():
            src = cache[k].index_select(1, src_idx).to(v.dtype)
            if arena.page and k in arena.paged_keys:
                sc = min(arena.sc, src.shape[2])
                if sc != phys_sc:
                    phys = arena.phys_slots(rows_l, sc).reshape(-1)
                    kept = np.nonzero(phys < v.shape[1])[0]
                    dst_idx = torch.tensor(phys[kept], dtype=torch.long, device=dev)
                    src_flat_idx = torch.tensor(kept, dtype=torch.long, device=dev)
                    phys_sc = sc
                flat = src[:, :, :sc].reshape(src.shape[0], len(rows_l) * sc,
                                              *src.shape[3:])
                v.index_copy_(1, dst_idx, flat.index_select(1, src_flat_idx))
            else:
                v.index_copy_(1, rows_idx, src)
        self.metrics.handoff_writes += 1

    def zero_rows(self, arena: CacheArena, rows: Sequence[int]) -> None:
        """Clear ``rows``' state in place — for tenants without a handoff
        write landing on rows recycled mid-lease, whose recurrent state would
        otherwise leak into them. Paged entries are cleared through the
        rows' page tables (slots on uncommitted pages are skipped)."""
        rows_l = list(rows)
        dev = arena.device
        rows_idx = torch.tensor(rows_l, dtype=torch.long, device=dev)
        phys_idx = None
        for k, v in arena.cache.items():
            if arena.page and k in arena.paged_keys:
                if phys_idx is None:
                    phys = arena.phys_slots(rows_l).reshape(-1)
                    phys_idx = torch.tensor(phys[phys < v.shape[1]], dtype=torch.long,
                                            device=dev)
                v.index_fill_(1, phys_idx, 0)
            else:
                v.index_fill_(1, rows_idx, 0)
