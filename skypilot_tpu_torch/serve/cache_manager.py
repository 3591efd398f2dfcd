"""Paged KV-cache management for the batching engine, host side
(mirrors `skypilot_tpu/serve/cache_manager.py`, with its page-pool and
prefix-cache instruments, its journal and its chaos site).

- `PagePool`: free list + per-page refcounts + pins; page 0 is the
  reserved NULL page (freed slots' block tables point at it, so a
  stale device write after a slot is recycled lands in garbage).
  Exhaustion raises `PagesExhausted`, which the engine turns into
  admission backpressure, never an engine failure.  Given a journal,
  the pool records `kv_pages_alloc` / `kv_pages_free {pages, n}` (the
  engine passes one only while someone watches), and `alloc` is the
  `serve.page_pool` chaos site: a deny raises `PagesExhausted`.
- `PrefixCache`: every FULL page of a prompt's prefilled region is
  registered under a chain hash, so requests sharing a prefix adopt
  the cached pages instead of re-prefilling them; LRU-evicted under
  pressure.  Shared pages are never written.
- `PagedKVManager`: what the engine talks to (plan an admission, track
  slot ownership, release on every completion path), plus what a KV
  handoff needs: how deep an import is already cached, fresh pages to
  stage it in, and the hottest entries for a prefix export.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from skypilot_tpu_torch.chaos import injector as chaos_injector
from skypilot_tpu_torch.observability import metrics as metrics_lib

NULL_PAGE = 0

_M_PAGES_TOTAL = metrics_lib.gauge(
    'skytpu_engine_kv_pages_total',
    'Allocatable KV pages in the page pool (excludes the null page).')
_M_PAGES_USED = metrics_lib.gauge(
    'skytpu_engine_kv_pages_used',
    'KV pages currently referenced by live slots or the prefix cache.')
_M_PAGES_PINNED = metrics_lib.gauge(
    'skytpu_engine_kv_pages_pinned',
    'KV pages pinned by the prefix cache (reusable cached prefixes).')
_M_PREFIX_HITS = metrics_lib.counter(
    'skytpu_engine_prefix_cache_hits_total',
    'Prompt pages served from the prefix cache instead of prefill.')
_M_PREFIX_MISSES = metrics_lib.counter(
    'skytpu_engine_prefix_cache_misses_total',
    'Prompt pages that had to be prefilled (no cached prefix).')


class PagesExhausted(RuntimeError):
    """The page pool cannot satisfy an allocation right now."""


def chunk_hashes(token_ids: Sequence[int], page_size: int) -> List[int]:
    """Chain hashes of every FULL page of `token_ids`: hash(page j)
    covers pages 0..j, so a hit at page j certifies the whole prefix."""
    out: List[int] = []
    prev = 0
    for start in range(0, len(token_ids) - page_size + 1, page_size):
        prev = hash((prev, tuple(token_ids[start:start + page_size])))
        out.append(prev)
    return out


class PagePool:
    """Fixed pool of KV pages.  A page is USED while ref + pin > 0.
    Thread-safe: submit() threads probe headroom while the worker
    allocates and frees."""

    def __init__(self, n_pages: int, page_size: int,
                 journal: Optional[Any] = None) -> None:
        if n_pages < 2:
            raise ValueError(f'page pool needs >= 2 pages (one is the '
                             f'reserved null page), got {n_pages}')
        if page_size < 1:
            raise ValueError(f'page_size must be >= 1, got {page_size}')
        self.n_pages = n_pages
        self.page_size = page_size
        self._lock = threading.Lock()
        self._free: collections.deque = collections.deque(
            range(1, n_pages))
        self._ref = [0] * n_pages
        self._pin = [0] * n_pages
        # None unless someone watches: no I/O on the admission path.
        self._journal = journal

    @property
    def capacity(self) -> int:
        return self.n_pages - 1          # null page excluded

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_count(self) -> int:
        with self._lock:
            return self.capacity - len(self._free)

    @property
    def pinned_count(self) -> int:
        with self._lock:
            return sum(1 for p in self._pin if p > 0)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref[page]

    def alloc(self, n: int) -> List[int]:
        """Allocate n fresh pages (ref 1 each), all or nothing."""
        if chaos_injector.inject('serve.page_pool', need=n,
                                 free=self.free_count) is chaos_injector.DENY:
            raise PagesExhausted(
                f'chaos: page pool denied allocation of {n} page(s)')
        with self._lock:
            if n > len(self._free):
                raise PagesExhausted(
                    f'page pool exhausted: need {n} page(s), '
                    f'{len(self._free)} free of {self.capacity}')
            pages = [self._free.popleft() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
        self._record('kv_pages_alloc', pages)
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                if self._ref[p] + self._pin[p] <= 0:
                    raise ValueError(f'incref of unallocated page {p}')
                self._ref[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages with no refs and no pins
        return to the free list."""
        freed: List[int] = []
        with self._lock:
            for p in pages:
                if self._ref[p] <= 0:
                    raise ValueError(f'decref of page {p} with refcount '
                                     f'{self._ref[p]}')
                self._ref[p] -= 1
                if self._ref[p] == 0 and self._pin[p] == 0:
                    self._free.append(p)
                    freed.append(p)
        if freed:
            self._record('kv_pages_free', freed)

    def pin(self, page: int) -> None:
        """Prefix-cache hold: keeps the page resident at ref 0."""
        with self._lock:
            if self._ref[page] + self._pin[page] <= 0:
                raise ValueError(f'pin of unallocated page {page}')
            self._pin[page] += 1

    def unpin(self, page: int) -> None:
        freed = False
        with self._lock:
            if self._pin[page] <= 0:
                raise ValueError(f'unpin of unpinned page {page}')
            self._pin[page] -= 1
            if self._pin[page] == 0 and self._ref[page] == 0:
                self._free.append(page)
                freed = True
        if freed:
            self._record('kv_pages_free', [page])

    def cow(self, page: int) -> Tuple[int, bool]:
        """Copy-on-write: (writable_page, needs_copy).  A private page
        comes back as-is; a shared or pinned one gets a fresh page (the
        caller copies the device contents) and drops the shared ref."""
        with self._lock:
            if self._ref[page] == 1 and self._pin[page] == 0:
                return page, False
        fresh = self.alloc(1)[0]
        self.decref([page])
        return fresh, True

    def _record(self, event: str, pages: List[int]) -> None:
        if self._journal is None:
            return
        try:
            self._journal.append(event, pages=list(pages), n=len(pages))
        except Exception:  # pylint: disable=broad-except
            pass  # recording must never break the admission path


class PrefixCache:
    """Chain hash -> cached page, LRU order.  Entries pin their page; a
    match increfs the page for the adopting slot."""

    def __init__(self, pool: PagePool) -> None:
        self._pool = pool
        self._entries: 'collections.OrderedDict[int, int]' = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def contains(self, h: int) -> bool:
        """Membership probe (no incref, no LRU touch): a KV import skips
        pages already resident."""
        return h in self._entries

    def match(self, hashes: Sequence[int]) -> List[int]:
        """Longest chain of cached pages; matched pages are incref'd."""
        pages: List[int] = []
        for h in hashes:
            page = self._entries.get(h)
            if page is None:
                break
            pages.append(page)
            self._entries.move_to_end(h)
        if pages:
            self._pool.incref(pages)
        self.hits += len(pages)
        self.misses += len(hashes) - len(pages)
        _M_PREFIX_HITS.inc(len(pages))
        _M_PREFIX_MISSES.inc(len(hashes) - len(pages))
        return pages

    def register(self, hashes: Sequence[int],
                 pages: Sequence[int]) -> None:
        """Publish freshly prefilled full pages (first writer wins)."""
        for h, page in zip(hashes, pages):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            self._pool.pin(page)
            self._entries[h] = page

    def evict(self, n_pages: int) -> int:
        """Unpin up to n_pages idle LRU entries; returns pages released."""
        released = 0
        for h in list(self._entries):
            if released >= n_pages:
                break
            page = self._entries[h]
            if self._pool.refcount(page) > 0:
                continue
            del self._entries[h]
            self._pool.unpin(page)
            released += 1
        return released

    def evictable(self) -> int:
        return sum(1 for page in self._entries.values()
                   if self._pool.refcount(page) == 0)

    def hot_entries(self, n: int) -> List[Tuple[int, int]]:
        """The n most recently used (hash, page) entries.  Each entry is
        an independent hash -> page mapping, so any subset transfers
        (the drain-time prefix export)."""
        items = list(self._entries.items())
        return items[-n:] if n > 0 else []

    def clear(self) -> None:
        for h in list(self._entries):
            self._pool.unpin(self._entries.pop(h))


@dataclasses.dataclass
class AdmissionPlan:
    """Everything the engine needs to land one request in pages."""
    row: List[int]            # block-table row: reused + fresh pages
    reuse_pages: List[int]    # cached pages adopted (prefix hit)
    fresh_pages: List[int]    # newly allocated pages
    n_reuse_tokens: int       # positions [0, n_reuse_tokens) are cached
    page_hashes: List[int]    # chain hashes of the prompt's full pages

    @property
    def prefix_hit_pages(self) -> int:
        return len(self.reuse_pages)


class PagedKVManager:
    """Pool + prefix cache + slot -> pages ownership for one engine."""

    def __init__(self, n_pages: int, page_size: int,
                 prefix_caching: bool = True,
                 journal: Optional[Any] = None) -> None:
        self.pool = PagePool(n_pages, page_size, journal=journal)
        self.page_size = page_size
        self.prefix_caching = prefix_caching
        self.prefix = PrefixCache(self.pool)
        self._slot_pages: Dict[int, List[int]] = {}

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages covering every position the request can touch: [0, n)
        for the prompt, then decode writes through n + max_new - 2."""
        total_positions = max(1, prompt_len + max_new_tokens - 1)
        return -(-total_positions // self.page_size)

    def can_admit(self, n_pages: int) -> bool:
        return self.pool.free_count + self.prefix.evictable() >= n_pages

    def plan_admission(self, prompt_ids: Sequence[int],
                       max_new_tokens: int, *,
                       prefix_ok: bool = True) -> AdmissionPlan:
        """Match the prompt against the prefix cache and allocate the
        fresh remainder; raises PagesExhausted (matched pages released).
        `prefix_ok=False` (MoE) neither matches nor publishes a prefix."""
        ps = self.page_size
        n = len(prompt_ids)
        total_pages = self.pages_needed(n, max_new_tokens)
        # Only pages fully inside the PREFILLED region [0, n-1) share.
        hashes = (chunk_hashes(prompt_ids[:n - 1], ps)
                  if prefix_ok and self.prefix_caching and n > 1 else [])
        reuse = self.prefix.match(hashes)
        try:
            fresh = self._alloc_with_eviction(total_pages - len(reuse))
        except PagesExhausted:
            if reuse:
                self.pool.decref(reuse)
            raise
        return AdmissionPlan(row=reuse + fresh, reuse_pages=reuse,
                             fresh_pages=fresh,
                             n_reuse_tokens=len(reuse) * ps,
                             page_hashes=hashes)

    def _alloc_with_eviction(self, n: int) -> List[int]:
        if n <= 0:
            return []
        shortfall = n - self.pool.free_count
        if shortfall > 0:
            self.prefix.evict(shortfall)
        return self.pool.alloc(n)

    def alloc_pages(self, n: int) -> List[int]:
        """n fresh pages (evicting idle prefix entries under pressure);
        raises PagesExhausted.  A KV import stages its pages here before
        publishing them."""
        return self._alloc_with_eviction(n)

    def import_prefix_depth(self, hashes: Sequence[int]) -> int:
        """Longest leading run of `hashes` already in the prefix cache:
        an import skips those pages (a chain hash can only be cached if
        every earlier one was, so the run stops at the first miss)."""
        depth = 0
        for h in hashes:
            if not self.prefix.contains(h):
                break
            depth += 1
        return depth

    def commit(self, slot: int, plan: AdmissionPlan) -> None:
        self._slot_pages[slot] = list(plan.row)

    def slot_row(self, slot: int) -> Optional[List[int]]:
        """The page row a slot owns (None before commit)."""
        pages = self._slot_pages.get(slot)
        return list(pages) if pages is not None else None

    def abandon(self, plan: AdmissionPlan) -> None:
        """Drop a plan that never reached a slot."""
        if plan.row:
            self.pool.decref(plan.row)

    def register_prefix(self, plan: AdmissionPlan) -> None:
        """Publish the plan's freshly written FULL prompt pages."""
        if not self.prefix_caching:
            return
        full = len(plan.page_hashes)
        r = len(plan.reuse_pages)
        if full > r:
            self.prefix.register(plan.page_hashes[r:full], plan.row[r:full])

    def release(self, slot: int) -> None:
        """Free a slot's pages; idempotent."""
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self.pool.decref(pages)

    def release_all(self) -> None:
        for slot in list(self._slot_pages):
            self.release(slot)
        self.prefix.clear()

    def stats(self) -> Dict[str, int]:
        stats = {
            'kv_pages_total': self.pool.capacity,
            'kv_pages_used': self.pool.used_count,
            'kv_pages_free': self.pool.free_count,
            'kv_pages_pinned': self.pool.pinned_count,
            'page_size': self.page_size,
            'prefix_cache_entries': len(self.prefix),
            'prefix_cache_hits': self.prefix.hits,
            'prefix_cache_misses': self.prefix.misses,
        }
        # Scrape-time gauges: /metrics calls engine.stats() first.
        _M_PAGES_TOTAL.set(stats['kv_pages_total'])
        _M_PAGES_USED.set(stats['kv_pages_used'])
        _M_PAGES_PINNED.set(stats['kv_pages_pinned'])
        return stats
