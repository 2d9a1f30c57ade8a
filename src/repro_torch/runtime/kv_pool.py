"""Paged KV-cache subsystem: block allocator + prefix cache (host side).

The KV cache is serving's scarce resource, the way chips are the paper's:
continuous batching made decode work proportional to live tokens,
but every slot still *reserved* a dense ``(max_len)`` HBM stripe.  This
module is the allocator that fixes the reservation side — the serving
analogue of Scylla's policy-driven resource pool:

* ``PagePool`` — a global pool of fixed-size pages (``page_size`` token
  positions each), refcounted, with a free list kept per HBM *bank*.
  Physical page 0 is reserved as the **null page**: free slots' page
  tables point at it and inactive writes land there, so the device side
  never needs a branch.
* Allocation **policies** mirror ``core/policies.py``: ``pack``
  (MinHostPolicy analogue — fill the fewest banks, contiguous page runs)
  vs ``spread`` (SpreadPolicy analogue — round-robin the emptiest banks
  so concurrent slots stream from disjoint banks).  Registered in
  ``KV_PAGE_POLICIES`` just like ``POLICIES``.
* ``PrefixCache`` — content-addressed full pages: chain-hash each
  ``page_size``-token prompt chunk onto its parent hash and map it to
  the page holding its K/V.  A later prompt sharing the prefix is
  admitted at ``pos = matched`` with the cached pages mapped read-only
  (refcount shared); **copy-on-write** fires when the admission must
  write into a shared page (full-prompt hits re-run the last page to
  recover logits).  Cache-only pages (refcount 1) are evicted LRU-first
  under pool pressure.
* ``KVCacheManager`` — per-slot page tables gluing the above to
  ``ServeEngine``: admission reserves exactly the pages a request can
  touch (``ceil((prompt + max_new) / page_size)``, not ``max_len``),
  returns ``None`` for backpressure when the pool is exhausted, and
  frees pages the moment a request finishes.

Everything here is host-side bookkeeping (numpy + dicts); the device
side consumes only the ``(slots, max_pages)`` int32 page-table array and
the (src, dst) page-copy list that admission returns.
"""
from __future__ import annotations

import hashlib
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised by ``PagePool.alloc`` when the free list cannot satisfy a
    request; ``KVCacheManager`` turns this into backpressure."""


# ---------------------------------------------------------------- policies
class PagePolicy:
    """Chooses which free pages an allocation takes (bank placement)."""

    name = "base"

    def select(self, free_by_bank: dict[int, list[int]],
               in_use_by_bank: dict[int, int], n: int) -> list[int]:
        raise NotImplementedError


class PackPagePolicy(PagePolicy):
    """Fill the fewest banks: partially-used banks first, lowest page ids
    within a bank (contiguous runs — the MinHostPolicy analogue: keep
    allocations dense so whole banks stay free for future jobs)."""

    name = "pack"

    def select(self, free_by_bank, in_use_by_bank, n):
        order = sorted(free_by_bank,
                       key=lambda b: (-in_use_by_bank[b], b))
        out: list[int] = []
        for b in order:
            take = free_by_bank[b][:n - len(out)]
            out.extend(take)
            if len(out) == n:
                break
        return out


class SpreadPagePolicy(PagePolicy):
    """Round-robin the emptiest banks (the SpreadPolicy analogue): one
    page per bank per round so concurrent slots stream KV from as many
    banks as possible, at the cost of fragmenting bank-contiguity."""

    name = "spread"

    def select(self, free_by_bank, in_use_by_bank, n):
        order = sorted(free_by_bank,
                       key=lambda b: (in_use_by_bank[b], b))
        out: list[int] = []
        idx = {b: 0 for b in order}
        while len(out) < n:
            progressed = False
            for b in order:
                if len(out) < n and idx[b] < len(free_by_bank[b]):
                    out.append(free_by_bank[b][idx[b]])
                    idx[b] += 1
                    progressed = True
            if not progressed:
                break
        return out


KV_PAGE_POLICIES = {
    "pack": PackPagePolicy,
    "spread": SpreadPagePolicy,
}


def get_page_policy(name: str) -> PagePolicy:
    return KV_PAGE_POLICIES[name]()


# -------------------------------------------------------------------- pool
class PagePool:
    """Refcounted fixed-size page pool with bank-aware placement.

    Pages are numbered 0..num_pages-1; page 0 is the reserved null page
    (never allocated, refcount pinned).  Banks stripe the pool into
    ``num_banks`` contiguous regions — the model of HBM channels the
    placement policies optimize over.

    ``num_hosts > 1`` (sharded serving) additionally partitions the pool
    into equal contiguous *host sub-pools*: the device-side page pools
    are sharded over the mesh's "data" axis, so pages
    ``[h * num_pages/H, (h+1) * num_pages/H)`` physically live on host
    (data row) ``h``.  ``alloc(host=h)`` then draws only from that
    host's banks, keeping a slot's whole page chain host-local — decode
    for the slot never gathers KV across hosts.  The null page sits in
    host 0's range (host 0 has one page less of capacity).
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 policy: str | PagePolicy = "pack", num_banks: int = 8,
                 num_hosts: int = 1):
        assert num_pages >= 2, "need at least the null page + one real page"
        assert page_size >= 1
        assert num_hosts >= 1
        if num_hosts > 1 and num_pages % num_hosts:
            # host sub-pools must tile the pool evenly (the device page
            # dim shards over the data axes) — round capacity UP rather
            # than refuse, so a caller-sized pool never silently shrinks
            # and never hard-errors.  Callers that size device arrays
            # from the pool must read back ``pool.num_pages``.
            rounded = -(-num_pages // num_hosts) * num_hosts
            warnings.warn(
                f"num_pages {num_pages} not divisible by num_hosts "
                f"{num_hosts}; rounding up to {rounded} so host sub-pools "
                f"align with the device shard of the page dim",
                RuntimeWarning, stacklevel=2)
            num_pages = rounded
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_banks = max(1, min(num_banks, num_pages - 1))
        self.num_hosts = num_hosts
        self._per_host = num_pages // num_hosts
        self.policy = (policy if isinstance(policy, PagePolicy)
                       else get_page_policy(policy))
        self._per_bank = -(-num_pages // self.num_banks)
        self.ref = np.zeros(num_pages, np.int32)
        self.ref[0] = 1  # null page: pinned, never on the free list
        self._free_by_bank: dict[int, list[int]] = {
            b: [] for b in range(self.num_banks)}
        for p in range(1, num_pages):
            self._free_by_bank[self.bank_of(p)].append(p)
        self._in_use_by_bank: dict[int, int] = {
            b: 0 for b in range(self.num_banks)}

    def bank_of(self, page: int) -> int:
        return page // self._per_bank

    def host_of(self, page: int) -> int:
        return page // self._per_host

    @property
    def available(self) -> int:
        return sum(len(v) for v in self._free_by_bank.values())

    @property
    def capacity(self) -> int:
        return self.num_pages - 1  # null page excluded

    @property
    def in_use(self) -> int:
        return self.capacity - self.available

    def free_by_host(self) -> list[int]:
        """Free-page count per host sub-pool (length ``num_hosts``) —
        what a sharded engine's ``offer()`` advertises."""
        counts = [0] * self.num_hosts
        for pages in self._free_by_bank.values():
            for p in pages:
                counts[self.host_of(p)] += 1
        return counts

    def free_in_host(self, host: int) -> int:
        return self.free_by_host()[host]

    def alloc(self, n: int = 1, *, host: Optional[int] = None) -> list[int]:
        """Take ``n`` pages (refcount 1 each) per the placement policy.

        ``host`` restricts the draw to one host sub-pool; ``None`` with
        ``num_hosts > 1`` picks the sub-pool with the most free pages
        (deterministic: lowest index on ties), so unconstrained chains —
        disagg adoptions, for instance — still stay host-local."""
        if n <= 0:
            return []
        if self.num_hosts > 1 and host is None:
            by_host = self.free_by_host()
            host = max(range(self.num_hosts), key=lambda h: (by_host[h], -h))
        if host is not None and self.num_hosts > 1:
            free = {b: [p for p in pages if self.host_of(p) == host]
                    for b, pages in self._free_by_bank.items()}
            free = {b: pages for b, pages in free.items() if pages}
            if sum(len(v) for v in free.values()) < n:
                raise PoolExhausted(
                    f"need {n} pages on host {host}, "
                    f"{self.free_in_host(host)} free of {self._per_host}")
        else:
            free = self._free_by_bank
            if self.available < n:
                raise PoolExhausted(
                    f"need {n} pages, {self.available} free of "
                    f"{self.capacity}")
        pages = self.policy.select(free, self._in_use_by_bank, n)
        assert len(pages) == n, (len(pages), n)
        for p in pages:
            self._free_by_bank[self.bank_of(p)].remove(p)
            self._in_use_by_bank[self.bank_of(p)] += 1
            assert self.ref[p] == 0, f"page {p} on free list with refs"
            self.ref[p] = 1
        return pages

    def incref(self, page: int):
        assert 0 < page < self.num_pages, page
        assert self.ref[page] > 0, f"incref of free page {page}"
        self.ref[page] += 1

    def decref(self, page: int):
        assert 0 < page < self.num_pages, page
        assert self.ref[page] > 0, f"double free of page {page}"
        self.ref[page] -= 1
        if self.ref[page] == 0:
            b = self.bank_of(page)
            self._free_by_bank[b].append(page)
            self._free_by_bank[b].sort()
            self._in_use_by_bank[b] -= 1

    def banks_touched(self, pages) -> int:
        return len({self.bank_of(p) for p in pages})


# ------------------------------------------------------------ prefix cache
def _chunk_key(parent: str, chunk: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(parent.encode())
    h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
    return h.hexdigest()


class PrefixCache:
    """Content-addressed map of full prompt pages -> physical pages.

    Keys chain-hash each ``page_size``-token chunk with its parent's key,
    so a hit on chunk *i* implies chunks 0..i-1 all matched.  The cache
    holds one refcount per entry; entries whose page refcount has dropped
    to 1 (cache-only) are evictable, LRU order.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._map: OrderedDict[str, int] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._map)

    def probe(self, prompt: np.ndarray) -> list[int]:
        """Read-only longest-cached-prefix pages — no increfs, no LRU
        moves, no hit/miss accounting.  ``KVCacheManager``'s sizing
        queries (``fits_now`` et al.) use this so a scheduler merely
        *considering* an admission never perturbs cache state."""
        ps = self.pool.page_size
        parent = ""
        pages: list[int] = []
        for i in range(len(prompt) // ps):
            key = _chunk_key(parent, prompt[i * ps:(i + 1) * ps])
            page = self._map.get(key)
            if page is None:
                break
            parent = key
            pages.append(page)
        return pages

    def evictable(self, exclude=(), host: Optional[int] = None) -> int:
        """Pages ``evict`` could free right now (cache-only, ref 1).
        ``exclude`` lists pages the prospective admission would itself
        use: its ``lookup`` increfs them *before* ``evict`` runs, so
        they must not be counted as reclaimable headroom.  ``host``
        counts only one host sub-pool (sharded serving: eviction there
        frees pages only that host's allocations can reuse)."""
        skip = set(exclude)
        return sum(1 for pg in self._map.values()
                   if self.pool.ref[pg] == 1 and pg not in skip
                   and (host is None or self.pool.host_of(pg) == host))

    def lookup(self, prompt: np.ndarray) -> tuple[list[int], int]:
        """Longest cached prefix of ``prompt`` in whole pages.

        Returns (pages, matched_tokens); each returned page has been
        incref'd on the caller's behalf (the caller decrefs on finish).
        """
        ps = self.pool.page_size
        pages: list[int] = []
        parent = ""
        for i in range(len(prompt) // ps):
            key = _chunk_key(parent, prompt[i * ps:(i + 1) * ps])
            page = self._map.get(key)
            if page is None:
                self.misses += 1
                break
            self._map.move_to_end(key)
            self.pool.incref(page)
            pages.append(page)
            parent = key
            self.hits += 1
        return pages, len(pages) * ps

    def insert(self, prompt: np.ndarray, blocks: list[int]):
        """Register ``prompt``'s full pages (blocks[i] holds tokens
        ``[i*ps, (i+1)*ps)``).  Existing entries are kept (first writer
        wins); new entries take one cache refcount."""
        ps = self.pool.page_size
        parent = ""
        for i in range(len(prompt) // ps):
            key = _chunk_key(parent, prompt[i * ps:(i + 1) * ps])
            if key not in self._map:
                self._map[key] = blocks[i]
                self.pool.incref(blocks[i])
            parent = key

    def evict(self, n_pages: int, host: Optional[int] = None) -> int:
        """Drop up to ``n_pages`` cache-only entries (page refcount 1),
        oldest first; ``host`` restricts to one host sub-pool.  Returns
        the number of pages actually freed."""
        freed = 0
        for key in list(self._map):
            if freed >= n_pages:
                break
            page = self._map[key]
            if self.pool.ref[page] == 1 and (
                    host is None or self.pool.host_of(page) == host):
                del self._map[key]
                self.pool.decref(page)
                freed += 1
        return freed


# ---------------------------------------------------------------- manager
@dataclass
class AdmitResult:
    """What the engine needs to act on an admission."""

    start: int  # prefill resumes here (tokens [start, len(prompt)) run)
    matched: int  # tokens satisfied by the prefix cache
    cow: list = field(default_factory=list)  # [(src_page, dst_page)] copies
    blocks: list = field(default_factory=list)


class KVCacheManager:
    """Per-slot page tables over a shared ``PagePool`` (+ prefix cache).

    The device contract is the ``page_table`` int32 array
    ``(slots, max_pages)``: logical block *i* of slot *s* lives in
    physical page ``page_table[s, i]`` (0 = null page for unmapped
    blocks).  One table serves every layer — layer pools are stacked, so
    a (page, offset) write lands at the same coordinates in each.

    ``num_hosts > 1`` (sharded serving): the device page pools are
    sharded over the mesh's "data" axis, so the manager partitions
    slots and pages alike — slot ``s`` belongs to host
    ``s * num_hosts // slots`` (the contiguous-block shard of the slot
    dim) and its admissions allocate only from that host's page
    sub-pool, keeping every chain's KV on the host that computes the
    slot's queries.  Prefix-cache chains are shared only within a host
    for the same reason.  Locality is a *placement* property — resumed
    or adopted chains from another host still decode correctly, just
    with cross-host gathers.
    """

    def __init__(self, *, slots: int, max_len: int, page_size: int,
                 num_pages: int, policy: str | PagePolicy = "pack",
                 prefix_cache: bool = True, num_banks: int = 8,
                 chunk: int = 0, num_hosts: int = 1):
        assert max_len % page_size == 0, (max_len, page_size)
        self.page_size = page_size
        self.max_pages = max_len // page_size
        self.max_len = max_len
        self.slots = slots
        self.num_hosts = num_hosts
        self.chunk = chunk or page_size  # engine's prefill-chunk grid
        assert self.chunk % page_size == 0, (self.chunk, page_size)
        self.pool = PagePool(num_pages, page_size, policy=policy,
                             num_banks=num_banks, num_hosts=num_hosts)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.page_table = np.zeros((slots, self.max_pages), np.int32)
        self._held: list[list[int]] = [[] for _ in range(slots)]
        # metrics: a private registry by default; the owning engine
        # rebinds onto the shared one (ServeEngine.bind_telemetry)
        self.bind_metrics(None, 0)

    def slot_host(self, slot: int) -> Optional[int]:
        """Host (mesh "data" row) that computes ``slot``'s queries —
        the contiguous-block partition jax uses for the sharded slot
        dim.  None when unsharded (num_hosts == 1)."""
        if self.num_hosts == 1:
            return None
        return slot * self.num_hosts // self.slots

    def free_by_host(self) -> list[int]:
        """Per-host free-page counts (``offer()`` advertises these)."""
        return self.pool.free_by_host()

    def bind_metrics(self, registry, replica: int) -> None:
        """Register the pool's series on ``registry`` (private
        ``MetricsRegistry`` when None) as function-backed gauges — the
        allocator keeps its own bookkeeping hot; the registry reads it
        live at export time, and ``stats()`` reads back through the
        registry so the legacy dict stays a view, not a second ledger."""
        from repro_torch.runtime.telemetry import MetricsRegistry
        if registry is None:
            registry = MetricsRegistry()
        self._registry = registry
        self._replica = int(replica)
        lbl = {"replica": str(replica)}
        for name, help, fn in (
                ("kv_page_size", "tokens per KV page",
                 lambda: self.page_size),
                ("kv_pages_capacity", "allocatable pages in the pool",
                 lambda: self.pool.capacity),
                ("kv_pages_in_use", "pages currently referenced",
                 lambda: self.pool.in_use),
                ("kv_prefix_entries", "prefix-cache chains resident",
                 lambda: 0 if self.prefix is None else len(self.prefix)),
                ("kv_prefix_hits", "prefix-cache probe hits",
                 lambda: 0 if self.prefix is None else self.prefix.hits),
                ("kv_prefix_misses", "prefix-cache probe misses",
                 lambda: 0 if self.prefix is None else self.prefix.misses)):
            registry.gauge(name, help, ("replica",)).labels(
                **lbl).set_function(fn)

    # ------------------------------------------------------------- sizing
    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        need = min(prompt_len + max_new, self.max_len)
        return -(-need // self.page_size)

    def _sizing(self, prompt: np.ndarray, max_new: int):
        """(fresh pages an ``admit`` would allocate, its cached-prefix
        pages) — the sizing half of ``admit`` with zero side effects."""
        prompt = np.asarray(prompt, np.int32)
        p = len(prompt)
        n_blocks = self.blocks_needed(p, max_new)
        cached = [] if self.prefix is None else self.prefix.probe(prompt)
        matched = len(cached) * self.page_size
        start = (min(matched, p - 1) // self.chunk) * self.chunk
        cow = max(0, len(cached) - start // self.page_size)
        return n_blocks - len(cached) + cow, cached

    def pages_needed_now(self, prompt: np.ndarray, max_new: int) -> int:
        """Fresh pages an ``admit`` of this request would allocate RIGHT
        NOW (prefix sharing and CoW headroom included), side-effect
        free — the testable spec of ``admit``'s pool consumption
        (tests/test_preemption.py holds them equal)."""
        return self._sizing(prompt, max_new)[0]

    def fits_now(self, prompt: np.ndarray, max_new: int,
                 slot: Optional[int] = None) -> bool:
        """Could ``admit`` succeed right now?  The scheduler's
        preemption phase gates swaps on this (an accurate estimate —
        over-estimating demand would suppress justified evictions).
        Evictable prefix-cache pages count as available (``admit``
        evicts them itself) — except the request's own cached prefix,
        which its lookup increfs before eviction runs.

        Sharded (num_hosts > 1): the answer is per host sub-pool —
        ``slot`` pins the host; without a slot the *best* host is
        assumed (a router-facing estimate; the admit of a specific
        slot on a fuller host can still backpressure)."""
        need, cached = self._sizing(prompt, max_new)
        if self.num_hosts == 1:
            avail = self.pool.available
            if self.prefix is not None:
                avail += self.prefix.evictable(exclude=cached)
            return need <= avail
        hosts = ([self.slot_host(slot)] if slot is not None
                 else range(self.num_hosts))
        by_host = self.pool.free_by_host()
        for h in hosts:
            avail = by_host[h]
            if self.prefix is not None:
                avail += self.prefix.evictable(exclude=cached, host=h)
            if need <= avail:
                return True
        return False

    def fits_ever(self, prompt_len: int, max_new: int) -> bool:
        """Could this request EVER be admitted (empty pool)?"""
        n = self.blocks_needed(prompt_len, max_new)
        # headroom: a prefix hit that re-runs the last chunk CoWs at most
        # chunk // page_size shared pages
        return (n <= self.max_pages
                and n + self.chunk // self.page_size <= self.pool.capacity)

    # ---------------------------------------------------------- admission
    def admit(self, slot: int, prompt: np.ndarray,
              max_new: int) -> Optional[AdmitResult]:
        """Reserve pages for a request; None = backpressure (try later).

        On success the slot's page-table row maps every block the request
        can touch; cached prefix pages are shared (read-only) and the
        result carries the (src, dst) device copies CoW demands.

        The prefill start is the largest multiple of ``self.chunk`` (the
        engine's prefill-chunk grid) not past the matched prefix; a
        full-prompt hit re-runs the last chunk to recover the logits that
        seed decode.  Every shared page the rewrite touches is CoW'd —
        the rewrite produces the same K/V, but the shared page must not
        see even an identical write while other slots read it.

        Sharded (num_hosts > 1): every fresh page comes from the slot's
        own host sub-pool, and a cached prefix chain is reused only when
        it lives on that host (otherwise it is released and re-run —
        correctness would survive a cross-host chain, locality would
        not).
        """
        assert not self._held[slot], f"slot {slot} already holds pages"
        host = self.slot_host(slot)
        prompt = np.asarray(prompt, np.int32)
        p = len(prompt)
        ps = self.page_size
        chunk = self.chunk
        n_blocks = self.blocks_needed(p, max_new)

        cached: list[int] = []
        matched = 0
        if self.prefix is not None:
            cached, matched = self.prefix.lookup(prompt)
            if host is not None and any(self.pool.host_of(pg) != host
                                        for pg in cached):
                for pg in cached:  # wrong host: treat as a miss
                    self.pool.decref(pg)
                cached, matched = [], 0
        start = (min(matched, p - 1) // chunk) * chunk
        first_write_block = start // ps
        cow_blocks = list(range(first_write_block, len(cached)))
        need_new = n_blocks - len(cached) + len(cow_blocks)
        free = (self.pool.available if host is None
                else self.pool.free_in_host(host))
        if free < need_new and self.prefix is not None:
            self.prefix.evict(need_new - free, host=host)
            free = (self.pool.available if host is None
                    else self.pool.free_in_host(host))
        if free < need_new:
            for pg in cached:  # roll back lookup refs; stay queued
                self.pool.decref(pg)
            return None
        fresh = self.pool.alloc(need_new, host=host)
        blocks = list(cached)
        cow = []
        for blk in cow_blocks:
            dst = fresh.pop()
            cow.append((blocks[blk], dst))
            self.pool.decref(blocks[blk])
            blocks[blk] = dst
        blocks.extend(fresh)
        assert len(blocks) == n_blocks, (len(blocks), n_blocks)
        self.page_table[slot, :] = 0
        self.page_table[slot, :n_blocks] = blocks
        self._held[slot] = blocks
        return AdmitResult(start=start, matched=matched, cow=cow,
                           blocks=blocks)

    def slot_span(self, slot: int) -> int:
        """Writable logical positions of ``slot``'s mapped page chain
        (``held pages * page_size``).  The speculative engine caps each
        tick's draft depth by this: admission reserved exactly
        ``ceil((prompt + max_new) / page_size)`` pages, and a draft
        never extends past the token budget, so in-flight drafts always
        fit the reservation — this is the belt-and-braces bound that
        keeps an off-by-one from ever writing through an unheld
        page-table entry."""
        return len(self._held[slot]) * self.page_size

    def register_prefix(self, slot: int, prompt: np.ndarray):
        """After prefill: publish the slot's full prompt pages for reuse."""
        if self.prefix is not None:
            self.prefix.insert(np.asarray(prompt, np.int32),
                               self._held[slot])

    def free_slot(self, slot: int):
        for pg in self._held[slot]:
            self.pool.decref(pg)
        self._held[slot] = []
        self.page_table[slot, :] = 0

    # --------------------------------------------------------- preemption
    def detach_slot(self, slot: int) -> list[int]:
        """Preemption: transfer the slot's page chain to the caller's
        checkpoint and unmap the row.  Zero-copy — refcounts are
        unchanged (the checkpoint now owns the slot's hold, so the pages
        can be neither reallocated nor prefix-evicted), and the K/V bytes
        never move.  ``attach_slot`` is the inverse at resume."""
        pages = self._held[slot]
        self._held[slot] = []
        self.page_table[slot, :] = 0
        return pages

    def attach_slot(self, slot: int, pages: list[int]):
        """Resume a detached page chain into ``slot`` (any free slot —
        page indirection makes the chain slot-independent)."""
        assert not self._held[slot], f"slot {slot} already holds pages"
        assert len(pages) <= self.max_pages, (len(pages), self.max_pages)
        self._held[slot] = list(pages)
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(pages)] = pages

    # ------------------------------------------------- cross-engine transfer
    def can_adopt(self, n: int) -> bool:
        """Could ``adopt_chain(n)`` succeed right now?  Evictable
        prefix-cache pages count — ``adopt_chain`` evicts them itself.
        Sharded: the chain must fit one host sub-pool (chains stay
        host-local), so the best host decides."""
        if n > self.max_pages:
            return False
        if self.num_hosts == 1:
            avail = self.pool.available
            if self.prefix is not None:
                avail += self.prefix.evictable()
            return n <= avail
        by_host = self.pool.free_by_host()
        return any(n <= by_host[h] + (0 if self.prefix is None else
                                      self.prefix.evictable(host=h))
                   for h in range(self.num_hosts))

    def adopt_chain(self, n: int) -> Optional[list[int]]:
        """Allocate ``n`` fresh pages in THIS pool to receive a page
        chain detached from *another* engine's pool — the destination
        half of a cross-engine handoff.  ``None`` = backpressure (the
        handoff stays queued).  The caller copies the K/V bytes across
        (``copy_cache_pages_across``) and then calls the source pool's
        ``release_chain`` on the old pages, keeping both pools
        refcount-balanced.  Sharded: the adopted chain lands whole on
        the emptiest host sub-pool (``PagePool.alloc(host=None)``)."""
        if n > self.max_pages:
            return None
        if self.num_hosts == 1:
            if self.pool.available < n and self.prefix is not None:
                self.prefix.evict(n - self.pool.available)
            if self.pool.available < n:
                return None
            return self.pool.alloc(n)
        by_host = self.pool.free_by_host()
        best = max(range(self.num_hosts), key=lambda h: (by_host[h], -h))
        if by_host[best] < n and self.prefix is not None:
            self.prefix.evict(n - by_host[best], host=best)
        if self.pool.free_in_host(best) < n:
            return None
        return self.pool.alloc(n, host=best)

    def release_chain(self, pages: list[int]) -> None:
        """Drop a detached chain's hold on THIS pool — the source half of
        a completed cross-engine transfer (or a discarded checkpoint).
        The inverse of the hold ``detach_slot`` handed the caller."""
        for pg in pages:
            self.pool.decref(pg)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Legacy stats dict, read back through the metrics registry
        (the ``kv_*`` function-backed gauges registered in
        ``bind_metrics``) — key set is schema-stable
        (tests/test_telemetry.py)."""
        v = self._registry.value
        lbl = {"replica": str(self._replica)}
        return {
            "page_size": int(v("kv_page_size", **lbl)),
            "capacity_pages": int(v("kv_pages_capacity", **lbl)),
            "in_use_pages": int(v("kv_pages_in_use", **lbl)),
            "prefix_entries": int(v("kv_prefix_entries", **lbl)),
            "prefix_hits": int(v("kv_prefix_hits", **lbl)),
            "prefix_misses": int(v("kv_prefix_misses", **lbl)),
        }
