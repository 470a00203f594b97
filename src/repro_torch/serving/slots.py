"""Slot pools over the decode cache: contiguous and paged (port of
``repro/serving/slots.py``).

Both pools expose one bookkeeping surface to the engine — ``admit`` /
``evict`` / ``read`` / ``entries`` / ``has_free`` — over the cache contract
of ``models/cache_ops.py``.

:class:`SlotPool` is the contiguous baseline: the pool *is* a batched
decode cache, so every slot owns a full ``max_seq`` stripe.

:class:`PagedSlotPool` shares sequence storage as ``n_blocks`` pages of
``block`` tokens; each slot holds a block table. Admission reserves the
prompt's pages, decode grows a slot a page at a time (:meth:`ensure_page`),
and eviction returns pages to the free list, so a budget far below
``capacity · max_seq`` still serves mixed-length traffic — the engine turns
:class:`PoolExhausted` at decode time into preemption and re-queueing.

With a :class:`~repro_torch.serving.prefix.PrefixCache` attached (DESIGN.md
§12) pages become *shared*: the pool keeps a per-page **refcount ledger**,
a matching request's block table attaches to pages already resident
(:meth:`PagedSlotPool.admit_prefix`), and the first write into a page with
refcount > 1, or one the prefix tree retains, goes through copy-on-write
(``cache_ops.paged_copy_page`` and a table rewrite), never in place.
Eviction is a decref: a page is zeroed and freed only at refcount 0 and
unretained; retained refcount-0 pages stay warm for later hits until the
LRU reclaimer (``PrefixCache.reclaim``) surrenders them under page
pressure.

A pool's ``cache`` may be placed on a mesh (a ``DTensor`` tree, as
``serving.Engine(mesh=...)`` makes it): the bookkeeping is host state that
every rank keeps alike, and every write goes through ``cache_ops``, which
writes each rank's shard.

Invariants: a slot is free or holds exactly one live request; a page is
free, referenced by ≥ 1 block table or staging pin, retained warm by the
prefix tree, or the trash page (never handed out); refusals are typed
(:class:`PoolExhausted` with ``uid`` and ``reason``); no page is freed at
refcount > 0 and no refcount goes negative
(:class:`~repro_torch.errors.PrefixCacheInvariantError`); eviction returns
the lowest free index first and zeroes what it frees, so pool contents are
a pure function of the live requests and the retained prefix set.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.errors import (ConfigError, PoolExhausted,
                                PrefixCacheInvariantError)
from repro_torch.models import cache_ops
from repro_torch.models.cache_ops import slot_evict, slot_insert, slot_read
from repro_torch.parallel.context import gathered

from .prefix import PrefixCache, PrefixMatch
from .queue import Request

__all__ = ["SlotPool", "PagedSlotPool", "SlotEntry", "PoolExhausted"]


@dataclass
class SlotEntry:
    """Host-side bookkeeping for one live request in a slot."""
    request: Request
    admitted_at: float
    admit_step: int
    admit_index: int = 0    # monotone admission counter (preemption order)
    generated: list = field(default_factory=list)   # sampled ids, host ints
    generator: Any = None   # per-request torch.Generator (temperature > 0)
    #: Prompt tokens already committed to the chunked-prefill staging cache;
    #: equals ``prompt_len`` from admission onward.
    prefill_offset: int = 0

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def next_write_pos(self) -> int:
        """Cache position the next decode step writes for this slot: the
        prefill filled ``[0, prompt_len)`` and each decode step appended one
        token (the first sampled token comes from the prefill logits)."""
        return self.request.prompt_len + self.n_generated - 1


class SlotPool:
    """Contiguous slot bookkeeping plus the pooled device cache."""

    def __init__(self, model, capacity: int, max_seq: int, *,
                 cache: Any = None):
        if capacity < 1:
            raise ConfigError("slot pool needs capacity ≥ 1")
        self.capacity = capacity
        self.max_seq = max_seq
        self._model = model
        self.cache = model.init_cache(capacity, max_seq) if cache is None \
            else cache
        self._free: list[int] = list(range(capacity))
        heapq.heapify(self._free)
        self.entries: dict[int, SlotEntry] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def has_free(self) -> bool:
        return bool(self._free)

    @property
    def active_slots(self) -> list[int]:
        return sorted(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def check_fits(self, req: Request) -> None:
        """Raise :class:`PoolExhausted` if ``req`` can never fit."""
        need = req.prompt_len + req.max_new_tokens
        if need > self.max_seq:
            raise PoolExhausted(
                f"request {req.uid!r} needs {need} cache positions "
                f"(prompt {req.prompt_len} + max_new {req.max_new_tokens}) "
                f"but the pool holds max_seq={self.max_seq}",
                uid=req.uid)

    def admit(self, entry: SlotEntry, single_cache: Any) -> int:
        """Insert a prefilled B=1 cache into the lowest free slot."""
        req = entry.request
        if not self._free:
            raise PoolExhausted("slot pool is full", uid=req.uid)
        self.check_fits(req)
        slot = heapq.heappop(self._free)
        self.cache = slot_insert(self.cache, single_cache, slot)
        self.entries[slot] = entry
        return slot

    def evict(self, slot: int) -> SlotEntry:
        """Free ``slot``, zeroing its device state; returns its entry."""
        entry = self.entries.pop(slot)
        self.cache = slot_evict(self.cache, slot)
        heapq.heappush(self._free, slot)
        return entry

    def read(self, slot: int) -> Any:
        if slot not in self.entries:
            raise KeyError(f"slot {slot} is not live")
        return slot_read(self.cache, slot)

    def positions(self) -> np.ndarray:
        return gathered(self.cache.pos).cpu().numpy()


class PagedSlotPool:
    """Paged slot bookkeeping: shared page pool + per-slot block tables.

    ``pool.cache`` is the paged device cache (``cache_ops.paged_init``
    layout); ``pool.tables`` the host ``(capacity, max_blocks)`` int32 block
    table (-1 = unallocated) handed to each paged decode step. Allocation
    is host-driven, so admit/evict/grow never wait on the device."""

    @staticmethod
    def plan(capacity: int, max_seq: int, block: int,
             n_blocks: int | None = None) -> tuple[int, int, int]:
        """The (block, max_blocks, n_blocks) the pool derives from the
        requested geometry — the one place the derivation lives. A page
        longer than ``max_seq`` is clamped; ``n_blocks`` defaults to no
        oversubscription."""
        if capacity < 1:
            raise ConfigError("slot pool needs capacity ≥ 1")
        if block < 1:
            raise ConfigError("page size must be ≥ 1 token")
        block = min(block, max_seq)
        max_blocks = -(-max_seq // block)
        n_blocks = capacity * max_blocks if n_blocks is None else n_blocks
        if n_blocks < 1:
            raise ConfigError("paged pool needs a page budget ≥ 1")
        return block, max_blocks, n_blocks

    def __init__(self, model, capacity: int, max_seq: int, *,
                 block: int = 64, n_blocks: int | None = None,
                 cache: Any = None):
        self.capacity = capacity
        self.max_seq = max_seq
        self.block, self.max_blocks, self.n_blocks = self.plan(
            capacity, max_seq, block, n_blocks)
        self._model = model
        self.cache = cache if cache is not None else cache_ops.paged_init(
            model.init_cache, capacity, self.n_blocks, self.block)
        self.tables = np.full((capacity, self.max_blocks), -1, np.int32)
        self._free: list[int] = list(range(capacity))
        heapq.heapify(self._free)
        self._free_pages: list[int] = list(range(self.n_blocks))
        heapq.heapify(self._free_pages)
        self.entries: dict[int, SlotEntry] = {}
        self.peak_pages = 0
        #: Per-page references: block tables and staging pins. Without a
        #: prefix cache every page is refcount 1 while owned, 0 when free.
        self.refcount = np.zeros(self.n_blocks, np.int64)
        #: Pages the prefix tree keeps warm (never zeroed or freed here).
        self.retained: set[int] = set()
        #: The attached PrefixCache (the engine wires it): identity and LRU.
        self.prefix: PrefixCache | None = None
        self.n_cow = 0
        self.n_reclaimed = 0
        #: Of those, pages freed by :meth:`reclaim_pinned`.
        self.n_reclaimed_pinned = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def has_free(self) -> bool:
        return bool(self._free)

    @property
    def active_slots(self) -> list[int]:
        return sorted(self.entries)

    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def pages_in_use(self) -> int:
        """Pages off the free list: live references and retained warm
        pages alike (both hold memory)."""
        return self.n_blocks - len(self._free_pages)

    @property
    def pages_live(self) -> int:
        """Pages referenced by a block table or a staging pin; drains to 0
        (``pages_in_use - pages_live`` is the warm prefix set)."""
        return int((self.refcount > 0).sum())

    def _reclaimable(self) -> int:
        """Retained warm pages the LRU reclaimer could surrender now."""
        return sum(1 for p in self.retained if self.refcount[p] == 0)

    @property
    def available_pages(self) -> int:
        """Free pages plus reclaimable warm pages: admission and growth
        count both, so a full warm cache never refuses work it could serve
        by shrinking."""
        return len(self._free_pages) + self._reclaimable()

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` sequence positions."""
        return -(-max(n_tokens, 0) // self.block)

    def _growth_pending(self) -> int:
        """Live slots that will still request at least one more page."""
        n = 0
        for slot, entry in self.entries.items():
            req = entry.request
            allocated = int((self.tables[slot] >= 0).sum())
            if self.pages_for(req.prompt_len + req.max_new_tokens) > allocated:
                n += 1
        return n

    def can_admit(self, req: Request, *,
                  match: PrefixMatch | None = None) -> bool:
        """Slot free and enough pages for the prompt plus its first decode
        write, plus one headroom page per still-growing live slot (without
        it a tight budget admits the queue head, grows an older slot and
        preempts the head again, a full prefill per cycle). Reclaimable
        warm pages count as capacity.

        ``match`` is the staging prefill's prefix plan: its shared pages
        are resident and claim nothing new, and a pinned CoW source whose
        only reference is the staging pin is credited back (admission
        copies it and drops the pin, so it turns reclaimable before the
        first decode write needs a page). Admission itself still takes its
        fresh pages with the pin held, so that draw is checked against
        uncredited capacity."""
        if not self._free:
            return False
        shared = cow_credit = 0
        if match is not None:
            shared = len(match.shared)
            if (match.cow_src is not None
                    and self.refcount[match.cow_src] == 1):
                cow_credit = 1
        avail = self.available_pages
        return (self.pages_for(req.prompt_len) - shared <= avail
                and self.pages_for(req.prompt_len + 1) - shared - cow_credit
                + self._growth_pending() <= avail)

    def __len__(self) -> int:
        return len(self.entries)

    def _take_pages(self, n: int, *, uid: str | None = None,
                    reason: str = "admission") -> list[int]:
        """Pop ``n`` fresh pages (refcount 1), reclaiming LRU warm prefix
        pages (zeroed) on a shortfall; a typed refusal otherwise."""
        if n > self.available_pages:
            raise PoolExhausted(
                f"need {n} pages but only {self.available_pages} of "
                f"{self.n_blocks} are free or reclaimable",
                pages_needed=n, pages_free=self.available_pages,
                uid=uid, reason=reason)
        if n > len(self._free_pages) and self.prefix is not None:
            ids = self.prefix.reclaim(n - len(self._free_pages),
                                      self.refcount)
            if ids:
                self.cache = cache_ops.paged_zero_pages(self.cache, ids)
                self.retained.difference_update(ids)
                self.n_reclaimed += len(ids)
                for p in ids:
                    heapq.heappush(self._free_pages, p)
        if n > len(self._free_pages):
            raise PoolExhausted(
                f"need {n} pages but only {len(self._free_pages)} of "
                f"{self.n_blocks} are free after reclaim",
                pages_needed=n, pages_free=len(self._free_pages),
                uid=uid, reason=reason)
        pages = [heapq.heappop(self._free_pages) for _ in range(n)]
        self.refcount[pages] = 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return pages

    def reclaim_pinned(self) -> int:
        """Last resort when no slot is left to preempt: the leaf-first
        reclaimer cannot surrender a refcount-0 warm page whose subtree
        holds a live page (a request that recomputed that block privately
        and registered its deeper pages below the resident one). Drop the
        LRU such page with its subtree: its refcount-0 pages are zeroed and
        freed, its live pages stop being retained. Returns the pages
        freed."""
        if self.prefix is None:
            return 0
        ids = self.prefix.reclaim_pinned(self.refcount)
        self.retained.difference_update(ids)
        freed = [p for p in ids if self.refcount[p] == 0]
        if freed:
            self.cache = cache_ops.paged_zero_pages(self.cache, freed)
            self.n_reclaimed += len(freed)
            self.n_reclaimed_pinned += len(freed)
            for p in freed:
                heapq.heappush(self._free_pages, p)
        return len(freed)

    def _release_page(self, page: int) -> None:
        """Drop one reference; zero and free the page at refcount 0 unless
        the prefix tree retains it warm."""
        self.refcount[page] -= 1
        if self.refcount[page] < 0:
            raise PrefixCacheInvariantError(
                f"page {page} refcount went negative")
        if self.refcount[page] == 0 and page not in self.retained:
            self.cache = cache_ops.paged_zero_pages(self.cache, [page])
            heapq.heappush(self._free_pages, int(page))

    def pin_pages(self, pages) -> None:
        """Take a staging reference on matched pages (the engine, at
        prefill start), so the reclaimer cannot surrender them before the
        request admits; admission (the block table's reference replaces
        the pin) or a staging preemption releases it."""
        for p in pages:
            self.refcount[p] += 1

    def unpin_pages(self, pages) -> None:
        for p in pages:
            self._release_page(int(p))

    def retain_pages(self, pages) -> None:
        """Mark pages the prefix tree just registered as retained warm."""
        for p in pages:
            if self.refcount[p] <= 0:
                raise PrefixCacheInvariantError(
                    f"page {p} retained while unreferenced")
            self.retained.add(int(p))

    def drop_retained(self) -> None:
        """Forget the warm prefix set: every retained page back on the free
        list. For a pool whose pages were zeroed under it while it held no
        reference (a graphed engine's shared pool, emptied when another
        engine bound it); any live reference is an invariant violation."""
        if self.entries or (self.refcount != 0).any():
            raise PrefixCacheInvariantError(
                "the warm prefix set is dropped only from a pool that holds "
                "no reference")
        for p in sorted(self.retained):
            heapq.heappush(self._free_pages, p)
        self.retained.clear()

    def writable(self, page: int) -> bool:
        """May a slot write into ``page`` in place? Only as its sole
        reference and when the prefix tree does not retain it (a retained
        page backs later hits even at refcount 1)."""
        return self.refcount[page] <= 1 and page not in self.retained

    def check_fits(self, req: Request) -> None:
        """Raise :class:`PoolExhausted` if ``req`` can never fit: over
        ``max_seq`` or over the page budget."""
        need = req.prompt_len + req.max_new_tokens
        if need > self.max_seq:
            raise PoolExhausted(
                f"request {req.uid!r} needs {need} cache positions "
                f"(prompt {req.prompt_len} + max_new {req.max_new_tokens}) "
                f"but the pool holds max_seq={self.max_seq}",
                uid=req.uid)
        if self.pages_for(need) > self.n_blocks:
            raise PoolExhausted(
                f"request {req.uid!r} needs {self.pages_for(need)} pages "
                f"of {self.block} tokens but the page budget is "
                f"n_blocks={self.n_blocks}",
                pages_needed=self.pages_for(need),
                pages_free=len(self._free_pages), uid=req.uid)

    def admit(self, entry: SlotEntry, single_cache: Any) -> int:
        """Reserve the prompt's pages and insert a prefilled B=1 cache into
        the lowest free slot; decode growth takes the rest on demand."""
        req = entry.request
        if not self._free:
            raise PoolExhausted("slot pool is full", uid=req.uid)
        self.check_fits(req)
        pages = self._take_pages(self.pages_for(req.prompt_len), uid=req.uid)
        slot = heapq.heappop(self._free)
        self.tables[slot, :len(pages)] = pages
        self.cache = cache_ops.paged_insert(self.cache, single_cache, slot,
                                            pages, block=self.block)
        self.entries[slot] = entry
        return slot

    def admit_prefix(self, entry: SlotEntry, single_cache: Any,
                     match: PrefixMatch) -> int:
        """Prefix-hit admission: attach ``match.shared`` by reference (their
        staging pins become this slot's table references, no refcount
        change), copy ``match.cow_src`` into a private page when the resume
        point falls inside it, and insert the suffix prefill from token
        ``match.resume`` with the overlay keeping the copied rows below it.
        The engine still holds the pin on ``cow_src`` and releases it after
        this returns."""
        req = entry.request
        if not self._free:
            raise PoolExhausted("slot pool is full", uid=req.uid)
        self.check_fits(req)
        shared = [int(p) for p in match.shared]
        n_total = self.pages_for(req.prompt_len)
        fresh = self._take_pages(n_total - len(shared), uid=req.uid)
        slot = heapq.heappop(self._free)
        self.tables[slot, :n_total] = shared + fresh
        if match.cow_src is not None:
            if not fresh:
                raise PrefixCacheInvariantError(
                    f"request {req.uid!r}: CoW admission took no private "
                    f"page for the resume point")
            self.cache = cache_ops.paged_copy_page(self.cache,
                                                   match.cow_src, fresh[0])
            self.n_cow += 1
        self.cache = cache_ops.paged_insert(self.cache, single_cache, slot,
                                            fresh, block=self.block,
                                            start=match.resume)
        self.entries[slot] = entry
        return slot

    def ensure_page(self, slot: int, write_pos: int) -> None:
        """Make the page covering ``write_pos`` allocated *and writable*
        for ``slot`` before a decode step writes there: an allocated but
        shared or retained page is copied first (CoW), so a decode write
        never lands in a page another request or the warm prefix set can
        see. :class:`PoolExhausted` when no page is free (the engine's cue
        to preempt)."""
        entry = self.entries.get(slot)
        uid = entry.request.uid if entry is not None else None
        index = write_pos // self.block
        if index >= self.max_blocks:
            raise PoolExhausted(
                f"slot {slot} write position {write_pos} exceeds "
                f"max_seq={self.max_seq}", uid=uid, reason="decode")
        page = int(self.tables[slot, index])
        if page >= 0:
            if self.writable(page):
                return
            private = self._take_pages(1, uid=uid, reason="decode")[0]
            self.cache = cache_ops.paged_copy_page(self.cache, page, private)
            self.tables[slot, index] = private
            self._release_page(page)
            self.n_cow += 1
            return
        self.tables[slot, index] = self._take_pages(1, uid=uid,
                                                    reason="decode")[0]

    def evict(self, slot: int) -> SlotEntry:
        """Release ``slot``'s references; zero and free what nothing else
        holds. A page another slot references survives untouched, and a
        refcount-0 page the prefix tree retains stays warm (contents
        intact, off the free list) until the reclaimer surrenders it. The
        slot's position is always reset; returns the entry."""
        entry = self.entries.pop(slot)
        pages = self.tables[slot][self.tables[slot] >= 0]
        self.refcount[pages] -= 1
        if (self.refcount[pages] < 0).any():
            raise PrefixCacheInvariantError(
                f"slot {slot} eviction drove a page refcount negative")
        freed = [int(p) for p in pages.tolist()
                 if self.refcount[p] == 0 and p not in self.retained]
        self.cache = cache_ops.paged_evict(self.cache, slot, freed)
        self.tables[slot, :] = -1
        for p in freed:
            heapq.heappush(self._free_pages, p)
        heapq.heappush(self._free, slot)
        return entry

    def read(self, slot: int) -> Any:
        """The slot's state as a B=1 dense cache (``max_blocks * block``
        positions)."""
        if slot not in self.entries:
            raise KeyError(f"slot {slot} is not live")
        tables = torch.as_tensor(self.tables, device=self.cache.pos.device)
        return cache_ops.paged_read(self.cache, tables, slot,
                                    block=self.block)

    def positions(self) -> np.ndarray:
        return gathered(self.cache.pos).cpu().numpy()
