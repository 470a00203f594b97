"""Slot pools over the decode cache: contiguous and paged (port of
``repro/serving/slots.py`` without the prefix-cache ledger).

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

Invariants: a slot is free or holds exactly one live request; a page is
free, owned by exactly one block table, or the trash page (never handed
out); refusals are typed (:class:`PoolExhausted` with ``uid`` and
``reason``); eviction returns the lowest free index first and zeroes what
it frees, so pool contents are a pure function of the live requests. The
page-sharing (copy-on-write prefix) ledger comes with the prefix-cache
slice.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.errors import ConfigError, PoolExhausted
from repro_torch.models import cache_ops
from repro_torch.models.cache_ops import slot_evict, slot_insert, slot_read

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
        return self.cache.pos.cpu().numpy()


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
        return self.n_blocks - len(self._free_pages)

    @property
    def pages_live(self) -> int:
        """Pages referenced by a block table (drains to 0)."""
        return int((self.tables >= 0).sum())

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

    def can_admit(self, req: Request) -> bool:
        """Slot free and enough pages for the prompt plus its first decode
        write, plus one headroom page per still-growing live slot (without
        it a tight budget admits the queue head, grows an older slot and
        preempts the head again, a full prefill per cycle)."""
        if not self._free:
            return False
        avail = len(self._free_pages)
        return (self.pages_for(req.prompt_len) <= avail
                and self.pages_for(req.prompt_len + 1)
                + self._growth_pending() <= avail)

    def __len__(self) -> int:
        return len(self.entries)

    def _take_pages(self, n: int, *, uid: str | None = None,
                    reason: str = "admission") -> list[int]:
        if n > len(self._free_pages):
            raise PoolExhausted(
                f"need {n} pages but only {len(self._free_pages)} of "
                f"{self.n_blocks} are free",
                pages_needed=n, pages_free=len(self._free_pages),
                uid=uid, reason=reason)
        pages = [heapq.heappop(self._free_pages) for _ in range(n)]
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return pages

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

    def ensure_page(self, slot: int, write_pos: int) -> None:
        """Allocate the page covering ``write_pos`` for ``slot`` before a
        decode step writes there; :class:`PoolExhausted` when none is free
        (the engine's cue to preempt)."""
        entry = self.entries.get(slot)
        uid = entry.request.uid if entry is not None else None
        index = write_pos // self.block
        if index >= self.max_blocks:
            raise PoolExhausted(
                f"slot {slot} write position {write_pos} exceeds "
                f"max_seq={self.max_seq}", uid=uid, reason="decode")
        if self.tables[slot, index] >= 0:
            return
        self.tables[slot, index] = self._take_pages(1, uid=uid,
                                                    reason="decode")[0]

    def evict(self, slot: int) -> SlotEntry:
        """Free ``slot`` and its pages, zeroing both; returns the entry."""
        entry = self.entries.pop(slot)
        pages = [int(p) for p in self.tables[slot] if p >= 0]
        self.cache = cache_ops.paged_evict(self.cache, slot, pages)
        self.tables[slot, :] = -1
        for p in pages:
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
        return self.cache.pos.cpu().numpy()
