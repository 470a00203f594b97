"""Slot and paged cache operations over the dense family's
:class:`~repro_torch.models.transformer.KVCache` (port of the slot and paged
subset of ``repro/models/cache_ops.py``).

Contract (the JAX package's): ``k``/``v`` leaves carry the batch/slot
dimension at axis 1 — ``leaf[:, i]`` is everything held for sequence ``i`` —
and ``pos`` is a per-sequence ``(B,)`` int32 vector.

**Paged layout**: the ``paged_*`` ops replace each slot's contiguous
sequence stripe with a shared page pool. ``k``/``v`` leaves become
``(lead, n_blocks + 1, block, KV, hd)``: axis 1 indexes physical pages of
``block`` tokens, and the last page is a write-off trash page that absorbs
scatters from free slots and is never handed out. A per-slot block table
``(capacity, max_blocks) int32`` maps logical page → physical page, ``-1``
marking an unallocated page (redirected to the trash page on read; its
contents are always masked by the position mask).

Index math only, so parity with the JAX package is exact equality. Unlike
the JAX package's pure functions, the writing ops (``slot_insert``,
``slot_evict``, ``paged_commit``, ``paged_insert``, ``paged_evict``) update
the cache in place and return it: the pools are the largest tensors of a
serving process; so do the speculative window's ``paged_commit_window`` and
``paged_rollback``. The copy-on-write ops of the prefix cache come with
that slice.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.errors import CacheLayoutError, ConfigError

from .transformer import KVCache

__all__ = ["slot_insert", "slot_read", "slot_evict", "slot_positions",
           "truncate_seq", "paged_init", "paged_gather", "paged_token_entry",
           "paged_commit", "paged_commit_window", "paged_rollback",
           "paged_insert", "paged_evict", "paged_read", "SLOT_AXIS"]

#: The slot (batch) dimension of every ``k``/``v`` cache leaf.
SLOT_AXIS = 1


def _leaves(cache: KVCache):
    return list(cache.k) + list(cache.v)


def _check_rank(leaf: torch.Tensor) -> None:
    if leaf.dim() < SLOT_AXIS + 2:
        raise CacheLayoutError(
            f"cache leaf of rank {leaf.dim()} cannot carry the slot axis at "
            f"{SLOT_AXIS} and a sequence axis after it")


def slot_insert(pool: KVCache, single: KVCache, slot: int) -> KVCache:
    """Write a single-sequence (B=1) cache into slot ``slot`` of ``pool``
    (in place). ``single``'s sequence extent may be shorter than the
    pool's: it lands as a prefix."""
    for pl, sl in zip(_leaves(pool), _leaves(single)):
        _check_rank(pl)
        s1 = sl.shape[2]
        if s1 > pl.shape[2]:
            raise CacheLayoutError(f"a {s1}-position cache cannot enter a "
                                   f"{pl.shape[2]}-position slot")
        pl[:, slot, :s1] = sl[:, 0].to(pl.dtype)
    pool.pos[slot] = single.pos.reshape(-1)[0]
    return pool


def slot_read(pool: KVCache, slot: int) -> KVCache:
    """Slot ``slot`` as a single-sequence (B=1) cache with the pool's
    sequence extent (views of the pool)."""
    return KVCache(k=tuple(t[:, slot:slot + 1] for t in pool.k),
                   v=tuple(t[:, slot:slot + 1] for t in pool.v),
                   pos=pool.pos[slot:slot + 1])


def slot_evict(pool: KVCache, slot: int) -> KVCache:
    """Zero slot ``slot``'s state and reset its position (in place), so
    pool contents stay a pure function of the admitted requests."""
    for pl in _leaves(pool):
        _check_rank(pl)
        pl[:, slot] = 0
    pool.pos[slot] = 0
    return pool


def slot_positions(pool: KVCache) -> torch.Tensor:
    """The pool's per-slot ``(B,)`` position vector."""
    return pool.pos


def truncate_seq(single: KVCache, length: int) -> KVCache:
    """Slice a single-sequence cache's ``k``/``v`` leaves down to
    ``length`` positions (axis 2): the bridge from a bucket-padded staging
    cache to the exact-extent cache the pools admit."""
    return KVCache(k=tuple(t[:, :, :length] for t in single.k),
                   v=tuple(t[:, :, :length] for t in single.v),
                   pos=single.pos)


# --------------------------------------------------------------------------
# Paged block-pool layout
# --------------------------------------------------------------------------

def _trash(leaf: torch.Tensor) -> int:
    """Physical index of the leaf's trash page (always the last)."""
    return leaf.shape[SLOT_AXIS] - 1


def _safe_tables(tables: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Block tables with unallocated (-1) entries redirected to the trash
    page."""
    return torch.where(tables < 0, _trash(leaf), tables).to(torch.long)


def paged_init(init_cache: Callable[[int, int], KVCache], capacity: int,
               n_blocks: int, block: int) -> KVCache:
    """A paged pool for a family whose ``init_cache(batch, max_seq)`` builds
    the contiguous layout: ``k``/``v`` leaves ``(lead, n_blocks + 1, block,
    KV, hd)`` (the ``+ 1`` is the trash page), ``pos`` ``(capacity,)``."""
    if n_blocks < 1 or block < 1 or capacity < 1:
        raise ConfigError(
            f"paged pool needs capacity/n_blocks/block ≥ 1, got "
            f"{capacity}/{n_blocks}/{block}")
    by_block = init_cache(n_blocks + 1, block)
    pos = torch.zeros((capacity,), dtype=torch.int32,
                      device=by_block.pos.device)
    return KVCache(k=by_block.k, v=by_block.v, pos=pos)


def paged_gather(data: KVCache, tables: torch.Tensor, *,
                 block: int) -> KVCache:
    """The dense per-slot cache view: each slot's pages gathered in logical
    order into ``max_blocks * block`` positions (unallocated pages read the
    trash page, masked downstream)."""
    capacity, max_blocks = tables.shape

    def one(leaf):
        gathered = leaf[:, _safe_tables(tables, leaf)]  # (lead, C, MB, blk, ..)
        return gathered.reshape(leaf.shape[0], capacity, max_blocks * block,
                                *leaf.shape[3:])

    return KVCache(k=tuple(one(t) for t in data.k),
                   v=tuple(one(t) for t in data.v), pos=data.pos)


def paged_token_entry(tables: torch.Tensor, pos, *,
                      block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot ``(table entry, in-page offset)`` of the page cell holding
    each row's token at ``pos`` (``(C,)``, or ``(C, W)`` for a window of
    positions a slot): the one derivation shared by :func:`paged_commit`,
    the windowed ops and the in-layer scatter of the paged decode step.
    The entry is the raw table value (callers redirect negatives to their
    trash page); a position outside the table's logical extent resolves to
    ``-1`` so the same redirect absorbs it."""
    capacity, max_blocks = tables.shape
    pos = torch.as_tensor(pos, device=tables.device).to(torch.long)
    raw_ix = torch.div(pos, block, rounding_mode="floor")
    page_ix = torch.clamp(raw_ix, 0, max_blocks - 1)
    entry = torch.gather(tables, 1,
                         page_ix.reshape(capacity, -1)).reshape(pos.shape)
    entry = torch.where((raw_ix < 0) | (raw_ix >= max_blocks),
                        torch.full_like(entry, -1), entry)
    return entry, torch.remainder(pos, block)


def paged_commit(data: KVCache, dense: KVCache, tables: torch.Tensor, *,
                 block: int) -> KVCache:
    """Fold one decode step's token per slot from the dense view back into
    its page (in place): the column at each slot's pre-step position goes
    to ``(tables[slot, pos // block], pos % block)``; ``pos`` is adopted
    from ``dense``."""
    capacity = tables.shape[0]
    wpos = data.pos.to(torch.long)
    entry, off = paged_token_entry(tables, wpos, block=block)
    rows = torch.arange(capacity, device=tables.device)
    for pl, dl in zip(_leaves(data), _leaves(dense)):
        bid = torch.where(entry < 0, _trash(pl), entry).to(torch.long)
        col = torch.clamp(wpos, max=dl.shape[2] - 1)
        pl[:, bid, off] = dl[:, rows, col].to(pl.dtype)
    return KVCache(k=data.k, v=data.v, pos=dense.pos.clone())


def _window(tables: torch.Tensor, base: torch.Tensor, width: int, *,
            block: int):
    """The ``(C, W)`` positions ``base + i`` and their page cells."""
    wpos = (base.to(torch.long)[:, None]
            + torch.arange(width, device=tables.device)[None, :])
    entry, off = paged_token_entry(tables, wpos, block=block)
    return wpos, entry, off


def paged_commit_window(data: KVCache, dense: KVCache, tables: torch.Tensor,
                        *, block: int, width: int) -> KVCache:
    """Fold a ``width``-token verify step's rows back into pages (in
    place): the windowed :func:`paged_commit` of speculative decoding. The
    dense view holds ``width`` fresh K/V rows a slot at ``[pos, pos +
    width)`` (``pos`` = ``data.pos``, the pre-step positions); each resolves
    its page cell through :func:`paged_token_entry`, so cells on an
    unallocated or out-of-range page land in the trash page. Every slot
    commits its whole window: :func:`paged_rollback` zeroes what
    verification rejects, and a free slot's window lands in the trash
    page. ``pos`` is adopted from ``dense``."""
    capacity = tables.shape[0]
    wpos, entry, off = _window(tables, data.pos, width, block=block)
    rows = torch.arange(capacity, device=tables.device)[:, None]
    for pl, dl in zip(_leaves(data), _leaves(dense)):
        bid = torch.where(entry < 0, _trash(pl), entry).to(torch.long)
        col = torch.clamp(wpos, max=dl.shape[2] - 1)
        pl[:, bid, off] = dl[:, rows, col].to(pl.dtype)
    return KVCache(k=data.k, v=data.v, pos=dense.pos.clone())


def paged_rollback(data: KVCache, tables: torch.Tensor, *, block: int,
                   width: int, accept) -> KVCache:
    """Rewind a committed ``width``-token window to its accepted prefix (in
    place): positions go back to ``pos - width + accept`` and the ``width``
    cells from there are zeroed — a deliberate overshoot past the dirty
    span, whose cells are already zero or resolve to the trash page. A free
    slot passes ``accept = 0``: its window committed to the trash page, so
    the rewind restores its position and its zeros land there again.
    Returns the cache with the rewound ``pos`` (a new tensor)."""
    accept = torch.as_tensor(accept, device=tables.device).to(torch.long)
    start = data.pos.to(torch.long) - width + accept
    _, entry, off = _window(tables, start, width, block=block)
    for pl in _leaves(data):
        bid = torch.where(entry < 0, _trash(pl), entry).to(torch.long)
        # a zero on the pool's device: a host scalar would be copied over,
        # a synchronizing call a graph capture refuses
        pl[:, bid, off] = pl.new_zeros(())
    return KVCache(k=data.k, v=data.v, pos=start.to(data.pos.dtype))


def paged_insert(data: KVCache, single: KVCache, slot: int, pages, *,
                 block: int, start: int = 0) -> KVCache:
    """Write a single-sequence (B=1) prefill cache into ``pages`` of the
    pool (host ints, ``ceil(S1 / block)`` of them; the last page's tail is
    zero-padded) and its position into ``slot`` — in place. ``start > 0``
    (the prefix-cache overlay) comes with the prefix-cache slice."""
    if start:
        raise ConfigError("paged_insert(start > 0) is the prefix-cache "
                          "admission path, which comes with that slice")
    ids = torch.as_tensor(np.asarray(pages, np.int64),
                          device=data.pos.device)
    n_pages = int(ids.shape[0])
    for pl, sl in zip(_leaves(data), _leaves(single)):
        lead, s1 = sl.shape[0], sl.shape[2]
        if n_pages * block < s1:
            raise CacheLayoutError(
                f"{n_pages} pages of {block} tokens cannot hold a "
                f"{s1}-token prefill cache")
        x = sl[:, 0]                                      # (lead, S1, ...)
        pad = n_pages * block - s1
        if pad:
            x = torch.cat([x, x.new_zeros((lead, pad, *x.shape[2:]))], dim=1)
        pl[:, ids] = x.reshape(lead, n_pages, block,
                               *x.shape[2:]).to(pl.dtype)
    data.pos[slot] = single.pos.reshape(-1)[0]
    return data


def paged_evict(data: KVCache, slot: int, pages) -> KVCache:
    """Zero ``pages`` and reset ``slot``'s position (in place), so a reused
    page never carries a previous tenant's K/V."""
    pages = np.asarray(pages, np.int64)
    if pages.size:
        ids = torch.as_tensor(pages, device=data.pos.device)
        for pl in _leaves(data):
            pl[:, ids] = 0
    data.pos[slot] = 0
    return data


def paged_read(data: KVCache, tables: torch.Tensor, slot: int, *,
               block: int) -> KVCache:
    """``slot`` as a single-sequence (B=1) dense cache of extent
    ``max_blocks * block`` (a test/debug surface)."""
    return slot_read(paged_gather(data, tables, block=block), slot)
