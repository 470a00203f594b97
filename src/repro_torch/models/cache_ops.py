"""Slot and paged cache operations over every ported family's cache —
the dense :class:`~repro_torch.models.transformer.KVCache`, the ssm
family's ``SSMCacheState`` and the hybrid's ``HybridCache`` (port of the
slot and paged subset of ``repro/models/cache_ops.py``).

Contract (the JAX package's): every leaf carries the batch/slot dimension
at axis 1 — ``leaf[:, i]`` is everything held for sequence ``i`` — and
``pos`` is a per-sequence ``(B,)`` int32 vector. Leaves fall in two
classes:

* *sequence leaves*: those under a ``k``/``v`` field (:data:`SEQ_FIELDS`;
  a tuple of tensors in the dense cache, one tensor in the hybrid's),
  with a per-token sequence axis at 2;
* *slot leaves*: every other leaf but ``pos`` (the Mamba conv window and
  state), O(1) per sequence.

**Paged layout**: the ``paged_*`` ops replace each slot's contiguous
sequence stripe with a shared page pool. Sequence leaves become
``(lead, n_blocks + 1, block, KV, hd)``: axis 1 indexes physical pages of
``block`` tokens, and the last page is a write-off trash page that absorbs
scatters from free slots and is never handed out. Slot leaves keep the
slot layout ``(lead, capacity, ...)``. A per-slot block table
``(capacity, max_blocks) int32`` maps logical page → physical page, ``-1``
marking an unallocated page (redirected to the trash page on read; its
contents are always masked by the position mask).

Index math only, so parity with the JAX package is exact equality. Unlike
the JAX package's pure functions, the writing ops (``slot_insert``,
``slot_evict``, ``paged_commit``, ``paged_insert``, ``paged_evict``) update
the cache in place and return it: the pools are the largest tensors of a
serving process; so do the speculative window's ``paged_commit_window`` and
``paged_rollback``, and the prefix cache's page-sharing ops
(``paged_copy_page``, ``paged_zero_pages``, ``prefix_seed``). Page ids are
host ints (page allocation is host-driven); the ops run eagerly between
step replays and never read the device.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.errors import CacheLayoutError, ConfigError

__all__ = ["slot_insert", "slot_read", "slot_evict", "slot_positions",
           "truncate_seq", "paged_init", "paged_gather", "paged_token_entry",
           "paged_commit", "paged_commit_window", "paged_rollback",
           "paged_insert", "paged_evict", "paged_read", "paged_copy_page",
           "paged_zero_pages", "prefix_seed", "seq_leaves", "slot_leaves",
           "SLOT_AXIS", "SEQ_FIELDS"]

#: The slot (batch) dimension of every non-``pos`` cache leaf.
SLOT_AXIS = 1

#: Fields whose leaves carry a per-token sequence axis (axis 2) and are
#: paged; every other leaf but ``pos`` is O(1) a sequence.
SEQ_FIELDS = ("k", "v")


def _flat(node) -> list[torch.Tensor]:
    if isinstance(node, torch.Tensor):
        return [node]
    return [t for child in node for t in _flat(child)]


def seq_leaves(cache) -> list[torch.Tensor]:
    """The cache's sequence leaves, in field order."""
    return [t for f in cache._fields if f in SEQ_FIELDS
            for t in _flat(getattr(cache, f))]


def slot_leaves(cache) -> list[torch.Tensor]:
    """The cache's slot leaves (neither sequence leaves nor ``pos``)."""
    return [t for f in cache._fields if f not in SEQ_FIELDS and f != "pos"
            for t in _flat(getattr(cache, f))]


def _rebuild(node, fn):
    """``node`` (a tensor, or a tuple / named tuple of them) with ``fn``
    applied to every tensor."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    items = [_rebuild(child, fn) for child in node]
    return type(node)(*items) if hasattr(node, "_fields") else tuple(items)


def _map(cache, *, seq: Callable | None = None,
         slot: Callable | None = None, pos: Any = None):
    """A cache of the same family with ``seq`` applied to its sequence
    leaves and ``slot`` to its slot leaves (those left as they are when
    ``None``) and ``pos`` in place of its positions when given."""
    fields = {}
    for f in cache._fields:
        if f == "pos":
            if pos is not None:
                fields[f] = pos
            continue
        fn = seq if f in SEQ_FIELDS else slot
        if fn is not None:
            fields[f] = _rebuild(getattr(cache, f), fn)
    return cache._replace(**fields)


def _check_rank(leaf: torch.Tensor, seq: bool = True) -> None:
    if leaf.dim() < SLOT_AXIS + 1 + seq:
        raise CacheLayoutError(
            f"cache leaf of rank {leaf.dim()} cannot carry the slot axis at "
            f"{SLOT_AXIS}" + (" and a sequence axis after it" if seq else ""))


def _insert_slot_leaves(pool, single, slot: int) -> None:
    for pl, sl in zip(slot_leaves(pool), slot_leaves(single), strict=True):
        _check_rank(pl, seq=False)
        pl[:, slot] = sl[:, 0].to(pl.dtype)


def _zero_slot_leaves(pool, slot: int) -> None:
    for pl in slot_leaves(pool):
        _check_rank(pl, seq=False)
        pl[:, slot] = 0


def slot_insert(pool, single, slot: int):
    """Write a single-sequence (B=1) cache into slot ``slot`` of ``pool``
    (in place). ``single``'s sequence extent may be shorter than the
    pool's: it lands as a prefix."""
    for pl, sl in zip(seq_leaves(pool), seq_leaves(single), strict=True):
        _check_rank(pl)
        s1 = sl.shape[2]
        if s1 > pl.shape[2]:
            raise CacheLayoutError(f"a {s1}-position cache cannot enter a "
                                   f"{pl.shape[2]}-position slot")
        pl[:, slot, :s1] = sl[:, 0].to(pl.dtype)
    _insert_slot_leaves(pool, single, slot)
    pool.pos[slot] = single.pos.reshape(-1)[0]
    return pool


def slot_read(pool, slot: int):
    """Slot ``slot`` as a single-sequence (B=1) cache with the pool's
    sequence extent (views of the pool)."""

    def one(t):
        return t[:, slot:slot + 1]

    return _map(pool, seq=one, slot=one, pos=pool.pos[slot:slot + 1])


def slot_evict(pool, slot: int):
    """Zero slot ``slot``'s state and reset its position (in place), so
    pool contents stay a pure function of the admitted requests."""
    for pl in seq_leaves(pool):
        _check_rank(pl)
        pl[:, slot] = 0
    _zero_slot_leaves(pool, slot)
    pool.pos[slot] = 0
    return pool


def slot_positions(pool) -> torch.Tensor:
    """The pool's per-slot ``(B,)`` position vector."""
    return pool.pos


def truncate_seq(single, length: int):
    """Slice a single-sequence cache's sequence leaves down to ``length``
    positions (axis 2); slot leaves and ``pos`` pass through: the bridge
    from a bucket-padded staging cache to the exact-extent cache the pools
    admit."""
    return _map(single, seq=lambda t: t[:, :, :length])


# --------------------------------------------------------------------------
# Paged block-pool layout
# --------------------------------------------------------------------------

def _page_ids(data, pages) -> torch.Tensor:
    """Host page ids as an index tensor on the pool's device."""
    return torch.as_tensor(np.asarray(pages, np.int64).reshape(-1),
                           device=data.pos.device)


def _trash(leaf: torch.Tensor) -> int:
    """Physical index of the leaf's trash page (always the last)."""
    return leaf.shape[SLOT_AXIS] - 1


def _safe_tables(tables: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Block tables with unallocated (-1) entries redirected to the trash
    page."""
    return torch.where(tables < 0, _trash(leaf), tables).to(torch.long)


def paged_init(init_cache: Callable[[int, int], Any], capacity: int,
               n_blocks: int, block: int):
    """A paged pool for a family whose ``init_cache(batch, max_seq)`` builds
    the contiguous layout: sequence leaves ``(lead, n_blocks + 1, block,
    KV, hd)`` (the ``+ 1`` is the trash page), slot leaves ``(lead,
    capacity, ...)``, ``pos`` ``(capacity,)``."""
    if n_blocks < 1 or block < 1 or capacity < 1:
        raise ConfigError(
            f"paged pool needs capacity/n_blocks/block ≥ 1, got "
            f"{capacity}/{n_blocks}/{block}")
    # the slot layout, built once; each sequence leaf's slot axis then
    # becomes the page axis (slot leaves are never made per page)
    by_slot = init_cache(capacity, block)
    return _map(by_slot, seq=lambda t: t.new_zeros(
        (t.shape[0], n_blocks + 1, *t.shape[2:])))


def paged_gather(data, tables: torch.Tensor, *, block: int):
    """The dense per-slot cache view: each slot's pages gathered in logical
    order into ``max_blocks * block`` positions (unallocated pages read the
    trash page, masked downstream); slot leaves and ``pos`` are the pool's
    own."""
    capacity, max_blocks = tables.shape

    def one(leaf):
        gathered = leaf[:, _safe_tables(tables, leaf)]  # (lead, C, MB, blk, ..)
        return gathered.reshape(leaf.shape[0], capacity, max_blocks * block,
                                *leaf.shape[3:])

    return _map(data, seq=one)


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


def _adopt_slot_leaves(data, dense) -> None:
    """Slot leaves of the dense view into the pool's (the same tensors
    when the view was gathered from it: nothing to copy)."""
    for pl, dl in zip(slot_leaves(data), slot_leaves(dense), strict=True):
        if dl is not pl:
            pl.copy_(dl)


def paged_commit(data, dense, tables: torch.Tensor, *, block: int):
    """Fold one decode step's token per slot from the dense view back into
    its page (in place): the column at each slot's pre-step position goes
    to ``(tables[slot, pos // block], pos % block)``; slot leaves and
    ``pos`` are adopted from ``dense``."""
    capacity = tables.shape[0]
    wpos = data.pos.to(torch.long)
    entry, off = paged_token_entry(tables, wpos, block=block)
    rows = torch.arange(capacity, device=tables.device)
    for pl, dl in zip(seq_leaves(data), seq_leaves(dense), strict=True):
        bid = torch.where(entry < 0, _trash(pl), entry).to(torch.long)
        col = torch.clamp(wpos, max=dl.shape[2] - 1)
        pl[:, bid, off] = dl[:, rows, col].to(pl.dtype)
    _adopt_slot_leaves(data, dense)
    return data._replace(pos=dense.pos.clone())


def _window(tables: torch.Tensor, base: torch.Tensor, width: int, *,
            block: int):
    """The ``(C, W)`` positions ``base + i`` and their page cells."""
    wpos = (base.to(torch.long)[:, None]
            + torch.arange(width, device=tables.device)[None, :])
    entry, off = paged_token_entry(tables, wpos, block=block)
    return wpos, entry, off


def paged_commit_window(data, dense, tables: torch.Tensor, *, block: int,
                        width: int):
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
    for pl, dl in zip(seq_leaves(data), seq_leaves(dense), strict=True):
        bid = torch.where(entry < 0, _trash(pl), entry).to(torch.long)
        col = torch.clamp(wpos, max=dl.shape[2] - 1)
        pl[:, bid, off] = dl[:, rows, col].to(pl.dtype)
    _adopt_slot_leaves(data, dense)
    return data._replace(pos=dense.pos.clone())


def paged_rollback(data, tables: torch.Tensor, *, block: int, width: int,
                   accept):
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
    for pl in seq_leaves(data):
        bid = torch.where(entry < 0, _trash(pl), entry).to(torch.long)
        # a zero on the pool's device: a host scalar would be copied over,
        # a synchronizing call a graph capture refuses
        pl[:, bid, off] = pl.new_zeros(())
    return data._replace(pos=start.to(data.pos.dtype))


def paged_insert(data, single, slot: int, pages, *, block: int,
                 start: int = 0):
    """Write a single-sequence (B=1) prefill cache into ``pages`` of the
    pool, its slot leaves into ``slot`` and its position into ``slot`` —
    in place.

    With ``start == 0`` (the default), ``pages`` holds ``ceil(S1 / block)``
    physical page ids (host ints); the last page's tail beyond ``S1`` is
    zero-padded.

    ``start > 0`` is the prefix-cache admission path: ``pages`` then covers
    only the token span from ``start``'s page onward — positions
    ``[(start // block) * block, …)`` — and page cells *below* ``start``
    keep their pool contents. That overlay makes copy-on-write admission
    exact: the page copy supplies the shared rows the staging prefill never
    computed, and ``single`` everything from the divergence point."""
    ids = _page_ids(data, pages)
    n_pages = int(ids.shape[0])
    pstart = (start // block) * block
    for pl, sl in zip(seq_leaves(data), seq_leaves(single), strict=True):
        lead, s1 = sl.shape[0], sl.shape[2]
        if pstart + n_pages * block < s1:
            raise CacheLayoutError(
                f"{n_pages} pages of {block} tokens at token offset "
                f"{pstart} cannot hold a {s1}-token prefill cache")
        x = sl[:, 0, pstart:].to(pl.dtype)                # (lead, S1', ...)
        if start > pstart:
            # overlay: cells below ``start`` keep the pool's contents (the
            # CoW copy); cells at or after it take ``single``'s
            cur = pl[:, ids].reshape(lead, n_pages * block, *x.shape[2:])
            cur[:, start - pstart:x.shape[1]] = x[:, start - pstart:]
            cur[:, x.shape[1]:] = 0
            x = cur
        else:
            pad = n_pages * block - x.shape[1]
            if pad:
                x = torch.cat([x, x.new_zeros((lead, pad, *x.shape[2:]))],
                              dim=1)
        pl[:, ids] = x.reshape(lead, n_pages, block, *x.shape[2:])
    _insert_slot_leaves(data, single, slot)
    data.pos[slot] = single.pos.reshape(-1)[0]
    return data


def paged_evict(data, slot: int, pages):
    """Zero ``pages`` and ``slot``'s slot leaves and reset its position (in
    place), so a reused page or slot never carries a previous tenant's
    state."""
    paged_zero_pages(data, pages)
    _zero_slot_leaves(data, slot)
    data.pos[slot] = 0
    return data


def paged_read(data, tables: torch.Tensor, slot: int, *, block: int):
    """``slot`` as a single-sequence (B=1) dense cache of extent
    ``max_blocks * block`` (a test/debug surface)."""
    return slot_read(paged_gather(data, tables, block=block), slot)


# --------------------------------------------------------------------------
# Prefix-cache page sharing
# --------------------------------------------------------------------------

def paged_copy_page(data, src: int, dst: int):
    """Copy physical page ``src``'s cells into page ``dst`` (in place): the
    copy-on-write primitive. Before the first write into a shared
    (refcount > 1 or prefix-retained) page, the pool copies it to a private
    page and rewrites the slot's block table."""
    for pl in seq_leaves(data):
        pl[:, int(dst)].copy_(pl[:, int(src)])
    return data


def paged_zero_pages(data, pages):
    """Zero the cells of ``pages`` (no slot's position is touched; in
    place): the reclaim half of prefix retention, and what eviction does
    to the pages it frees, so pool contents stay a pure function of the
    live requests and the retained prefix set."""
    ids = _page_ids(data, pages)
    if ids.numel():
        for pl in seq_leaves(data):
            pl[:, ids] = 0
    return data


def prefix_seed(single, data, pages, *, block: int, resume: int):
    """Seed a B=1 staging cache from pool ``pages`` (in place): its rows
    ``[0, min(len(pages) * block, extent))`` take the pages' cells and its
    position becomes ``resume``, so the next chunk of a chunked prefill
    runs at offset ``resume`` over the seeded rows as if the chunks before
    it had run. Rows at or after ``resume`` are overwritten by the suffix
    chunks before any query reaches them. The position is set by a fill on
    the cache's device, in its buffer, so a captured chunk step sees it."""
    ids = _page_ids(data, pages)
    n = int(ids.numel())
    for sl, dl in zip(seq_leaves(single), seq_leaves(data), strict=True):
        n_rows = min(n * block, sl.shape[2])
        if n_rows:
            flat = dl[:, ids].reshape(dl.shape[0], n * block, *dl.shape[3:])
            sl[:, 0, :n_rows] = flat[:, :n_rows].to(sl.dtype)
    single.pos.fill_(resume)
    return single
