"""Token-hash radix tree over the paged pool: prefix-cache bookkeeping (the
port's own copy of ``repro/serving/prefix.py``, DESIGN.md §12; pure Python
and numpy, so its digests and plans equal the reference's).

The tree maps **block-aligned prompt prefixes** to physical pages already
resident in the :class:`~repro_torch.serving.slots.PagedSlotPool`. Nodes live at
full-page granularity: the node at depth ``i`` owns the page holding prompt
tokens ``[i * block, (i + 1) * block)``, and its key is a chained keyed
BLAKE2b digest of (parent digest, block tokens) — the ``seed`` knob keys
the hash, so digests are deterministic per seed but not portable across
seeds. Every node also stores the raw block tokens and match verifies them
exactly, so a digest collision degrades to a cache miss, never to
cross-request KV leakage.

Sharing is sound for this repo in a way it is not for floating-point
serving stacks generally: the paper's multiplier is a *deterministic*
stochastic multiplier (arXiv:2302.08324) and per-row activation
quantization makes logits batch-composition invariant, so the K/V pages a
prefix produces are bit-identical regardless of which request computed
them, at what chunk offset, or in which batch. Attaching a later request's
block table to an earlier request's pages is therefore exact, not
approximate.

The tree owns *identity and recency* only — refcounts, retention, and the
free list stay in the pool (the one ledger, DESIGN.md §12). ``match``
returns a :class:`PrefixMatch` plan; the engine pins the matched pages,
seeds the staging cache, and the pool attaches/copies at admission.
``reclaim`` is the eviction half: under page pressure the pool asks the
tree to surrender its least-recently-touched idle (refcount == 0) leaves,
deepest-first, so interior nodes are never orphaned from their extensions.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.errors import PrefixCacheInvariantError

__all__ = ["PrefixCache", "PrefixMatch"]

_MISS: "PrefixMatch"


@dataclass(frozen=True)
class PrefixMatch:
    """An admission plan for one prompt: skip prefill for ``resume`` tokens
    whose K/V already lives in ``pages``.

    ``resume`` is capped at ``prompt_len - 1`` — at least one prompt token
    is always recomputed so the final-chunk logits (the first sampled
    token's source) exist — and then rounded *down* to a chunk multiple:
    the chunked-prefill step writes whole chunks at the staging offset, so
    a non-chunk-aligned resume would run the final chunk past the bucket
    edge and, in the reference, clamp its write onto seeded rows.
    When the rounded resume falls inside a matched page, that page holds
    positions the suffix prefill rewrites, so it cannot be attached
    shared: it becomes the copy-on-write source (:attr:`cow_src`) and
    everything before it attaches by reference (:attr:`shared`).
    """
    resume: int = 0                      # prefill tokens skipped (0 = miss)
    pages: tuple[int, ...] = ()          # matched pages, prompt order
    block: int = 0

    @property
    def hit(self) -> bool:
        return self.resume > 0

    @property
    def shared(self) -> tuple[int, ...]:
        """Pages attached by reference (cover ``[0, resume)`` entirely)."""
        if self.resume >= len(self.pages) * self.block:
            return self.pages
        return self.pages[:-1]

    @property
    def cow_src(self) -> int | None:
        """The page copied at admission (holds position ``resume``), or
        None when ``resume`` is page-aligned and no copy is needed."""
        if not self.pages or self.resume >= len(self.pages) * self.block:
            return None
        return self.pages[-1]


_MISS = PrefixMatch()


@dataclass
class _Node:
    page: int
    tokens: np.ndarray                   # raw block tokens (collision guard)
    digest: bytes
    parent: "_Node | None"
    children: dict = field(default_factory=dict)   # digest -> _Node
    tick: int = 0


class PrefixCache:
    """The radix tree + LRU recency; one instance per engine.

    ``block`` must equal the pool's page size — nodes and pages are the
    same granularity by construction. ``align`` is the engine's prefill
    chunk length: resume offsets are rounded down to its multiples (see
    :class:`PrefixMatch`). ``seed`` keys the block hash (``serve.py
    --prefix-block-hash``); streams are invariant to it because matching
    always verifies raw tokens.
    """

    def __init__(self, block: int, seed: int = 0, align: int = 1):
        self.block = block
        self.align = max(1, align)
        self._key = int(seed).to_bytes(8, "little", signed=True)
        self._root = _Node(page=-1, tokens=np.empty(0, np.int32),
                           digest=b"", parent=None)
        self._by_page: dict[int, _Node] = {}
        self._tick = 0

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        return len(self._by_page)

    def owns(self, page: int) -> bool:
        return page in self._by_page

    def retained_pages(self) -> set[int]:
        return set(self._by_page)

    # ------------------------------------------------------------- hashing

    def _digest(self, parent: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16, key=self._key)
        h.update(parent)
        h.update(np.ascontiguousarray(tokens, np.int64).tobytes())
        return h.digest()

    def _blocks(self, prompt: np.ndarray):
        """(digest, block tokens) per full page of ``prompt``, chained."""
        prompt = np.asarray(prompt)
        digest = self._root.digest
        for i in range(len(prompt) // self.block):
            tokens = prompt[i * self.block:(i + 1) * self.block]
            digest = self._digest(digest, tokens)
            yield digest, tokens

    # -------------------------------------------------------- match / insert

    def match(self, prompt: np.ndarray) -> PrefixMatch:
        """The deepest resident block-aligned prefix of ``prompt``, as an
        admission plan; touches the recency of the nodes the plan *uses*
        (those covering ``[0, resume)`` — not deeper matched pages the
        rounded-down resume leaves unread)."""
        prompt = np.asarray(prompt)
        node, nodes = self._root, []
        for digest, tokens in self._blocks(prompt):
            child = node.children.get(digest)
            if child is None or not np.array_equal(child.tokens, tokens):
                break
            node = child
            nodes.append(node)
        if not nodes:
            return _MISS
        cap = min(len(nodes) * self.block, len(prompt) - 1)
        resume = (cap // self.align) * self.align
        if resume <= 0:
            return _MISS
        used = nodes[:-(-resume // self.block)]   # nodes covering [0, resume)
        self._tick += 1
        walk = used[-1]   # matched-but-unused deeper pages keep their age:
        while walk is not self._root:   # the plan never touches them, so
            walk.tick = self._tick      # they must not out-compete used
            walk = walk.parent          # pages for warm retention
        return PrefixMatch(resume=resume,
                           pages=tuple(n.page for n in used),
                           block=self.block)

    def insert(self, prompt: np.ndarray, pages) -> list[int]:
        """Register ``prompt``'s full pages (prompt order, one physical id
        per block) after admission; returns the pages *newly* retained by
        the tree — the pool marks exactly those as retained. Pages whose
        node already exists (a re-computation or CoW copy of resident
        content) are left private to their slot.
        """
        prompt = np.asarray(prompt)
        pages = list(pages)
        if len(pages) != len(prompt) // self.block:
            raise PrefixCacheInvariantError(
                f"prefix insert got {len(pages)} pages for "
                f"{len(prompt)} tokens at block={self.block}")
        self._tick += 1
        node, new = self._root, []
        for (digest, tokens), page in zip(self._blocks(prompt), pages):
            child = node.children.get(digest)
            if child is not None and not np.array_equal(child.tokens,
                                                        tokens):
                break                         # digest collision: stop, miss
            if child is None:
                if int(page) in self._by_page:
                    raise PrefixCacheInvariantError(
                        f"page {page} registered under two prefixes")
                child = _Node(page=int(page), tokens=np.array(tokens),
                              digest=digest, parent=node)
                node.children[digest] = child
                self._by_page[child.page] = child
                new.append(child.page)
            child.tick = self._tick
            node = child
        return new

    # ------------------------------------------------------------- eviction

    def reclaim(self, need: int, refcount: np.ndarray) -> list[int]:
        """Surrender up to ``need`` retained pages whose refcount is 0,
        least-recently-touched leaves first (dropping a leaf may expose its
        parent as the next candidate). Returns the surrendered page ids —
        the pool zeroes and frees them; fewer than ``need`` means the rest
        of the tree is pinned by live block tables."""
        out: list[int] = []
        while len(out) < need:
            victim = None
            for node in self._by_page.values():
                if node.children or refcount[node.page] != 0:
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            victim.parent.children.pop(victim.digest, None)
            del self._by_page[victim.page]
            out.append(victim.page)
        return out

    def reclaim_pinned(self, refcount: np.ndarray) -> list[int]:
        """Drop the least-recently-touched refcount-0 page that ``reclaim``
        cannot reach because a live page below it pins it, together with
        its whole subtree. Returns the dropped pages, the victim first;
        those still referenced leave the tree and stay private to their
        slots. Empty when no refcount-0 page is left."""
        victim = None
        for node in self._by_page.values():
            if refcount[node.page] != 0:
                continue
            if victim is None or node.tick < victim.tick:
                victim = node
        if victim is None:
            return []
        victim.parent.children.pop(victim.digest, None)
        out, stack = [], [victim]
        while stack:
            node = stack.pop()
            del self._by_page[node.page]
            out.append(node.page)
            stack.extend(node.children.values())
        return out
