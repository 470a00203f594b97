"""Serving step functions of the port and its per-shape compiled-step
cache (the serving subset of ``repro/launch/steps.py``).

The step functions run eagerly under ``torch.no_grad()``. The engine runs
them through step objects over static buffers that it fills and reads: a
:class:`DecodeStep` (tokens, block table, logits; it advances the pool's
positions in place) and a :class:`PrefillStep` (one chunk of a chunked
prefill into a B=1 staging cache of a prompt bucket's extent, or a
one-shot prefill of one prompt length) and the three steps of a
self-speculative round (:class:`DraftStep`, :class:`VerifyStep`,
:class:`RollbackStep`). :func:`cached_decode_step`
memoises one decode step per decode shape, as the JAX package memoises
one jitted executable per shape (``cached_decode_step`` /
``cached_paged_decode_step``), and captures it into a CUDA graph; its
prefill steps hang off it, one per (bucket, chunk) or prompt length
(:func:`cached_chunked_prefill_step`, :func:`cached_prefill_step`, the
reference's ``cached_chunked_prefill_step`` / ``cached_prefill_step``),
captured at first use over the same weights, and so do its speculative
steps (:func:`cached_draft_loop_step`, :func:`cached_verify_window_step`,
:func:`cached_rollback_step`), over its KV pool. On the card every decode
step, prefill chunk, one-shot prefill and draft, verify or rollback of
the engine is one graph replay. A decode entry owns the weights and the
KV pool it was captured over, its prefill entries' staging buffers and
its drafts' weights packed at their width; an engine binding it copies
its float weights in and packs them, unless the entry holds them already. Every replay runs on the caller's current stream,
so the graphs, which share one memory pool, never run at once.

The spec helpers of the reference's step builders are here too:
:func:`activation_spec` (the residual stream's spec),
:func:`abstract_params` / :func:`abstract_opt_state` (shape-only trees on
the ``meta`` device) and :func:`opt_pspecs` (the optimizer state's specs).
The reference's mesh-bound builders (``build_*_step(cfg, mesh)`` and
their ``cached_*_step`` memos, which the dry run uses) are
``launch/mesh_steps.py``'s; the ``cached_*_step`` names here are the
engine's per-shape graph caches.
"""
from __future__ import annotations

import dataclasses
import gc
import warnings
import weakref

import torch

from repro_torch import tree as tr
from repro_torch.errors import ConfigError
from repro_torch.kernels import autotune
from repro_torch.kernels.ops import launch_counters
from repro_torch.kernels.sc_matmul import (PackedWeight, pack_weight,
                                           scratch_scope)
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import bind, cache_ops, pack_sc_weights
from repro_torch.optim import init as opt_init
from repro_torch.optim.adamw import Quantized8
from repro_torch.parallel.sharding import DATA_AXES, P, fit_spec, is_spec

__all__ = ["prompt_buckets", "bucket_for", "prefill_step", "decode_step",
           "chunked_prefill_step", "paged_decode_step", "DecodeStep",
           "PrefillStep", "cached_decode_step", "cached_chunked_prefill_step",
           "cached_prefill_step", "capture", "decode_steps",
           "clear_decode_steps", "launch_counters", "draft_config", "tune",
           "draft_loop_step", "verify_window_step", "rollback_step",
           "DraftStep", "VerifyStep", "RollbackStep",
           "cached_draft_loop_step", "cached_verify_window_step",
           "cached_rollback_step", "activation_spec", "abstract_params",
           "abstract_opt_state", "opt_pspecs"]

#: Eager runs of a step on the capture stream before its capture, each
#: from the step's reset state: they allocate the step's SC-GEMM scratch
#: and make the kernels' one-time attribute calls outside the capture.
WARMUP_RUNS = 3
#: Eager runs a capture makes in all: its tuning pass (:func:`tune`) and
#: the warm-up; each launches the step's kernels.
EAGER_RUNS = 1 + WARMUP_RUNS


def prompt_buckets(max_seq: int, chunk: int) -> tuple[int, ...]:
    """The padded prompt-length set for chunked prefill: powers-of-two
    multiples of ``chunk``, capped at the smallest chunk multiple covering
    ``max_seq``. Every bucket is a chunk multiple, so a prompt's chunks
    always fit its bucket's staging extent."""
    if chunk < 1 or max_seq < 1:
        raise ValueError(f"need chunk/max_seq >= 1, got {chunk}/{max_seq}")
    top = -(-max_seq // chunk) * chunk
    out = []
    b = chunk
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return tuple(out)


def bucket_for(prompt_len: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket covering ``prompt_len``."""
    for b in buckets:
        if b >= prompt_len:
            return b
    raise ValueError(f"prompt of {prompt_len} tokens exceeds the largest "
                     f"bucket {buckets[-1]}")


@torch.no_grad()
def prefill_step(model, params, batch: dict, *, extra_slots: int = 0):
    """One-shot prefill (the sequential baseline's admission)."""
    return model.prefill_step(params, batch, extra_slots=extra_slots)


@torch.no_grad()
def decode_step(model, params, cache, batch: dict):
    """One token per sequence over a dense cache (the baseline's decode)."""
    return model.decode_step(params, cache, batch)


@torch.no_grad()
def chunked_prefill_step(model, params, cache, batch: dict):
    """One prompt chunk into a B=1 staging cache, which it advances in
    place: ``batch = {"tokens": (1, chunk), "n_valid": int or (1,) int32
    tensor}``."""
    return model.prefill_chunk_step(params, cache, batch)


@torch.no_grad()
def paged_decode_step(model, params, cache, tables: torch.Tensor,
                      batch: dict):
    """One token per slot straight on the page pool (fused: attention
    walks the block table)."""
    return model.paged_decode_step(params, cache, tables, batch)


def draft_config(cfg, draft_bits: int):
    """The speculative draft's config: the same architecture and weights
    through the paper's multiplier at ``draft_bits``, projections and
    attention alike (self-speculation)."""
    return dataclasses.replace(cfg, use_sc_gemm=True, attn_sc=True,
                               sc_bits=draft_bits).validate()


@torch.no_grad()
def draft_loop_step(model, params, cache, tables: torch.Tensor, batch: dict,
                    *, k: int, out: torch.Tensor | None = None):
    """The speculative draft: ``k`` fused paged decode sub-steps of the
    draft ``model`` (:func:`draft_config`) from each slot's last sampled
    token ``batch["tokens"] (C, 1)``, each sub-step's token the argmax of
    its logits on the device, fed to the next. Returns the ``(C, k)``
    int32 proposals (into ``out`` when given) and the cache: the draft's
    K/V rows are scratch at ``[pos, pos + k)`` that the verify step
    overwrites, and ``cache.pos`` is back at its entry value."""
    p0 = cache.pos.clone()
    toks = batch["tokens"]
    if out is None:
        out = torch.empty((toks.shape[0], k), dtype=torch.int32,
                          device=toks.device)
    for i in range(k):
        logits, new = paged_decode_step(model, params, cache, tables,
                                        {"tokens": toks})
        out[:, i] = torch.argmax(logits[:, -1], dim=-1)
        cache.pos.copy_(new.pos)
        toks = out[:, i:i + 1]
    cache.pos.copy_(p0)
    return out, cache


@torch.no_grad()
def verify_window_step(model, params, cache, tables: torch.Tensor,
                       batch: dict, *, block: int, width: int):
    """The speculative verify: the exact model over each slot's window
    ``batch["tokens"] (C, width)`` — its last sampled token and the draft's
    proposals — in one forward: gather the dense view, run
    ``decode_window_step`` on it, fold the window's K/V rows back into the
    pages (``cache_ops.paged_commit_window``). Returns the exact argmax
    after each row, ``(C, width)`` int32 (row ``i`` is what ``i + 1``
    sequential decode steps sample), never the logits, and the cache with
    ``pos + width``."""
    dense = cache_ops.paged_gather(cache, tables, block=block)
    logits, dense = model.decode_window_step(params, dense, batch)
    new = cache_ops.paged_commit_window(cache, dense, tables, block=block,
                                        width=width)
    return torch.argmax(logits, dim=-1).to(torch.int32), new


@torch.no_grad()
def rollback_step(cache, tables: torch.Tensor, accept: torch.Tensor, *,
                  block: int, width: int):
    """The speculative rollback: each slot's committed window rewound to
    its ``accept`` tokens (``cache_ops.paged_rollback``)."""
    return cache_ops.paged_rollback(cache, tables, block=block, width=width,
                                    accept=accept)


# ------------------------------------------------------- graphed steps


def _tensors(tree):
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, torch.Tensor):
        yield tree


def _floats(tree):
    """The parameter tree without its packed weights (every ``"packed"``
    entry dropped)."""
    if isinstance(tree, dict):
        return {k: _floats(v) for k, v in tree.items() if k != "packed"}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_floats(v) for v in tree)
    return tree


def _pairs(have, want):
    """Each packed weight of ``have`` with what stands at its place in
    ``want``, a tree of the same structure."""
    if isinstance(have, PackedWeight):
        yield have, want
    elif isinstance(have, dict):
        for k, v in have.items():
            yield from _pairs(v, want[k])
    elif isinstance(have, (list, tuple)):
        for h, w in zip(have, want, strict=True):
            yield from _pairs(h, w)


@torch.no_grad()
def repack(params, cfg) -> None:
    """Pack ``params``' packed weights anew from its own float weights, in
    place and one weight at a time, so no second packed copy of the tree
    is ever alive (a packed zamba2-7b is ~12.6 GiB)."""
    # each pack's place holds the float weight it is made from, as the
    # projection takes it
    wanted = pack_sc_weights(params, cfg, pack=lambda w, bits: w)
    for dst, w in _pairs(params, wanted):
        fresh = pack_weight(w, dst.bits)
        dst.plane.copy_(fresh.plane)
        dst.scale.copy_(fresh.scale)


def _fingerprint(params) -> list:
    """Which tensors ``params``' float weights are, and how many times
    each has been written in place (its version counter)."""
    return [(weakref.ref(t), t._version) for t in _tensors(_floats(params))]


def _unchanged(fingerprint: list | None, params) -> bool:
    """``params``' float weights are the tensors of ``fingerprint``, none
    written since."""
    if fingerprint is None:
        return False
    ts = list(_tensors(_floats(params)))
    return len(ts) == len(fingerprint) and all(
        ref() is t and t._version == version
        for (ref, version), t in zip(fingerprint, ts))


def _codebooks(cfg) -> tuple[int, ...]:
    """The trailing codebook axis of a step's token and logits buffers:
    ``(K,)`` with ``cfg.n_codebooks``, else none."""
    return (cfg.n_codebooks,) if cfg.n_codebooks else ()


def _empty_like(tree, device):
    """A parameter tree of the same structure with new, uninitialised
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _empty_like(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_empty_like(v, device) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _empty_like(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device=device)
    return tree


class _Step:
    """What a step over static buffers shares with the others: ``run``
    (the step, eagerly) and ``reset`` (its reset state) are the
    subclass's; :meth:`replay` runs ``run`` until :func:`capture` makes it
    a CUDA graph's replay. ``launch_counts`` holds, by wrapper name, the
    kernel launches one captured step makes; each replay adds them to the
    wrappers' counters. ``scratch`` is the SC-GEMM scratch the graph was
    captured over (``kernels.sc_matmul.scratch_scope``), kept as long as
    the step. ``tuning_sweeps`` counts the autotuner's sweeps in the
    step's tuning passes, ``capture_sweeps`` those in its last warm-up and
    capture (lookup-only, so 0)."""

    def _init_replay(self) -> None:
        self.captures = 0
        self.replays = 0
        self.tuning_sweeps = 0
        self.capture_sweeps = 0
        self.launch_counts: dict[str, int] = {}
        self.scratch: dict = {}
        self._graph = None

    def replay(self) -> None:
        if self._graph is None:
            self.run()
        else:
            self._graph.replay()
        self.replays += 1
        if self.launch_counts:
            counters = launch_counters()
            for name, n in self.launch_counts.items():
                counters[name].launches += n


class DecodeStep(_Step):
    """One batched decode step over static buffers.

    The caller writes ``tokens (capacity, 1)`` and, paged, ``tables
    (capacity, max_blocks)`` (int32) in place, calls :meth:`replay`, and
    reads ``logits (capacity, 1, vocab)`` (float32); with codebooks
    ``tokens (capacity, 1, K)`` and ``logits (capacity, 1, K, vocab)``.
    The step advances
    ``cache.pos`` in place, so the pool's positions tensor is the same
    one for the step's whole life; admission and eviction write it in
    place too. ``fused=False`` runs the gather → dense decode → commit
    round trip; ``max_blocks=None`` is the contiguous pool.

    ``prefills`` holds the prefill steps of this entry, by shape
    (:func:`cached_chunked_prefill_step`, :func:`cached_prefill_step`):
    they run over the same weights, and are captured when this step
    was. ``specs`` holds its speculative steps the same way, by
    ``("draft", k, draft_bits)``, ``("verify", width)`` and
    ``("rollback", width)``; ``drafts`` the draft model and the weights
    packed at each draft width, shared by every draft step of that
    width."""

    def __init__(self, model, params, cache, *, capacity: int,
                 max_blocks: int | None = None, block: int | None = None,
                 fused: bool = True):
        dev = cache.pos.device
        self.model, self.params, self.cache = model, params, cache
        self.paged = max_blocks is not None
        self.block, self.fused = block, fused
        kb = _codebooks(model.cfg)
        self.tokens = torch.zeros((capacity, 1, *kb), dtype=torch.int32,
                                  device=dev)
        self.tables = None if not self.paged else torch.full(
            (capacity, max_blocks), -1, dtype=torch.int32, device=dev)
        self.logits = torch.zeros((capacity, 1, *kb, model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.prefills: dict[tuple, PrefillStep] = {}
        self.specs: dict[tuple, _Step] = {}
        self.drafts: dict[int, tuple] = {}
        # the float weights the step holds (:meth:`load`), and the draft
        # widths packed before they last changed
        self.loaded: list | None = None
        self.stale_drafts: set[int] = set()
        self.owner = None       # a weakref to the engine it serves
        self._init_replay()

    @torch.no_grad()
    def run(self) -> None:
        """The step, eagerly: the existing step functions on the static
        buffers, the logits and the new positions copied into place."""
        batch = {"tokens": self.tokens}
        if not self.paged:
            logits, new = decode_step(self.model, self.params, self.cache,
                                      batch)
        elif self.fused:
            logits, new = paged_decode_step(self.model, self.params,
                                            self.cache, self.tables, batch)
        else:
            dense = cache_ops.paged_gather(self.cache, self.tables,
                                           block=self.block)
            logits, dense = decode_step(self.model, self.params, dense,
                                        batch)
            new = cache_ops.paged_commit(self.cache, dense, self.tables,
                                         block=self.block)
        self.logits.copy_(logits)
        self.cache.pos.copy_(new.pos)

    def load(self, params, *, draft_bits: int | None = None) -> None:
        """Copy the float weights of ``params`` (a tree of the same
        structure and shapes; packed weights in it are ignored) into the
        step's own and pack the step's weights anew from them, in place
        (:func:`repack`), unless the step holds them already: they are
        the tensors it was made or last loaded from, unwritten since.
        Then pack the draft weights of width ``draft_bits`` (when there
        are any) anew if the float weights changed after they were
        packed. Other widths keep the weights they were packed from until
        an engine drafting at that width binds the step."""
        if not _unchanged(self.loaded, params):
            pairs = list(zip(_tensors(_floats(self.params)),
                             _tensors(_floats(params)), strict=True))
            for dst, src in pairs:
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ConfigError(
                        f"weights {tuple(src.shape)} {src.dtype} do not fit "
                        f"the captured step's {tuple(dst.shape)} "
                        f"{dst.dtype}")
            with torch.no_grad():
                for dst, src in pairs:
                    dst.copy_(src)
            repack(self.params, self.model.cfg)
            self.loaded = _fingerprint(params)
            self.stale_drafts = set(self.drafts)
        if draft_bits in self.stale_drafts:
            model, packed = self.drafts[draft_bits]
            repack(packed, model.cfg)
            self.stale_drafts.discard(draft_bits)

    def reset(self) -> None:
        """An empty pool: pages, states, positions and inputs zeroed,
        every table entry unallocated."""
        with torch.no_grad():
            for t in (*_tensors(self.cache), self.tokens, self.logits):
                t.zero_()
            if self.tables is not None:
                self.tables.fill_(-1)


class PrefillStep(_Step):
    """One prefill over static buffers, on the weights ``params``.

    Chunked (``chunk`` tokens): the caller writes ``tokens (1, chunk)``
    (zero-padded past the valid ones) and ``n_valid (1,)`` (int32) in
    place, calls :meth:`replay`, and reads ``logits (1, 1, vocab)``
    (float32, the last valid row); with codebooks ``tokens (1, chunk,
    K)`` and ``logits (1, 1, K, vocab)``. The chunk lands in the B=1 staging
    ``cache`` of ``extent`` positions (a prompt bucket) at ``cache.pos``,
    which the step advances in place; a new prompt starts with
    :meth:`start`. The caller keeps ``cache.pos + chunk <= extent``.

    One-shot (``chunk=None``): ``tokens (1, extent)`` is the prompt;
    ``cache`` (extent ``extent``, ``pos`` = ``extent``) and ``logits``
    take the prefill's K/V and last-row logits.

    Either way the caller copies ``cache`` out (``cache_ops.truncate_seq``
    and the pool's admission) before the step runs again."""

    def __init__(self, model, params, *, extent: int,
                 chunk: int | None = None):
        dev = model.device
        self.model, self.params = model, params
        self.extent, self.chunk = extent, chunk
        kb = _codebooks(model.cfg)
        self.tokens = torch.zeros((1, extent if chunk is None else chunk,
                                   *kb), dtype=torch.int32, device=dev)
        self.n_valid = None if chunk is None else torch.zeros(
            (1,), dtype=torch.int32, device=dev)
        self.cache = model.init_cache(1, extent)
        self.logits = torch.zeros((1, 1, *kb, model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self._init_replay()
        self.reset()

    @torch.no_grad()
    def run(self) -> None:
        """The step, eagerly: the existing prefill functions on the static
        buffers, the logits (and, one-shot, the K/V) copied into place."""
        if self.chunk is not None:
            logits, _ = chunked_prefill_step(
                self.model, self.params, self.cache,
                {"tokens": self.tokens, "n_valid": self.n_valid})
        else:
            logits, out = prefill_step(self.model, self.params,
                                       {"tokens": self.tokens})
            for dst, src in zip(_tensors(self.cache), _tensors(out),
                                strict=True):
                dst.copy_(src)
        self.logits.copy_(logits)

    def start(self) -> None:
        """A new prompt: the staging position back to 0 and the recurrent
        state (a Mamba family's conv windows and states) zeroed. K/V left
        past the position by an earlier prompt stay: every key past a
        row's position is masked to an exact zero weight."""
        self.cache.pos.zero_()
        for t in cache_ops.slot_leaves(self.cache):
            t.zero_()

    def seed(self, data, pages, *, block: int, resume: int) -> None:
        """A prefix hit's start, after :meth:`start`: the staging rows
        below the matched pages' extent take the pool ``data``'s ``pages``
        and the position becomes ``resume`` (a chunk multiple), written in
        place into the buffers the captured chunk graph reads
        (``cache_ops.prefix_seed``). The next replay then runs the chunk at
        ``resume`` over the seeded rows, the same graph a cold prompt
        replays there."""
        cache_ops.prefix_seed(self.cache, data, pages, block=block,
                              resume=resume)

    def reset(self) -> None:
        """Zero tokens at position 0 (a full chunk valid), zero caches and
        logits: what a capture runs on."""
        with torch.no_grad():
            for t in (*_tensors(self.cache), self.tokens, self.logits):
                t.zero_()
            if self.chunk is None:
                self.cache.pos.fill_(self.extent)
            else:
                self.cache.pos.zero_()
                self.n_valid.fill_(self.chunk)


def _packs(tree):
    """The packed weights of a parameter tree, in a fixed order."""
    if isinstance(tree, PackedWeight):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _packs(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _packs(v)


class VerifyStep(_Step):
    """The verify of a speculative round over ``decode``'s pool, tables
    and weights (:func:`verify_window_step`). ``window (C, width)`` int32
    is its input: column 0 is copied from ``decode.tokens`` on the device
    when the step runs, columns ``1 ..`` are written by the draft step
    (its ``out`` is a view of them). ``out (C, width)`` int32 takes the
    exact argmaxes; the pool's positions advance by ``width`` in place."""

    def __init__(self, decode: DecodeStep, *, width: int):
        dev = decode.cache.pos.device
        self.decode, self.cache, self.width = decode, decode.cache, width
        capacity = decode.tokens.shape[0]
        self.window = torch.zeros((capacity, width), dtype=torch.int32,
                                  device=dev)
        self.out = torch.zeros((capacity, width), dtype=torch.int32,
                               device=dev)
        self._init_replay()

    @torch.no_grad()
    def run(self) -> None:
        d = self.decode
        self.window[:, :1].copy_(d.tokens)
        out, new = verify_window_step(d.model, d.params, d.cache, d.tables,
                                      {"tokens": self.window},
                                      block=d.block, width=self.width)
        self.out.copy_(out)
        d.cache.pos.copy_(new.pos)

    def reset(self) -> None:
        """The decode entry's reset state (an empty pool) and zero
        windows."""
        self.decode.reset()
        with torch.no_grad():
            self.window.zero_()
            self.out.zero_()


class DraftStep(_Step):
    """The draft of a speculative round (:func:`draft_loop_step`): ``k``
    sub-steps of ``model`` (the draft config) over ``decode``'s pool and
    tables, from ``decode.tokens``, its proposals written into ``out (C,
    k)`` (a view of the verify step's window). ``params`` shares the
    decode entry's float weights and holds its one extra copy, the
    weights packed at the draft's width (``decode.drafts``), which
    :meth:`DecodeStep.load` packs anew."""

    def __init__(self, decode: DecodeStep, model, params,
                 out: torch.Tensor, *, k: int):
        self.decode, self.cache = decode, decode.cache
        self.model, self.params, self.out, self.k = model, params, out, k
        self._init_replay()

    @torch.no_grad()
    def run(self) -> None:
        d = self.decode
        draft_loop_step(self.model, self.params, d.cache, d.tables,
                        {"tokens": d.tokens}, k=self.k, out=self.out)

    @property
    def weight_bytes(self) -> int:
        """Device bytes of the draft's own packed weights."""
        return sum(p.plane.nbytes + p.scale.nbytes
                   for p in _packs(self.params))

    def reset(self) -> None:
        self.decode.reset()


class RollbackStep(_Step):
    """The rollback of a speculative round (:func:`rollback_step`) over
    ``decode``'s pool and tables: ``accept (C,)`` int32 is its input (0
    for a free slot); the pool's positions rewind in place."""

    def __init__(self, decode: DecodeStep, *, width: int):
        self.decode, self.cache, self.width = decode, decode.cache, width
        self.accept = torch.zeros((decode.tokens.shape[0],),
                                  dtype=torch.int32,
                                  device=decode.cache.pos.device)
        self._init_replay()

    @torch.no_grad()
    def run(self) -> None:
        d = self.decode
        new = rollback_step(d.cache, d.tables, self.accept, block=d.block,
                            width=self.width)
        d.cache.pos.copy_(new.pos)

    def reset(self) -> None:
        self.decode.reset()
        self.accept.zero_()


def tune(step: _Step) -> int:
    """A capture's tuning pass: one eager ``step.run()`` on the caller's
    stream from ``step.reset()``, with the autotuner's sweeps allowed, so
    every kernel launch plan the step needs is in the cache before the
    lookup-only warm-up and capture; then ``step.reset()`` again. It runs
    outside the step's SC-GEMM scratch scope (a sweep's K splits grow the
    shared scratch, never the step's) and outside sync debug mode (a sweep
    synchronizes). Returns the sweeps it ran (``step.tuning_sweeps`` adds
    them up)."""
    before = autotune.sweeps
    with torch.no_grad():
        step.reset()
        step.run()
        step.reset()
    swept = autotune.sweeps - before
    step.tuning_sweeps += swept
    return swept


def capture(step: _Step) -> None:
    """Capture ``step.run`` (any of the steps above) into a CUDA graph and
    make its replay the step's ``replay``, PyTorch's way: first the tuning
    pass (:func:`tune`), then :data:`WARMUP_RUNS` eager runs on a side
    stream, each from ``step.reset()`` (with synchronizing calls made
    errors), then the capture on that stream from the reset state under
    ``torch.no_grad()``, into the memory pool every graph shares. From
    the warm-up on the autotuner is lookup-only (a miss raises), and
    ``step.capture_sweeps`` records the sweeps there: 0. The warm-up and
    the capture take their SC-GEMM scratch from the step's own table,
    which the step keeps, sized for the tuned plans. The launches the
    capture recorded become ``step.launch_counts``; the counters are put
    back, since a capture launches nothing. Python's cyclic collector runs
    just before the capture and not during it. Raises, never falls
    back."""
    dev = step.cache.pos.device
    if dev.type != "cuda":
        raise ConfigError(f"CUDA graphs need the card, not {dev}; on the "
                          f"CPU the engine runs the eager steps "
                          f"(graphs=None or False)")
    global _POOL
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    tune(step)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    mode = torch.cuda.get_sync_debug_mode()
    counters = launch_counters()
    swept = autotune.sweeps
    with autotune.lookup_only(), scratch_scope(step.scratch):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Synchronization debug mode")
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.cuda.stream(stream):
                    for _ in range(WARMUP_RUNS):
                        step.reset()
                        step.run()
                    step.reset()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(stream)
        before = {name: fn.launches for name, fn in counters.items()}
        # a graph destroyed during the capture (an old entry's, freed when
        # the collector breaks its reference cycle) invalidates it: dead
        # cycles go now, and the collector waits till the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(graph, pool=_POOL,
                                                   stream=stream):
                step.run()
        finally:
            if collecting:
                gc.enable()
    step.launch_counts = {name: fn.launches - before[name]
                          for name, fn in counters.items()
                          if fn.launches != before[name]}
    for name, fn in counters.items():
        fn.launches = before[name]
    step.capture_sweeps = autotune.sweeps - swept
    step._graph = graph
    step.captures += 1


_POOL = None
_STEPS: dict[tuple, DecodeStep] = {}


def _decode_key(cfg, device: torch.device, *, capacity: int, max_seq: int,
                block: int, n_blocks: int, max_blocks: int | None,
                fused: bool) -> tuple:
    """What the reference keys its cached decode steps on: the config
    (attention mode and ``sc_bits`` included), the pool's shape, the
    fused/gather structure and the device."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if max_blocks is None:
        return (cfg, str(device), "contiguous", capacity, max_seq)
    return (cfg, str(device), "paged", capacity, block, n_blocks, max_blocks,
            fused)


def cached_decode_step(model, params, *, capacity: int, max_seq: int,
                       block: int = 0, n_blocks: int = 0,
                       max_blocks: int | None = None,
                       fused: bool = True) -> DecodeStep:
    """The decode step of this shape (paged, or with ``max_blocks=None``
    the contiguous pool), made and captured (:func:`capture`) on first
    use and shared by every engine of the shape after that, with its
    prefill steps.
    Table contents, page churn and positions are inputs: they never cause
    a second capture. A new entry owns new weights (``params``' structure,
    loaded from ``params``' float weights and packed from its own copy, so
    the entry holds the one packed copy it serves from; ``params`` may lie
    on another device, the host included, and are copied in tensor by
    tensor) and a new, empty KV pool; engines bind it through
    :meth:`DecodeStep.load` and :meth:`DecodeStep.reset`."""
    key = _decode_key(model.cfg, model.device, capacity=capacity,
                      max_seq=max_seq, block=block, n_blocks=n_blocks,
                      max_blocks=max_blocks, fused=fused)
    step = _STEPS.get(key)
    if step is None:
        cache = model.init_cache(capacity, max_seq) if max_blocks is None \
            else cache_ops.paged_init(model.init_cache, capacity, n_blocks,
                                      block)
        own = _empty_like(_floats(params), model.device)
        with torch.no_grad():
            for dst, src in zip(_tensors(own), _tensors(_floats(params)),
                                strict=True):
                dst.copy_(src)
        step = DecodeStep(model, pack_sc_weights(own, model.cfg), cache,
                          capacity=capacity, max_blocks=max_blocks,
                          block=block, fused=fused)
        step.loaded = _fingerprint(params)
        capture(step)
        step.reset()
        _STEPS[key] = step
    return step


def _prefill_entry(decode: DecodeStep, key: tuple, *, extent: int,
                   chunk: int | None = None) -> PrefillStep:
    step = decode.prefills.get(key)
    if step is None:
        step = PrefillStep(decode.model, decode.params, extent=extent,
                           chunk=chunk)
        if decode.captures:
            capture(step)
            step.reset()
        decode.prefills[key] = step
    return step


def cached_chunked_prefill_step(decode: DecodeStep, *, bucket: int,
                                chunk: int) -> PrefillStep:
    """The chunked-prefill step of ``decode``'s engines for prompts of
    ``bucket`` (a :func:`prompt_buckets` extent) in chunks of ``chunk``:
    made on first use over ``decode``'s weights, captured (:func:`capture`,
    with zero tokens at position 0, then reset) when ``decode`` was, and
    kept in ``decode.prefills``. Like the reference's
    ``cached_chunked_prefill_step`` it is keyed on the config (through the
    decode entry: attention mode and ``sc_bits`` included), the device,
    the bucket and the chunk, so an engine makes at most
    ``len(prompt_buckets(max_seq, chunk))`` of them; the chunk's offset
    and valid length are inputs, never a new capture."""
    return _prefill_entry(decode, ("chunked", bucket, chunk), extent=bucket,
                          chunk=chunk)


def cached_prefill_step(decode: DecodeStep, *,
                        prompt_len: int) -> PrefillStep:
    """The one-shot prefill step of ``decode``'s engines for prompts of
    ``prompt_len`` tokens, made and captured as
    :func:`cached_chunked_prefill_step`'s: one per distinct prompt length,
    as the reference compiles one prefill per prompt length."""
    return _prefill_entry(decode, ("oneshot", prompt_len), extent=prompt_len)


def _spec_entry(decode: DecodeStep, key: tuple, make) -> _Step:
    step = decode.specs.get(key)
    if step is None:
        if not decode.paged:
            raise ConfigError("speculative steps run on the paged pool")
        if decode.model.cfg.n_codebooks:
            # as in the reference: a codebook head would need an
            # acceptance per codebook
            raise ConfigError("speculative steps take no codebook head")
        step = make()
        if decode.captures:
            # the capture runs from the entry's reset state: an empty pool
            capture(step)
            step.reset()
        decode.specs[key] = step
    return step


def cached_verify_window_step(decode: DecodeStep, *,
                              width: int) -> VerifyStep:
    """The verify step of ``decode``'s engines for windows of ``width``
    rows (the reference's ``cached_verify_window_step``): made on first
    use over ``decode``'s weights and pool, captured when ``decode`` was,
    kept in ``decode.specs``. A capture resets the pool, so an engine asks
    for its speculative steps when it binds the entry, holding nothing."""
    return _spec_entry(decode, ("verify", width),
                       lambda: VerifyStep(decode, width=width))


def cached_draft_loop_step(decode: DecodeStep, *, k: int,
                           draft_bits: int) -> DraftStep:
    """The draft step of ``decode``'s engines for ``k`` proposals at
    ``draft_bits`` (the reference's ``cached_draft_loop_step``), made and
    captured as :func:`cached_verify_window_step`'s, writing into the
    window of the verify step of width ``k + 1``. The entry's weights
    are packed at ``draft_bits`` once (``decode.drafts``), one extra
    copy shared by the draft steps of every ``k``."""
    verify = cached_verify_window_step(decode, width=k + 1)
    if draft_bits not in decode.drafts:
        cfg = draft_config(decode.model.cfg, draft_bits)
        decode.drafts[draft_bits] = (bind(cfg, decode.model.device),
                                     pack_sc_weights(decode.params, cfg))

    def make():
        return DraftStep(decode, *decode.drafts[draft_bits],
                         verify.window[:, 1:], k=k)

    return _spec_entry(decode, ("draft", k, draft_bits), make)


def cached_rollback_step(decode: DecodeStep, *,
                         width: int) -> RollbackStep:
    """The rollback step of ``decode``'s engines for windows of ``width``
    rows (the reference's ``cached_rollback_step``)."""
    return _spec_entry(decode, ("rollback", width),
                       lambda: RollbackStep(decode, width=width))


def decode_steps() -> dict[tuple, DecodeStep]:
    """The cached decode steps, by key."""
    return dict(_STEPS)


def clear_decode_steps() -> None:
    """Forget every cached decode step (engines holding one keep it)."""
    _STEPS.clear()


def drop_decode_steps(cfg) -> int:
    """Forget the cached decode steps of ``cfg``'s model (engines holding
    one keep it); returns how many were dropped."""
    keys = [k for k in _STEPS if k[0] == cfg]
    for k in keys:
        del _STEPS[k]
    return len(keys)


# ------------------------------------------------------------- specs

def activation_spec(mesh, strategy: str = "tp_sp"):
    """Residual stream ``(B, S, d)``: batch over the data axes, sequence
    over ``model`` (sequence parallelism; ``parallel/context.py``). The
    ``"dp"`` strategy spreads batch over every axis instead."""
    names = mesh_axes(mesh)
    axes = tuple(a for a in DATA_AXES if a in names) or None
    if strategy == "dp":
        axes = tuple(axes or ()) + (("model",) if "model" in names else ())
        return P(axes, None, None)
    return P(axes, "model", None)


def abstract_params(cfg, seed: int = 0):
    """``cfg``'s parameter tree on the ``meta`` device: shapes and dtypes,
    no storage (a 400 B model costs nothing)."""
    return bind(cfg, "meta").init_params(seed)


def abstract_opt_state(cfg, params, optc):
    """The AdamW state of ``params`` (an :func:`abstract_params` tree) on
    the ``meta`` device."""
    del cfg
    return opt_init(params, optc)


def opt_pspecs(cfg, opt_state, p_specs, mesh):
    """Moments follow their parameter's spec; quantized moments shard
    their block dim over every mesh axis (pure ZeRO state), or stay
    replicated where the mesh does not divide it."""
    del cfg
    all_axes = tuple(mesh_axes(mesh))
    flat_spec = tr.leaves(p_specs, is_leaf=is_spec)

    def fit(t):
        return fit_spec(P(all_axes, None), tuple(t.shape), mesh)

    def moments(tree):
        flat, structure = tr.flatten(
            tree, is_leaf=lambda x: isinstance(x, Quantized8))
        if len(flat) != len(flat_spec):
            raise ConfigError(f"{len(flat)} moments, {len(flat_spec)} "
                              f"parameter specs")
        return tr.unflatten(structure, [
            Quantized8(q=fit(leaf.q), scale=fit(leaf.scale))
            if isinstance(leaf, Quantized8) else spec
            for leaf, spec in zip(flat, flat_spec)])

    return {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]),
            "step": P()}
