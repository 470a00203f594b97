"""Mesh-bound step builders (port of the reference's ``build_*_step(cfg,
mesh)`` and ``cached_*_step(cfg, mesh)``, ``repro/launch/steps.py``).

Each builder returns what the reference's returns — ``(step, shardings,
params_abs)``, and ``(step, shardings, (params_abs, opt_abs), optc)`` for
train — where ``step`` takes trees placed by
:func:`repro_torch.parallel.sharding.distribute` on ``mesh`` (a named
``DeviceMesh``) and ``shardings`` holds the
:class:`~repro_torch.parallel.sharding.NamedSharding` trees of its inputs
(``"params"``, ``"opt"``, ``"cache"``, ``"tables"``, and ``"batch_fn"``,
a function of a batch). The step runs the port's own functions on
``DTensor``s — ``launch.train``'s loss and gradient, the models'
``prefill_step``, ``decode_step``, ``paged_decode_step`` and
``prefill_chunk_step``, ``launch.steps``' draft, verify and rollback —
under ``activation_sharding_scope`` where the reference installs it, and
under DTensor's ``implicit_replication``, so a plain tensor a model makes
(positions, masks, rope tables) counts as the same on every rank. It
returns its outputs in the reference's out-shardings and, in train, pins
the gradients to the parameters' layout first.

The kernels are custom operators whose sharding rules
(``parallel/kernel_sharding.py``) keep each reduction axis whole on a
rank, and an SC-GEMM weight is packed at its whole tensor's scale, so the
SC numeric is the unsharded one: a rank's share of an output is the bits
of its slice of the one-rank output. Under ``cfg.use_sc_gemm`` every
projection goes through the SC-GEMM operator (``sc_impl`` "pallas" unless
the config names a kernel plan already): the plain formulations'
integer reductions have no DTensor rule, and all give the same bits.

The names ``cached_*_step`` here are the reference's memos of these
builders (``functools.lru_cache`` on cfg, mesh and shape); the engine's
per-shape CUDA-graph caches of the same names are ``launch/steps.py``'s.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from repro_torch import tree as tr
from repro_torch.core.sc_matmul import resolve_impl
from repro_torch.launch import steps as eager
from repro_torch.launch import train as tt
from repro_torch.launch.mesh import mesh_axes
from repro_torch.launch.steps import (abstract_opt_state, abstract_params,
                                      activation_spec, opt_pspecs)
from repro_torch.models import bind, cache_ops
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel.context import activation_sharding_scope, is_dtensor
from repro_torch.parallel.sharding import (DATA_AXES, NamedSharding, P,
                                           batch_pspecs, cache_pspecs,
                                           fit_spec, is_spec, named,
                                           paged_pool_pspecs,
                                           paged_tables_pspec, param_pspecs)

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "build_paged_decode_step", "build_chunked_prefill_step",
           "build_draft_loop_step", "build_verify_window_step",
           "build_rollback_step", "cached_train_step", "cached_prefill_step",
           "cached_decode_step", "cached_paged_decode_step",
           "cached_chunked_prefill_step", "cached_draft_loop_step",
           "cached_verify_window_step", "cached_rollback_step",
           "mesh_config", "place_outputs"]


def mesh_config(cfg):
    """``cfg`` as the mesh-bound steps run it: SC projections through the
    SC-GEMM operator (``sc_impl`` "pallas" unless it names a kernel plan
    already)."""
    if cfg.use_sc_gemm and resolve_impl(cfg.sc_impl) not in ("pallas",
                                                             "pallas_tuned"):
        cfg = dataclasses.replace(cfg, sc_impl="pallas").validate()
    return cfg


def _bound(cfg, mesh):
    from repro_torch.parallel import kernel_sharding
    kernel_sharding.register()
    return bind(mesh_config(cfg), mesh.device_type)


@contextlib.contextmanager
def _on_mesh(mesh, act_spec: P | None = None):
    """The scope a step body runs in: plain tensors replicate implicitly,
    and the residual stream's sharding where the reference installs it."""
    from torch.distributed.tensor.experimental import implicit_replication
    scope = (activation_sharding_scope(NamedSharding(mesh, act_spec))
             if act_spec is not None else contextlib.nullcontext())
    with implicit_replication(), scope:
        yield


def place_outputs(tree, shardings):
    """Each ``DTensor`` of ``tree`` redistributed to its
    :class:`NamedSharding` (a tree of one structure, or one sharding for
    every leaf); the reference's ``out_shardings``."""
    def one(t, s):
        if not is_dtensor(t):
            return t
        return t.redistribute(s.mesh, s.placements)
    if isinstance(shardings, NamedSharding):
        return tr.tree_map(lambda t: one(t, shardings), tree)
    return tr.tree_map(one, tree, shardings)


def _named(mesh, specs):
    """``named(mesh, specs)`` with every axis of one device dropped from
    the specs: a split over it changes nothing, and DTensor refuses to
    flatten a dim split even over one device. A single spec gives one
    :class:`NamedSharding`."""
    sizes = mesh_axes(mesh)

    def live(spec):
        def entry(e):
            axes = e if isinstance(e, tuple) else (e,)
            kept = tuple(a for a in axes if a is not None and sizes[a] > 1)
            return kept or None
        return P(*(entry(e) for e in spec))

    if is_spec(specs):
        return NamedSharding(mesh, live(specs))
    return named(mesh, tr.tree_map(live, specs, is_leaf=is_spec))


def _data_axes(mesh):
    return tuple(a for a in DATA_AXES if a in mesh_axes(mesh)) or None


def _logits_sharding(cfg, mesh, rows: int) -> NamedSharding:
    """Logits ``(rows, 1, V)`` (``(rows, 1, K, V)`` with codebooks): rows
    over the data axes where they divide."""
    shape = ((rows, 1, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks
             else (rows, 1, cfg.vocab_size))
    spec = P(*((_data_axes(mesh),) + (None,) * (len(shape) - 1)))
    return _named(mesh, fit_spec(spec, shape, mesh))


def _token_grid_sharding(mesh, capacity: int, width: int) -> NamedSharding:
    """A ``(capacity, width)`` int32 token grid: slots over the data
    axes."""
    return _named(mesh, fit_spec(P(_data_axes(mesh), None),
                                 (capacity, width), mesh))


def _batch_fn(cfg, mesh):
    return lambda batch: _named(mesh, batch_pspecs(cfg, batch, mesh))


# ------------------------------------------------------------- builders

def build_train_step(cfg, mesh, *, optc: AdamWConfig | None = None,
                     peak_lr: float = 3e-4, warmup: int = 100,
                     total_steps: int = 10_000):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``{"loss", "lr", "grad_norm"}``: the loss and
    every leaf's gradient (``launch.train.value_and_grad``) under the
    residual stream's sharding, the gradients pinned to the parameters'
    layout, ``warmup_cosine`` at ``opt_state["step"]`` and AdamW."""
    m = _bound(cfg, mesh)
    cfg = m.cfg
    optc = optc or AdamWConfig(quantize_moments=cfg.n_experts >= 64)
    act = activation_spec(mesh, cfg.sharding_strategy)
    params_abs = abstract_params(cfg)
    opt_abs = abstract_opt_state(cfg, params_abs, optc)
    p_specs = param_pspecs(cfg, params_abs, mesh)
    o_specs = opt_pspecs(cfg, opt_abs, p_specs, mesh)
    shardings = {
        "params": _named(mesh, p_specs),
        "opt": _named(mesh, o_specs),
        "batch_fn": _batch_fn(cfg, mesh),
        "metrics": _named(mesh, {"loss": P(), "lr": P(), "grad_norm": P()}),
    }

    def train_step(params, opt_state, batch):
        tt._refuse_packed(params)
        with _on_mesh(mesh, act):
            loss, grads = tt.value_and_grad(m, params, batch)
        with _on_mesh(mesh):
            # pinned to the parameters' layouts (the reference's
            # with_sharding_constraint(grads, grad_sh))
            grads = place_outputs(grads, shardings["params"])
            lr = warmup_cosine(opt_state["step"], peak_lr=peak_lr,
                               warmup_steps=warmup, total_steps=total_steps)
            new_params, new_opt = apply_updates(params, grads, opt_state,
                                                optc, lr)
            sq = [torch.sum(torch.square(g.to(torch.float32)))
                  for g in tr.leaves(grads)]
            norm = torch.sqrt(functools.reduce(torch.add, sq))
            metrics = {"loss": loss, "lr": lr, "grad_norm": norm}
            return (place_outputs(new_params, shardings["params"]),
                    place_outputs(new_opt, shardings["opt"]),
                    place_outputs(metrics, shardings["metrics"]))

    return train_step, shardings, (params_abs, opt_abs), optc


def _cache_shardings(cfg, mesh, batch_size: int, seq_len: int):
    cache_abs = bind(cfg, "meta").init_cache(batch_size, seq_len)
    return _named(mesh, cache_pspecs(cfg, cache_abs, mesh,
                                    batch_size=batch_size))


def build_prefill_step(cfg, mesh, *, batch_size: int, seq_len: int,
                       extra_slots: int = 0):
    """``prefill(params, batch) -> (logits, cache)``: the family's
    one-shot prefill under the residual stream's sharding."""
    m = _bound(cfg, mesh)
    cfg = m.cfg
    act = activation_spec(mesh, cfg.sharding_strategy)
    params_abs = abstract_params(cfg)
    cache_sh = _cache_shardings(cfg, mesh, batch_size,
                                seq_len + extra_slots)
    logits_sh = _logits_sharding(cfg, mesh, batch_size)
    shardings = {"params": _named(mesh, param_pspecs(cfg, params_abs, mesh)),
                 "batch_fn": _batch_fn(cfg, mesh), "cache": cache_sh}

    @torch.no_grad()
    def prefill(params, batch):
        with _on_mesh(mesh, act):
            logits, cache = m.prefill_step(params, batch,
                                           extra_slots=extra_slots)
            return (place_outputs(logits, logits_sh),
                    place_outputs(cache, cache_sh))

    return prefill, shardings, params_abs


def build_decode_step(cfg, mesh, *, batch_size: int, seq_len: int):
    """``decode(params, cache, batch) -> (logits, cache)``: one token a
    sequence over a dense cache (written in place, and returned in its
    layout)."""
    m = _bound(cfg, mesh)
    cfg = m.cfg
    params_abs = abstract_params(cfg)
    cache_sh = _cache_shardings(cfg, mesh, batch_size, seq_len)
    logits_sh = _logits_sharding(cfg, mesh, batch_size)
    shardings = {"params": _named(mesh, param_pspecs(cfg, params_abs, mesh)),
                 "batch_fn": _batch_fn(cfg, mesh), "cache": cache_sh}

    @torch.no_grad()
    def decode(params, cache, batch):
        with _on_mesh(mesh):
            logits, cache = m.decode_step(params, cache, batch)
            return (place_outputs(logits, logits_sh),
                    place_outputs(cache, cache_sh))

    return decode, shardings, params_abs


def _paged_shardings(cfg, mesh, *, capacity: int, block: int,
                     n_blocks: int):
    """(params, pool and tables shardings, params_abs) of a paged pool."""
    params_abs = abstract_params(cfg)
    pool_abs = cache_ops.paged_init(bind(cfg, "meta").init_cache, capacity,
                                    n_blocks, block)
    return (_named(mesh, param_pspecs(cfg, params_abs, mesh)),
            _named(mesh, paged_pool_pspecs(cfg, pool_abs, mesh)),
            _named(mesh, paged_tables_pspec(mesh)), params_abs)


def build_paged_decode_step(cfg, mesh, *, capacity: int, block: int,
                            n_blocks: int, max_blocks: int,
                            fused: bool = True):
    """``decode(params, data, tables, batch) -> (logits, data)`` over a
    paged pool (``cache_ops.paged_init``'s layout, written in place):
    ``fused`` runs the family's ``paged_decode_step`` (attention through
    the block table), else gather → ``decode_step`` → one-token commit."""
    del max_blocks
    m = _bound(cfg, mesh)
    cfg = m.cfg
    p_sh, pool_sh, tables_sh, params_abs = _paged_shardings(
        cfg, mesh, capacity=capacity, block=block, n_blocks=n_blocks)
    logits_sh = _logits_sharding(cfg, mesh, capacity)
    shardings = {"params": p_sh, "batch_fn": _batch_fn(cfg, mesh),
                 "cache": pool_sh, "tables": tables_sh}

    @torch.no_grad()
    def decode(params, data, tables, batch):
        with _on_mesh(mesh):
            if fused:
                logits, data = m.paged_decode_step(params, data, tables,
                                                   batch)
            else:
                dense = cache_ops.paged_gather(data, tables, block=block)
                logits, dense = m.decode_step(params, dense, batch)
                data = cache_ops.paged_commit(data, dense, tables,
                                              block=block)
            return (place_outputs(logits, logits_sh),
                    place_outputs(data, pool_sh))

    return decode, shardings, params_abs


def build_chunked_prefill_step(cfg, mesh, *, seq_len: int, chunk: int):
    """``step(params, cache, batch) -> (logits, cache)``: one chunk
    ``batch = {"tokens": (1, chunk), "n_valid": (1,)}`` into a B=1
    staging cache of extent ``seq_len``, advanced in place."""
    del chunk
    m = _bound(cfg, mesh)
    cfg = m.cfg
    act = activation_spec(mesh, cfg.sharding_strategy)
    params_abs = abstract_params(cfg)
    cache_sh = _cache_shardings(cfg, mesh, 1, seq_len)
    logits_sh = _logits_sharding(cfg, mesh, 1)
    shardings = {"params": _named(mesh, param_pspecs(cfg, params_abs, mesh)),
                 "batch_fn": _batch_fn(cfg, mesh), "cache": cache_sh}

    @torch.no_grad()
    def step(params, cache, batch):
        with _on_mesh(mesh, act):
            logits, cache = m.prefill_chunk_step(params, cache, batch)
            return (place_outputs(logits, logits_sh),
                    place_outputs(cache, cache_sh))

    return step, shardings, params_abs


def build_draft_loop_step(draft_cfg, mesh, *, capacity: int, block: int,
                          n_blocks: int, max_blocks: int, k: int):
    """``draft(params, data, tables, batch) -> (tokens, data)``: ``k``
    fused paged decode sub-steps of the draft config (``launch.steps.
    draft_config``), chained by argmax; ``data.pos`` back at its entry
    value, the draft's K/V rows scratch that the verify overwrites."""
    del max_blocks
    m = _bound(draft_cfg, mesh)
    p_sh, pool_sh, tables_sh, params_abs = _paged_shardings(
        m.cfg, mesh, capacity=capacity, block=block, n_blocks=n_blocks)
    tokens_sh = _token_grid_sharding(mesh, capacity, k)
    shardings = {"params": p_sh, "batch_fn": _batch_fn(m.cfg, mesh),
                 "cache": pool_sh, "tables": tables_sh}

    @torch.no_grad()
    def draft(params, data, tables, batch):
        # launch.steps.draft_loop_step's sub-steps, its tokens stacked
        # rather than written into a buffer (a plain buffer would not take
        # a DTensor's writes)
        with _on_mesh(mesh):
            p0, toks, cols = data.pos, batch["tokens"], []
            for _ in range(k):
                logits, data = m.paged_decode_step(params, data, tables,
                                                   {"tokens": toks})
                cols.append(torch.argmax(logits[:, -1], dim=-1)
                            .to(torch.int32))
                toks = cols[-1][:, None]
            data = data._replace(pos=p0)
            return (place_outputs(torch.stack(cols, dim=1), tokens_sh),
                    place_outputs(data, pool_sh))

    return draft, shardings, params_abs


def build_verify_window_step(cfg, mesh, *, capacity: int, block: int,
                             n_blocks: int, max_blocks: int, width: int):
    """``verify(params, data, tables, batch) -> (tokens, data)``: gather,
    ``decode_window_step``, ``paged_commit_window``
    (``launch.steps.verify_window_step``); the exact argmax after each
    row."""
    del max_blocks
    m = _bound(cfg, mesh)
    p_sh, pool_sh, tables_sh, params_abs = _paged_shardings(
        m.cfg, mesh, capacity=capacity, block=block, n_blocks=n_blocks)
    tokens_sh = _token_grid_sharding(mesh, capacity, width)
    shardings = {"params": p_sh, "batch_fn": _batch_fn(m.cfg, mesh),
                 "cache": pool_sh, "tables": tables_sh}

    @torch.no_grad()
    def verify(params, data, tables, batch):
        with _on_mesh(mesh):
            tokens, data = eager.verify_window_step(
                m, params, data, tables, batch, block=block, width=width)
            return (place_outputs(tokens, tokens_sh),
                    place_outputs(data, pool_sh))

    return verify, shardings, params_abs


def build_rollback_step(cfg, mesh, *, capacity: int, block: int,
                        n_blocks: int, max_blocks: int, width: int):
    """``rollback(data, tables, accept) -> data``: each slot's committed
    window rewound to its accepted tokens
    (``launch.steps.rollback_step``)."""
    del max_blocks
    cfg = mesh_config(cfg)
    _, pool_sh, tables_sh, params_abs = _paged_shardings(
        cfg, mesh, capacity=capacity, block=block, n_blocks=n_blocks)
    shardings = {"cache": pool_sh, "tables": tables_sh}

    @torch.no_grad()
    def rollback(data, tables, accept):
        with _on_mesh(mesh):
            data = eager.rollback_step(data, tables, accept, block=block,
                                       width=width)
            return place_outputs(data, pool_sh)

    return rollback, shardings, params_abs


# ---------------------------------------------------------------- memos
# Equal (cfg, mesh, shape) share one built step, as the reference's memos
# share one jitted step: cfg is a frozen dataclass and a DeviceMesh
# hashes by its devices and names.

@functools.lru_cache(maxsize=64)
def cached_train_step(cfg, mesh, *, optc: AdamWConfig | None = None,
                      peak_lr: float = 3e-4, warmup: int = 100,
                      total_steps: int = 10_000):
    return build_train_step(cfg, mesh, optc=optc, peak_lr=peak_lr,
                            warmup=warmup, total_steps=total_steps)


@functools.lru_cache(maxsize=64)
def cached_prefill_step(cfg, mesh, *, batch_size: int, seq_len: int,
                        extra_slots: int = 0):
    return build_prefill_step(cfg, mesh, batch_size=batch_size,
                              seq_len=seq_len, extra_slots=extra_slots)


@functools.lru_cache(maxsize=64)
def cached_decode_step(cfg, mesh, *, batch_size: int, seq_len: int):
    return build_decode_step(cfg, mesh, batch_size=batch_size,
                             seq_len=seq_len)


@functools.lru_cache(maxsize=64)
def cached_chunked_prefill_step(cfg, mesh, *, seq_len: int, chunk: int):
    return build_chunked_prefill_step(cfg, mesh, seq_len=seq_len,
                                      chunk=chunk)


@functools.lru_cache(maxsize=64)
def cached_paged_decode_step(cfg, mesh, *, capacity: int, block: int,
                             n_blocks: int, max_blocks: int,
                             fused: bool = True):
    return build_paged_decode_step(cfg, mesh, capacity=capacity,
                                   block=block, n_blocks=n_blocks,
                                   max_blocks=max_blocks, fused=fused)


@functools.lru_cache(maxsize=64)
def cached_draft_loop_step(draft_cfg, mesh, *, capacity: int, block: int,
                           n_blocks: int, max_blocks: int, k: int):
    return build_draft_loop_step(draft_cfg, mesh, capacity=capacity,
                                 block=block, n_blocks=n_blocks,
                                 max_blocks=max_blocks, k=k)


@functools.lru_cache(maxsize=64)
def cached_verify_window_step(cfg, mesh, *, capacity: int, block: int,
                              n_blocks: int, max_blocks: int, width: int):
    return build_verify_window_step(cfg, mesh, capacity=capacity,
                                    block=block, n_blocks=n_blocks,
                                    max_blocks=max_blocks, width=width)


@functools.lru_cache(maxsize=64)
def cached_rollback_step(cfg, mesh, *, capacity: int, block: int,
                         n_blocks: int, max_blocks: int, width: int):
    return build_rollback_step(cfg, mesh, capacity=capacity, block=block,
                               n_blocks=n_blocks, max_blocks=max_blocks,
                               width=width)
