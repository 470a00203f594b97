"""Mixture-of-Experts FFN: group-limited GShard-style top-k routing (port of
``repro/models/moe.py``).

Tokens are routed within groups of ``g = min(router_group_size, tokens)``;
each expert takes at most ``C = moe_capacity(cfg)`` tokens of a group, and
a token over capacity is dropped (its combine weight is zero), as in
GShard/Switch. A load-balancing aux loss (Switch §2.2) comes beside the
output.

The reference's one-hot dispatch and combine einsums over ``(ng, G, E,
C)`` become an index gather into a fixed ``(E, ng·C, d)`` buffer and a
gather back: every dispatched row has exactly one source token, so the
gather is exact, and no shape depends on the routing, so a step stays one
CUDA graph with no host sync. Empty capacity rows hold zeros and, as in
the reference, all ``E·ng·C`` rows go through the experts.

Batch invariance on the card: the router's logits are fixed-order dot
products (:func:`~.layers.tree_sum` over ``d``) and its softmax sums with
``tree_sum`` too, so a token's probabilities do not depend on how many
rows share the step; a token's combine reads only its own ``top_k`` rows,
summed in slot order. Positions do depend on the group, so streams equal
a B=1 run only while no token is dropped (``C`` at least every group the
server forms).

The steps (:func:`router_probs`, :func:`route`, :func:`dispatch`,
:func:`gated_ffn` for the experts and the shared expert, :func:`combine`,
:func:`aux_loss`) are public so that tests can hold each against the
reference; :func:`moe_ffn` chains them.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sc_layers import sc_proj
from repro_torch.errors import ConfigError
from repro_torch.parallel.context import (gathered, split_leading_over_data,
                                          whole_rows)

from .layers import tree_sum

__all__ = ["moe_capacity", "init_moe_params", "pack_moe", "Routing",
           "router_probs", "route", "dispatch", "combine", "aux_loss",
           "gated_ffn", "moe_ffn"]


def moe_capacity(cfg: ModelConfig) -> int:
    """Per-expert dispatch rows of one router group: ``G·top_k/E ·
    capacity_factor``, at least 4 (the reference's rule)."""
    g, e = cfg.router_group_size, cfg.n_experts
    return max(int(g * cfg.top_k / e * cfg.capacity_factor), 4)


def init_moe_params(cfg: ModelConfig, normal, dtype: torch.dtype) -> dict:
    """The reference's shapes and scales: the router ``(d, E)`` in float32
    in every dtype, experts ``w1``/``w3`` ``(E, d, f)`` and ``w2`` ``(E, f,
    d)``, and with ``cfg.shared_expert_d_ff`` a dense ``shared`` gated FFN.
    ``normal(shape, scale, dtype)`` draws the weights
    (``transformer.normal_init``)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    params = {
        "router": normal((d, e), d ** -0.5, torch.float32),
        "w1": normal((e, d, f), d ** -0.5, dtype),
        "w3": normal((e, d, f), d ** -0.5, dtype),
        "w2": normal((e, f, d), f ** -0.5, dtype),
    }
    if cfg.shared_expert_d_ff:
        fs = cfg.shared_expert_d_ff
        params["shared"] = {"w1": normal((d, fs), d ** -0.5, dtype),
                            "w3": normal((d, fs), d ** -0.5, dtype),
                            "w2": normal((fs, d), fs ** -0.5, dtype)}
    return params


def pack_moe(p: dict, cfg: ModelConfig, pack) -> dict:
    """The MoE weights with their SC-GEMM packs beside them: each expert
    projection one batched pack ``(E, K, N)``, the shared expert's plain
    packs; the router stays a float product."""
    bits = cfg.sc_bits
    out = dict(p)
    out["packed"] = {name: pack(p[name], bits) for name in ("w1", "w3", "w2")}
    if "shared" in p:
        sh = dict(p["shared"])
        sh["packed"] = {name: pack(sh[name], bits)
                        for name in ("w1", "w3", "w2")}
        out["shared"] = sh
    return out


class Routing(NamedTuple):
    """Top-k routing of ``ng`` groups of ``G`` tokens, one entry a slot
    (``K = top_k`` rounds): ``probs (ng, G, E)`` the router's float32
    probabilities; ``expert (K, ng, G)`` the expert each round chose;
    ``position (K, ng, G)`` its row among the expert's ``C`` (0 where not
    kept); ``keep`` the reference's ``pos < C``; ``gate (K, ng, G)`` the
    normalised gate, 0 where the slot is not dispatched; ``dispatch``
    whether the slot takes a row (kept, a gate above 0, and an expert not
    chosen in an earlier round)."""
    probs: torch.Tensor
    expert: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    dispatch: torch.Tensor


def router_probs(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``softmax(x_f32 @ router)`` over experts for ``xg (ng, G, d)``: each
    logit a :func:`tree_sum` over ``d`` and the softmax's sum a
    ``tree_sum`` over ``E``, so a token's row is the same bits whatever
    else shares the call (a library product picks its kernel, and so its
    order of summation, by the row count)."""
    x = xg.to(torch.float32)
    logits = tree_sum(x[..., :, None] * router.to(torch.float32), -2)
    shifted = logits - logits.amax(-1, keepdim=True)
    ex = torch.exp(shifted)
    return ex / tree_sum(ex, -1)[..., None]


def route(probs: torch.Tensor, top_k: int, capacity: int) -> Routing:
    """The reference's slot-by-slot top-k (``moe.py:93-106``): each round
    every token takes the first maximum of its unchosen probabilities;
    its position is the expert's count so far plus the earlier tokens of
    the group that chose it this round — round-major, so all first choices
    come before any second; it is kept iff that position is below
    ``capacity``; every choice, kept or not, counts. Gates are normalised
    over the kept slots (denominator at least 1e-9)."""
    ng, g, e = probs.shape
    experts = torch.arange(e, device=probs.device)
    counts = torch.zeros((ng, 1, e), dtype=torch.int64, device=probs.device)
    chosen = torch.zeros((ng, g, e), dtype=torch.bool, device=probs.device)
    masked = probs
    rounds = []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                    # (ng, G)
        onehot = idx[..., None] == experts                    # (ng, G, E)
        oh = onehot.to(torch.int64)
        gate = torch.gather(masked, -1, idx[..., None])[..., 0]
        pos = torch.gather(counts + torch.cumsum(oh, dim=1) - oh, -1,
                           idx[..., None])[..., 0]
        # a re-chosen expert (only once every unchosen probability is
        # exactly 0) keeps its one row
        fresh = ~torch.gather(chosen, -1, idx[..., None])[..., 0]
        keep = pos < capacity
        rounds.append((idx, torch.where(keep, pos, 0), keep,
                       torch.where(keep, gate, 0.0), fresh))
        counts = counts + oh.sum(dim=1, keepdim=True)
        masked = masked * (1.0 - onehot.to(masked.dtype))
        chosen = chosen | onehot
    denom = rounds[0][3]
    for r in rounds[1:]:
        denom = denom + r[3]
    denom = torch.clamp_min(denom, 1e-9)
    expert, position, keep, raw, fresh = (torch.stack(t) for t in
                                          zip(*rounds))
    gate = raw / denom
    send = keep & fresh & (gate > 0)
    return Routing(probs, expert, position, keep,
                   torch.where(send, gate, 0.0), send)


def dispatch(xg: torch.Tensor, r: Routing,
             capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather each dispatched slot's token ``xg (ng, G, d)`` into row
    ``position`` of its expert's group block: ``xe (E, ng·C, d)``, zeros
    in the rows no token took. Also returns each slot's row in ``xe``
    flattened, ``rows (K, ng, G)``, or ``E·ng·C`` (past the last row) for
    a slot not dispatched."""
    ng, g, d = xg.shape
    k = r.expert.shape[0]
    e = r.probs.shape[-1]
    n_rows = e * ng * capacity
    group = torch.arange(ng, device=xg.device)[:, None]
    # on a mesh the slots' rows are gathered whole: every rank builds
    # the one source table (DTensor has no rule for its scatter)
    rows = gathered(torch.where(r.dispatch,
                                (r.expert * ng + group) * capacity
                                + r.position, n_rows))
    token = torch.arange(ng * g, device=xg.device).reshape(ng, g)
    # one source a row; every slot not dispatched lands on the spare
    # entry past the rows, which no gather reads
    src = torch.full((n_rows + 1,), ng * g, dtype=torch.int64,
                     device=xg.device)
    src.scatter_(0, rows.reshape(-1), token.expand(k, ng, g).reshape(-1))
    x = torch.cat([whole_rows(xg, 2).reshape(ng * g, d),
                   xg.new_zeros((1, d))])
    return x[src[:n_rows]].reshape(e, ng * capacity, d), rows


def gated_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x@w1) * (x@w3) @ w2`` through ``sc_proj`` (its packs from
    ``p["packed"]`` where there are any): a dense MLP or shared expert on
    ``x (..., d)``, or every expert at once on its dispatched rows ``x (E,
    R, d)`` with weights ``(E, ·, ·)`` — under SC-GEMM each projection one
    batched launch, each expert's weight at its own scale and each row at
    its own (an empty capacity row quantizes to zeros and gives zeros).
    ``act`` is SiLU, or GELU in its tanh form (``jax.nn.gelu``'s
    default)."""
    act = F.silu if cfg.act == "silu" else partial(F.gelu, approximate="tanh")
    packed = p.get("packed", {})
    h = act(sc_proj(x, p["w1"], cfg, packed.get("w1"))) \
        * sc_proj(x, p["w3"], cfg, packed.get("w3"))
    return sc_proj(h, p["w2"], cfg, packed.get("w2"))


def combine(ye: torch.Tensor, rows: torch.Tensor, gate: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's output ``(ng, G, d)``: its slots' expert rows
    ``ye (E, R, d)`` weighted by their gates (cast to ``dtype`` first, as
    the reference's ``combine.astype``), summed in slot order in float32
    and rounded once to ``dtype``. A slot not dispatched reads a zero row
    at gate 0."""
    e, rr, d = ye.shape
    flat = torch.cat([whole_rows(ye, 2).reshape(e * rr, d),
                      ye.new_zeros((1, d))])
    y = None
    for k in range(rows.shape[0]):
        w = gate[k].to(dtype).to(torch.float32)[..., None]
        term = w * flat[rows[k]].to(torch.float32)
        y = term if y is None else y + term
    return y.to(dtype)


def aux_loss(probs: torch.Tensor) -> torch.Tensor:
    """Switch's load-balance loss ``E · mean_groups Σ_e f_e · P_e``: ``f_e``
    the share of a group's tokens whose top choice is ``e``, ``P_e`` its
    mean probability."""
    e = probs.shape[-1]
    me = probs.mean(dim=1)
    top1 = F.one_hot(torch.argmax(probs, dim=-1), e).to(torch.float32)
    fe = top1.mean(dim=1)
    return e * torch.mean(torch.sum(fe * me, dim=-1))


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
            with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``x (B, S, d)`` → (output, aux loss, or None without ``with_aux``).

    The ``B·S`` tokens split into groups of ``min(router_group_size,
    B·S)``; a token count that is not a whole number of groups raises
    :class:`ConfigError` where the reference asserts, and nothing is
    padded. Then routing in float32, dispatch, the experts, combine, and
    with ``cfg.shared_expert_d_ff`` the shared expert on every token added
    after."""
    b, s, d = x.shape
    c = moe_capacity(cfg)
    t = b * s
    g = min(cfg.router_group_size, t)
    if t % g:
        raise ConfigError(f"{cfg.name}: {t} tokens are not a whole number "
                          f"of router groups of {g}")
    ng = t // g
    xg = split_leading_over_data(x.reshape(ng, g, d))
    r = route(split_leading_over_data(router_probs(xg, p["router"])),
              cfg.top_k, c)
    xe, rows = dispatch(xg, r, c)
    ye = gated_ffn(p, xe, cfg)
    out = combine(ye, rows, r.gate, x.dtype).reshape(b, s, d)
    if "shared" in p:
        out = out + gated_ffn(p["shared"], x, cfg)
    return out, aux_loss(r.probs) if with_aux else None
