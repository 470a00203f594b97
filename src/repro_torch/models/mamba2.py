"""Mamba-2 (SSD, state-space duality) blocks — port of
``repro/models/mamba2.py`` (arXiv:2405.21060).

The chunked SSD algorithm: the sequence is split into chunks of length Q;
the quadratic intra-chunk term and the inter-chunk state recurrence
(carrying the ``(H, P, N)`` state from chunk to chunk) together compute the
selective SSM exactly. Decode is the O(1) one-token recurrence against the
carried state.

Shapes: d_inner = expand·d_model, heads H = d_inner/headdim, head dim P,
state dim N = ssm_state. B/C are single-group (broadcast over heads).

**Invariance.** The serving engine's streams must equal the sequential
baseline bit for bit on the card, so the scan runs chunk by chunk with the
same operations at the same shapes whether a prompt arrives in one call
of ``nc`` chunks or as ``nc`` calls (a batched contraction over ``nc``
chunks could change algorithm with ``nc``), and every float reduction
whose batch changes between the engine and the baseline — the decode
readout and the decode conv window — is a ``layers.tree_sum``. Prefill is
B=1 in both, so its per-chunk contractions are plain matmuls.

With ``cfg.use_sc_gemm`` ``in_proj`` and ``out_proj`` run through
``sc_proj`` — one SC-GEMM launch each on the card, given the weights packed
by :func:`pack_mamba_layers`. The decode and chunk steps write the layer's
conv window and state into the cache leaves they are given, in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sc_layers import sc_proj
from repro_torch.errors import ConfigError
from repro_torch.parallel.context import reshape, whole_groups_grad

from .layers import rms_norm, tree_sum

__all__ = ["MambaCache", "init_mamba_params", "mamba_block", "ssd_scan",
           "init_mamba_cache", "mamba_chunk_step", "mamba_decode_step",
           "pack_mamba_layers", "F32_LEAVES"]

#: Mixer leaves the reference keeps in float32 whatever the model dtype.
F32_LEAVES = ("dt_bias", "A_log", "D")


class MambaCache(NamedTuple):
    """One layer's (or, stacked, every layer's) recurrent state:
    ``conv (…, B, conv_width - 1, conv_channels)`` in the model dtype — the
    raw conv inputs before the current position — and ``state (…, B, H,
    P, N)`` in float32."""
    conv: torch.Tensor
    state: torch.Tensor


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    heads = cfg.ssm_heads
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n            # conv over [x, B, C]
    return d_in, heads, n, conv_ch


def init_mamba_params(cfg: ModelConfig, normal, dtype,
                      device: torch.device) -> dict:
    """One mixer's parameters with the reference's shapes and scales
    (``mamba2.py:41-55``); ``normal(shape, scale)`` draws the weights."""
    d = cfg.d_model
    d_in, heads, n, conv_ch = _dims(cfg)
    proj_out = 2 * d_in + 2 * n + heads      # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, proj_out), d ** -0.5),
        "conv_w": normal((cfg.ssm_conv, conv_ch), 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((heads,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, **f32)),
        "D": torch.ones((heads,), **f32),
        "gate_norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def pack_mamba_layers(layers: list, cfg: ModelConfig, pack) -> list:
    """Each layer's mixer with ``in_proj`` and ``out_proj`` packed by
    ``pack(w, bits)`` beside the float weights (``mixer["packed"]``)."""
    out = []
    for layer in layers:
        mixer = dict(layer["mixer"])
        mixer["packed"] = {name: pack(mixer[name], cfg.sc_bits)
                           for name in ("in_proj", "out_proj")}
        out.append({**layer, "mixer": mixer})
    return out


def _proj(p: dict, name: str, x: torch.Tensor, cfg: ModelConfig):
    return sc_proj(x, p[name], cfg, p.get("packed", {}).get(name))


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, heads, n, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, n, n, heads], dim=-1)


def _causal_conv(ext: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over ``ext (B, width-1 + T, C)``: the ``T``
    rows of a chunk after the ``width - 1`` raw rows before it (zeros at a
    sequence's start). The lag terms accumulate in the reference's order
    (``x·w[-1]``, then lag 1, 2, …), so a one-shot prompt and its chunks
    give the same bits."""
    width = w.shape[0]
    t = ext.shape[1] - (width - 1)
    out = ext[:, width - 1:] * w[-1]
    for i in range(1, width):
        out = out + ext[:, width - 1 - i:width - 1 - i + t] * w[-1 - i]
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise segment sums: ``out[..., i, j] =
    Σ_{j<k<=i} a_k``, ``-inf`` above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def _ssd_chunk(x, dt, a, bmat, cmat, state):
    """One chunk of the SSD scan: ``x (B, Q, H, P)``, ``dt (B, Q, H)``,
    ``a (H,)``, ``bmat``/``cmat (B, Q, N)``, ``state (B, H, P, N)`` entering
    the chunk → (``y (B, Q, H, P)``, the state leaving it). The reference's
    einsums (``mamba2.py:102-125``) as explicit matmuls."""
    dac = (-(dt * a)).transpose(1, 2)                  # (B, H, Q) negative
    a_cum = torch.cumsum(dac, dim=-1)
    lmat = torch.exp(_segsum(dac))                     # (B, H, Q, Q)
    xdt = (x * dt[..., None]).permute(0, 2, 1, 3)      # (B, H, Q, P)
    # intra-chunk (diagonal) term: Σ_s (C_l·B_s) L[h, l, s] xdt[s, h]
    cb = cmat @ bmat.transpose(1, 2)                   # (B, Q, Q)
    y = (cb[:, None] * lmat) @ xdt                     # (B, H, Q, P)
    # the state entering the chunk, decayed to each row, read through C
    y = y + (cmat[:, None] @ state.transpose(2, 3)) \
        * torch.exp(a_cum)[..., None]
    # input -> state contribution of the chunk, and the carried state
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, H, Q)
    states = (xdt * decay_states[..., None]).transpose(2, 3) @ bmat[:, None]
    new = state * torch.exp(a_cum[..., -1])[..., None, None] + states
    return y.permute(0, 2, 1, 3), new


def ssd_scan(x, dt, a, bmat, cmat, chunk: int, initial_state=None):
    """Chunked SSD. ``x: (B, L, H, P)``; ``dt: (B, L, H)`` (post-softplus);
    ``a: (H,)`` (positive); ``bmat, cmat: (B, L, N)``. Returns (``y: (B, L,
    H, P)``, final state ``(B, H, P, N)``). ``L`` must be a multiple of
    ``chunk`` (:class:`ConfigError` otherwise, where the reference
    asserts)."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    if l % chunk:
        raise ConfigError(f"the SSD scan takes whole chunks: a {l}-row "
                          f"sequence is not a multiple of ssm_chunk={chunk}")
    state = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for c in range(0, l, chunk):
        y, state = _ssd_chunk(x[:, c:c + chunk], dt[:, c:c + chunk], a,
                              bmat[:, c:c + chunk], cmat[:, c:c + chunk],
                              state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _mixer(params: dict, x: torch.Tensor, cfg: ModelConfig, conv_carry,
           state, n_valid=None):
    """in_proj → causal conv (from ``conv_carry``) → SSD (from ``state``)
    → gated norm → out_proj over ``x (B, T, d)``. Returns the output, the
    raw conv rows ``ext (B, width-1 + T, C)`` and the final state.
    ``n_valid`` zeroes ``dt`` past the valid rows."""
    d_in, heads, n, _ = _dims(cfg)
    z, xin, bmat, cmat, dt = _split(_proj(params, "in_proj", x, cfg), cfg)
    xbc_raw = torch.cat([xin, bmat, cmat], dim=-1)
    ext = torch.cat([conv_carry.to(xbc_raw.dtype), xbc_raw], dim=1)
    xbc = _causal_conv(ext, params["conv_w"], params["conv_b"])
    xin, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    b, t, _ = x.shape
    xh = reshape(xin, b, t, heads, cfg.ssm_headdim).to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    if n_valid is not None:
        rows = torch.arange(t, device=x.device)[None, :, None]
        dt = torch.where(rows < n_valid, dt, torch.zeros_like(dt))
    y, final = ssd_scan(xh, dt, torch.exp(params["A_log"]),
                        bmat.to(torch.float32), cmat.to(torch.float32),
                        cfg.ssm_chunk, initial_state=state)
    y = y + xh * params["D"][None, None, :, None]
    y = whole_groups_grad(reshape(y, b, t, d_in), 2, heads).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], eps=cfg.norm_eps)
    return _proj(params, "out_proj", y, cfg), ext, final


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                return_cache: bool = False):
    """The full Mamba-2 mixer over whole sequences ``x: (B, L, d)`` from a
    zero state; ``return_cache=True`` also returns the :class:`MambaCache`
    after the last position (prefill → decode)."""
    d_in, heads, n, conv_ch = _dims(cfg)
    b = x.shape[0]
    carry = x.new_zeros((b, cfg.ssm_conv - 1, conv_ch))
    out, ext, final = _mixer(params, x, cfg, carry, None)
    if not return_cache:
        return out
    conv = ext[:, ext.shape[1] - (cfg.ssm_conv - 1):].to(x.dtype)
    return out, MambaCache(conv=conv, state=final.to(torch.float32))


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device: torch.device, lead: tuple = ()) -> MambaCache:
    """Zero conv windows and states for ``batch`` sequences, each leaf with
    the leading axes ``lead`` (the layer stack)."""
    d_in, heads, n, conv_ch = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=dtype, device=device),
        state=torch.zeros((*lead, batch, heads, cfg.ssm_headdim, n),
                          dtype=torch.float32, device=device))


def mamba_chunk_step(params: dict, x: torch.Tensor, cache: MambaCache,
                     cfg: ModelConfig, n_valid: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill continuation: run ``x: (B, T, d)`` against
    ``cache`` (one layer's leaves, updated in place) and return the output.

    The rows equal those of a one-shot :func:`mamba_block` as long as every
    chunk boundary lands on a multiple of ``cfg.ssm_chunk``. ``n_valid``
    (an int32 tensor of one element, ``1 <= n_valid <= T``) marks the real
    rows: pad rows get ``dt = 0`` (no state contribution, decay 1) and the
    conv window ends at the last valid row, as a shorter prompt's would.
    Nothing is read on the host, so a CUDA graph captures the step."""
    out, ext, final = _mixer(params, x, cfg, cache.conv, cache.state,
                             n_valid=n_valid)
    # raw rows ending at the last valid position: ext[:, n_valid :
    # n_valid + width-1], zeros of the initial carry on a short stream
    rows = (n_valid.to(torch.long).reshape(1)
            + torch.arange(cfg.ssm_conv - 1, device=x.device))
    cache.conv.copy_(ext.index_select(1, rows).to(cache.conv.dtype))
    cache.state.copy_(final)
    return out


def mamba_decode_step(params: dict, x: torch.Tensor, cache: MambaCache,
                      cfg: ModelConfig) -> torch.Tensor:
    """The one-token recurrence: ``x: (B, 1, d)`` → ``y (B, 1, d)``; the
    conv window and state in ``cache`` (one layer's leaves) advance in
    place. Both reductions (the conv window, the state read through C)
    are ``tree_sum``s, so a row's bits do not depend on the batch."""
    d_in, heads, n, _ = _dims(cfg)
    z, xin, bmat, cmat, dt = _split(_proj(params, "in_proj", x, cfg), cfg)
    xbc_new = torch.cat([xin, bmat, cmat], dim=-1)              # (B, 1, C)
    window = torch.cat([cache.conv.to(xbc_new.dtype), xbc_new], dim=1)
    conv = tree_sum((window * params["conv_w"][None]).to(torch.float32),
                    1)[:, None].to(window.dtype)
    conv_out = F.silu(conv + params["conv_b"])
    xin, bmat, cmat = torch.split(conv_out, [d_in, n, n], dim=-1)
    b = x.shape[0]
    xh = reshape(xin, b, heads, cfg.ssm_headdim).to(torch.float32)
    dt = F.softplus(dt[:, 0].to(torch.float32) + params["dt_bias"])  # (B, H)
    da = torch.exp(-dt * torch.exp(params["A_log"]))
    bv = bmat[:, 0].to(torch.float32)                           # (B, N)
    cv = cmat[:, 0].to(torch.float32)
    # h' = da·h + dt·x ⊗ B ; y = h'·C + D·x
    upd = (dt[..., None] * xh)[..., None] * bv[:, None, None, :]
    state = cache.state * da[..., None, None] + upd
    y = tree_sum(state * cv[:, None, None, :], -1)              # (B, H, P)
    y = y + xh * params["D"][None, :, None]
    y = reshape(y, b, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["gate_norm"], eps=cfg.norm_eps)
    cache.conv.copy_(window[:, 1:].to(cache.conv.dtype))
    cache.state.copy_(state)
    return _proj(params, "out_proj", y, cfg)
