"""Fused causal flash-attention forward (port of
``repro/kernels/flash_attention.py``).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:91``) with the CUDA kernel in
``csrc/flash_attention.cu``, in float32 and bf16, float and SC variants
(``sc_bits``: the QKᵀ and PV contractions through the popcount multiplier,
``csrc/sc_attention.cuh``). ``flash_attention.launches`` counts launches.

Layout: ``q (B, H, Sq, D)``, ``k, v (B, KV, Skv, D)`` with head ``h``
reading KV head ``h // (H // KV)``; any strides with a contiguous last
axis (the model passes transposed views of its ``(B, S, H, D)`` tensors,
and the output takes ``q``'s layout). Returns ``(B, H, Sq, D)`` in
``q.dtype``.

Positions are absolute: query row ``i`` sits at ``q_offset + i`` and key
``j`` at ``j``. The kernel masks the ragged Sq/Skv edges itself, so nothing
is padded. What it computes differs from the TPU kernel on purpose in two
points:

* ``q_offset``: chunked prefill runs the kernel at its staging offset,
  where the reference took its jnp formulation (``repro/models/
  transformer.py:228-234``), so that chunked and one-shot prefill reduce
  every row identically (``models/layers.py``).
* Probabilities stay float32 into PV. The TPU kernel casts ``p`` to
  ``v.dtype`` (a bf16 rounding at bf16 inputs, ``flash_attention.py:74``);
  its gate's docstring and the jnp formulation, which this kernel
  replaces on the serving path, keep float32.

``group`` is the SC quantization group: probabilities are quantized per
row over each ``group`` keys from key 0 — the TPU kernel's ``bk``, the jnp
formulation's ``kv_block`` — after the row's maximum over the whole group
is known. Trailing masked keys are exact zeros, so a row's result depends
only on its position, the keys at or before it and ``group``: not on the
other rows of its tile, on Skv, or on the chunk it arrived in.

Tolerance against :func:`flash_attention_torch`: float32 rtol 1e-4 / atol
1e-5 (sums reassociated), bf16 rtol 1.6e-2 / atol 1e-2 (one bf16 rounding
of the output each). SC: the scores and quantized planes repeat the plain
version's float32 operations one for one, so only the float sums over keys
differ; the same tolerances hold unless a probability lands within an ulp
of a rounding boundary and moves one magnitude step, which moves the
output by at most ``max|v| / (2**bits - 1)`` (``sc_tolerance``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError

from . import build
from .sc_attention import check_sc_bits

__all__ = ["flash_attention", "flash_attention_torch", "sc_tolerance",
           "BLOCK_Q", "BLOCK_K", "MAX_D", "MAX_GROUP"]

#: Query rows per block and keys per shared-memory K/V tile (compile-time
#: constants of ``csrc/flash_attention.cu``).
BLOCK_Q, BLOCK_K = 16, 32
#: Largest head dim and SC quantization group the kernel's shared memory
#: holds (scores of a whole group stay on chip).
MAX_D, MAX_GROUP = 256, 2048


def sc_tolerance(v: torch.Tensor, bits: int) -> float:
    """One output quantization step: the most a single probability
    magnitude moving one step can change an output element."""
    return float(v.abs().max()) / (stream_length(bits) - 1)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          group: int = 64,
                          sc_bits: int | None = None) -> torch.Tensor:
    """Plain version: the model layers' flash formulation with positions
    ``q_offset + i`` / ``j`` and ``kv_block = group``."""
    from repro_torch.models.layers import _flash_plain
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    dev = q.device
    qpos = (q_offset + torch.arange(sq, dtype=torch.int32,
                                    device=dev)).expand(b, sq)
    kpos = torch.arange(skv, dtype=torch.int32, device=dev).expand(b, skv)
    out = _flash_plain(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), q_positions=qpos,
                       kv_positions=kpos, causal=causal, window=None,
                       logit_softcap=None, q_block=min(BLOCK_Q, max(sq, 1)),
                       kv_block=group, skip_masked_blocks=False,
                       bf16_probs=False, sc_bits=sc_bits)
    return out.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, group: int = 64,
                    sc_bits: int | None = None) -> torch.Tensor:
    """Fused flash forward: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    check_sc_bits(sc_bits)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ConfigError(f"flash kernel layout: q (B, H, Sq, D), k/v "
                          f"(B, KV, Skv, D); got {tuple(q.shape)}, "
                          f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    b2, kv, skv, d2 = k.shape
    if (b2, d2) != (b, d) or kv < 1 or h % kv:
        raise ConfigError(f"flash kernel: k/v {tuple(k.shape)} do not match "
                          f"q {tuple(q.shape)} (H must be a multiple of KV)")
    if group < 1 or q_offset < 0:
        raise ConfigError(f"flash kernel needs group >= 1 and q_offset >= 0, "
                          f"got {group}, {q_offset}")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal,
                                     q_offset=q_offset, group=group,
                                     sc_bits=sc_bits)
    if not all(t.is_cuda and t.device == q.device for t in (k, v)):
        raise ConfigError("flash kernel: every operand must be on the "
                          "query's CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ConfigError(f"flash kernel takes f32 or bf16 q, k, v of one "
                          f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_D or group > MAX_GROUP:
        raise ConfigError(f"flash kernel holds D <= {MAX_D} and a group of "
                          f"<= {MAX_GROUP} keys, got D={d}, group={group}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel() == 0 or skv == 0:
        return out.zero_()
    lib = build.load("flash_attention")
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 \
        else lib.flash_attention_bf16
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, sq, skv, d, h // kv, *strides, int(q_offset),
            int(causal), int(group), sc_bits or 0, d ** -0.5, stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
