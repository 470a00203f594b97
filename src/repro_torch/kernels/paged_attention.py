"""Paged decode-attention kernel wrapper (port of
``repro/kernels/paged_attention.py``).

Replaces the Pallas TPU kernel ``paged_attention_pallas``
(``repro/kernels/paged_attention.py:194``) with the CUDA kernels in
``csrc/paged_attention.cu``: one query token per slot, attended through the
slot's block table against the page pool, with no gathered dense view.
Bound by the bytes of K and V it reads; it walks only the pages up to each
slot's position.

Float path: an online softmax over 32-token tiles, because the TPU
kernel's whole-row buffer does not fit a block's shared memory at long
contexts. The TPU kernel matched the gathered-dense path bit for bit, an
artefact of XLA-CPU lowering; the online softmax here agrees with the
plain version to a stated tolerance instead (f32: rtol 1e-4 / atol 1e-5,
sums reassociated over 32-token tiles; bf16: rtol 1.6e-2 / atol 1e-2, one
bf16 rounding of the output).

SC path (``sc_bits``): the reference quantizes the *normalized*
probability row over all keys (``paged_attention.py:172-185``), so it is
two passes inside the block — SC scores, masks, row max and denominator,
then the probabilities, their quantization and the SC PV. The score row
sits in shared memory between the passes, or in a device workspace this
wrapper allocates when the row is too long for it. Scores and quantized
planes repeat the plain version's float32 operations one for one; the
tolerance is the float path's, plus one output quantization step
(``flash_attention.sc_tolerance``) should a probability land within an
ulp of a rounding boundary. Every head layout is served under SC.

``paged_attention.launches`` counts kernel launches, both paths.

Layout: ``q (C, KV, G, D)``; ``k_pages, v_pages (P, block, KV, D)`` with
page ``P - 1`` the trash page; ``tables (C, MB) int32`` (−1 = unallocated);
``q_positions (C,)``. Returns ``(C, KV, G, D)`` in ``q.dtype``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.errors import ConfigError

from . import build
from .sc_attention import check_sc_bits

__all__ = ["paged_attention", "paged_attention_torch", "SC_ROW_SMEM_BYTES"]

#: Largest SC score row (G rows of MB·block float32 scores) kept in shared
#: memory between the two passes; a longer one goes to a device workspace.
SC_ROW_SMEM_BYTES = 64 * 1024


def paged_attention_torch(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          q_positions: torch.Tensor, *,
                          window: int | None = None,
                          sc_bits: int | None = None) -> torch.Tensor:
    """Plain version: gather the pages dense (−1 → trash page) and run the
    exact-softmax decode attention of ``models.layers``."""
    from repro_torch.models.layers import _decode_attention_plain, _gather_pages
    c, kv, g, d = q.shape
    out = _decode_attention_plain(
        q.reshape(c, 1, kv * g, d), _gather_pages(k_pages, tables),
        _gather_pages(v_pages, tables), q_position=q_positions.to(torch.int64),
        window=window, sc_bits=sc_bits)
    return out.reshape(c, kv, g, d)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    q_positions: torch.Tensor, *, window: int | None = None,
                    logit_softcap: float | None = None,
                    sc_bits: int | None = None) -> torch.Tensor:
    """Fused paged decode attention: the CUDA kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    check_sc_bits(sc_bits)
    if logit_softcap is not None:
        raise ConfigError("the paged kernel takes no logit softcap; softcap "
                          "layers stay on the gathered path")
    if window is not None and window < 1:
        raise ConfigError(f"sliding window must be >= 1, got {window}")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ConfigError(f"paged kernel layout: q (C, KV, G, D), pages "
                          f"(P, block, KV, D); got {tuple(q.shape)}, "
                          f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    c, kv, g, d = q.shape
    n_pages, block, kv2, d2 = k_pages.shape
    if (kv2, d2) != (kv, d) or tables.dim() != 2 or tables.shape[0] != c:
        raise ConfigError(f"paged kernel: pages {tuple(k_pages.shape)} / "
                          f"tables {tuple(tables.shape)} do not match q "
                          f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return paged_attention_torch(q, k_pages, v_pages, tables,
                                     q_positions, window=window,
                                     sc_bits=sc_bits)
    tensors = (q, k_pages, v_pages, tables, q_positions)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ConfigError("paged kernel: every operand must be on the "
                          "query's CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ConfigError(f"paged kernel takes f32 or bf16 q and pages of "
                          f"the same dtype, got {q.dtype}, {k_pages.dtype}, "
                          f"{v_pages.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ConfigError("paged kernel: page pools must be contiguous")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    q_positions = q_positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.load("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    dims = (c, kv, g, d, block, tables.shape[1], n_pages)
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), q_positions.data_ptr(), out.data_ptr()]
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    if sc_bits is None:
        fn = getattr(lib, f"paged_attention_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(*args, *dims, d ** -0.5,
                0 if window is None else int(window), stream)
    else:
        # the score row of each (slot, KV head) between the two passes:
        # in shared memory when it fits, else in this workspace
        row = tables.shape[1] * block
        work = None
        if g * row * 4 > SC_ROW_SMEM_BYTES:
            work = torch.empty((c, kv, g, row), dtype=torch.float32,
                               device=q.device)
        fn = getattr(lib, f"paged_attention_sc_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rc = fn(*args, 0 if work is None else work.data_ptr(), *dims,
                d ** -0.5, 0 if window is None else int(window), sc_bits,
                stream)
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
