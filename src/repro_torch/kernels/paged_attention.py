"""Paged decode-attention kernel wrapper (port of
``repro/kernels/paged_attention.py``).

Replaces the Pallas TPU kernel ``paged_attention_pallas``
(``repro/kernels/paged_attention.py:194``) with the CUDA kernels in
``csrc/paged_attention.cu``: one query token per slot, attended through the
slot's block table against the page pool, with no gathered dense view.

Design (the source's header has the details): one thread-block cluster of
:data:`RANKS` CTAs per (slot, KV head), one launch per call. Key tile ``i``
(keys ``32i … 32i + 31`` by absolute position, whatever the page size)
belongs to rank ``i mod RANKS``; each rank stages its tiles' K and V rows
through two shared-memory stages, the next tile's 16-byte chunks loaded
into registers while the current one is computed, and the ranks meet
through distributed shared memory. What bounds it: the bytes of K and V at
long contexts, the latency of a tile's load and of the cluster's exchanges
at short ones. The tiles, their owners and every order of summation depend
only on the key index, the slot's position and the window, so a slot's
output is bit-identical whatever the page size, the table layout or the
other slots of the batch (a dense cache viewed as one page per slot
included).

Float path: each rank runs an online softmax over its tiles and the ranks'
``(m, l, o)`` partials are merged in rank order. It agrees with the plain
version's one exact softmax to a stated tolerance (f32: rtol 1e-4 / atol
1e-5, sums reassociated over tiles and ranks; bf16: rtol 1.6e-2 / atol
1e-2, one bf16 rounding of the output).

SC path (``sc_bits``): the reference quantizes the *normalized*
probability row over all keys (``paged_attention.py:172-185``), so the
ranks exchange the row max, the partial denominators (added in rank
order) and the probability max before each quantizes its own
probabilities and sums its own SC PV terms; the partial sums are added in
rank order. A rank's scores sit in shared memory between the passes, or in
a device workspace this wrapper allocates when the rank's share
(:func:`plan`) is longer than :data:`SC_ROW_SMEM_BYTES`. Scores and
quantized planes repeat the plain version's float32 operations one for
one; the tolerance is the float path's, plus one output quantization step
(``flash_attention.sc_tolerance``) should a probability land within an ulp
of a rounding boundary. Every head layout is served under SC.

``paged_attention.launches`` counts kernel launches, both paths: one a
call; ``paged_attention.sc.launches`` counts the SC path's alone.
:func:`plan` is the launch plan as a pure function of the shapes. The
wrapper is the custom operator ``torch.ops.repro_torch.paged_attention``
(the plain version on the CPU, the launch on the card, a fake
implementation for ``FakeTensor``s, a ``DTensor`` sharding rule in
``parallel/kernel_sharding.py``), whose implementation plain tensors
call directly (``build.direct``).

Layout: ``q (C, KV, G, D)``; ``k_pages, v_pages (P, block, KV, D)`` with
page ``P - 1`` the trash page; ``tables (C, MB) int32`` (−1 = unallocated);
``q_positions (C,)``. Returns ``(C, KV, G, D)`` in ``q.dtype``.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from repro_torch.errors import ConfigError

from . import build
from .sc_attention import check_sc_bits

__all__ = ["paged_attention", "paged_attention_torch", "plan", "Plan",
           "rank_tiles", "RANKS", "TILE", "SC_ROW_SMEM_BYTES"]

#: CTAs in the cluster that splits one (slot, KV head)'s keys, keys in a
#: tile, threads in a CTA (compile-time constants of the kernel).
RANKS, TILE, THREADS = 8, 32, 128
#: Largest share of SC scores (G rows of one rank's keys, float32) a CTA
#: keeps in shared memory between its two passes; a longer share goes to a
#: device workspace.
SC_ROW_SMEM_BYTES = 64 * 1024


class Plan(NamedTuple):
    """One call's launch: ``grid`` is (RANKS, C, KV) in clusters of
    ``ranks`` CTAs along x; ``share`` is the SC score slots a rank keeps per
    query row (0 on the float path); ``workspace`` the float32 shape of the
    SC score workspace, or None when the share fits shared memory."""
    ranks: int
    grid: tuple[int, int, int]
    share: int
    smem_bytes: int
    workspace: tuple[int, ...] | None


def rank_tiles(rank: int, pos: int, row_keys: int,
               window: int | None = None) -> range:
    """The tiles ``rank`` walks for a slot at ``pos`` whose table row holds
    ``row_keys`` keys: tiles ``first // TILE … last // TILE`` of the keys it
    attends, those congruent to ``rank`` mod RANKS, ascending — the
    kernel's ``key_span`` and ``own_tiles``."""
    last = min(pos, row_keys - 1)
    first = max(0, pos - window + 1) if window else 0
    if pos < 0 or first > last:
        return range(0)
    lo = first // TILE
    return range(lo + (rank - lo) % RANKS, last // TILE + 1, RANKS)


def plan(c: int, kv: int, g: int, d: int, block: int, max_blocks: int,
         sc_bits: int | None = None, *, esz: int = 2) -> Plan:
    """The launch for ``C`` slots of ``KV`` heads of ``G`` query rows of
    width ``D``, tables of ``max_blocks`` pages of ``block`` keys and
    ``esz``-byte elements. Shared memory: two stages of a tile's rows (K
    and V on the float path, K or V on the SC path; rows padded to 16 bytes
    plus 16), the query rows and outputs, and on the SC path a quantized
    tile, the exchange slots and, when it fits :data:`SC_ROW_SMEM_BYTES`,
    the rank's share of scores."""
    stride = -(-d * esz // 16) * 16 + 16
    stages = 2 * (2 if sc_bits is None else 1) * TILE * stride
    grid = (RANKS, c, kv)
    if sc_bits is None:
        smem = stages + 4 * (2 * g * d + THREADS // 32 * TILE + 2 * g)
        return Plan(RANKS, grid, 0, smem, None)
    row_keys = max_blocks * block
    share = TILE * len(rank_tiles(0, row_keys - 1, row_keys))
    in_smem = g * share * 4 <= SC_ROW_SMEM_BYTES
    smem = stages + 4 * (2 * g * d + TILE * (d + 1) + TILE + 5 * g
                         + (g * share if in_smem else 0))
    return Plan(RANKS, grid, share, smem,
                None if in_smem else (c, kv, RANKS, g, share))


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: Argument types of the C entries ``paged_attention_{f32,bf16}`` (float
#: path) and ``paged_attention_sc_{f32,bf16}``: pointers (the stream last),
#: the shapes and the plan as ints, the attention scale as a float.
ARGTYPES = {"float": [_PTR] * 6 + [_I32] * 8 + [_F32, _I32, _PTR],
            "sc": [_PTR] * 7 + [_I32] * 9 + [_F32, _I32, _I32, _PTR]}
_ENTRIES: dict = {}


def _entries() -> dict:
    """The four C entry points, their argument types set once."""
    if not _ENTRIES:
        lib = build.load("paged_attention")
        for suffix in ("f32", "bf16"):
            for path, prefix in (("float", ""), ("sc", "sc_")):
                fn = getattr(lib, f"paged_attention_{prefix}{suffix}")
                fn.argtypes = ARGTYPES[path]
                fn.restype = _I32
                _ENTRIES[prefix + suffix] = fn
    return _ENTRIES


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
    card, the plain version for tensors on the CPU, both
    ``torch.ops.repro_torch.paged_attention``'s implementation (called
    directly for plain tensors, ``build.direct``)."""
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
    c, kv, _, d = q.shape
    if tuple(k_pages.shape[2:]) != (kv, d) or tables.dim() != 2 or tables.shape[0] != c:
        raise ConfigError(f"paged kernel: pages {tuple(k_pages.shape)} / "
                          f"tables {tuple(tables.shape)} do not match q "
                          f"{tuple(q.shape)}")
    args = (q, k_pages, v_pages, tables, q_positions,
            0 if window is None else int(window), sc_bits or 0)
    if build.direct(*args[:5]):
        return _paged_attention_impl(*args)
    return torch.ops.repro_torch.paged_attention(*args)


paged_attention.launches = 0
paged_attention.sc = SimpleNamespace(launches=0)


def _paged_attention_impl(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          q_positions: torch.Tensor, window: int,
                          sc_bits: int) -> torch.Tensor:
    """:func:`paged_attention` with ``window`` and ``sc_bits`` 0 for none:
    the plain version on the CPU, else one launch."""
    window, sc_bits = window or None, sc_bits or None
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
    c, kv, g, d = q.shape
    n_pages, block = k_pages.shape[:2]
    q = q.contiguous()
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        tables = tables.to(torch.int32).contiguous()
    if q_positions.dtype != torch.int32 or not q_positions.is_contiguous():
        q_positions = q_positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    esz = q.element_size()
    p = plan(c, kv, g, d, block, tables.shape[1], sc_bits, esz=esz)
    vec = int(d * esz % 16 == 0 and k_pages.data_ptr() % 16 == 0
              and v_pages.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), q_positions.data_ptr(), out.data_ptr())
    dims = (c, kv, g, d, block, tables.shape[1], n_pages, vec)
    win = 0 if window is None else int(window)
    if sc_bits is None:
        rc = _entries()[suffix](*args, *dims, d ** -0.5, win, stream)
    else:
        work = None if p.workspace is None else torch.empty(
            p.workspace, dtype=torch.float32, device=q.device)
        rc = _entries()[f"sc_{suffix}"](
            *args, 0 if work is None else work.data_ptr(), *dims, p.share,
            d ** -0.5, win, sc_bits, stream)
    build.check(rc, "paged_attention")
    paged_attention.launches += 1
    if sc_bits is not None:
        paged_attention.sc.launches += 1
    return out


_paged_attention_op = torch.library.custom_op(
    "repro_torch::paged_attention", _paged_attention_impl, mutates_args=())


@_paged_attention_op.register_fake
def _paged_attention_fake(q, k_pages, v_pages, tables, q_positions, window,
                          sc_bits):
    return q.new_empty(q.shape)
