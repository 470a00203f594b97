"""Fused causal flash-attention forward (port of
``repro/kernels/flash_attention.py``).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:91``) with the CUDA kernels in
``csrc/flash_attention.cu``, one launch a call: bf16 float attention on
tensor cores (``mma.sync`` m16n8k16, ldmatrix fragments, K/V tiles of 64
keys by double-buffered 16-byte ``cp.async``), float32 float attention on
CUDA cores (no TF32), and SC attention (``sc_bits``: the QKᵀ and PV
contractions through the popcount multiplier, ``csrc/sc_attention.cuh``)
on packed 8-bit magnitudes in byte SIMD. ``flash_attention.launches``
counts launches, ``flash_attention.sc.launches`` the SC path's alone.
:func:`plan` is the launch plan as a pure function of the shapes; the
source's header has the design.

Layout: ``q (B, H, Sq, D)``, ``k, v (B, KV, Skv, D)`` with head ``h``
reading KV head ``h // (H // KV)``; any strides with a contiguous last
axis (the model passes transposed views of its ``(B, S, H, D)`` tensors,
and the output takes ``q``'s layout). Returns ``(B, H, Sq, D)`` in
``q.dtype``. A block serves the query heads of one KV head (all of them
where shared memory allows), so each K/V tile is read once for them.

Positions are absolute: query row ``i`` sits at ``q_offset + i`` and key
``j`` at ``j``. ``q_offset`` is a host int, or a 0-dim int32 tensor on the
card that the kernel reads at block entry: a CUDA graph captured over a
prefill chunk then replays at the staging offset of the moment, and the
launch (grid, heads a block) is the same for every offset (:func:`plan`).
Query positions are cut into m-tiles of :data:`BLOCK_Q` aligned to
position 0 (:func:`row_tile`), so a row's tile and slot depend on its
position alone, whichever way the offset came. The kernel masks the ragged Sq/Skv edges itself,
so nothing is padded, and zero-fills key rows past the last one a block's
rows can see (a staging cache past the chunk may hold NaN). What it
computes differs from the TPU kernel on purpose in two points:

* ``q_offset``: chunked prefill runs the kernel at its staging offset,
  where the reference took its jnp formulation (``repro/models/
  transformer.py:228-234``), so that chunked and one-shot prefill reduce
  every row identically (``models/layers.py``).
* Probabilities are not rounded to ``v.dtype`` before PV. The TPU kernel
  casts ``p`` to ``v.dtype`` (a bf16 rounding at bf16 inputs,
  ``flash_attention.py:74``); its gate's docstring and the jnp
  formulation, which this kernel replaces on the serving path, keep
  float32. Here float32 and SC inputs keep float32 probabilities; bf16
  float inputs feed the tensor cores ``p`` as a bf16 high part plus a
  bf16 low part, 16 significant bits (relative error at most 2**-17).

``group`` is the SC quantization group: probabilities are quantized per
row over each ``group`` keys from key 0 — the TPU kernel's ``bk``, the jnp
formulation's ``kv_block`` — after the row's maximum over the whole group
is known. The float paths update the running maximum per key tile instead
(their result depends on ``group`` only through rounding). Trailing masked
keys are exact zeros, so a row's result depends only on its position, the
keys at or before it and ``group``: not on the other rows of its block, on
Skv, or on the chunk it arrived in.

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
from types import SimpleNamespace
from typing import NamedTuple

import torch

from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError

from . import build
from .sc_attention import check_sc_bits

__all__ = ["flash_attention", "flash_attention_torch", "sc_tolerance",
           "plan", "Plan", "row_tile", "m_tile_count", "BLOCK_Q", "TILE_K", "MAX_D",
           "MAX_GROUP", "SMEM_MAX"]

#: Query positions per m-tile (a tile's rows are positions 16t .. 16t+15).
BLOCK_Q = 16
#: Keys per shared-memory K/V tile of each path (compile-time constants of
#: ``csrc/flash_attention.cu``).
TILE_K = {"mma": 64, "f32": 32, "sc": 32}
#: Warps of a bf16 block at most; threads of an f32 block and of an SC
#: block; PV outputs (of 4 elements) an SC thread holds.
MMA_MAX_WARPS, THREADS, SC_THREADS, SC_ITEMS = 8, 256, 512, 4
#: K/V tiles in the bf16 path's copy ring (two in flight while one is
#: computed).
MMA_STAGES = 3
#: Largest head dim (every registered config whose attention the kernel
#: serves has D <= 128; SC counts stay int16-exact: 128 * 254 < 2**15) and
#: SC quantization group.
MAX_D, MAX_GROUP = 128, 2048
#: Dynamic shared memory a Hopper block may use.
SMEM_MAX = 227 * 1024


def _a16(n: int) -> int:
    return -(-n // 16) * 16


class Plan(NamedTuple):
    """One call's launch. ``path`` is "mma" (bf16 float), "f32" (float32
    float) or "sc"; a block serves ``heads`` query heads of one KV head over
    ``m_tiles`` m-tiles with ``threads`` threads; ``grid`` is (m-tile
    blocks, KV x head groups, B)."""
    path: str
    heads: int
    m_tiles: int
    threads: int
    grid: tuple[int, int, int]
    smem_bytes: int


def smem_bytes(path: str, heads: int, m_tiles: int, d: int, group: int,
               esz: int) -> int:
    """Shared memory of one block (``flash_attention_smem_bytes`` in the
    source). mma: the query rows and three stages of K and V rows, each row
    padded to 64 or 128 elements plus 16 bytes. f32: query rows, output
    accumulators, a tile's probabilities, two stages of K and V rows (plus
    4 floats each) and three floats a row. SC: packed query words, six
    floats a row, the group's int16 counts and key scales, two stages of
    raw rows, the quantized tile and a tile's two probability words."""
    rows = BLOCK_Q * heads
    if path == "mma":
        row = ((64 if d <= 64 else 128) + 8) * 2
        return row * (rows * m_tiles + 2 * MMA_STAGES * TILE_K["mma"])
    if path == "f32":
        tk = TILE_K["f32"]
        return 4 * (2 * rows * d + rows * tk + 4 * tk * (d + 4) + 3 * rows)
    tk, dw = TILE_K["sc"], -(-d // 4)
    return (_a16(rows * dw * 12) + _a16(rows * 24) + _a16(rows * group * 2)
            + _a16(group * 4) + _a16(2 * tk * d * esz) + _a16(tk * dw * 24)
            + rows * tk * 8)


def row_tile(pos: int) -> tuple[int, int]:
    """The m-tile and slot of the query row at absolute position ``pos``:
    the same whatever ``q_offset``, Sq or the block's other rows."""
    return divmod(pos, BLOCK_Q)


def m_tile_count(sq: int, q_offset: int | torch.Tensor = 0) -> int:
    """The m-tiles the launch covers: those of rows ``q_offset ..
    q_offset + Sq - 1`` for a host offset; for an offset held on the card,
    whose value the host never reads, the most any offset needs,
    ``ceil((Sq - 1) / 16) + 1`` (the kernel's blocks past the offset's
    last m-tile return at once)."""
    if isinstance(q_offset, torch.Tensor):
        return (sq + BLOCK_Q - 2) // BLOCK_Q + 1
    return row_tile(q_offset + sq - 1)[0] + 1 - row_tile(q_offset)[0]


def plan(b: int, h: int, kv: int, sq: int, d: int, group: int,
         q_offset: int | torch.Tensor = 0, sc_bits: int | None = None, *,
         esz: int = 2, sms: int | None = None, heads: int | None = None,
         m_tiles: int | None = None) -> Plan:
    """The launch for ``B`` batch rows of ``H`` query heads over ``KV`` KV
    heads, ``Sq`` rows at ``q_offset``, head dim ``d``, elements of
    ``esz`` bytes. A tensor ``q_offset`` (read on the card) plans for
    :func:`m_tile_count`'s worst case, so the launch does not depend on
    its value. bf16 float: up to :data:`MMA_MAX_WARPS` heads a block
    (a warp each), with m-tiles added until a block has 4 warps. f32
    float: 4 heads a block. SC: as many heads as fit shared memory with
    the group's counts and :data:`SC_ITEMS` outputs a thread — fewer when
    the grid would hold fewer blocks than the card's ``sms`` (a 16-row
    chunk: one m-tile a KV head), trading repeated K/V quantization for
    blocks that run in parallel. ``heads`` and ``m_tiles``, where given (a
    tuned ``autotune.FlashConfig``), replace those choices. No result
    depends on the plan."""
    g = h // kv
    tiles = m_tile_count(sq, q_offset)
    if sc_bits is not None:
        path, threads, hb, mt = "sc", SC_THREADS, heads, m_tiles or 1
        if hb is None:
            row_sets = SC_THREADS // -(-d // 4)
            hb = max([n for n in range(1, g + 1)
                      if smem_bytes("sc", n, 1, d, group, esz) <= SMEM_MAX
                      and BLOCK_Q * n <= SC_ITEMS * row_sets] or [1])
            while sms and hb > 1 and b * tiles * kv * -(-g // hb) < sms:
                hb -= 1
    elif esz == 2:
        path, hb = "mma", heads or min(g, MMA_MAX_WARPS)
        mt = m_tiles or max(1, min(-(-4 // hb), tiles))
        threads = 32 * hb * mt
    else:
        path, hb, mt, threads = "f32", heads or min(g, 4), m_tiles or 1, \
            THREADS
    grid = (-(-tiles // mt), kv * -(-g // hb), b)
    return Plan(path, hb, mt, threads, grid,
                smem_bytes(path, hb, mt, d, group, esz))


_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
#: Argument types of the C entries ``flash_attention_{f32,bf16}``: the four
#: tensors, the shapes and the plan (B, H, KV, Sq, Skv, D, G, heads,
#: m-tiles), twelve strides, q_offset and its device copy (or null),
#: causal, group, sc_bits, vec, the attention scale and the stream.
ARGTYPES = ([_PTR] * 4 + [_I32] * 9 + [_I64] * 12 + [_I32, _PTR]
            + [_I32] * 4 + [_F32, _PTR])
_ENTRIES: dict = {}


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    """The card's multiprocessor count, read once per device."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _entries() -> dict:
    """The C entry points by dtype, their argument types set once."""
    if not _ENTRIES:
        lib = build.load("flash_attention")
        for dtype, suffix in ((torch.float32, "f32"),
                              (torch.bfloat16, "bf16")):
            fn = getattr(lib, f"flash_attention_{suffix}")
            fn.argtypes = ARGTYPES
            fn.restype = _I32
            _ENTRIES[dtype] = fn
        fn = lib.flash_attention_smem_bytes
        fn.argtypes = [_I32] * 6
        fn.restype = _I64
        _ENTRIES["smem_bytes"] = fn
    return _ENTRIES


def sc_tolerance(v: torch.Tensor, bits: int) -> float:
    """One output quantization step: the most a single probability
    magnitude moving one step can change an output element."""
    return float(v.abs().max()) / (stream_length(bits) - 1)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int | torch.Tensor = 0, group: int = 64,
                          sc_bits: int | None = None) -> torch.Tensor:
    """Plain version: the model layers' flash formulation with positions
    ``q_offset + i`` / ``j`` (built on the tensors' device, from a tensor
    offset too) and ``kv_block = group``."""
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


def _check_offset(q_offset, q: torch.Tensor) -> None:
    """A host offset is an int >= 0; an offset on the device a 0-dim (or
    one-element) int32 tensor on the query's device, whose value is the
    caller's to keep >= 0 (reading it would synchronize)."""
    if isinstance(q_offset, torch.Tensor):
        if (q_offset.numel() != 1 or q_offset.dtype != torch.int32
                or q_offset.device != q.device):
            raise ConfigError(f"flash kernel: a tensor q_offset is one int32 "
                              f"on the query's device, got {q_offset.dtype} "
                              f"{tuple(q_offset.shape)} on {q_offset.device}")
    elif q_offset < 0:
        raise ConfigError(f"flash kernel needs q_offset >= 0, got {q_offset}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int | torch.Tensor = 0,
                    group: int = 64, sc_bits: int | None = None,
                    config=None) -> torch.Tensor:
    """Fused flash forward: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU. ``q_offset`` is an int, or a
    one-element int32 tensor on the query's device (read by the kernel).
    ``config`` (a tuned ``autotune.FlashConfig``) sets the heads and
    m-tiles a block; the bits do not depend on it."""
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
    if group < 1:
        raise ConfigError(f"flash kernel needs group >= 1, got {group}")
    _check_offset(q_offset, q)
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
    esz = q.element_size()
    if config is None:
        p = plan(b, h, kv, sq, d, group, q_offset, sc_bits, esz=esz,
                 sms=_sm_count(q.device))
    else:
        p = plan(b, h, kv, sq, d, group, q_offset, sc_bits, esz=esz,
                 heads=config.heads, m_tiles=config.m_tiles)
        if not (config.is_valid() and config.fits(p.path, d, group, esz)):
            raise ConfigError(f"flash plan {config} is not one the kernel "
                              f"takes on its {p.path} path at D={d}, "
                              f"group={group}")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    # 16-byte copies: every row and base address 16-byte aligned
    vec = int(d * esz % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
              and all(s * esz % 16 == 0 for s in strides[:9]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    on_device = isinstance(q_offset, torch.Tensor)
    rc = _entries()[q.dtype](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv,
        sq, skv, d, h // kv, p.heads, p.m_tiles, *strides,
        0 if on_device else int(q_offset),
        q_offset.data_ptr() if on_device else None, int(causal), int(group),
        sc_bits or 0, vec, d ** -0.5, stream)
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    if sc_bits is not None:
        flash_attention.sc.launches += 1
    return out


flash_attention.launches = 0
flash_attention.sc = SimpleNamespace(launches=0)
