"""SC-GEMM kernel wrappers (port of ``repro/kernels/sc_matmul.py`` and of the
quantize / count / dequantize chain of ``repro/kernels/ops.py``).

One CUDA kernel, ``csrc/sc_matmul.cu``, replaces the Pallas TPU kernel
``sc_matmul_counts_pallas`` (``repro/kernels/sc_matmul.py:89``) and the
operators around it. It has two entries:

* :func:`sc_linear` — a model projection as one launch: float activation
  rows (f32 or bf16) are quantized per row inside the kernel, counted
  against a weight plane packed once by :func:`pack_weight`, and written
  dequantized, ``counts · ((N · s_row) · s_w)``, in the activations' dtype.
  ``sc_linear.launches`` counts its launches.
* :func:`sc_matmul_counts_signed` — the JAX kernel's signature: signed
  planes in, float32 exact counts out. ``sc_matmul_counts_signed.launches``
  counts its launches.

A batched :class:`PackedWeight` (``pack_weight`` of ``(E, K, N)``: a MoE
projection's experts) makes :func:`sc_linear` of rows ``(E, M, K)`` one
launch for all ``E`` problems, each the bits of its own unbatched launch
(the reference's ``jax.vmap`` over ``sc_proj``, which gives its
``pallas_call`` a batch grid axis).

Each takes its plain PyTorch version (:func:`sc_linear_torch`,
:func:`sc_matmul_counts_signed_torch`) for tensors on the CPU and launches
the kernel for tensors on the card — never on a failure. :func:`plan` picks
the kernel's row tile and K split from the shape (the source note says
why); a tuned plan (``autotune.KernelConfig``) replaces it where the caller
passes one.

:func:`sc_linear` is the custom operator ``torch.ops.repro_torch.sc_linear``
(``torch.library.custom_op``): its implementation is the plain version on
the CPU and the launch on the card, and its fake implementation gives the
output's shape, dtype and strides, so a ``FakeTensor`` (the dry run) and a
``DTensor`` (whose sharding rule is ``parallel/kernel_sharding.py``'s)
pass through it. Plain tensors call the implementation directly
(``build.direct``).
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.sc_matmul import signed_counts
from repro_torch.core.sc_numerics import (absmax_scale, quantize_at_scale,
                                          quantize_sign_magnitude)
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError, KernelLaunchError

from . import build

__all__ = ["sc_matmul_counts", "sc_matmul_counts_torch",
           "sc_matmul_counts_signed", "sc_matmul_counts_signed_torch",
           "pack_signed", "plane_dtype", "check_exact", "PackedWeight",
           "pack_weight", "sc_linear", "sc_linear_torch", "plan",
           "row_tile", "scratch_scope"]

#: Largest |count| a float32 holds exactly.
EXACT_LIMIT = 1 << 24
#: Output columns of one block (``kTileN`` in the source).
TILE_N = 64
#: K rows of one pipeline stage; a block's K range is a multiple of it.
K_STAGE = 32
#: Quantized A entries (8 bytes each) a block may keep in shared memory.
A_SMEM_ENTRIES = 8192
#: Largest K range of a block: the packed 16-bit form's lanes hold at most
#: 128 k rows a thread (``csrc/sc_matmul.cu``).
K_BLOCK_MAX = 4096
#: Blocks per SM the K split aims for.
BLOCKS_PER_SM = 2
#: Row tiles of all problems of a launch (the grid's z extent) at most.
MAX_GRID_Z = 65535
#: Elements of a weight quantized at once when it is packed: a large head
#: (llama4's 5,120 x 202,048) quantized whole would need ~20 GB of float32
#: and int64 temporaries beside the model.
PACK_CHUNK = 1 << 24


def plane_dtype(bits: int) -> torch.dtype:
    """Signed-plane dtype: int16 holds magnitudes up to 2**15 - 1."""
    return torch.int16 if bits <= 15 else torch.int32


def check_exact(k: int, bits: int) -> None:
    """Refuse shapes whose counts could leave float32's exact range: each
    term is at most ``2**bits - 1``, so ``K · (2**bits - 1)`` must stay
    below 2**24."""
    if bits < 1 or bits > 30:
        raise ConfigError(f"SC-GEMM operand width must be 1..30, got {bits}")
    if k * (stream_length(bits) - 1) >= EXACT_LIMIT:
        raise ConfigError(
            f"SC-GEMM counts at K={k}, bits={bits} can reach "
            f"{k * (stream_length(bits) - 1)} >= 2**24, beyond float32's "
            f"exact integers")


def pack_signed(sign: torch.Tensor, mag: torch.Tensor,
                bits: int) -> torch.Tensor:
    """``sign · mag`` as one signed integer plane (a zero magnitude
    contributes nothing, so its sign is not needed)."""
    dt = plane_dtype(bits)
    return sign.to(dt) * mag.to(dt)


@dataclass(frozen=True)
class PackedWeight:
    """A weight ``(K, N)`` quantized and packed once, in the kernel's
    layout: ``plane`` is the signed plane ``(K, ldb)`` (int16 or int32,
    ``ldb`` = N rounded up to 8 so each row starts on 16 bytes, zero past
    N), ``scale`` the float32 per-tensor scale (0-dim), ``bits`` the width
    and ``shape`` the weight's ``(K, N)``. Batched (``experts`` = E > 0,
    the weights ``(E, K, N)`` of a MoE projection): ``plane`` is ``(E, K,
    ldb)`` and ``scale`` ``(E,)``, each expert's its own. A snapshot: a
    weight changed later needs a new one."""
    plane: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: tuple[int, int]
    experts: int = 0

    def to(self, device) -> "PackedWeight":
        return PackedWeight(self.plane.to(device), self.scale.to(device),
                            self.bits, self.shape, self.experts)


def _pack_one(w: torch.Tensor, bits: int, out: torch.Tensor,
              scale: torch.Tensor | None = None) -> torch.Tensor:
    """Quantize ``w (K, N)`` at its per-tensor scale (``scale``, or its
    own) into the zeroed plane ``out (K, ldb)``, a block of rows at a time
    (elementwise at the whole tensor's scale: the bits of quantizing it
    whole); returns the scale."""
    k, n = w.shape
    rows = max(1, PACK_CHUNK // max(n, 1))
    if scale is None:
        absmax = torch.stack([w[i:i + rows].abs().amax().to(torch.float32)
                              for i in range(0, k, rows)]).amax()
        scale = absmax_scale(absmax, bits=bits)
    for i in range(0, k, rows):
        q = quantize_at_scale(w[i:i + rows].to(torch.float32), scale,
                              bits=bits)
        out[i:i + rows, :n] = pack_signed(q.sign, q.mag, bits)
    return scale


@torch.no_grad()
def pack_weight(w: torch.Tensor, bits: int) -> PackedWeight:
    """Quantize ``w (K, N)`` per tensor and pack it: the plane and scale are
    the ones ``quantize_sign_magnitude`` + :func:`pack_signed` give,
    made a block of rows at a time (:data:`PACK_CHUNK`). ``w (E, K, N)``
    packs each expert so, into one batched pack."""
    if w.dim() not in (2, 3):
        raise ConfigError(f"a packed weight is (K, N) or (E, K, N), got "
                          f"{tuple(w.shape)}")
    k, n = w.shape[-2:]
    check_exact(k, bits)
    from repro_torch.parallel.context import is_dtensor
    if is_dtensor(w):
        return _pack_sharded(w, bits)
    ldb = -(-n // 8) * 8
    plane = torch.zeros((*w.shape[:-2], k, ldb), dtype=plane_dtype(bits),
                        device=w.device)
    if w.dim() == 2:
        return PackedWeight(plane, _pack_one(w, bits, plane), bits, (k, n))
    e = w.shape[0]
    scale = torch.empty((e,), dtype=torch.float32, device=w.device)
    for i in range(e):
        scale[i] = _pack_one(w[i], bits, plane[i])
    return PackedWeight(plane, scale, bits, (k, n), e)


def _pack_sharded(w, bits: int) -> PackedWeight:
    """:func:`pack_weight` of a ``DTensor``: each scale from the whole
    weight (an abs-max over every shard), replicated, and each shard's
    plane quantized at it — elementwise, so every shard holds the bits of
    its slice of the whole weight's plane. The kernel wants K whole, so
    the float weight is gathered over K first (the integer plane is
    never sent: NCCL and gloo move no int16); a plane with padding
    columns keeps its columns whole too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    k, n = w.shape[-2:]
    ldb = -(-n // 8) * 8
    lead = w.dim() - 2
    whole = {w.dim() - 2} | ({w.dim() - 1} if ldb != n else set())
    place = [Replicate() if isinstance(p, Shard) and p.dim in whole else p
             for p in w.placements]
    if place != list(w.placements):
        w = w.redistribute(w.device_mesh, place)
    absmax = w.abs().amax(dim=(-2, -1)).full_tensor().to(torch.float32)
    scale = absmax_scale(absmax, bits=bits)
    # the scales follow the weight's expert axis, if it is split
    s_place = [p if lead and isinstance(p, Shard) and p.dim == 0
               else Replicate() for p in place]
    local_scale = DTensor.from_local(scale, w.device_mesh,
                                     [Replicate()] * len(place)
                                     ).redistribute(w.device_mesh,
                                                    s_place).to_local()
    local = w.to_local()
    lk, ln = local.shape[-2:]
    plane = torch.zeros((*local.shape[:-2], lk, ldb if ldb != n else ln),
                        dtype=plane_dtype(bits), device=local.device)
    if lead:
        for i in range(local.shape[0]):
            _pack_one(local[i], bits, plane[i], local_scale[i])
    else:
        _pack_one(local, bits, plane, local_scale)
    mesh = w.device_mesh
    return PackedWeight(
        DTensor.from_local(plane, mesh, place, shape=(*w.shape[:-1], ldb),
                           stride=_contiguous_stride((*w.shape[:-1], ldb))),
        DTensor.from_local(local_scale, mesh, s_place,
                           shape=scale.shape,
                           stride=_contiguous_stride(scale.shape)),
        bits, (k, n), w.shape[0] if lead else 0)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def row_tile(m: int) -> int:
    """Rows a block: the smallest of 1, 2, 4, 8 and 16 covering M up to
    16."""
    mr = 1
    while mr < min(max(m, 1), 16):
        mr *= 2
    return mr


def plan(m: int, n: int, k: int, sms: int,
         batch: int = 1) -> tuple[int, int, int]:
    """``(mr, kc, splits)`` of a launch of ``batch`` problems (M, K, N):
    rows a block (:func:`row_tile`), the K range a block (a multiple of
    :data:`K_STAGE`, capped so its quantized rows fit shared memory), and
    the number of K ranges, chosen so the grid gives ``BLOCKS_PER_SM``
    blocks per SM where K allows."""
    mr = row_tile(m)
    tiles = -(-n // TILE_N) * -(-max(m, 1) // mr) * batch
    kc_max = max(K_STAGE, min(K_BLOCK_MAX,
                              A_SMEM_ENTRIES // mr // K_STAGE * K_STAGE))
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // tiles), -(-k // K_STAGE)))
    kc = -(-max(-(-k // splits), 1) // K_STAGE) * K_STAGE
    kc = min(kc, kc_max)
    return mr, kc, max(1, -(-k // kc))


_SMS: dict[int, int] = {}
#: Per stream: the tile counters (zeroed once; the kernel's last block of
#: each tile puts its counter back to 0) and the K split's int32 partials.
#: Launches on one stream run in order, so each launch finds both free.
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
#: The scratch table of a CUDA graph's capture (:func:`scratch_scope`), or
#: None for the shared one above.
_SCOPE: dict | None = None
_FN = None


@contextlib.contextmanager
def scratch_scope(table: dict):
    """Give every SC-GEMM launch inside the block its scratch from
    ``table`` instead of the shared per-stream table. A captured step
    warms up and captures inside its own table and keeps it: its graph
    replays over scratch that no later call, on whatever stream (the
    streams that captures take come from a small pool and repeat), can
    grow and so free. The table is made by the eager warm-up runs, never
    during the capture (:func:`_scratch` raises then)."""
    global _SCOPE
    outer, _SCOPE = _SCOPE, table
    try:
        yield table
    finally:
        _SCOPE = outer


def _scratch(dev: torch.device, stream: int, tiles: int,
             partials: int) -> tuple[torch.Tensor, torch.Tensor]:
    table = _SCRATCH if _SCOPE is None else _SCOPE
    key = (dev.index, stream)
    counters, ws = table.get(key, (None, None))
    grow = (counters is None or counters.numel() < tiles
            or ws.numel() < partials)
    if grow and dev.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise KernelLaunchError("SC-GEMM scratch of a capturing stream must "
                                "exist before the capture: run the step on "
                                "that stream first")
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros((max(tiles, 1 << 12),), dtype=torch.int32,
                               device=dev)
    if ws is None or ws.numel() < partials:
        ws = torch.empty((max(partials, 1 << 20),), dtype=torch.int32,
                         device=dev)
    table[key] = (counters, ws)
    return counters, ws


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("sc_matmul").sc_gemm
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(a, plane, w_scale, out, *, m, n, k, bits, config=None,
            batch: int = 1):
    """One launch of the kernel: ``a`` f32/bf16 (fused) or a signed plane
    (counts), ``plane (K, ldb)``; with ``batch`` > 1, ``batch`` problems
    of that shape stacked on a leading axis of ``a``, ``plane``,
    ``w_scale`` and ``out`` (contiguous). The plan is ``config``'s (a
    tuned ``autotune.KernelConfig``) or :func:`plan`'s. A tuned row tile
    past :func:`row_tile` of the call's rows (a skinny key's winner, swept
    at its bucket's M, serving fewer rows) is cut to it: the same grid and
    K split, no masked rows."""
    dev = a.device
    if config is None:
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        mr, kc, splits = plan(m, n, k, sms, batch)
    else:
        if not (config.is_valid() and config.fits()):
            raise ConfigError(f"SC-GEMM plan {config} is not one the kernel "
                              f"takes")
        mr, kc, splits = (min(config.mr, row_tile(m)), config.kc,
                          config.splits(k))
    if -(-m // mr) * batch > MAX_GRID_Z:
        raise ConfigError(f"SC-GEMM of {batch} problems of {m} rows at "
                          f"{mr} rows a block exceeds the kernel grid")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = counters = 0
    if splits > 1:
        tiles = -(-n // TILE_N) * -(-m // mr) * batch
        c, w = _scratch(dev, stream, tiles, tiles * splits * mr * TILE_N)
        counters, ws = c.data_ptr(), w.data_ptr()
    a_kind = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2,
              torch.int32: 3}[a.dtype]
    rc = _kernel()(a_kind, 0 if plane.dtype == torch.int16 else 1,
                   a.data_ptr(), plane.data_ptr(),
                   0 if w_scale is None else w_scale.data_ptr(),
                   out.data_ptr(), ws, counters, m, n, k, plane.shape[-1],
                   bits, mr, kc, splits, batch,
                   m * k if batch > 1 else 0,
                   plane[0].numel() if batch > 1 else 0,
                   m * n if batch > 1 else 0, stream)
    build.check(rc, "sc_gemm")


def sc_matmul_counts_torch(sx, mx, sy, my, bits: int) -> torch.Tensor:
    """Plain version: signed SC-GEMM counts as float32 ``(M, N)``."""
    return signed_counts(sx, mx, sy, my, bits).to(torch.float32)


def sc_matmul_counts_signed_torch(a: torch.Tensor, b: torch.Tensor, *,
                                  bits: int) -> torch.Tensor:
    """Plain version of the kernel on signed planes ``a (M, K)``,
    ``b (K, N)``."""
    return sc_matmul_counts_torch(torch.sign(a) + (a == 0).to(a.dtype),
                                  a.abs(),
                                  torch.sign(b) + (b == 0).to(b.dtype),
                                  b.abs(), bits)


def _check_cuda(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ConfigError(f"{what} on {a.device} and {b.device}: both must be "
                          f"on one CUDA device or on the CPU")


def sc_matmul_counts_signed(a: torch.Tensor, b: torch.Tensor, *,
                            bits: int, config=None) -> torch.Tensor:
    """Signed SC-GEMM counts of signed planes ``a (M, K)`` and ``b (K, N)``
    as float32 ``(M, N)`` exact integers: the CUDA kernel for CUDA tensors
    (at ``config``'s launch plan, an ``autotune.KernelConfig``, or
    :func:`plan`'s), the plain version for CPU tensors."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ConfigError(f"SC-GEMM planes must be (M, K) x (K, N), got "
                          f"{tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    check_exact(k, bits)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sc_matmul_counts_signed_torch(a, b, bits=bits)
    dt = plane_dtype(bits)
    _check_cuda(a, b, "SC-GEMM planes")
    if a.dtype != dt or b.dtype != dt:
        raise ConfigError(f"SC-GEMM planes at bits={bits} must be {dt}, got "
                          f"{a.dtype} and {b.dtype}")
    if m >= (1 << 20) or n >= (1 << 30):
        raise ConfigError(f"SC-GEMM shape ({m}, {n}) exceeds the kernel grid")
    ldb = -(-n // 8) * 8
    b = F.pad(b, (0, ldb - n)) if ldb != n else b.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch(a.contiguous(), b, None, out, m=m, n=n, k=k, bits=bits,
            config=config)
    sc_matmul_counts_signed.launches += 1
    return out


sc_matmul_counts_signed.launches = 0


def sc_matmul_counts(sx, mx, sy, my, *, bits: int = 8) -> torch.Tensor:
    """Signed SC-GEMM counts from sign/magnitude planes (the JAX kernel's
    signature): ``sx, mx (M, K)``, ``sy, my (K, N)`` → float32 ``(M, N)``."""
    if mx.device.type == "cpu" and my.device.type == "cpu":
        check_exact(mx.shape[1], bits)
        return sc_matmul_counts_torch(sx, mx, sy, my, bits)
    return sc_matmul_counts_signed(pack_signed(sx, mx, bits),
                                   pack_signed(sy, my, bits), bits=bits)


def sc_linear_torch(x: torch.Tensor, pw: PackedWeight) -> torch.Tensor:
    """Plain version of the fused kernel: quantize the rows of ``x (M, K)``
    (per-row scales), count against the packed plane, dequantize by
    ``(N · s_row) · s_w`` and cast to ``x``'s dtype — the unfused chain.
    Batched, ``x (E, M, K)``: that of each expert in turn."""
    if pw.experts:
        return torch.stack([
            sc_linear_torch(x[e], PackedWeight(pw.plane[e], pw.scale[e],
                                               pw.bits, pw.shape))
            for e in range(pw.experts)])
    n = pw.shape[1]
    qa = quantize_sign_magnitude(x.to(torch.float32), bits=pw.bits, axis=-1)
    counts = sc_matmul_counts_signed_torch(
        pack_signed(qa.sign, qa.mag, pw.bits), pw.plane[:, :n], bits=pw.bits)
    out = counts * (stream_length(pw.bits) * qa.scale * pw.scale)
    return out.to(x.dtype)


def sc_linear(x: torch.Tensor, pw: PackedWeight, *,
              config=None) -> torch.Tensor:
    """SC-GEMM ``x @ w`` of float rows ``x (M, K)`` (f32 or bf16) and a
    packed weight, per-row activation scales, in ``x``'s dtype: one kernel
    launch for CUDA tensors, at ``config``'s launch plan (a tuned
    ``autotune.KernelConfig``) or :func:`plan`'s, whose bits are the same;
    the plain version for CPU tensors. A row
    holding a NaN comes out NaN, and so does a row holding an Inf (on the
    CPU only at bits <= 15: there a NaN magnitude converts to int32's
    minimum, which an int16 plane truncates to 0). With a batched pack of
    E experts, ``x (E, M, K)`` gives ``(E, M, N)``: one launch for all of
    them on the card, each expert's rows the bits of its own call, or a
    :class:`ConfigError` where the launch cannot be made (never a loop
    over experts). Both are ``torch.ops.repro_torch.sc_linear``'s
    implementation, called directly for plain tensors
    (``build.direct``)."""
    k, n = pw.shape
    if pw.experts:
        ok = x.dim() == 3 and x.shape[0] == pw.experts and x.shape[2] == k
        want = f"({pw.experts}, M, {k})"
    else:
        ok = x.dim() == 2 and x.shape[1] == k
        want = f"(M, {k})"
    if not ok:
        raise ConfigError(f"SC-GEMM rows must be {want}, got "
                          f"{tuple(x.shape)}")
    if not (x.device.type == "cpu" and pw.plane.device.type == "cpu"):
        _check_cuda(x, pw.plane, "SC-GEMM rows and packed weight")
    mr, kc = (0, 0) if config is None else (config.mr, config.kc)
    args = (x, pw.plane, pw.scale, pw.bits, pw.plane.shape[-1] - n, mr, kc)
    if build.direct(x, pw.plane, pw.scale):
        return _sc_linear_impl(*args)
    return torch.ops.repro_torch.sc_linear(*args)


sc_linear.launches = 0


def _sc_linear_impl(x: torch.Tensor, plane: torch.Tensor,
                    scale: torch.Tensor, bits: int, pad: int, mr: int,
                    kc: int) -> torch.Tensor:
    """:func:`sc_linear` on a plane ``(K, L)`` (or ``(E, K, L)``) whose
    last ``pad`` columns are padding, at the plan ``(mr, kc)`` (``mr`` 0:
    :func:`plan`'s): the plain version on the CPU, else one launch."""
    n = plane.shape[-1] - pad
    pw = PackedWeight(plane, scale, bits, (plane.shape[-2], n),
                      plane.shape[0] if plane.dim() == 3 else 0)
    if x.device.type == "cpu":
        return sc_linear_torch(x, pw)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ConfigError(f"SC-GEMM rows must be float32 or bfloat16 on the "
                          f"card, got {x.dtype}")
    m = x.shape[-2]
    if m >= (1 << 20) or n >= (1 << 30):
        raise ConfigError(f"SC-GEMM shape ({m}, {n}) exceeds the kernel grid")
    config = None
    if mr:
        from .autotune import KernelConfig
        config = KernelConfig(mr, kc)
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    _launch(x.contiguous(), plane, scale, out, m=m, n=n, k=pw.shape[0],
            bits=bits, config=config, batch=max(pw.experts, 1))
    sc_linear.launches += 1
    return out


_sc_linear_op = torch.library.custom_op("repro_torch::sc_linear",
                                        _sc_linear_impl, mutates_args=())


@_sc_linear_op.register_fake
def _sc_linear_fake(x, plane, scale, bits, pad, mr, kc):
    return x.new_empty((*x.shape[:-1], plane.shape[-1] - pad))
