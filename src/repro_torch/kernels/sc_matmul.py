"""SC-GEMM counts kernel wrapper (port of ``repro/kernels/sc_matmul.py``).

Replaces the Pallas TPU kernel ``sc_matmul_counts_pallas``
(``repro/kernels/sc_matmul.py:89``) with the CUDA kernel in
``csrc/sc_matmul.cu``: signed counts ``Σ_k s_x s_y O(x, y)`` as exact
integers in float32. On Hopper the closed form runs on the CUDA cores in
int32, bound by integer issue rather than memory at the decode shapes; the
kernel decodes each B element once per row block and masks ragged edges
itself, so no operand is padded. See the source note for the layout.

:func:`sc_matmul_counts_signed` is the kernel's wrapper: it launches the
kernel for tensors on the card and takes the plain PyTorch version
:func:`sc_matmul_counts_signed_torch` for tensors on the CPU — never on a
failure. ``sc_matmul_counts_signed.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.sc_matmul import signed_counts
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError

from . import build

__all__ = ["sc_matmul_counts", "sc_matmul_counts_torch",
           "sc_matmul_counts_signed", "sc_matmul_counts_signed_torch",
           "pack_signed", "plane_dtype", "check_exact"]

#: Largest |count| a float32 holds exactly.
EXACT_LIMIT = 1 << 24


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


def sc_matmul_counts_signed(a: torch.Tensor, b: torch.Tensor, *,
                            bits: int) -> torch.Tensor:
    """Signed SC-GEMM counts of signed planes ``a (M, K)`` and ``b (K, N)``
    as float32 ``(M, N)`` exact integers: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ConfigError(f"SC-GEMM planes must be (M, K) x (K, N), got "
                          f"{tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    check_exact(k, bits)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sc_matmul_counts_signed_torch(a, b, bits=bits)
    dt = plane_dtype(bits)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ConfigError(f"SC-GEMM planes on {a.device} and {b.device}: "
                          f"both must be on one CUDA device or on the CPU")
    if a.dtype != dt or b.dtype != dt:
        raise ConfigError(f"SC-GEMM planes at bits={bits} must be {dt}, got "
                          f"{a.dtype} and {b.dtype}")
    if m >= (1 << 20) or n >= (1 << 30):
        raise ConfigError(f"SC-GEMM shape ({m}, {n}) exceeds the kernel grid")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = build.load("sc_matmul")
    fn = lib.sc_matmul_counts_i16 if dt == torch.int16 \
        else lib.sc_matmul_counts_i32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bits,
            stream)
    build.check(rc, "sc_matmul_counts")
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
