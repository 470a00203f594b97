"""The bit-parallel stream multiplier of the port (``kernels/sc_bitops.py``,
``kernels/ops.py::sc_stream_mul``, the stream oracles of ``kernels/ref.py``)
against the JAX package's, on the CPU, where the wrapper takes the plain
version. The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sc_bitops import _correlation_word, _thermo_word
from repro_torch.core.multipliers import proposed_closed_form
from repro_torch.core.tcu import popcount_u32
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sc_bitops
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.sc_bitops import (correlation_word,
                                           sc_stream_mul_cuda,
                                           sc_stream_mul_torch, thermo_word)

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _tuner_cache(tmp_path, monkeypatch):
    """Both packages' autotuner caches in the test's own directory
    (``pallas_tuned`` and ``tune=True`` sweep and write them), never the
    default paths."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))


def _grid(bits, step=1):
    r = np.arange(0, 1 << bits, step, dtype=np.int32)
    x, y = np.meshgrid(r, r, indexing="ij")
    return x.reshape(-1), y.reshape(-1)


@pytest.mark.parametrize("bits", [5, 6, 7, 8])
def test_stream_words_equal_jax_word_by_word(bits):
    v = np.arange(1 << bits, dtype=np.int32)
    vt = torch.as_tensor(v)
    for w in range((1 << bits) // 32):
        want_x = np.asarray(_thermo_word(jnp.asarray(v), w)).view(np.uint32)
        want_y = np.asarray(_correlation_word(jnp.asarray(v), w, bits)
                            ).view(np.uint32)
        got_x, got_y = thermo_word(vt, w), correlation_word(vt, w, bits)
        assert got_x.dtype == got_y.dtype == torch.int64
        np.testing.assert_array_equal(got_x.numpy().astype(np.uint32), want_x,
                                      err_msg=f"thermo bits={bits} word={w}")
        np.testing.assert_array_equal(got_y.numpy().astype(np.uint32), want_y,
                                      err_msg=f"corr bits={bits} word={w}")
    # the word boundary by name: x just below and at the end of word 0
    assert int(thermo_word(torch.tensor(31), 0)) == 0x7FFFFFFF
    assert int(thermo_word(torch.tensor(32), 0)) == 0xFFFFFFFF
    assert int(thermo_word(torch.tensor(32), 1)) == 0


@pytest.mark.parametrize("bits", [5, 8])
def test_stream_oracles_equal_jax(bits):
    x, y = _grid(bits)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_array_equal(ref.sc_stream_mul_ref(xt, yt, bits).numpy(),
                                  np.asarray(jref.sc_stream_mul_ref(xj, yj,
                                                                    bits)))
    for got, want in zip(ref.sc_stream_words_ref(xt, yt, bits),
                         jref.sc_stream_words_ref(xj, yj, bits)):
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want).astype(np.uint32))


def test_stream_product_equals_jax_oracle_on_the_full_8_bit_grid():
    x, y = _grid(8)
    got = ops.sc_stream_mul(torch.as_tensor(x), torch.as_tensor(y), bits=8)
    assert got.dtype == torch.int32 and got.shape == (65536,)
    want = jref.sc_stream_mul_ref(jnp.asarray(x), jnp.asarray(y), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [5, 6, 8])
def test_stream_product_equals_the_pallas_kernel(bits):
    """The subsampled grids of the JAX package's own kernel test, through
    its Pallas kernel in interpret mode."""
    x, y = _grid(bits, step=max((1 << bits) // 64, 1))
    want = jops.sc_stream_mul(jnp.asarray(x), jnp.asarray(y), bits=bits,
                              interpret=True)
    got = ops.sc_stream_mul(torch.as_tensor(x), torch.as_tensor(y),
                            bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [9, 10])
def test_plain_version_equals_closed_form_on_seeded_wide_operands(bits):
    rng = np.random.default_rng(bits)
    x, y = (torch.as_tensor(rng.integers(0, 1 << bits, 3000, dtype=np.int32))
            for _ in range(2))
    assert torch.equal(sc_stream_mul_torch(x, y, bits=bits),
                       proposed_closed_form(x, y, bits=bits))


def test_shape_is_kept_and_block_rows_do_not_change_the_result():
    rng = np.random.default_rng(3)
    x, y = (torch.as_tensor(rng.integers(0, 256, (3, 7, 29), dtype=np.int64))
            for _ in range(2))
    outs = [ops.sc_stream_mul(x, y, bits=8, block_rows=r) for r in (1, 4, 8)]
    assert outs[0].shape == (3, 7, 29) and outs[0].dtype == torch.int32
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert torch.equal(outs[0], proposed_closed_form(x, y, bits=8))


@pytest.mark.parametrize("shape", [(0,), (2, 0, 3)])
def test_empty_operands_return_an_empty_result(shape):
    """The JAX package's regression: an empty operand returns the empty
    result directly."""
    x = torch.zeros(shape, dtype=torch.int32)
    before = sc_stream_mul_cuda.launches
    out = ops.sc_stream_mul(x, x, bits=8)
    assert out.shape == shape and out.dtype == torch.int32
    assert sc_stream_mul_cuda.launches == before


def test_refusals():
    x = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ConfigError, match="5 <= bits"):
        ops.sc_stream_mul(x % 16, x % 16, bits=4)
    with pytest.raises(ConfigError, match="block_rows"):
        ops.sc_stream_mul(x, x, bits=8, block_rows=16)
    with pytest.raises(ConfigError, match="5 <= bits"):
        ops.sc_stream_mul(x % 16, x % 16, bits=4, tune=True)
    with pytest.raises(ConfigError, match="one shape"):
        ops.sc_stream_mul(x, x[:10], bits=8)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x = torch.arange(200, dtype=torch.int32)
    before = sc_stream_mul_cuda.launches
    got = sc_stream_mul_cuda(x, x.flip(0), bits=8)
    assert sc_stream_mul_cuda.launches == before
    assert torch.equal(got, sc_stream_mul_torch(x, x.flip(0), bits=8))


def test_kernel_source_is_integer_only():
    """The port's form of the JAX package's integer-only audit: the CUDA
    source names no floating-point type."""
    src = (CSRC / "sc_bitops.cu").read_text()
    found = re.findall(r"\b(float\w*|double|__half\w*|__nv_bfloat16"
                       r"|__fdiv\w*|rintf?|powf?)\b", src)
    assert not found, found
    assert "__popc" in src


# -- the CUDA kernel's word construction, mirrored on the CPU ---------------

_FULL = 0xFFFFFFFF


def _funnelshift_lc(lo, hi, shift):
    """CUDA's ``__funnelshift_lc(lo, hi, shift)`` on int64 tensors holding
    unsigned 32-bit values: the high word of ``hi:lo << min(shift, 32)``,
    the shift read as unsigned (a negative one clamps to 32)."""
    s = torch.clamp(shift & _FULL, max=32)
    wide = (hi << 32) | lo
    return ((wide << s) >> 32) & _FULL


def _viaddmax_s32(a, b, c):
    """CUDA's ``__viaddmax_s32(a, b, c)``: max(a + b, c)."""
    return torch.clamp(a + b, min=c)


def _kernel_constants():
    """The chunk and thermometer-ROM constants of ``csrc/sc_bitops.cu``."""
    src = (CSRC / "sc_bitops.cu").read_text()
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
    for line in ("constexpr int kSpan = 32 * kChunk;",
                 "constexpr int kLead = kSpan - 32;",
                 "constexpr int kTop = kSpan + 33;",
                 "constexpr int kRom = kLead + kTop + 1;"):
        assert line in src, line
    span = 32 * chunk
    return chunk, span - 32, span + 33


def _kernel_words(x, y, bits):
    """Every word of both streams as ``csrc/sc_bitops.cu`` builds them:
    (thermometer, correlation), each (words, n) int64. Chunks of up to
    ``kChunk`` words; per chunk an element's pointer into the thermometer
    ROM at T(clamp(x - base, 0, kTop)) and word j read 32 j words below
    it; the per-element ``ys``, ``P`` and ``Q`` of ``prepare`` and the
    offset 32w - base for the correlation word; bit 0 of word 0's
    correlation word cleared."""
    chunk, lead, top = _kernel_constants()
    t = torch.arange(-lead, top + 1)
    rom = _funnelshift_lc(torch.full_like(t, _FULL), torch.zeros_like(t),
                          torch.clamp(t, min=0))
    half, n_words = (1 << bits) // 2, (1 << bits) // 32
    words = min(n_words, chunk)
    x, y = x.to(torch.int64), y.to(torch.int64)
    msb = y >= half
    ys = 2 * torch.where(msb, y - half, y) + torch.where(msb, 2, 0)
    p = torch.where(msb, 0xAAAAAAAA, 0)
    q = torch.where(msb, _FULL, 0xAAAAAAAA)
    zero = torch.zeros_like(x)
    xws, yws = [], []
    for base in range(0, 32 * n_words, 32 * words):
        tx = lead + torch.clamp(x - base, 0, top)   # the chunk's pointer
        for j in range(words):
            xws.append(rom[tx - 32 * j])
            yws.append(p | _funnelshift_lc(
                q, zero, _viaddmax_s32(ys - base, -32 * j, 0)))
    yws[0] = yws[0] & (~1 & _FULL)
    return torch.stack(xws), torch.stack(yws)


def _jax_words(x, y, bits):
    """The JAX package's ``_thermo_word`` / ``_correlation_word`` for every
    word, (words, n) uint32."""
    w = jnp.arange((1 << bits) // 32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xw = jax.vmap(lambda i: _thermo_word(xj, i))(w)
    yw = jax.vmap(lambda i: _correlation_word(yj, i, bits))(w)
    return np.asarray(xw).astype(np.uint32), np.asarray(yw).astype(np.uint32)


def _assert_words_equal(x, y, bits):
    xw, yw = _kernel_words(torch.as_tensor(x), torch.as_tensor(y), bits)
    want_x, want_y = _jax_words(x, y, bits)
    np.testing.assert_array_equal(xw.numpy().astype(np.uint32), want_x,
                                  err_msg=f"thermometer, bits={bits}")
    np.testing.assert_array_equal(yw.numpy().astype(np.uint32), want_y,
                                  err_msg=f"correlation, bits={bits}")
    got = torch.zeros(len(x), dtype=torch.int64)
    for a, b in zip(xw, yw):
        got += popcount_u32(a & b)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.sc_stream_mul_ref(jnp.asarray(x),
                                                        jnp.asarray(y), bits)))


@pytest.mark.parametrize("bits", [5, 6, 7, 8])
def test_kernel_word_construction_equals_jax_exhaustively(bits):
    """Every word of both streams for every operand value (and so every
    pair's count) at B = 5..8."""
    x, y = _grid(bits)
    _assert_words_equal(x, y, bits)


@pytest.mark.parametrize("bits", [10, 12, 16])
def test_kernel_word_construction_equals_jax_on_seeded_operands(bits):
    """Seeded operands with msb both set and clear inside every group of
    32 elements (a warp's worth), and the edge values of both streams."""
    rng = np.random.default_rng(100 + bits)
    n, half = 1024, 1 << (bits - 1)
    x = rng.integers(0, 1 << bits, n, dtype=np.int32)
    y = rng.integers(0, 1 << bits, n, dtype=np.int32)
    y[0::32] = rng.integers(0, half, n // 32)
    y[1::32] = rng.integers(half, 1 << bits, n // 32)
    edges = [0, 1, 31, 32, 33, half - 1, half, half + 1, (1 << bits) - 1]
    x[2:2 + len(edges)] = edges
    y[2 + len(edges):2 + 2 * len(edges)] = edges
    msb = (y >= half).reshape(-1, 32)
    assert msb.any(axis=1).all() and (~msb).any(axis=1).all()
    _assert_words_equal(x, y, bits)


def test_funnel_shift_mirror_clamps_as_cuda_does():
    lo = torch.tensor([_FULL] * 5)
    got = _funnelshift_lc(lo, torch.zeros_like(lo),
                          torch.tensor([0, 1, 31, 32, 40]))
    assert got.tolist() == [0, 1, 0x7FFFFFFF, _FULL, _FULL]
    # a negative shift reads as a huge unsigned one: hence the kernel's max
    assert int(_funnelshift_lc(torch.tensor(_FULL), torch.tensor(0),
                               torch.tensor(-3))) == _FULL


def test_argument_types_match_the_c_entry():
    """ctypes passes what ARGTYPES says: a pointer typed as an int would be
    cut to 32 bits, a 64-bit count passed as an int cut too."""
    src = (CSRC / "sc_bitops.cu").read_text()
    m = re.search(r'extern "C" int sc_stream_mul\(([^)]*)\)', src)
    params = [re.sub(r"\s+\w+$", "", p.strip()).replace("const ", "")
              .replace(" ", "") for p in m.group(1).split(",")]
    kinds = {"void*": "ptr", "int": "int", "longlong": "i64"}
    names = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_longlong: "i64"}
    assert [names[t] for t in sc_bitops.ARGTYPES] == [kinds[p]
                                                      for p in params]


def test_misaligned_views_are_copied_to_aligned_buffers():
    """A view that starts 4 bytes into its storage cannot take the
    kernel's 16-byte loads: the wrapper copies it, values unchanged."""
    base = torch.arange(64, dtype=torch.int32)
    assert base.data_ptr() % sc_bitops.ALIGN == 0
    view = base[1:]
    got = sc_bitops._aligned(view)
    assert got.data_ptr() % sc_bitops.ALIGN == 0
    assert got.data_ptr() != view.data_ptr() and torch.equal(got, view)
    assert sc_bitops._aligned(base).data_ptr() == base.data_ptr()
