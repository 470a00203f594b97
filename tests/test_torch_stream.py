"""The bit-parallel stream multiplier of the port (``kernels/sc_bitops.py``,
``kernels/ops.py::sc_stream_mul``, the stream oracles of ``kernels/ref.py``)
against the JAX package's, on the CPU, where the wrapper takes the plain
version. The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sc_bitops import _correlation_word, _thermo_word
from repro_torch.core.multipliers import proposed_closed_form
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.sc_bitops import (correlation_word,
                                           sc_stream_mul_cuda,
                                           sc_stream_mul_torch, thermo_word)

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


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
    with pytest.raises(ConfigError, match="Queue 1 #13"):
        ops.sc_stream_mul(x, x, bits=8, tune=True)
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
