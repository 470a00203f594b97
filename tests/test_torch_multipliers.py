"""The port's bit-level front end and multipliers (``repro_torch.core.tcu``,
``repro_torch.core.multipliers``) against the JAX package's, on the CPU:
the same numpy int32 operands (exhaustive grids or seeded draws) through
both, counts and streams exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multipliers as jm
from repro.core import tcu as jt
from repro_torch.core import multipliers as tm
from repro_torch.core import tcu as tt
from repro_torch.kernels import ref as tref

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


def _grid(bits):
    n = 1 << bits
    x, y = np.meshgrid(np.arange(n, dtype=np.int32),
                       np.arange(n, dtype=np.int32), indexing="ij")
    return x.reshape(-1), y.reshape(-1)


def _both(fn_jax, fn_torch, *arrays, **kw):
    """Run the JAX and port functions on the same numpy int32 inputs."""
    got_j = np.asarray(fn_jax(*(jnp.asarray(a, jnp.int32) for a in arrays),
                              **kw))
    got_t = fn_torch(*(torch.as_tensor(a) for a in arrays), **kw).numpy()
    return got_j, got_t


# ---------------------------------------------------------------------- tcu

@pytest.mark.parametrize("bits", range(2, 9))
def test_tcu_decode_and_correlation_encode_equal_jax_exhaustively(bits):
    v = np.arange(1 << bits, dtype=np.int32)
    for jfn, tfn in ((jt.tcu_decode, tt.tcu_decode),
                     (jt.correlation_encode, tt.correlation_encode)):
        got_j, got_t = _both(jfn, tfn, v, bits=bits)
        assert got_t.dtype == np.int8 and got_t.shape == got_j.shape
        np.testing.assert_array_equal(got_t, got_j)


@pytest.mark.parametrize("bits", [5, 6, 8])
def test_packed_words_equal_jax_and_round_trip(bits):
    x, y = _grid(bits)
    for jfn, tfn in ((jt.tcu_decode, tt.tcu_decode),
                     (jt.correlation_encode, tt.correlation_encode)):
        stream_j = jfn(jnp.asarray(x, jnp.int32), bits=bits, dtype=jnp.int32)
        stream_t = tfn(torch.as_tensor(x), bits=bits, dtype=torch.int32)
        words_j = np.asarray(jt.pack_stream(stream_j))
        words_t = tt.pack_stream(stream_t)
        assert words_t.dtype == torch.int64
        assert words_t.min() >= 0 and words_t.max() < 2 ** 32
        np.testing.assert_array_equal(words_t.numpy().astype(np.uint32),
                                      words_j.astype(np.uint32))
        assert torch.equal(tt.unpack_stream(words_t, dtype=torch.int32),
                           stream_t)
        # an int32 bit pattern of the same words unpacks the same
        as_i32 = torch.as_tensor(words_j.astype(np.uint32).view(np.int32))
        assert torch.equal(tt.unpack_stream(as_i32, dtype=torch.int32),
                           stream_t)


def test_pack_stream_refuses_ragged_streams():
    with pytest.raises(ValueError, match="multiple of 32"):
        tt.pack_stream(torch.zeros((2, 48), dtype=torch.int8))


def test_popcount_u32_equals_jax_on_seeded_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.asarray(jt.popcount_u32(jnp.asarray(words, jnp.uint32)))
    for t in (torch.as_tensor(words.astype(np.int64)),          # unsigned
              torch.as_tensor(words.view(np.int32))):           # bit pattern
        got = tt.popcount_u32(t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[1] == 32


# ---------------------------------------------------------- proposed design

@pytest.mark.parametrize("bits", range(2, 9))
def test_closed_form_equals_bitlevel_exhaustively(bits):
    x, y = (torch.as_tensor(a) for a in _grid(bits))
    closed = tm.proposed_closed_form(x, y, bits=bits)
    assert torch.equal(closed, tm.proposed_bitlevel(x, y, bits=bits))
    assert torch.equal(closed, tref.sc_stream_mul_ref(x, y, bits=bits))


@pytest.mark.parametrize("bits", [3, 8])
def test_proposed_forms_equal_jax_exhaustively(bits):
    x, y = _grid(bits)
    for jfn, tfn in ((jm.proposed_closed_form, tm.proposed_closed_form),
                     (jm.proposed_bitlevel, tm.proposed_bitlevel)):
        got_j, got_t = _both(jfn, tfn, x, y, bits=bits)
        assert got_t.dtype == np.int32
        np.testing.assert_array_equal(got_t, got_j)


def test_closed_form_has_one_copy():
    assert tref.proposed_closed_form is tm.proposed_closed_form


@pytest.mark.parametrize("x,y,exp_ou", [(4, 6, 3), (5, 3, 2), (3, 4, 1)])
def test_paper_table1_rows(x, y, exp_ou):
    """The paper's Table I worked examples at B = 3."""
    o = tm.proposed_closed_form(torch.tensor(x), torch.tensor(y), bits=3)
    assert int(o) == exp_ou


# ---------------------------------------------------------------- baselines

@pytest.mark.parametrize("bits", range(3, 9))
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "indep"])
def test_gaines_equals_jax_exhaustively(bits, shared):
    x, y = _grid(bits)
    # the default 0x5A where it lies inside the state space
    seed_y = 0x5A if 0x5A < (1 << bits) else 0x5A % ((1 << bits) - 1) + 1
    got_j, got_t = _both(jm.gaines, tm.gaines, x, y, bits=bits,
                         shared_sng=shared, seed_y=seed_y)
    np.testing.assert_array_equal(got_t, got_j)
    assert tm.gaines_period(bits) == jm.gaines_period(bits)


@pytest.mark.parametrize("operand_bits", [None, 8, 6, 3])
def test_jenson_equals_jax_exhaustively(operand_bits):
    x, y = _grid(8)
    got_j, got_t = _both(jm.jenson, tm.jenson, x, y, bits=8,
                         operand_bits=operand_bits)
    np.testing.assert_array_equal(got_t, got_j)
    assert (tm.jenson_cycles(8, operand_bits)
            == jm.jenson_cycles(8, operand_bits))


@pytest.mark.parametrize("variant", ["rate_temporal", "rate_rate_shared",
                                     "rate_rate_indep"])
@pytest.mark.parametrize("bits", [4, 8])
def test_umul_equals_jax_exhaustively(variant, bits):
    x, y = _grid(bits)
    got_j, got_t = _both(jm.umul, tm.umul, x, y, bits=bits, variant=variant)
    np.testing.assert_array_equal(got_t, got_j)


def test_gaines_rejects_bad_seeds_and_widths():
    """The JAX package's ValueErrors, word for word."""
    x = torch.arange(8, dtype=torch.int32)
    xj = jnp.arange(8, dtype=jnp.int32)
    cases = [dict(bits=8, seed_x=0), dict(bits=8, seed_x=256),
             dict(bits=4, shared_sng=False), dict(bits=2), dict(bits=9)]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jm.gaines(xj, xj, **kw)
        with pytest.raises(ValueError) as got:
            tm.gaines(x, x, **kw)
        assert str(got.value) == str(want.value)
    # seed_y is unused (and so not validated) when the SNG is shared
    assert int(tm.gaines(torch.tensor(3), torch.tensor(5), bits=4)) == 3


def test_other_errors_match_jax():
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="operand_bits must be <= bits"):
        tm.jenson(x, x, bits=4, operand_bits=5)
    with pytest.raises(ValueError, match="unknown uMUL variant 'bogus'"):
        tm.umul(x, x, bits=4, variant="bogus")
    with pytest.raises(ValueError, match="operand width"):
        tt.stream_length(0)


@pytest.mark.parametrize("name", ["proposed", "gaines", "jenson", "umul"])
def test_eval_functions_equal_jax(name):
    """The registry's float32 estimates, on the 8-bit grid: the same
    quotients of the same integer counts. (Called eagerly under x64, the
    JAX package's Jenson quotient is float64; its values are exact in
    float32, as they are inside its jitted error sweep.)"""
    x, y = _grid(8)
    got_j = np.asarray(jm.MULTIPLIERS[name](jnp.asarray(x), jnp.asarray(y),
                                            8))
    got_t = tm.MULTIPLIERS[name](torch.as_tensor(x), torch.as_tensor(y), 8)
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), got_j)
    assert list(tm.MULTIPLIERS) == list(jm.MULTIPLIERS)
