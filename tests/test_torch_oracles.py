"""The port's attention oracles (``kernels/ref.py``) and
``core.error_analysis.sc_attention_divergence`` held against the JAX
package on the CPU, and the port's plain kernel versions held against the
oracles. Inputs are float32 from numpy seeds.

Tolerances, port oracle against JAX oracle on the same inputs:

* ``flash_attention_ref``: within 1e-6 of the largest output (float32
  einsum and softmax summed in other orders);
* ``sc_attention_scores_ref`` / ``sc_attention_pv_ref``: within an ulp of
  their scales, 1e-6 relative (the integer counts agree; the reference's
  jitted quantizer fuses its scale division differently from an eager
  division, the drift ``src/repro/kernels/sc_attention.py:30-35``
  describes);
* ``sc_flash_attention_ref`` / ``sc_decode_attention_ref``: within one
  probability step times the largest |v|, ``max|v| / (2**bits - 1)`` —
  an ulp of softmax can move one probability magnitude one step.

Plain kernel versions against the oracles, at the reference tests'
tolerances: float flash 2e-3 (``tests/test_kernels.py:177``); SC flash
``8 / (2**bits - 1)`` with the quantization group the whole key row
(``tests/test_sc_attention.py:130``, whose block is the row); SC decode,
paged and dense, windows and softcaps, ``2 / (2**bits - 1)``
(``tests/test_sc_attention.py:193``).

``sc_attention_divergence`` against the same statistics computed by the
JAX oracles on the port's draws, passed across as numpy: ``output_mad``
within 2e-6 of the largest exact output and ``score_mad`` within two
float32 ulps of the largest exact score — each oracle's values sit within
float32 roundings of JAX's (up to 7e-7 for outputs near 2), and the two
means, summed in float32 in other orders, move by up to the sum (1.3e-6
relative was seen for an output MAD near 0.08, 2.7e-6 for a score MAD
near 0.7).
The divergence falls from 2 to 4 to 8 bits, as the reference's flash test
expects (``tests/test_sc_attention.py:135-148``); at 6 and 8 bits it sits
on the multiplier's own bias, where neither package's falls (the JAX
package's own output MAD is 0.0897 at 6 bits and 0.0903 at 8 at the
defaults).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.error_analysis import (_attention_draws,
                                             sc_attention_divergence)
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.kernels.paged_attention import paged_attention_torch
from repro_torch.kernels.sc_attention import sc_pv, sc_scores
from repro_torch.models.layers import decode_attention

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

BITS = [4, 8]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_largest(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------- port oracle vs JAX

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 2), (3, 3), (4, 1)])
def test_flash_attention_ref_matches_jax(causal, h, kv):
    q, k, v = (_rand(s, shp) for s, shp in
               ((1, (2, h, 24, 16)), (2, (2, kv, 24, 16)),
                (3, (2, kv, 24, 16))))
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    want = jref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.float32
    _close_to_largest(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("bits", BITS)
def test_sc_attention_scores_ref_matches_jax(bits):
    q, k = _rand(bits, (2, 3, 5, 16)), _rand(bits + 100, (2, 3, 7, 16))
    got = ref.sc_attention_scores_ref(_t(q), _t(k), bits=bits)
    want = np.asarray(jref.sc_attention_scores_ref(q, k, bits=bits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", BITS)
def test_sc_attention_pv_ref_matches_jax(bits):
    p = np.asarray(jax.nn.softmax(_rand(bits, (2, 3, 5, 7)), axis=-1),
                   np.float32)
    v = _rand(bits + 200, (2, 3, 1, 7, 16))
    got = ref.sc_attention_pv_ref(_t(p), _t(v), bits=bits)
    want = np.asarray(jref.sc_attention_pv_ref(p, v, bits=bits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4)])
def test_sc_flash_attention_ref_matches_jax(bits, h, kv):
    q, k, v = (_rand(bits + s, shp) for s, shp in
               ((0, (2, h, 16, 16)), (1, (2, kv, 16, 16)),
                (2, (2, kv, 16, 16))))
    got = ref.sc_flash_attention_ref(_t(q), _t(k), _t(v), bits=bits)
    want = np.asarray(jref.sc_flash_attention_ref(q, k, v, bits=bits))
    tol = np.abs(v).max() / (2 ** bits - 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 5.0), (6, 5.0)])
def test_sc_decode_attention_ref_matches_jax(bits, window, softcap):
    q = _rand(bits, (3, 1, 4, 16))
    kc, vc = _rand(bits + 1, (3, 12, 2, 16)), _rand(bits + 2, (3, 12, 2, 16))
    pos = np.asarray([3, 7, 11], np.int32)
    got = ref.sc_decode_attention_ref(_t(q), _t(kc), _t(vc),
                                      q_position=_t(pos), bits=bits,
                                      window=window, logit_softcap=softcap)
    want = np.asarray(jref.sc_decode_attention_ref(
        q, kc, vc, q_position=pos, bits=bits, window=window,
        logit_softcap=softcap))
    assert got.shape == want.shape == (3, 1, 4, 16)
    tol = np.abs(vc).max() / (2 ** bits - 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_decode_oracle_takes_a_scalar_position():
    q = _t(_rand(1, (2, 1, 2, 8)))
    kc, vc = _t(_rand(2, (2, 6, 1, 8))), _t(_rand(3, (2, 6, 1, 8)))
    a = ref.sc_decode_attention_ref(q, kc, vc, q_position=4, bits=8)
    b = ref.sc_decode_attention_ref(q, kc, vc,
                                    q_position=torch.tensor([4, 4]), bits=8)
    assert torch.equal(a, b)


# ------------------------------------- plain kernel versions vs oracles

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1)])
def test_flash_plain_matches_oracle(causal, h, kv):
    q, k, v = (_t(_rand(s, shp)) for s, shp in
               ((7, (1, h, 40, 32)), (8, (1, kv, 40, 32)),
                (9, (1, kv, 40, 32))))
    out = flash_attention_torch(q, k, v, causal=causal, group=16)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (4, 1)])
def test_flash_plain_sc_matches_oracle(bits, h, kv):
    s, d = 48, 32
    q, k, v = (_t(_rand(bits * 7 + h + i, shp)) for i, shp in
               enumerate(((1, h, s, d), (1, kv, s, d), (1, kv, s, d))))
    out = flash_attention_torch(q, k, v, causal=True, group=s, sc_bits=bits)
    want = ref.sc_flash_attention_ref(q, k, v, bits=bits)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                               atol=8.0 / (2 ** bits - 1))


def _paginate(rows, block, gen):
    """Dense ``(C, S, KV, D)`` rows in shuffled pages of ``block`` keys,
    one trash page last; the block table."""
    c, s = rows.shape[:2]
    mb = s // block
    order = gen.permutation(c * mb)
    pages = torch.zeros((c * mb + 1, block, *rows.shape[2:]))
    tables = torch.empty((c, mb), dtype=torch.int32)
    for i in range(c):
        for j in range(mb):
            pid = int(order[i * mb + j])
            pages[pid] = rows[i, j * block:(j + 1) * block]
            tables[i, j] = pid
    return pages, tables


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("window", [None, 6])
def test_paged_plain_sc_matches_oracle(bits, window):
    c, s, h, kv, d = 3, 16, 4, 2, 16
    q = _t(_rand(bits, (c, 1, h, d)))
    kc, vc = _t(_rand(bits + 1, (c, s, kv, d))), _t(_rand(bits + 2,
                                                          (c, s, kv, d)))
    pos = torch.tensor([3, 9, 15], dtype=torch.int32)
    gen = np.random.default_rng(bits)
    kp, tables = _paginate(kc, 4, gen)
    vp, _ = _paginate(vc, 4, np.random.default_rng(bits))
    out = paged_attention_torch(q.reshape(c, kv, h // kv, d), kp, vp, tables,
                                pos, window=window, sc_bits=bits)
    want = ref.sc_decode_attention_ref(q, kc, vc, q_position=pos, bits=bits,
                                       window=window)
    np.testing.assert_allclose(out.reshape(c, 1, h, d).numpy(),
                               want.numpy(), rtol=0,
                               atol=2.0 / (2 ** bits - 1))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("window,softcap", [(None, 5.0), (6, 5.0),
                                            (6, None)])
def test_decode_attention_sc_matches_oracle(bits, window, softcap):
    """The model layer's dense decode (its gathered path serves softcap
    layers on the card too) against the decode oracle."""
    q = _t(_rand(bits, (3, 1, 4, 16)))
    kc, vc = _t(_rand(bits + 1, (3, 12, 2, 16))), _t(_rand(bits + 2,
                                                           (3, 12, 2, 16)))
    pos = torch.tensor([3, 7, 11], dtype=torch.int32)
    out = decode_attention(q, kc, vc, q_position=pos, window=window,
                           logit_softcap=softcap, sc_bits=bits)
    want = ref.sc_decode_attention_ref(q, kc, vc, q_position=pos, bits=bits,
                                       window=window, logit_softcap=softcap)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                               atol=2.0 / (2 ** bits - 1))


@pytest.mark.parametrize("bits", BITS)
def test_sc_helpers_match_oracles(bits):
    """The raw helpers the kernels' plain versions share, against the
    oracles built on the core ops (``tests/test_sc_attention.py:82-99``)."""
    q, k = _t(_rand(bits, (2, 3, 5, 16))), _t(_rand(bits + 100,
                                                    (2, 3, 7, 16)))
    np.testing.assert_allclose(
        sc_scores(q, k, bits=bits).numpy(),
        ref.sc_attention_scores_ref(q, k, bits=bits).numpy(), rtol=1e-6)
    p = torch.softmax(_t(_rand(bits, (2, 3, 5, 7))), dim=-1)
    v = _t(_rand(bits + 200, (2, 3, 1, 7, 16)))
    np.testing.assert_allclose(
        sc_pv(p, v, bits=bits).numpy(),
        ref.sc_attention_pv_ref(p, v, bits=bits).numpy(), rtol=1e-6,
        atol=1e-6)


# ---------------------------------------------- sc_attention_divergence

def _jax_statistics(q, k, v, bits, g):
    """JAX's output and score MADs and their tolerances (docstring)."""
    exact = jref.flash_attention_ref(q, k, v, causal=True)
    sc = jref.sc_flash_attention_ref(q, k, v, bits=bits, causal=True)
    kr = jnp.repeat(k, g, axis=1)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, kr,
                        preferred_element_type=jnp.float32)
    scores_sc = jref.sc_attention_scores_ref(q, kr, bits=bits)
    eps = float(np.finfo(np.float32).eps)
    return (float(jnp.mean(jnp.abs(exact - sc))),
            float(jnp.mean(jnp.abs(scores - scores_sc))),
            2e-6 * float(jnp.abs(exact).max()),
            2 * eps * float(jnp.abs(scores).max()))


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_sc_attention_divergence_matches_jax_on_its_draws(bits):
    kw = dict(b=2, kv=2, g=2, s=32, d=16, seed=3)
    got = sc_attention_divergence(bits, device="cpu", **kw)
    q, k, v = (t.numpy() for t in _attention_draws(
        **{n: kw[n] for n in ("b", "kv", "g", "s", "d", "seed")}))
    out_mad, score_mad, out_tol, score_tol = _jax_statistics(q, k, v, bits,
                                                             kw["g"])
    assert got["bits"] == bits
    assert abs(got["output_mad"] - out_mad) <= out_tol
    assert abs(got["score_mad"] - score_mad) <= score_tol


def test_sc_attention_divergence_falls_as_bits_rise():
    """More operand bits, closer to exact attention, at the defaults
    (``tests/test_sc_attention.py:135-148`` sweeps 2, 4 and 8 bits)."""
    rows = [sc_attention_divergence(bits, device="cpu") for bits in (2, 4, 8)]
    assert rows[0]["output_mad"] > rows[1]["output_mad"] > \
        rows[2]["output_mad"]
    assert rows[0]["score_mad"] > rows[1]["score_mad"] > rows[2]["score_mad"]
