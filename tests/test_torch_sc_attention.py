"""SC attention of the PyTorch port held against the JAX package: the four
helpers (``kernels/sc_attention.py``), the flash kernel's plain version
against ``flash_attention_pallas`` in interpret mode, and the plain SC
flash, decode and paged formulations against the JAX jnp and
gathered-dense paths.

Tolerances: integer planes and counts exactly equal; scales within 1 ulp;
float outputs rtol = atol = 1e-5 in float32 (the port sums by pairwise
halving where XLA picks its own order). SC outputs after a softmax: XLA's
and PyTorch's exp may differ in the last ulp, and a probability that lands
within that ulp of a rounding boundary moves one magnitude step, which
moves an output by at most one quantization step ``max|v| / (2**bits -
1)``; so those are held to that step, and all but 1% of their elements to
1e-5. The two reference bitwise tests that fail under jax 0.9 are not used
as oracles."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sc_attention as jsc
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as jl
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError
from repro_torch.kernels import sc_attention as tsc
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_torch)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import layers as tl

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

TOL = dict(rtol=1e-5, atol=1e-5)
ALL_BITS = range(2, 9)


def _assert_sc_close(got, want, v, bits):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    step = np.abs(np.asarray(v)).max() / (stream_length(bits) - 1)
    assert err.max() <= step, (err.max(), step)
    assert (err > 1e-5).mean() <= 0.01, (err > 1e-5).mean()


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------- helpers

@pytest.mark.parametrize("bits", ALL_BITS)
def test_quant_rows_planes_equal_jax(bits):
    v = _normal(bits, (3, 7, 40), scale=3.0)
    v[0, 0, :3] = (-0.0, 0.0, -1e-9)         # signed zeros, tiny negatives
    v[1, 2] = 0.0                            # an all-zero row: scale 1e-12/n
    j = jsc.sc_quant_rows(jnp.asarray(v), bits)
    t = tsc.sc_quant_rows(torch.as_tensor(v), bits)
    np.testing.assert_array_equal(t.mag.numpy(), np.asarray(j.mag))
    np.testing.assert_array_equal(t.sign.numpy(), np.asarray(j.sign))
    assert t.sign[0, 0, 0] == 1                # -0.0 is +1
    np.testing.assert_array_max_ulp(t.scale.numpy(), np.asarray(j.scale),
                                    maxulp=1)


@pytest.mark.parametrize("bits", ALL_BITS)
def test_popcount_exhaustive_equals_jax(bits):
    x = np.arange(stream_length(bits), dtype=np.int32)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    got = tsc.sc_popcount(torch.as_tensor(xx), torch.as_tensor(yy), bits)
    want = jsc.sc_popcount(jnp.asarray(xx), jnp.asarray(yy), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the closed form counts the set bits of X_u AND Y_u: never more than
    # either operand's ones, and O(0, y) = 0
    assert (got.numpy() <= np.minimum(xx, yy)).all()
    assert (got.numpy()[0] == 0).all()


def _counts(scores, q, k, bits, quant):
    """Exact integer counts behind dequantized scores, recovered with the
    producer's own scales (float64, so the division is exact)."""
    qs = np.asarray(quant(q, bits).scale, np.float64)
    ks = np.asarray(quant(k, bits).scale, np.float64)
    denom = stream_length(bits) * qs * np.swapaxes(ks, -1, -2)
    return np.round(np.asarray(scores, np.float64) / denom).astype(np.int64)


@pytest.mark.parametrize("bits", [2, 4, 6, 8])
def test_scores_counts_equal_jax(bits):
    q = _normal(bits, (2, 3, 5, 24))
    k = _normal(bits + 50, (2, 3, 9, 24), scale=2.0)
    js = jsc.sc_scores(jnp.asarray(q), jnp.asarray(k), bits=bits)
    ts = tsc.sc_scores(torch.as_tensor(q), torch.as_tensor(k), bits=bits)
    np.testing.assert_array_equal(
        _counts(ts.numpy(), torch.as_tensor(q), torch.as_tensor(k), bits,
                tsc.sc_quant_rows),
        _counts(js, jnp.asarray(q), jnp.asarray(k), bits, jsc.sc_quant_rows))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [2, 4, 6, 8])
def test_pv_equals_jax(bits):
    p = np.array(jax.nn.softmax(jnp.asarray(_normal(bits, (2, 3, 5, 11))),
                                  axis=-1))
    p[0, 0, 0, 4:] = 0.0                     # masked keys: exact zeros
    v = _normal(bits + 9, (2, 3, 1, 11, 16))
    got = tsc.sc_pv(torch.as_tensor(p), torch.as_tensor(v), bits=bits)
    want = jsc.sc_pv(jnp.asarray(p), jnp.asarray(v), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_magnitude_contributes_exact_zero():
    q = torch.zeros((1, 2, 16))
    k = torch.as_tensor(_normal(3, (1, 5, 16), scale=100.0))
    s = tsc.sc_scores(q, k, bits=8)
    assert (s == 0).all() and not torch.signbit(s).any()
    y = torch.arange(256, dtype=torch.int32)
    assert (tsc.sc_popcount(torch.zeros_like(y), y, 8) == 0).all()


def test_sc_bits_are_checked():
    for bits in (None, 2, 8):
        tsc.check_sc_bits(bits)
    for bits in (1, 9, 16):
        with pytest.raises(ConfigError, match="2...8"):
            tsc.check_sc_bits(bits)


# -------------------------------------------- flash: plain version vs Pallas

def _flash_inputs(b, h, kv, sq, skv, d, seed):
    return (_normal(seed, (b, h, sq, d)), _normal(seed + 1, (b, kv, skv, d)),
            _normal(seed + 2, (b, kv, skv, d)))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,h,kv,sq,skv,d,bq,bk", [
    (1, 2, 2, 256, 256, 128, 128, 128),    # MHA square
    (2, 4, 2, 256, 512, 128, 128, 256),    # GQA, longer kv
    (1, 8, 1, 512, 512, 128, 256, 512),    # MQA
], ids=["mha", "gqa", "mqa"])
def test_flash_wrapper_plain_equals_pallas(b, h, kv, sq, skv, d, bq, bk,
                                           causal):
    """The port's flash wrapper on the CPU (its plain version) against the
    TPU kernel in interpret mode at ``tests/test_kernels.py``'s shapes."""
    q, k, v = _flash_inputs(b, h, kv, sq, skv, d, seed=b * 100 + h)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, bq=bq, bk=bk,
                                  interpret=True)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal=causal, group=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("b,h,kv", [(1, 2, 2), (1, 4, 2), (1, 4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_wrapper_plain_sc_equals_pallas(b, h, kv, bits):
    """SC at ``tests/test_sc_attention.py``'s kernel shapes, the
    quantization group pinned to the kernel's ``bk``."""
    q, k, v = _flash_inputs(b, h, kv, 128, 128, 128, seed=b * 7 + h)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, bq=128, bk=64,
                                  interpret=True, sc_bits=bits)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal=True, group=64,
                          sc_bits=bits)
    _assert_sc_close(got.numpy(), want, v, bits)


def test_flash_full_mask_ignores_the_padding_past_skv():
    """Non-causal at a ragged Skv: the zero keys that pad Skv up to the
    group are no keys (the kernel reads none of them), so the plain version
    equals an exact softmax over the Skv real keys (float64, atol 1e-5)."""
    q, k, v = _flash_inputs(1, 4, 2, 9, 21, 16, seed=40)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal=False, group=8)
    kr = np.repeat(k, 2, axis=1).astype(np.float64)
    vr = np.repeat(v, 2, axis=1).astype(np.float64)
    s = q.astype(np.float64) @ kr.swapaxes(-1, -2) / 4.0
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ vr
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------- plain formulations vs jnp paths

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", [
    dict(h=4, kv=2, sq=24, skv=24, qb=8, kb=8, offset=0, window=None),
    dict(h=4, kv=4, sq=24, skv=24, qb=8, kb=8, offset=0, window=None),
    dict(h=4, kv=2, sq=8, skv=32, qb=8, kb=16, offset=10, window=None),
    dict(h=4, kv=1, sq=16, skv=16, qb=16, kb=8, offset=0, window=5),
], ids=["gqa", "mha", "chunk", "window"])
def test_flash_formulation_sc_equals_jax(case, bits):
    b, d = 2, 16
    sq, skv = case["sq"], case["skv"]
    q = _normal(bits + sq, (b, sq, case["h"], d))
    k = _normal(bits + sq + 1, (b, skv, case["kv"], d))
    v = _normal(bits + sq + 2, (b, skv, case["kv"], d))
    qp = np.broadcast_to(case["offset"] + np.arange(sq, dtype=np.int32),
                         (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    kw = dict(causal=True, window=case["window"], q_block=case["qb"],
              kv_block=case["kb"], sc_bits=bits)
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_positions=jnp.asarray(qp),
                              kv_positions=jnp.asarray(kp), kernel_impl="jnp",
                              **kw)
    args = (torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    pos = dict(q_positions=torch.as_tensor(qp),
               kv_positions=torch.as_tensor(kp))
    got = tl.flash_attention(*args, **pos, kernel_impl="jnp", **kw)
    _assert_sc_close(got.numpy(), want, v, bits)
    if case["window"] is None:
        # through the kernel's wrapper (its plain version here): the same
        via = tl.flash_attention(*args, **pos, kernel_impl="pallas_tuned",
                                 q_offset=case["offset"], **kw)
        assert torch.equal(via, got)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_sc_equals_jax(bits, window):
    b, s, h, kv, d = 3, 12, 4, 2, 16
    q = _normal(bits, (b, 1, h, d))
    kc = _normal(bits + 1, (b, s, kv, d))
    vc = _normal(bits + 2, (b, s, kv, d))
    pos = np.asarray([3, 7, 11], np.int32)
    want = jax.jit(functools.partial(jl.decode_attention, window=window,
                                     sc_bits=bits))(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        q_position=jnp.asarray(pos))
    got = tl.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                              torch.as_tensor(vc),
                              q_position=torch.as_tensor(pos), window=window,
                              sc_bits=bits)
    _assert_sc_close(got.numpy(), want, vc, bits)


def test_decode_sc_extent_and_batch_invariant():
    """Garbage rows past every position and co-batched rows change no bit
    of the plain version: masked keys are exact zero terms, scales are per
    row, and every sum is a tree sum."""
    b, h, kv, d = 3, 4, 2, 16
    kc, vc = _normal(1, (b, 48, kv, d)), _normal(2, (b, 48, kv, d))
    q = torch.as_tensor(_normal(3, (b, 1, h, d)))
    pos = torch.as_tensor([40, 47, 9], dtype=torch.int32)
    base = tl.decode_attention(q, torch.as_tensor(kc), torch.as_tensor(vc),
                               q_position=pos, sc_bits=8)
    grown = [torch.as_tensor(np.concatenate([x, 1e3 * _normal(4, (b, 16, kv,
                                                                  d))], 1))
             for x in (kc, vc)]
    assert torch.equal(base, tl.decode_attention(q, *grown, q_position=pos,
                                                 sc_bits=8))
    for i in range(b):
        solo = tl.decode_attention(q[i:i + 1], torch.as_tensor(kc[i:i + 1]),
                                   torch.as_tensor(vc[i:i + 1]),
                                   q_position=pos[i:i + 1], sc_bits=8)
        assert torch.equal(solo, base[i:i + 1])


@functools.partial(jax.jit, static_argnums=(5, 6))
def _jax_paged(q, kp, vp, tables, pos, window, bits):
    return jl.paged_decode_attention(q, jl.PagedKV(kp, vp, tables),
                                     q_position=pos, window=window,
                                     kernel_impl="jnp", sc_bits=bits)


def _paged_problem(seed, *, c, h, kv, d, mb, block):
    rng = np.random.default_rng(seed)
    n_pages = c * mb + 2
    kp = rng.standard_normal((n_pages, block, kv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, block, kv, d)).astype(np.float32)
    q = rng.standard_normal((c, 1, h, d)).astype(np.float32)
    perm = rng.permutation(n_pages - 1)
    tables = np.full((c, mb), -1, np.int32)
    pos = np.zeros(c, np.int32)
    at = 0
    for i in range(c):
        n = int(rng.integers(1, mb + 1))
        tables[i, :n] = perm[at:at + n]
        at += n
        pos[i] = rng.integers((n - 1) * block, n * block)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("c,h,kv,d,mb,block,window", [
    (3, 4, 2, 16, 4, 4, None),      # fragmented GQA
    (2, 4, 2, 16, 3, 4, 6),         # window straddling pages
    (2, 4, 4, 16, 3, 4, None),      # full MHA
    (2, 4, 1, 16, 4, 4, None),      # single KV head (SC only)
    (3, 15, 5, 64, 4, 16, None),    # smollm's head layout
])
def test_paged_sc_equals_jax_gathered_dense(c, h, kv, d, mb, block, window,
                                            bits):
    q, kp, vp, tables, pos = _paged_problem(c * 37 + mb + bits, c=c, h=h,
                                            kv=kv, d=d, mb=mb, block=block)
    g = h // kv
    want = np.asarray(_jax_paged(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tables),
                                 jnp.asarray(pos), window, bits))
    args = [torch.as_tensor(x) for x in (kp, vp, tables, pos)]
    tq = torch.as_tensor(q)
    got = paged_attention(tq[:, 0].reshape(c, kv, g, d), *args, window=window,
                          sc_bits=bits)
    _assert_sc_close(got.numpy().reshape(c, 1, h, d), want, vp, bits)
    paged = tl.PagedKV(*args[:3])
    for impl in ("auto", "jnp"):
        out = tl.paged_decode_attention(tq, paged, q_position=args[3],
                                        window=window, kernel_impl=impl,
                                        sc_bits=bits)
        assert torch.equal(out, got.reshape(c, 1, h, d))


def test_sc_widens_the_paged_gate_but_not_softcap(monkeypatch):
    """SC serves every head layout, single-KV MHA included, and a softcap
    layer takes the kernel's route on the SC path too (the kernel applies
    the cap); widths outside 2..8 are not served."""
    import repro_torch.kernels.paged_attention as pa
    assert not tl._paged_kernel_eligible(1, 1)
    assert tl._paged_kernel_eligible(1, 1, sc_bits=8)
    assert tl._paged_kernel_eligible(3, 5, sc_bits=8)
    assert not tl._paged_kernel_eligible(3, 5, sc_bits=9)
    calls, wrapped = [], pa.paged_attention

    def spy(*args, **kw):
        calls.append((kw.get("logit_softcap"), kw.get("sc_bits")))
        return wrapped(*args, **kw)
    monkeypatch.setattr(pa, "paged_attention", spy)
    q, kp, vp, tables, pos = _paged_problem(5, c=2, h=4, kv=1, d=16, mb=3,
                                            block=4)
    args = [torch.as_tensor(x) for x in (kp, vp, tables, pos)]
    out = tl.paged_decode_attention(torch.as_tensor(q), tl.PagedKV(*args[:3]),
                                    q_position=args[3], logit_softcap=30.0,
                                    sc_bits=8)
    want = tl._decode_attention_plain(
        torch.as_tensor(q), tl._gather_pages(args[0], args[2]),
        tl._gather_pages(args[1], args[2]), q_position=args[3],
        logit_softcap=30.0, sc_bits=8)
    assert torch.equal(out, want)
    assert calls == [(30.0, 8)]


def test_flash_gate_drops_alignment_keeps_features():
    ok = dict(causal=True, window=None, logit_softcap=None, bf16_probs=False,
              kv_block=64, d=64)
    assert tl._flash_kernel_eligible(**ok)
    assert tl._flash_kernel_eligible(**ok, sc_bits=2)
    assert tl._flash_kernel_eligible(**ok, sc_bits=8)
    for bad in (dict(sc_bits=1), dict(sc_bits=9), dict(causal=False),
                dict(window=8), dict(logit_softcap=30.0),
                dict(bf16_probs=True), dict(d=512), dict(kv_block=4096)):
        assert not tl._flash_kernel_eligible(**{**ok, **bad}), bad


# ------------------------------------------------- row invariance, backward

@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
def test_chunked_rows_equal_oneshot_rows(bits):
    """The prefill contract the kernel keeps on the card, held here by its
    plain version: 16-row chunks at their staging offsets over a larger
    extent (garbage past the filled prefix) give the one-shot rows bit for
    bit, with the group ``min(kv_block, extent)`` each call site passes."""
    h, kv, d, s, kv_block = 6, 2, 16, 48, 1024
    q = torch.as_tensor(_normal(11, (1, h, s, d)))
    k = torch.as_tensor(_normal(12, (1, kv, s, d)))
    v = torch.as_tensor(_normal(13, (1, kv, s, d)))
    one = flash_attention_torch(q, k, v, group=min(kv_block, s),
                                sc_bits=bits)
    for off, extent in ((0, 64), (16, 64), (32, 128)):
        kx = torch.as_tensor(_normal(14, (1, kv, extent, d), scale=50.0))
        vx = torch.as_tensor(_normal(15, (1, kv, extent, d), scale=50.0))
        kx[:, :, :s], vx[:, :, :s] = k, v
        got = flash_attention_torch(q[:, :, off:off + 16], kx, vx,
                                    q_offset=off, group=min(kv_block, extent),
                                    sc_bits=bits)
        assert torch.equal(got, one[:, :, off:off + 16]), (off, extent)


def test_kernel_call_backward_is_the_plain_vjp():
    """The kernel's autograd wrapper recomputes its backward through the
    plain formulation: the same gradients as differentiating the plain
    formulation itself."""
    b, s, h, kv, d = 1, 12, 4, 2, 16
    base = [torch.as_tensor(_normal(20 + i, shape)) for i, shape in
            enumerate(((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))]
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    grad = torch.as_tensor(_normal(30, (b, s, h, d)))
    grads = {}
    for impl in ("pallas_tuned", "jnp"):
        leaves = [t.clone().requires_grad_() for t in base]
        out = tl.flash_attention(*leaves, q_positions=pos, kv_positions=pos,
                                 q_block=4, kv_block=8, kernel_impl=impl,
                                 q_offset=0)
        out.backward(grad)
        grads[impl] = [t.grad for t in leaves]
    for a, b_ in zip(grads["pallas_tuned"], grads["jnp"]):
        assert a is not None and torch.equal(a, b_)
