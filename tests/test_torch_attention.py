"""Attention and layer primitives of the PyTorch port held against the JAX
package: the paged decode path's plain version against the gathered-dense
JAX formulation (``kernel_impl="jnp"``), dense decode attention, the flash
formulation chunked prefill uses, RMSNorm and RoPE.

Tolerance: rtol = atol = 1e-5 in float32 — the port sums by pairwise
halving (``layers.tree_sum``) where XLA picks its own order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.errors import ConfigError
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_torch)
from repro_torch.models import layers as tl

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_inputs(c, kv, g, d, block, mb, positions, seed, dtype=np.float32):
    """Page pools with fragmented tables: each slot's pages scattered over
    the pool, -1 past its last page (some slots also leave holes earlier
    pages never use)."""
    rng = np.random.default_rng(seed)
    n_pages = c * mb + 1
    perm = rng.permutation(n_pages - 1)
    tables = np.full((c, mb), -1, np.int32)
    used = 0
    for i, p in enumerate(positions):
        need = p // block + 1
        tables[i, :need] = perm[used:used + need]
        used += need
    q = rng.standard_normal((c, kv, g, d)).astype(dtype)
    k = rng.standard_normal((n_pages, block, kv, d)).astype(dtype)
    v = rng.standard_normal((n_pages, block, kv, d)).astype(dtype)
    return q, k, v, tables, np.asarray(positions, np.int32)


GEOMETRIES = [
    # (C, KV, G, D, block, MB, positions, window)
    (4, 5, 3, 64, 16, 4, [17, 63, 0, 40], None),      # smollm's head layout
    (4, 5, 3, 64, 16, 4, [33, 50, 5, 63], 12),        # ... with a window
    (3, 2, 2, 16, 4, 6, [7, 21, 13], None),           # reduced smollm
    (2, 2, 1, 16, 8, 3, [9, 23], 5),                  # full MHA, windowed
]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=range(len(GEOMETRIES)))
def test_paged_plain_equals_jax_gathered_dense(geom):
    c, kv, g, d, block, mb, positions, window = geom
    q, k, v, tables, qpos = _paged_inputs(c, kv, g, d, block, mb, positions,
                                          seed=sum(positions))
    h = kv * g
    want = jl.paged_decode_attention(
        jnp.asarray(q.reshape(c, 1, h, d)),
        jl.PagedKV(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables)),
        q_position=jnp.asarray(qpos), window=window, kernel_impl="jnp")
    want = np.asarray(want).reshape(c, kv, g, d)
    args = [torch.as_tensor(x) for x in (q, k, v, tables, qpos)]
    np.testing.assert_allclose(
        paged_attention_torch(*args, window=window).numpy(), want, **TOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_allclose(paged_attention(*args, window=window).numpy(),
                               want, **TOL)
    # and the model-layer dispatch, both through the wrapper and gathered
    paged = tl.PagedKV(args[1], args[2], args[3])
    for impl in ("auto", "jnp"):
        out = tl.paged_decode_attention(args[0].reshape(c, 1, h, d), paged,
                                        q_position=args[4], window=window,
                                        kernel_impl=impl)
        np.testing.assert_allclose(out.numpy().reshape(c, kv, g, d), want,
                                   **TOL)


def test_paged_bf16_pages_equal_jax():
    c, kv, g, d, block, mb = 2, 5, 3, 64, 16, 3
    q, k, v, tables, qpos = _paged_inputs(c, kv, g, d, block, mb, [20, 47],
                                          seed=4)
    qj, kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jl.paged_decode_attention(
        qj.reshape(c, 1, kv * g, d), jl.PagedKV(kj, vj, jnp.asarray(tables)),
        q_position=jnp.asarray(qpos), kernel_impl="jnp")
    qt, kt, vt = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in (qj, kj, vj))
    got = paged_attention(qt, kt, vt, torch.as_tensor(tables),
                          torch.as_tensor(qpos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want.astype(jnp.float32)).reshape(c, kv, g, d),
        rtol=1.6e-2, atol=1e-2)


def test_paged_wrapper_refuses_what_it_does_not_serve():
    q, k, v, tables, qpos = (torch.as_tensor(x) for x in _paged_inputs(
        1, 2, 2, 8, 4, 2, [3], seed=0))
    # SC scores at 2..8 bits are served; other widths are refused
    out = paged_attention(q, k, v, tables, qpos, sc_bits=8)
    assert out.shape == q.shape and torch.isfinite(out).all()
    for bits in (1, 9):
        with pytest.raises(ConfigError, match="SC attention"):
            paged_attention(q, k, v, tables, qpos, sc_bits=bits)
    # a logit softcap is served: the result is the gathered formulation's
    # (the plain version is that formulation); a cap that is not > 0 is
    # refused
    got = paged_attention(q, k, v, tables, qpos, logit_softcap=30.0)
    want = tl._decode_attention_plain(
        q.reshape(1, 1, 4, 8), tl._gather_pages(k, tables),
        tl._gather_pages(v, tables), q_position=qpos, logit_softcap=30.0)
    assert torch.equal(got.reshape(want.shape), want)
    assert not torch.equal(got, paged_attention(q, k, v, tables, qpos))
    for cap in (0.0, -30.0):
        with pytest.raises(ConfigError, match="softcap"):
            paged_attention(q, k, v, tables, qpos, logit_softcap=cap)
    with pytest.raises(ConfigError, match="layout"):
        paged_attention(q[0], k, v, tables, qpos)


def _wrapper_calls(monkeypatch):
    """Calls that reach the paged kernel's wrapper (on the CPU its plain
    version; ``paged_attention.launches`` counts launches on the card)."""
    import repro_torch.kernels.paged_attention as pa
    calls, wrapped = [], pa.paged_attention

    def spy(*args, **kw):
        calls.append(kw.get("logit_softcap"))
        return wrapped(*args, **kw)
    monkeypatch.setattr(pa, "paged_attention", spy)
    return calls


def test_paged_eligibility_keeps_softcap_and_single_kv_mha_gathered(
        monkeypatch):
    """Float single-KV-head full MHA stays gathered; a softcap layer takes
    the kernel's route (the kernel applies the cap)."""
    assert tl._paged_kernel_eligible(3, 5)              # smollm, head_dim 64
    assert not tl._paged_kernel_eligible(1, 1)          # KV == 1, G == 1
    assert tl._paged_kernel_eligible(1, 2)
    calls = _wrapper_calls(monkeypatch)
    for kv, g in ((2, 2), (1, 1)):
        q, k, v, tables, qpos = (torch.as_tensor(x) for x in _paged_inputs(
            2, kv, g, 8, 4, 3, [5, 9], seed=kv))
        out = tl.paged_decode_attention(
            q.reshape(2, 1, kv * g, 8), tl.PagedKV(k, v, tables),
            q_position=qpos, logit_softcap=30.0)
        want = tl._decode_attention_plain(
            q.reshape(2, 1, kv * g, 8), tl._gather_pages(k, tables),
            tl._gather_pages(v, tables), q_position=qpos, logit_softcap=30.0)
        assert torch.equal(out, want)
    assert calls == [30.0]                  # the GQA layout only


@pytest.mark.parametrize("w,window", [(1, None), (3, None), (1, 6)])
def test_decode_attention_equals_jax(w, window):
    rng = np.random.default_rng(w)
    b, s, kv, g, d = 3, 20, 2, 2, 16
    q = rng.standard_normal((b, w, kv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    qpos = np.asarray([4, 11, 15], np.int32)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_position=jnp.asarray(qpos), window=window)
    got = tl.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v),
                              q_position=torch.as_tensor(qpos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", [
    dict(sq=12, skv=12, qb=4, kb=8, window=None, offset=0),
    dict(sq=8, skv=32, qb=8, kb=16, window=None, offset=10),   # chunk step
    dict(sq=16, skv=16, qb=16, kb=16, window=5, offset=0),
], ids=["prefill", "chunk", "window"])
def test_flash_formulation_equals_jax(case):
    rng = np.random.default_rng(case["sq"])
    b, h, kv, d = 2, 4, 2, 16
    sq, skv = case["sq"], case["skv"]
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    qp = np.broadcast_to(case["offset"] + np.arange(sq, dtype=np.int32),
                         (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    kw = dict(causal=True, window=case["window"], q_block=case["qb"],
              kv_block=case["kb"])
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_positions=jnp.asarray(qp),
                              kv_positions=jnp.asarray(kp), kernel_impl="jnp",
                              **kw)
    got = tl.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), q_positions=torch.as_tensor(qp),
                             kv_positions=torch.as_tensor(kp), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_and_rope_equal_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    for plus_one in (False, True):
        np.testing.assert_allclose(
            tl.rms_norm(torch.as_tensor(x), torch.as_tensor(w),
                        plus_one=plus_one).numpy(),
            np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w),
                                   plus_one=plus_one)), **TOL)
    pos = np.asarray([[0, 1, 2, 7, 100], [3, 4, 5, 6, 255]], np.int32)
    cj, sj = jl.rope(jnp.asarray(pos), 16, 10000.0)
    ct, st = tl.rope(torch.as_tensor(pos), 16, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(
        tl.apply_rope(torch.as_tensor(x), ct, st).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), cj, sj)), **TOL)


def test_tree_sum_is_invariant_to_batch_and_trailing_zeros():
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal((5, 37)).astype(np.float32))
    row = tl.tree_sum(x[2:3], -1)
    assert torch.equal(tl.tree_sum(x, -1)[2:3], row)
    padded = torch.cat([x, torch.zeros((5, 90))], dim=1)
    assert torch.equal(tl.tree_sum(padded, -1), tl.tree_sum(x, -1))
    np.testing.assert_allclose(tl.tree_sum(x, 0).numpy(), x.sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)
