"""SC-GEMM in the PyTorch port held against the JAX package: exact counts
on identical planes, count-identical dispatch, and the ``sc_dense`` STE.

Inputs are made with numpy from a seed and cast to float32/int32 explicitly
(``tests/conftest.py`` turns on JAX x64 for the whole session)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sc_layers as jsc_layers
from repro.core.sc_numerics import quantize_sign_magnitude as jquant
from repro.core.sc_numerics import recover_counts as jrecover
from repro.kernels.ops import sc_matmul_pallas
from repro.kernels.ref import sc_matmul_counts_ref as jcounts_ref
from repro.kernels.sc_matmul import sc_matmul_counts_pallas
from repro_torch.core.sc_layers import sc_dense, sc_proj
from repro_torch.core.sc_matmul import (sc_matmul, sc_matmul_mxu_split,
                                        sc_matmul_reference)
from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.errors import ConfigError
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sc_matmul import (pack_signed, sc_matmul_counts,
                                           sc_matmul_counts_signed,
                                           sc_matmul_counts_signed_torch,
                                           sc_matmul_counts_torch)

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

# (M, K, N): decode-shaped M=4, ragged extents, a K past one Pallas block
SHAPES = [(4, 96, 40), (5, 33, 17), (16, 130, 72), (1, 64, 128),
          (9, 600, 20)]


def _planes(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    nmax = (1 << bits) - 1
    mx = rng.integers(0, nmax + 1, (m, k)).astype(np.int32)
    my = rng.integers(0, nmax + 1, (k, n)).astype(np.int32)
    sx = np.where(rng.random((m, k)) < 0.5, -1, 1).astype(np.int32)
    sy = np.where(rng.random((k, n)) < 0.5, -1, 1).astype(np.int32)
    return sx, mx, sy, my


def _pad(a, rows, cols, value):
    r, c = a.shape
    return np.pad(a, ((0, (-r) % rows), (0, (-c) % cols)),
                  constant_values=value)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_counts_equal_pallas_interpret_and_ref(shape, bits):
    m, k, n = shape
    sx, mx, sy, my = _planes(m, k, n, bits, seed=m * 1000 + k + n)
    bm, bn, bk = 8, 128, 128
    pallas = sc_matmul_counts_pallas(
        jnp.asarray(_pad(sx, bm, bk, 1)), jnp.asarray(_pad(mx, bm, bk, 0)),
        jnp.asarray(_pad(sy, bk, bn, 1)), jnp.asarray(_pad(my, bk, bn, 0)),
        bits=bits, bm=bm, bn=bn, bk=bk, chunk=8, interpret=True)
    pallas = np.asarray(pallas)[:m, :n].astype(np.int64)
    oracle = np.asarray(jcounts_ref(jnp.asarray(sx), jnp.asarray(mx),
                                    jnp.asarray(sy), jnp.asarray(my), bits))
    t = [torch.as_tensor(x) for x in (sx, mx, sy, my)]
    plain = sc_matmul_counts_torch(*t, bits).numpy()
    assert plain.dtype == np.float32
    np.testing.assert_array_equal(plain.astype(np.int64), pallas)
    np.testing.assert_array_equal(plain.astype(np.int64), oracle)
    np.testing.assert_array_equal(
        ref.sc_matmul_counts_ref(*t, bits).numpy(), oracle)
    # the kernel's signed-plane entry and the sign/magnitude entry agree
    a = pack_signed(t[0], t[1], bits)
    b = pack_signed(t[2], t[3], bits)
    np.testing.assert_array_equal(
        sc_matmul_counts_signed(a, b, bits=bits).numpy(), plain)
    np.testing.assert_array_equal(
        sc_matmul_counts_signed_torch(a, b, bits=bits).numpy(), plain)
    np.testing.assert_array_equal(sc_matmul_counts(*t, bits=bits).numpy(),
                                  plain)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(4, 96, 40), (7, 130, 33)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ops_sc_matmul_counts_equal_pallas_wrapper(shape, bits):
    """The port's kernel wrapper (plain on the CPU) against the JAX Pallas
    wrapper in interpret mode, compared through recovered integer counts —
    the f32 scales may differ by an ulp between the two frameworks."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    j = sc_matmul_pallas(jnp.asarray(a), jnp.asarray(b), bits=bits,
                         bm=8, bn=128, bk=128, chunk=8, row_quant=True,
                         interpret=True)
    t = ops.sc_matmul(torch.as_tensor(a), torch.as_tensor(b), bits=bits,
                      row_quant=True)
    want = jrecover(np.asarray(j), a, b, bits=bits, row_quant=True)
    got = jrecover(t.numpy(), a, b, bits=bits, row_quant=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("row_quant", [False, True])
def test_quantization_planes_equal_jax(row_quant):
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((6, 50)) * 3).astype(np.float32)
    axis = -1 if row_quant else None
    j = jquant(jnp.asarray(v), bits=8, axis=axis)
    t = quantize_sign_magnitude(torch.as_tensor(v), bits=8, axis=axis)
    np.testing.assert_array_equal(t.mag.numpy(), np.asarray(j.mag))
    np.testing.assert_array_equal(t.sign.numpy(), np.asarray(j.sign))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                               rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("impl", ["ref", "mxu_split", "pallas",
                                  "pallas_tuned", "auto"])
def test_dispatch_is_count_identical(impl):
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((5, 70)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((70, 24)).astype(np.float32))
    want = sc_matmul_reference(a, b, bits=8, row_quant=True)
    got = sc_matmul(a, b, bits=8, impl=impl, row_quant=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        sc_matmul_mxu_split(a, b, bits=8, chunk=7, row_quant=True).numpy(),
        want.numpy())
    np.testing.assert_array_equal(ref.sc_matmul_ref(a, b, 8, True).numpy(),
                                  want.numpy())


def test_impl_env_override(monkeypatch):
    from repro_torch.core.sc_matmul import IMPL_ENV, resolve_impl
    monkeypatch.setenv(IMPL_ENV, "ref")
    assert resolve_impl(None) == "ref" and resolve_impl("pallas") == "pallas"
    monkeypatch.setenv(IMPL_ENV, "bogus")
    with pytest.raises(ValueError):
        resolve_impl("auto")


def test_exactness_bound_is_enforced():
    a = torch.ones((2, 3000), dtype=torch.int16)
    b = torch.ones((3000, 4), dtype=torch.int16)
    with pytest.raises(ConfigError, match="2\\*\\*24"):
        sc_matmul_counts_signed(a, b, bits=13)


def test_wide_operands_take_int32_planes():
    """bits > 15 no longer fit int16 planes; counts stay exact."""
    sx, mx, sy, my = _planes(3, 40, 6, 16, seed=9)
    t = [torch.as_tensor(x) for x in (sx, mx, sy, my)]
    a, b = pack_signed(t[0], t[1], 16), pack_signed(t[2], t[3], 16)
    assert a.dtype == torch.int32
    oracle = np.asarray(jcounts_ref(*(jnp.asarray(x) for x in
                                      (sx, mx, sy, my)), 16))
    np.testing.assert_array_equal(
        sc_matmul_counts_signed(a, b, bits=16).numpy().astype(np.int64),
        oracle)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sc_dense_forward_equals_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 20)) * 0.2).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    xt = torch.as_tensor(np.array(xj.astype(jnp.float32))).to(tdt)
    wt = torch.as_tensor(np.array(wj.astype(jnp.float32))).to(tdt)
    j = jsc_layers.sc_dense(xj, wj, 8, "mxu_split")
    t = sc_dense(xt, wt, 8, "pallas")
    assert t.dtype == tdt and t.shape == (2, 3, 20)
    x2 = np.asarray(xj.astype(jnp.float32)).reshape(6, 48)
    w2 = np.asarray(wj.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_array_equal(
            jrecover(t.reshape(6, 20).numpy(), x2, w2, row_quant=True),
            jrecover(np.asarray(j).reshape(6, 20), x2, w2, row_quant=True))
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-6 if dtype == "float32" else 1e-2)


def test_sc_dense_ste_gradient_equals_jax():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 16)) * 0.2).astype(np.float32)
    g = rng.standard_normal((3, 16)).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jsc_layers.sc_dense(x, w, 8, "mxu_split") * g)

    gx_j, gw_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(w))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    (sc_dense(xt, wt, 8) * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=1e-5,
                               atol=1e-6)


def test_sc_proj_follows_the_config():
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal((2, 64)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((64, 8)).astype(np.float32))
    np.testing.assert_array_equal(sc_proj(x, w, cfg).numpy(), (x @ w).numpy())
    sc = cfg.__class__(**{**cfg.__dict__, "use_sc_gemm": True})
    np.testing.assert_array_equal(sc_proj(x, w, sc).numpy(),
                                  sc_dense(x, w, 8).numpy())
