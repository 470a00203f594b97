"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need a CUDA device and skip elsewhere; this file imports
no JAX, so it runs where the card is (the machine has no JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.) ``chip_smoke.py``
checks the same kernels at the main path's shapes; here the geometries are
the odd ones: ragged extents, every row-block width, page sizes that are
not tile multiples, windows, single-KV-head layouts, score rows too long
for shared memory. Float and SC attention alike; the engine's streams are
held to the sequential baseline with each.
"""
import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.configs.registry import ARCHS
from repro_torch.errors import ConfigError
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_torch,
                                                 sc_tolerance)
from repro_torch.core.multipliers import proposed_closed_form
from repro_torch.kernels import ops
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import (RANKS, paged_attention,
                                                 paged_attention_torch)
from repro_torch.kernels.paged_attention import plan as paged_plan
from repro_torch.kernels.sc_bitops import (sc_stream_mul_cuda,
                                           sc_stream_mul_torch)
from repro_torch.kernels.sc_matmul import (pack_signed, pack_weight, plan,
                                           sc_linear, sc_linear_torch,
                                           sc_matmul_counts_signed,
                                           sc_matmul_counts_signed_torch)
from repro_torch.launch.serve import generate
from repro_torch.models import bind, layers
from repro_torch.serving import Engine, Request

pytestmark = pytest.mark.gpu

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _tuner_cache(tmp_path, monkeypatch):
    """The autotuner's cache ("auto" on the card sweeps and writes it) in
    the test's own directory: every test sweeps afresh."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU "
                    "or interpret mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _planes(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    nmax = (1 << bits) - 1
    sx = np.where(rng.random((m, k)) < 0.5, -1, 1)
    sy = np.where(rng.random((k, n)) < 0.5, -1, 1)
    mx = rng.integers(0, nmax + 1, (m, k))
    my = rng.integers(0, nmax + 1, (k, n))
    a = pack_signed(torch.as_tensor(sx), torch.as_tensor(mx), bits)
    b = pack_signed(torch.as_tensor(sy), torch.as_tensor(my), bits)
    return a, b


@pytest.mark.parametrize("m,k,n,bits", [
    (1, 960, 320, 8), (2, 33, 17, 8), (3, 129, 65, 8), (4, 960, 960, 8),
    (5, 1000, 333, 8), (8, 64, 31, 4), (16, 2560, 960, 8), (40, 96, 200, 8),
    (4, 600, 50, 12), (3, 200, 96, 16), (7, 0, 9, 8), (20, 200, 99, 16),
    (64, 2560, 960, 8), (9, 4000, 50, 12)])
def test_sc_counts_kernel_equals_plain(cuda, m, k, n, bits):
    a, b = _planes(m, k, n, bits, seed=m * 7 + k + n)
    a, b = a.to(cuda), b.to(cuda)
    before = sc_matmul_counts_signed.launches
    got = sc_matmul_counts_signed(a, b, bits=bits)
    assert sc_matmul_counts_signed.launches == before + 1
    want = sc_matmul_counts_signed_torch(a, b, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# smollm-360m's projections (K, N): q/o, k/v, w1/w3, w2 and the LM head
SMOLLM_SHAPES = [(960, 960), (960, 320), (960, 2560), (2560, 960),
                 (960, 49152)]


def _fused_case(m, k, n, bits, dtype, seed, cuda):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((k, n)) * k ** -0.5,
                        dtype=torch.float32)
    return x.to(dtype).to(cuda), pack_weight(w.to(dtype).to(cuda), bits)


@pytest.mark.parametrize("m,k,n,bits,dtype", [
    *[(m, k, n, 8, torch.bfloat16) for m in (1, 4, 16, 64)
      for k, n in SMOLLM_SHAPES],
    *[(m, 200, 96, bits, torch.float32) for m in (4, 20)
      for bits in range(1, 9)],
    (8, 130, 72, 8, torch.float32), (9, 130, 72, 8, torch.float32),
    (16, 130, 72, 8, torch.bfloat16), (17, 130, 72, 8, torch.bfloat16),
    (7, 1000, 333, 8, torch.bfloat16), (37, 129, 65, 8, torch.float32),
    (3, 200, 96, 16, torch.float32), (20, 200, 99, 16, torch.bfloat16)])
def test_fused_kernel_equals_plain(cuda, m, k, n, bits, dtype):
    """The fused projection is bit-equal to its plain version (the unfused
    chain on the same packed weight) in the packed 16-bit (bits <= 8) and
    int32 forms, one launch a call."""
    x, pw = _fused_case(m, k, n, bits, dtype, m * 31 + k + n + bits, cuda)
    before = sc_linear.launches
    got = sc_linear(x, pw)
    assert sc_linear.launches == before + 1
    want = sc_linear_torch(x, pw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("bits,dtype", [(8, torch.bfloat16), (8, torch.float32),
                                        (4, torch.float32),
                                        (16, torch.float32)])
@pytest.mark.parametrize("m,k", [(6, 250), (20, 130)])
def test_fused_kernel_rows_holding_nan_or_inf(cuda, m, k, bits, dtype):
    """A row holding a NaN, an Inf or a -Inf comes out NaN, as in the
    plain version on the card (the row absmax carries the NaN through);
    the other rows stay bit-equal."""
    x, pw = _fused_case(m, k, 72, bits, dtype, m + k + bits, cuda)
    x = x.clone()
    x[1, 5], x[3, k - 1], x[4, 0] = math.nan, math.inf, -math.inf
    got, want = sc_linear(x, pw), sc_linear_torch(x, pw)
    bad = torch.zeros(m, dtype=torch.bool, device=cuda)
    bad[[1, 3, 4]] = True
    assert torch.equal(got.isnan().all(1), bad)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got[~bad], want[~bad])


@pytest.mark.parametrize("m,k,n", [(4, 960, 960), (16, 960, 320),
                                   (64, 2560, 960), (9, 960, 49152)])
def test_fused_rows_equal_their_one_row_calls(cuda, m, k, n):
    """Batch invariance: the K split and the row tile depend on M, the
    bits of a row do not."""
    x, pw = _fused_case(m, k, n, 8, torch.bfloat16, m + k, cuda)
    assert plan(m, n, k, 132) != plan(1, n, k, 132)
    whole = sc_linear(x, pw)
    for i in range(m):
        assert torch.equal(whole[i:i + 1], sc_linear(x[i:i + 1], pw))


def test_fused_wrapper_never_falls_back_on_the_card(cuda):
    x, pw = _fused_case(4, 64, 16, 8, torch.float32, 0, cuda)
    with pytest.raises(ConfigError, match="float32 or bfloat16"):
        sc_linear(x.half(), pw)
    with pytest.raises(ConfigError, match="device"):
        sc_linear(x, pw.to("cpu"))
    with pytest.raises(ConfigError, match="rows must be"):
        sc_linear(x[:, :32], pw)


def _paged(c, kv, g, d, block, mb, positions, seed, dtype, cuda):
    rng = np.random.default_rng(seed)
    n_pages = c * mb + 1
    perm = rng.permutation(n_pages - 1)
    tables = np.full((c, mb), -1, np.int32)
    used = 0
    for i, p in enumerate(positions):
        need = min(p // block + 1, mb)
        tables[i, :need] = perm[used:used + need]
        used += need
    q = torch.as_tensor(rng.standard_normal((c, kv, g, d)), dtype=dtype)
    k = torch.as_tensor(rng.standard_normal((n_pages, block, kv, d)),
                        dtype=dtype)
    v = torch.as_tensor(rng.standard_normal((n_pages, block, kv, d)),
                        dtype=dtype)
    return [t.to(cuda) for t in (q, k, v, torch.as_tensor(tables),
                                 torch.as_tensor(positions, dtype=torch.int32))]


# f32: the online softmax reassociates the sums over 32-token tiles; bf16:
# both sides round the float32 result to bf16 once
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [
    # (C, KV, G, D, block, MB, positions, window)
    (4, 5, 3, 64, 64, 4, [0, 63, 64, 255], None),    # page edges
    (4, 5, 3, 64, 64, 4, [100, 200, 31, 32], 17),
    (3, 2, 2, 16, 4, 6, [7, 21, 13], None),          # pages under one tile
    (2, 2, 1, 16, 48, 3, [95, 50], 5),               # page not a tile multiple
    (2, 1, 4, 128, 32, 4, [127, 40], None),          # one KV head, D=128
    (1, 8, 2, 256, 16, 2, [31], None),               # big D: dynamic smem
    (4, 4, 7, 128, 64, 4, [100, 255, 37, 64], None),  # qwen2-7b: G 7
    (4, 8, 5, 128, 64, 4, [100, 255, 37, 64], None),  # qwen2.5-14b: G 5
], ids=range(8))
def test_paged_kernel_equals_plain(cuda, geom, dtype):
    c, kv, g, d, block, mb, positions, window = geom
    args = _paged(c, kv, g, d, block, mb, positions, sum(positions), dtype,
                  cuda)
    before, sc0 = paged_attention.launches, paged_attention.sc.launches
    got = paged_attention(*args, window=window)
    assert paged_attention.launches == before + 1 and got.dtype == dtype
    assert paged_attention.sc.launches == sc0
    want = paged_attention_torch(*args, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_dense_decode_runs_the_paged_kernel(cuda):
    """A dense cache on the card is one page per sequence."""
    rng = np.random.default_rng(3)
    b, s, kv, g, d = 3, 40, 2, 3, 32
    q, k, v = (torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(cuda)
               for shape in ((b, 1, kv * g, d), (b, s, kv, d), (b, s, kv, d)))
    pos = torch.as_tensor([0, 17, 39], dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    got = layers.decode_attention(q, k, v, q_position=pos)
    assert paged_attention.launches == before + 1
    want = layers._decode_attention_plain(q, k, v, q_position=pos)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("block", [32, 64])
def test_engine_streams_equal_sequential_baseline_on_the_card(cuda, block):
    """Batch invariance on the card: a reduced smollm (float32, SC-GEMM on)
    served through the engine emits the sequential baseline's tokens."""
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                              use_sc_gemm=True).validate()
    params = bind(cfg, cuda).init_params(0)
    rng = np.random.default_rng(block)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 30, 17, 5, 40)]
    gens = [5, 12, 7, 20, 9]
    engine = Engine(cfg, params, device=cuda, capacity=3, max_seq=64,
                    block=block, chunk=16)
    fused0, counts0 = sc_linear.launches, sc_matmul_counts_signed.launches
    res = engine.run([Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
                      for i, (p, g) in enumerate(zip(prompts, gens))])
    st = engine.stats
    # one fused launch a projection; no weight quantized per call. A
    # prefill shape's capture (at its first use in the run) launches too,
    # in its tuning pass and warm-up runs
    from repro_torch.launch.steps import EAGER_RUNS
    assert sc_linear.launches - fused0 == (7 * cfg.n_layers + 1) * (
        st["decode_steps"] + st["prefill_chunks"]
        + EAGER_RUNS * st["prefill_captures"])
    assert sc_matmul_counts_signed.launches == counts0
    for r, p, g in zip(res, prompts, gens):
        ref = generate(cfg, params, p[None], gen_tokens=g, device=cuda)
        np.testing.assert_array_equal(r.tokens, ref[0].cpu().numpy())


# ------------------------------------------------------- SC attention slice

def _sc_close(got, want, v, bits, tol):
    """Kernel vs plain version under SC: the scores and quantized planes
    repeat the plain float32 operations one for one, so all but 1% of the
    elements meet the float tolerance; a probability within an ulp of a
    rounding boundary may move one magnitude step, so no element may differ
    by more than one output quantization step ``max|v| / (2**bits - 1)``
    plus that tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = (sc_tolerance(v, bits) + tol["atol"]
             + tol["rtol"] * want.abs().max().item())
    assert err.max().item() <= bound, (err.max().item(), bound)
    loose = ~torch.isclose(got, want, **tol)
    assert loose.float().mean().item() <= 0.01


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [
    # (B, H, KV, Sq, Skv, D, q_offset, group, causal)
    (1, 15, 5, 64, 64, 64, 0, 64, True),       # smollm one-shot
    (1, 15, 5, 16, 128, 64, 32, 128, True),    # smollm chunk over a bucket
    (2, 6, 2, 37, 53, 128, 16, 24, True),      # ragged, D 128, small group
    (2, 4, 4, 45, 45, 128, 0, 32, True),       # G 1
    (1, 3, 1, 5, 300, 32, 290, 300, True),     # one KV head, long row
    (1, 4, 2, 33, 47, 64, 0, 16, False),       # not causal
], ids=range(6))
def test_flash_kernel_equals_plain(cuda, geom, dtype, bits):
    b, h, kv, sq, skv, d, off, group, causal = geom
    rng = np.random.default_rng(sq * 7 + skv)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype
                               ).to(cuda)
               for shape in ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d)))
    kw = dict(causal=causal, q_offset=off, group=group, sc_bits=bits)
    before, sc0 = flash_attention.launches, flash_attention.sc.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    assert flash_attention.sc.launches == sc0 + (bits is not None)
    want = flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    else:
        _sc_close(got, want, v, bits, TOL[dtype])


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_chunked_rows_equal_oneshot_rows_bitwise(cuda, dtype, bits):
    """Through the kernel: 16-row chunks at their staging offsets over
    larger extents (garbage past the prompt) give the one-shot rows bit for
    bit, with the group ``min(kv_block, extent)`` each call site passes."""
    rng = np.random.default_rng(5)
    h, kv, s, d = 15, 5, 64, 64
    q = torch.as_tensor(rng.standard_normal((1, s, h, d)), dtype=dtype
                        ).to(cuda).transpose(1, 2)
    k, v = (torch.as_tensor(rng.standard_normal((1, kv, s, d)), dtype=dtype
                            ).to(cuda) for _ in range(2))
    one = flash_attention(q, k, v, q_offset=0, group=s, sc_bits=bits)
    for off in (0, 16, 32, 48):
        for extent in (64, 128, 256):
            kx, vx = (torch.as_tensor(50 * rng.standard_normal(
                (1, kv, extent, d)), dtype=dtype).to(cuda) for _ in range(2))
            kx[:, :, :s], vx[:, :, :s] = k, v
            got = flash_attention(q[:, :, off:off + 16], kx, vx, q_offset=off,
                                  group=extent, sc_bits=bits)
            assert torch.equal(got, one[:, :, off:off + 16]), (off, extent)


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_chunked_rows_bitwise_with_nan_past_the_chunk(cuda, dtype,
                                                            bits):
    """The staging cache past the chunk holds NaN (rows not written yet):
    the kernel must never let those key rows reach its arithmetic, so the
    chunk's rows still equal the one-shot rows bit for bit."""
    rng = np.random.default_rng(6)
    h, kv, s, d = 15, 5, 64, 64
    q = torch.as_tensor(rng.standard_normal((1, s, h, d)), dtype=dtype
                        ).to(cuda).transpose(1, 2)
    k, v = (torch.as_tensor(rng.standard_normal((1, kv, s, d)), dtype=dtype
                            ).to(cuda) for _ in range(2))
    one = flash_attention(q, k, v, q_offset=0, group=s, sc_bits=bits)
    for off in (0, 16, 32, 48):
        for extent in (64, 128, 256):
            kx, vx = (torch.full((1, kv, extent, d), math.nan, dtype=dtype,
                                 device=cuda) for _ in range(2))
            kx[:, :, :off + 16], vx[:, :, :off + 16] = (k[:, :, :off + 16],
                                                         v[:, :, :off + 16])
            got = flash_attention(q[:, :, off:off + 16], kx, vx, q_offset=off,
                                  group=extent, sc_bits=bits)
            assert torch.equal(got, one[:, :, off:off + 16]), (off, extent)


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
@pytest.mark.parametrize("geom", [
    # (H, KV, Sq, Skv, D, q_offset): 2,048-token prompts at group 1024
    (15, 5, 2048, 2048, 64, 0),      # L1: smollm one-shot
    (15, 5, 16, 2048, 64, 2032),     # L2: its last chunk
    (28, 4, 2048, 2048, 128, 0),     # L3: qwen2-7b's width
    (16, 1, 300, 1100, 128, 800),    # G 16 over two groups, ragged
], ids=["L1", "L2", "L3", "g16"])
def test_flash_kernel_long_prompts_equal_plain(cuda, geom, bits):
    h, kv, sq, skv, d, off = geom
    rng = np.random.default_rng(sq + skv + d)
    q = torch.as_tensor(rng.standard_normal((1, sq, h, d)),
                        dtype=torch.bfloat16).to(cuda).transpose(1, 2)
    k, v = (torch.as_tensor(rng.standard_normal((1, skv, kv, d)),
                            dtype=torch.bfloat16).to(cuda).transpose(1, 2)
            for _ in range(2))
    kw = dict(q_offset=off, group=1024, sc_bits=bits)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16])
    else:
        _sc_close(got, want, v, bits, TOL[torch.bfloat16])


def test_flash_plan_matches_the_compiled_kernel(cuda):
    """``flash_attention.smem_bytes`` (the wrapper's plan) equals the
    kernel's own formula, read through the C entry, for every path."""
    from repro_torch.kernels import flash_attention as fa
    entry = fa._entries()["smem_bytes"]
    for path, code in (("f32", 0), ("mma", 1), ("sc", 2)):
        for heads in (1, 3, 4, 7, 8):
            for m_tiles in (1, 2, 4):
                for d in (32, 64, 112, 128):
                    for group in (16, 100, 1024, 2048):
                        for esz in (2, 4):
                            want = fa.smem_bytes(path, heads, m_tiles, d,
                                                 group, esz)
                            got = entry(code, esz, heads, m_tiles, d, group)
                            assert got == want, (path, heads, m_tiles, d,
                                                 group, esz)


def test_flash_kernel_backward_is_the_plain_vjp(cuda):
    """The kernel's autograd wrapper differentiates through the plain
    formulation: its gradients equal autograd's through that formulation."""
    rng = np.random.default_rng(9)
    b, s, h, kv, d = 2, 24, 6, 2, 32
    base = [torch.as_tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(cuda)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    grad = torch.as_tensor(rng.standard_normal((b, s, h, d)),
                           dtype=torch.float32).to(cuda)
    pos = torch.arange(s, dtype=torch.int32, device=cuda).expand(b, s)
    kw = dict(q_positions=pos, kv_positions=pos, q_block=8, kv_block=16)
    grads, outs = {}, {}
    for impl in ("auto", "jnp"):
        leaves = [t.clone().requires_grad_() for t in base]
        out = layers.flash_attention(*leaves, kernel_impl=impl, q_offset=0,
                                     **kw)
        out.backward(grad)
        grads[impl], outs[impl] = [t.grad for t in leaves], out.detach()
    torch.testing.assert_close(outs["auto"], outs["jnp"],
                               **TOL[torch.float32])
    # the same float32 recompute on both sides; only the card's choice of
    # reduction kernels in autograd's own backward could reorder a sum
    for a, b_ in zip(grads["auto"], grads["jnp"]):
        assert a is not None
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [
    # (C, KV, G, D, block, MB, positions, window)
    (4, 5, 3, 64, 64, 4, [0, 63, 64, 255], None),
    (4, 5, 3, 64, 64, 4, [100, 200, 31, 32], 17),
    (3, 2, 2, 16, 4, 6, [7, 21, 13], None),          # pages under one tile
    (2, 1, 1, 64, 48, 3, [95, 50], None),            # KV 1, G 1: SC only
    (2, 2, 4, 128, 256, 80, [20000, 300], None),     # a long row
], ids=range(5))
def test_paged_sc_kernel_equals_plain(cuda, geom, dtype, bits):
    c, kv, g, d, block, mb, positions, window = geom
    args = _paged(c, kv, g, d, block, mb, positions, sum(positions) + bits,
                  dtype, cuda)
    before, sc0 = paged_attention.launches, paged_attention.sc.launches
    got = paged_attention(*args, window=window, sc_bits=bits)
    assert paged_attention.launches == before + 1 and got.dtype == dtype
    assert paged_attention.sc.launches == sc0 + 1
    want = paged_attention_torch(*args, window=window, sc_bits=bits)
    torch.cuda.synchronize()
    _sc_close(got, want, args[2], bits, TOL[dtype])


def test_dense_sc_decode_runs_the_paged_kernel(cuda):
    rng = np.random.default_rng(4)
    b, s, kv, g, d = 3, 40, 1, 1, 32
    q, k, v = (torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(cuda)
               for shape in ((b, 1, kv * g, d), (b, s, kv, d), (b, s, kv, d)))
    pos = torch.as_tensor([0, 17, 39], dtype=torch.int32, device=cuda)
    before = paged_attention.launches
    got = layers.decode_attention(q, k, v, q_position=pos, sc_bits=8)
    assert paged_attention.launches == before + 1
    want = layers._decode_attention_plain(q, k, v, q_position=pos, sc_bits=8)
    _sc_close(got, want, v, 8, TOL[torch.float32])


# ------------------------------------------------- paged kernel invariances

def _rows(c, s, kv, g, d, dtype, seed, cuda):
    """q (C, KV, G, D) and dense K/V rows (C, S, KV, D) from a seed."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), dtype=dtype).to(cuda)
            for shape in ((c, kv, g, d), (c, s, kv, d), (c, s, kv, d))]


def _paginate(k_rows, v_rows, block, seed):
    """Lay dense rows (C, S, KV, D) out in pages of ``block`` keys scattered
    over a pool in a random order, the trash page last; ``block=None`` is
    the dense view (one page per slot, as ``layers.decode_attention``
    passes a dense cache)."""
    c, s, kv, d = k_rows.shape
    if block is None:
        return k_rows, v_rows, torch.arange(c, dtype=torch.int32,
                                            device=k_rows.device)[:, None]
    mb = -(-s // block)
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(c * mb),
                           device=k_rows.device)
    pools = []
    for rows in (k_rows, v_rows):
        pool = torch.zeros((c * mb + 1, block, kv, d), dtype=rows.dtype,
                           device=rows.device)
        pool[perm] = torch.nn.functional.pad(
            rows, (0, 0, 0, 0, 0, mb * block - s)).reshape(c * mb, block,
                                                           kv, d)
        pools.append(pool)
    return pools[0], pools[1], perm.reshape(c, mb).to(torch.int32)


@pytest.mark.parametrize("window", [None, 100], ids=["full", "window"])
@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_softcap_kernel_equals_plain(cuda, dtype, bits, window):
    """gemma2-9b's decode layout (KV 8, G 2, D 256) with its logit softcap
    50: the kernel caps each scaled score before the masks, as the plain
    version does; the tolerances are the float and SC paths' own (the
    cap's tanh on the card and in PyTorch may part by an ulp). Scores
    are scaled up so the cap bends them."""
    args = _paged(4, 8, 2, 256, 64, 4, [255, 100, 37, 64], 50 + (bits or 0),
                  dtype, cuda)
    args[0] = (args[0].float() * 8).to(dtype)
    def counts():
        return (paged_attention.launches, paged_attention.sc.launches,
                paged_attention.softcap.launches,
                paged_attention.sc.softcap.launches)
    launches = counts()
    got = paged_attention(*args, window=window, logit_softcap=50.0,
                          sc_bits=bits)
    sc = bits is not None
    assert counts() == (launches[0] + 1, launches[1] + sc, launches[2] + 1,
                        launches[3] + sc)
    want = paged_attention_torch(*args, window=window, logit_softcap=50.0,
                                 sc_bits=bits)
    uncapped = paged_attention_torch(*args, window=window, sc_bits=bits)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    else:
        _sc_close(got, want, args[2], bits, TOL[dtype])
    assert (uncapped.float() - want.float()).abs().max() > 0.05


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
def test_paged_softcap_kernel_is_bitwise_paging_invariant(cuda, bits):
    """With the softcap, as without: the same rows at block 16, 64 and
    256 and as the dense view give identical outputs."""
    q, k_rows, v_rows = _rows(2, 700, 8, 2, 256, torch.bfloat16, 23, cuda)
    q = (q.float() * 8).to(torch.bfloat16)
    pos = torch.tensor([650, 333], dtype=torch.int32, device=cuda)
    outs = {block: paged_attention(q, *_paginate(k_rows, v_rows, block,
                                                 seed=block or 0), pos,
                                   window=300, logit_softcap=50.0,
                                   sc_bits=bits)
            for block in (16, 64, 256, None)}
    for block, out in outs.items():
        assert torch.equal(out, outs[None]), block


@pytest.mark.parametrize("window", [None, 300], ids=["full", "window"])
@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_is_bitwise_paging_invariant(cuda, dtype, bits, window):
    """The same slots' rows laid out at block 16, 32, 48, 64 and 256 and as
    the dense view give identical outputs: tiles start at absolute key
    multiples of 32, whatever the page size."""
    q, k_rows, v_rows = _rows(2, 700, 5, 3, 64, dtype, 21, cuda)
    pos = torch.tensor([650, 333], dtype=torch.int32, device=cuda)
    outs = {}
    for block in (16, 32, 48, 64, 256, None):
        kp, vp, tables = _paginate(k_rows, v_rows, block, seed=block or 0)
        outs[block] = paged_attention(q, kp, vp, tables, pos, window=window,
                                      sc_bits=bits)
    for block, out in outs.items():
        assert torch.equal(out, outs[None]), block
    want = paged_attention_torch(q, *_paginate(k_rows, v_rows, None, 0),
                                 pos, window=window, sc_bits=bits)
    if bits is None:
        torch.testing.assert_close(outs[None].float(), want.float(),
                                   **TOL[dtype])
    else:
        _sc_close(outs[None], want, v_rows, bits, TOL[dtype])


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_is_bitwise_batch_invariant(cuda, dtype, bits):
    """A slot launched alone (C = 1) gives the bits it gives among three
    other slots at other positions."""
    q, k_rows, v_rows = _rows(4, 300, 5, 3, 64, dtype, 22, cuda)
    kp, vp, tables = _paginate(k_rows, v_rows, 64, seed=3)
    pos = torch.tensor([100, 255, 37, 64], dtype=torch.int32, device=cuda)
    together = paged_attention(q, kp, vp, tables, pos, sc_bits=bits)
    for i in range(4):
        alone = paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                pos[i:i + 1], sc_bits=bits)
        assert torch.equal(alone, together[i:i + 1]), i


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [
    # (C, KV, G, D, block, MB, positions, window, SC scores in a workspace)
    (2, 2, 3, 64, 64, 150, [8500, 9599], None, False),   # 8k+ keys a slot
    (1, 2, 4, 64, 256, 160, [40000], None, True),        # 80 KB a rank
    (2, 5, 3, 64, 64, 20, [1000, 1270], 300, False),     # window opens mid-tile
    (3, 2, 2, 112, 32, 8, [255, 17, 200], 7, False),     # D 112: 224-byte rows
], ids=range(4))
def test_paged_kernel_long_rows_and_windows(cuda, geom, dtype, bits):
    c, kv, g, d, block, mb, positions, window, workspace = geom
    esz = 4 if dtype == torch.float32 else 2
    assert (paged_plan(c, kv, g, d, block, mb, 8, esz=esz).workspace
            is not None) == workspace
    if window:          # the first key mid-tile, in a tile that is not rank 0's
        first = positions[0] - window + 1
        assert first % 32 and first // 32 % RANKS
    args = _paged(c, kv, g, d, block, mb, positions, sum(positions), dtype,
                  cuda)
    before = paged_attention.launches
    got = paged_attention(*args, window=window, sc_bits=bits)
    assert paged_attention.launches == before + 1
    want = paged_attention_torch(*args, window=window, sc_bits=bits)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    else:
        _sc_close(got, want, args[2], bits, TOL[dtype])


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
def test_paged_kernel_many_clusters_and_idle_slots(cuda, bits):
    """C = 64 (320 clusters), slots at position -1 among them: an idle
    slot's cluster writes zeros and returns together, the live slots equal
    the plain version, and nothing waits on a cluster that left."""
    rng = np.random.default_rng(64)
    positions = [int(p) for p in rng.integers(0, 256, 64)]
    positions[0] = positions[5] = positions[63] = -1
    args = _paged(64, 5, 3, 64, 64, 4, [max(p, 0) for p in positions], 64,
                  torch.bfloat16, cuda)
    args[4] = torch.tensor(positions, dtype=torch.int32, device=cuda)
    got = paged_attention(*args, sc_bits=bits)
    torch.cuda.synchronize()
    want = paged_attention_torch(*args, sc_bits=bits)
    live = args[4] >= 0
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    if bits is None:
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   **TOL[torch.bfloat16])
    else:
        _sc_close(got[live], want[live], args[2], bits, TOL[torch.bfloat16])


def test_paged_plan_matches_the_compiled_kernel(cuda):
    """The wrapper's plan and the kernel agree on the cluster size and on
    every launch's shared memory."""
    lib = build.load("paged_attention")
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    assert lib.paged_attention_ranks() == RANKS
    for g, d in ((3, 64), (16, 128), (2, 256), (1, 112), (7, 128)):
        for esz in (2, 4):
            for bits, mb in ((None, 4), (8, 4), (8, 64), (8, 2048)):
                p = paged_plan(4, 5, g, d, 16, mb, bits, esz=esz)
                got = lib.paged_attention_smem_bytes(
                    int(bits is not None), esz, g, d, p.share,
                    int(p.workspace is None))
                assert got == p.smem_bytes, (g, d, esz, bits, mb)


def test_wrappers_never_fall_back_on_the_card(cuda):
    """A CUDA tensor the kernels do not take raises; it is never handed to
    the plain version."""
    q = torch.zeros((1, 2, 4, 16), dtype=torch.float16, device=cuda)
    with pytest.raises(ConfigError, match="f32 or bf16"):
        flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ConfigError, match="device"):
        flash_attention(q.float(), q[:, :1].float().cpu(),
                        q[:, :1].float().cpu())


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_engine_sc_attention_streams_equal_baseline_on_the_card(cuda, mode):
    """SC-GEMM and SC attention at 8 bits on a reduced smollm (float32):
    the engine's streams equal the sequential baseline's, prefill through
    the flash kernel and decode through the paged kernel."""
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                              use_sc_gemm=True, attn_sc=True,
                              sc_bits=8).validate()
    params = bind(cfg, cuda).init_params(0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (9, 30, 17, 5, 40)]
    gens = [5, 12, 7, 20, 9]
    engine = Engine(cfg, params, device=cuda, capacity=3, max_seq=64,
                    block=32, chunk=16, prefill_mode=mode)
    flash0, paged0 = flash_attention.launches, paged_attention.launches
    res = engine.run([Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
                      for i, (p, g) in enumerate(zip(prompts, gens))])
    assert flash_attention.launches > flash0
    assert paged_attention.launches > paged0
    for r, p, g in zip(res, prompts, gens):
        ref = generate(cfg, params, p[None], gen_tokens=g, device=cuda)
        np.testing.assert_array_equal(r.tokens, ref[0].cpu().numpy())


@pytest.mark.parametrize("bits", [5, 6, 7, 8])
def test_stream_kernel_equals_plain_exhaustively(cuda, bits):
    """Every operand pair at B = 5..8: the kernel's counts equal the plain
    version's and the closed form's exactly."""
    n = 1 << bits
    x, y = torch.meshgrid(torch.arange(n, dtype=torch.int32, device=cuda),
                          torch.arange(n, dtype=torch.int32, device=cuda),
                          indexing="ij")
    x, y = x.reshape(-1), y.reshape(-1)
    got = sc_stream_mul_cuda(x, y, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_stream_mul_torch(x, y, bits=bits))
    assert torch.equal(got, proposed_closed_form(x, y, bits=bits))


@pytest.mark.parametrize("block_rows", [1, 3, 8])
def test_stream_kernel_equals_plain_on_a_seeded_12_bit_sample(cuda,
                                                              block_rows):
    rng = np.random.default_rng(12 + block_rows)
    x, y = (torch.as_tensor(rng.integers(0, 1 << 12, (5, 2049)),
                            dtype=torch.int32).to(cuda) for _ in range(2))
    x[0, :3] = torch.tensor([0, 4095, 2048], dtype=torch.int32)
    y[0, :3] = torch.tensor([4095, 0, 2048], dtype=torch.int32)
    got = ops.sc_stream_mul(x, y, bits=12, block_rows=block_rows)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    assert torch.equal(got, sc_stream_mul_torch(x, y, bits=12))
    assert torch.equal(got, proposed_closed_form(x, y, bits=12))


@pytest.mark.parametrize("bits", [9, 11, 16])
def test_stream_kernel_equals_plain_on_seeded_random_samples(cuda, bits):
    """2^20 random pairs: msb set and clear inside every warp's elements,
    the chunk loop's fixed-B instances at 9, 11 and 16."""
    rng = np.random.default_rng(200 + bits)
    x, y = (torch.as_tensor(rng.integers(0, 1 << bits, 1 << 20),
                            dtype=torch.int32).to(cuda) for _ in range(2))
    got = ops.sc_stream_mul(x, y, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, sc_stream_mul_torch(x, y, bits=bits))
    assert torch.equal(got, proposed_closed_form(x, y, bits=bits))


@pytest.mark.parametrize("bits", [17, 20])
def test_stream_kernel_run_time_width_equals_closed_form(cuda, bits):
    """B > 16 runs the instance whose chunk count is read at run time."""
    rng = np.random.default_rng(bits)
    x, y = (torch.as_tensor(rng.integers(0, 1 << bits, 4099),
                            dtype=torch.int32).to(cuda) for _ in range(2))
    got = ops.sc_stream_mul(x, y, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, proposed_closed_form(x, y, bits=bits))


@pytest.mark.parametrize("n", [1, 31, 100_003])
@pytest.mark.parametrize("block_rows", [1, 8])
def test_stream_kernel_ragged_sizes(cuda, n, block_rows):
    """The thread straddling the end loads and stores element by element."""
    rng = np.random.default_rng(n)
    x, y = (torch.as_tensor(rng.integers(0, 1 << 10, n),
                            dtype=torch.int32).to(cuda) for _ in range(2))
    got = ops.sc_stream_mul(x, y, bits=10, block_rows=block_rows)
    torch.cuda.synchronize()
    assert got.shape == (n,)
    assert torch.equal(got, proposed_closed_form(x, y, bits=10))


def test_stream_kernel_takes_a_view_at_storage_offset_one(cuda):
    """``x[1:]`` starts 4 bytes past a 16-byte boundary: the wrapper
    copies it to an aligned buffer instead of refusing it."""
    rng = np.random.default_rng(1)
    x, y = (torch.as_tensor(rng.integers(0, 1 << 12, 10_001),
                            dtype=torch.int32).to(cuda) for _ in range(2))
    xv, yv = x[1:], y[1:]
    assert xv.data_ptr() % 16 != 0
    before = sc_stream_mul_cuda.launches
    got = ops.sc_stream_mul(xv, yv, bits=12)
    torch.cuda.synchronize()
    assert sc_stream_mul_cuda.launches == before + 1
    assert torch.equal(got, proposed_closed_form(xv, yv, bits=12))


def test_stream_wrapper_counts_launches_and_never_falls_back(cuda):
    x = torch.arange(300, dtype=torch.int32, device=cuda) % 256
    before = sc_stream_mul_cuda.launches
    ops.sc_stream_mul(x, x.flip(0), bits=8)
    assert sc_stream_mul_cuda.launches == before + 1
    ops.sc_stream_mul(x[:0], x[:0], bits=8)        # empty: nothing launched
    assert sc_stream_mul_cuda.launches == before + 1
    with pytest.raises(ConfigError, match="int32"):
        sc_stream_mul_cuda(x.long(), x.long(), bits=8)
    with pytest.raises(ConfigError, match="device"):
        sc_stream_mul_cuda(x, x.cpu(), bits=8)
    with pytest.raises(ConfigError, match="block_rows"):
        ops.sc_stream_mul(x, x, bits=8, block_rows=16)
    assert sc_stream_mul_cuda.launches == before + 1


# ----------------------------------------------------- decode graphs


def _graph_cfg(attn_sc: bool):
    return dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                               use_sc_gemm=True, attn_sc=attn_sc,
                               sc_bits=8).validate()


def _graph_requests(cfg):
    rng = np.random.default_rng(13)
    lens, gens = (9, 30, 17, 5, 22), (5, 12, 7, 14, 9)
    return [Request(uid=f"r{i}",
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=(n,)).astype(np.int32),
                    max_new_tokens=g)
            for i, (n, g) in enumerate(zip(lens, gens))]


GRAPH_ENGINE = dict(capacity=2, max_seq=64, block=16, chunk=16)


class _Recording(Engine):
    """An engine that keeps every decode step's logit rows."""

    def _decode_once(self):
        rows = super()._decode_once()
        self.rows = getattr(self, "rows", []) + [rows]
        return rows


@pytest.mark.parametrize("attn_sc,kw", [
    (False, {}), (True, {}), (False, dict(prefill_mode="oneshot")),
    (True, dict(fused=False)), (False, dict(paged=False))],
    ids=["fused-float", "fused-sc", "oneshot", "gather-sc", "contiguous"])
def test_graph_replay_logits_bitwise_equal_the_eager_step(cuda, attn_sc, kw):
    """Five requests through two slots, so requests are admitted and
    evicted between decode steps (one-shot: an eager SC-GEMM prefill on
    the default stream between replays): every decode step's logit rows
    from the replayed graph equal the eager step's bit for bit."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(attn_sc)
    params = bind(cfg, cuda).init_params(0)
    runs = {}
    for graphs in (False, True):
        eng = _Recording(cfg, params, device=cuda, graphs=graphs,
                         **GRAPH_ENGINE, **kw)
        runs[graphs] = (eng, eng.run(_graph_requests(cfg)))
    (eager, eager_res), (graphed, res) = runs[False], runs[True]
    assert graphed.graphs and not eager.graphs
    assert len(graphed.rows) == len(eager.rows) >= 12
    for i, (g, e) in enumerate(zip(graphed.rows, eager.rows)):
        np.testing.assert_array_equal(g, e, err_msg=f"decode step {i}")
    for r, e in zip(res, eager_res):
        np.testing.assert_array_equal(r.tokens, e.tokens)
    assert graphed._decode.captures == 1
    assert graphed._decode.replays == len(graphed.rows)
    steps.clear_decode_steps()


def test_one_capture_per_shape_over_engine_runs(cuda):
    """The default engine on the card is graphed; a second engine of the
    shape (another prefill mode) replays the same capture."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    params = bind(cfg, cuda).init_params(0)
    first = Engine(cfg, params, device=cuda, **GRAPH_ENGINE)
    assert first.graphs and len(steps.decode_steps()) == 1
    first.run(_graph_requests(cfg))
    second = Engine(cfg, params, device=cuda, prefill_mode="oneshot",
                    **GRAPH_ENGINE)
    second.run(_graph_requests(cfg))
    step = first._decode
    assert second._decode is step and step.captures == 1
    assert len(steps.decode_steps()) == 1
    assert step.replays == (first.stats["decode_steps"]
                            + second.stats["decode_steps"])
    steps.clear_decode_steps()


def test_a_graphed_engine_builds_its_entry_from_weights_on_the_host(
        cuda, monkeypatch):
    """Weights left on the host reach the card once, as the entry's own
    copy: the engine moves no tree of the caller's to the device, and the
    streams are those of the same weights on the card; so are they after
    another engine bound the entry and this one bound it back from the
    host."""
    from repro_torch.launch import steps
    from repro_torch.models.transformer import params_to
    from repro_torch.serving import engine as engine_mod
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    params = bind(cfg, cuda).init_params(0)
    want = Engine(cfg, params, device=cuda, **GRAPH_ENGINE).run(
        _graph_requests(cfg))
    steps.clear_decode_steps()
    host = params_to(params, "cpu")
    moved = []
    monkeypatch.setattr(engine_mod, "params_to",
                        lambda tree, dev: moved.append(dev) or
                        params_to(tree, dev))
    eng = Engine(cfg, host, device=cuda, **GRAPH_ENGINE)
    assert all(t.is_cuda for t in steps._tensors(eng._decode.params))
    got = eng.run(_graph_requests(cfg))
    other = Engine(cfg, bind(cfg, cuda).init_params(1), device=cuda,
                   prefill_mode="oneshot", **GRAPH_ENGINE)
    other.run(_graph_requests(cfg))
    again = eng.run([dataclasses.replace(r, uid=f"{r.uid}-again")
                     for r in _graph_requests(cfg)])
    assert moved == [] and eng._decode is other._decode
    for a, b, c in zip(got, want, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(c.tokens, b.tokens)
    steps.clear_decode_steps()


@pytest.mark.parametrize("attn_sc", [False, True], ids=["float", "sc"])
def test_replays_count_the_launches_their_capture_recorded(cuda, attn_sc):
    """A capture records one fused SC-GEMM launch a projection and one
    paged launch a layer, what an eager run of the step launches; N
    replays add N times that to the counters."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(attn_sc)
    eng = Engine(cfg, bind(cfg, cuda).init_params(0), device=cuda,
                 **GRAPH_ENGINE)
    step = eng._decode
    want = {"sc_linear": 7 * cfg.n_layers + 1,
            "paged_attention": cfg.n_layers}
    if attn_sc:
        want["paged_attention_sc"] = cfg.n_layers
    assert step.launch_counts == want
    s0, p0 = sc_linear.launches, paged_attention.launches
    step.run()
    assert (sc_linear.launches - s0, paged_attention.launches - p0) == \
        (want["sc_linear"], want["paged_attention"])
    s0, p0 = sc_linear.launches, paged_attention.launches
    for _ in range(5):
        step.replay()
    torch.cuda.synchronize()
    assert (sc_linear.launches - s0, paged_attention.launches - p0) == \
        (5 * want["sc_linear"], 5 * want["paged_attention"])
    steps.clear_decode_steps()


def test_a_capture_that_synchronizes_raises(cuda):
    """A host synchronization in the step fails the warm-up (synchronizing
    calls are errors there); the capture raises and nothing is cached."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    eng = Engine(cfg, bind(cfg, cuda).init_params(0), device=cuda,
                 graphs=False, **GRAPH_ENGINE)

    class Syncing(steps.DecodeStep):
        def run(self):
            super().run()
            int(self.cache.pos.sum())

    step = Syncing(eng._m, eng._params, eng.pool.cache,
                   capacity=GRAPH_ENGINE["capacity"],
                   max_blocks=eng.pool.max_blocks, block=eng.pool.block)
    with pytest.raises(RuntimeError):
        steps.capture(step)
    assert step.captures == 0 and not steps.decode_steps()


# ----------------------------------------------------- prefill graphs


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_device_offset_equals_the_int_offset_bitwise(cuda, dtype,
                                                           bits):
    """The offset read on the device (a worst-case grid whose blocks find
    their m-tiles from it) gives the int-offset launch's bits at every
    chunk offset of a 256-token bucket and at ragged offsets, with NaN in
    the staging cache past the chunk."""
    rng = np.random.default_rng(11)
    h, kv, e, d, chunk = 15, 5, 256, 64, 16
    q = torch.as_tensor(rng.standard_normal((1, e, h, d)), dtype=dtype
                        ).to(cuda).transpose(1, 2)
    k, v = (torch.as_tensor(rng.standard_normal((1, kv, e, d)),
                            dtype=dtype).to(cuda) for _ in range(2))
    offsets = list(range(0, e - chunk + 1, chunk)) + [3, 37, 100, 239]
    for off in offsets:
        kx, vx = (torch.full_like(t, math.nan) for t in (k, v))
        kx[:, :, :off + chunk], vx[:, :, :off + chunk] = (
            k[:, :, :off + chunk], v[:, :, :off + chunk])
        rows = q[:, :, off:off + chunk]
        want = flash_attention(rows, kx, vx, q_offset=off, group=e,
                               sc_bits=bits)
        dev_off = torch.tensor(off, dtype=torch.int32, device=cuda)
        got = flash_attention(rows, kx, vx, q_offset=dev_off, group=e,
                              sc_bits=bits)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), off
        assert torch.equal(got, want), off


def _prefill_run(step, prompt, chunk=None):
    """A prompt through a prefill step, as the engine drives it: each
    chunk's (or the one-shot's) logits, then the step's K/V."""
    logits = []
    if chunk is None:
        step.tokens.copy_(torch.as_tensor(prompt)[None])
        step.replay()
        logits.append(step.logits.clone())
    else:
        step.start()
        for off in range(0, len(prompt), chunk):
            nv = min(chunk, len(prompt) - off)
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :nv] = prompt[off:off + nv]
            step.tokens.copy_(torch.as_tensor(toks))
            step.n_valid.fill_(nv)
            step.replay()
            logits.append(step.logits.clone())
    n = len(prompt)
    return logits, [t[:, :, :n].clone()
                    for t in (*step.cache.k, *step.cache.v)]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("attn_sc", [False, True], ids=["float", "sc"])
def test_prefill_replays_bitwise_equal_the_eager_step(cuda, attn_sc, mode):
    """A captured prefill step's replays give each chunk's logits (or the
    one-shot's) and the staging K/V bit for bit as the same step run
    eagerly; chunked, two prompts go through one staging buffer, the
    second shorter, so the second meets the first's K/V past it."""
    from repro_torch.launch import steps
    from repro_torch.models.transformer import pack_sc_weights
    cfg = _graph_cfg(attn_sc)
    model = bind(cfg, cuda)
    params = pack_sc_weights(model.init_params(0), cfg)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (45, 21)]

    def pair(**shape):
        eager = steps.PrefillStep(model, params, **shape)
        graphed = steps.PrefillStep(model, params, **shape)
        steps.capture(graphed)
        graphed.reset()
        want = {"sc_linear": 7 * cfg.n_layers + 1,
                "flash_attention": cfg.n_layers}
        if attn_sc:
            want["flash_attention_sc"] = cfg.n_layers
        assert graphed.captures == 1 and graphed.launch_counts == want
        return eager, graphed

    if mode == "chunked":
        steps_for = [pair(extent=64, chunk=16)] * len(prompts)
    else:
        steps_for = [pair(extent=len(p)) for p in prompts]
    chunk = 16 if mode == "chunked" else None
    for prompt, (eager, graphed) in zip(prompts, steps_for):
        le, ke = _prefill_run(eager, prompt, chunk)
        lg, kg = _prefill_run(graphed, prompt, chunk)
        torch.cuda.synchronize()
        assert len(le) == len(lg) == (-(-len(prompt) // 16) if chunk else 1)
        for a, b in zip((*le, *ke), (*lg, *kg)):
            assert torch.equal(a, b)
        assert graphed.replays == eager.replays


def test_a_prefill_capture_that_synchronizes_raises(cuda):
    """A host read in a prefill step fails its warm-up: the capture
    raises, and the step stays uncaptured."""
    from repro_torch.launch import steps
    cfg = _graph_cfg(False)
    model = bind(cfg, cuda)

    class Syncing(steps.PrefillStep):
        def run(self):
            super().run()
            int(self.cache.pos.sum())

    step = Syncing(model, model.init_params(0), extent=32, chunk=16)
    with pytest.raises(RuntimeError):
        steps.capture(step)
    assert step.captures == 0 and step.launch_counts == {}


def test_decode_graph_is_bitwise_unmoved_by_prefill_captures(cuda):
    """The scratch hazard: forty prefill steps captured and replayed after
    the decode graph (more captures than the stream pool holds, so their
    streams repeat the decode graph's, and with more SC-GEMM rows than a
    decode step) leave the decode graph's logit rows bitwise equal to the
    eager engine's, run for run (a second run's idle slots start from the
    first run's leftovers, in both engines alike)."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(True)
    params = bind(cfg, cuda).init_params(0)
    again = [dataclasses.replace(r, uid=r.uid + "-again")
             for r in _graph_requests(cfg)]
    eager = _Recording(cfg, params, device=cuda, graphs=False,
                       **GRAPH_ENGINE)
    eager.run(_graph_requests(cfg))
    eager_first, eager.rows = eager.rows, []
    eager.run(again)
    graphed = _Recording(cfg, params, device=cuda, **GRAPH_ENGINE)
    graphed.run(_graph_requests(cfg))
    for i, (a, b) in enumerate(zip(graphed.rows, eager_first, strict=True)):
        np.testing.assert_array_equal(a, b, err_msg=f"decode step {i}")
    decode = graphed._decode
    rng = np.random.default_rng(19)
    for n in range(1, 41):
        step = steps.cached_prefill_step(decode, prompt_len=n)
        step.tokens.copy_(torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, n)), dtype=torch.int32))
        step.replay()
    assert all(s.captures == 1 for s in decode.prefills.values())
    graphed.rows = []
    graphed.run(again)
    for i, (a, b) in enumerate(zip(graphed.rows, eager.rows, strict=True)):
        np.testing.assert_array_equal(a, b, err_msg=f"decode step {i}")
    assert decode.captures == 1
    steps.clear_decode_steps()


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_graphed_engine_replays_one_prefill_capture_a_shape(cuda, mode):
    """The engine's prefill runs through its shape's captured step: one
    capture a shape used, replays equal to the run's prefill chunks or
    prefills, none captured again on a second run."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    eng = Engine(cfg, bind(cfg, cuda).init_params(0), device=cuda,
                 prefill_mode=mode, **GRAPH_ENGINE)
    reqs = _graph_requests(cfg)
    eng.run(reqs)
    entries = eng.prefill_steps()
    want = ({("chunked", b, 16) for b in {16, 32}} if mode == "chunked"
            else {("oneshot", r.prompt_len) for r in reqs})
    assert set(entries) == want
    assert eng.stats["prefill_captures"] == len(want)
    calls = "prefill_chunks" if mode == "chunked" else "prefills"
    assert sum(s.replays for s in entries.values()) == eng.stats[calls]
    eng.run([dataclasses.replace(r, uid=r.uid + "-again") for r in reqs])
    assert eng.stats["prefill_captures"] == 0
    assert all(s.captures == 1 for s in eng.prefill_steps().values())
    steps.clear_decode_steps()


# ------------------------------------------------ speculative decoding


@pytest.mark.parametrize("window", [None, 7], ids=["full", "window7"])
@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_window_attention_is_the_one_row_kernel_call_bitwise(cuda, dtype,
                                                             bits, window):
    """A W = 4 verify window through ``layers.decode_attention`` on the
    card is one paged-kernel launch whose row ``(b, i)`` equals the
    one-row call at ``pos_b + i`` bit for bit (ragged positions, one
    window reaching the cache's end). Rolled-back cells: NaN in K and Inf
    in V past each row's own position (a draft's scratch past a slot's
    accepted prefix) change no bit of any row, on the dense view and
    through the pages of a pool (block 16)."""
    rng = np.random.default_rng(23)
    b, s, kv, g, d, w = 4, 80, 5, 3, 64, 4
    q = torch.as_tensor(rng.standard_normal((b, w, kv * g, d)),
                        dtype=dtype).to(cuda)
    k, v = (torch.as_tensor(rng.standard_normal((b, s, kv, d)),
                            dtype=dtype).to(cuda) for _ in range(2))
    pos = torch.as_tensor([0, 17, 40, 76], dtype=torch.int32, device=cuda)
    kw = dict(window=window, sc_bits=bits)
    before, sc0 = paged_attention.launches, paged_attention.sc.launches
    got = layers.decode_attention(q, k, v, q_position=pos, **kw)
    assert paged_attention.launches == before + 1 and got.dtype == dtype
    assert paged_attention.sc.launches == sc0 + (bits is not None)
    ones = [layers.decode_attention(q[:, i:i + 1], k, v,
                                    q_position=pos + i, **kw)
            for i in range(w)]
    for i, one in enumerate(ones):
        assert torch.equal(got[:, i:i + 1], one), f"row {i}"
    kp, vp = k.clone(), v.clone()
    for row, p in enumerate(pos.tolist()):
        kp[row, p + w:] = float("nan")
        vp[row, p + w:] = float("inf")
    assert torch.equal(layers.decode_attention(q, kp, vp, q_position=pos,
                                               **kw), got)
    # the next round's first row at pos: everything past it poisoned
    kp, vp = k.clone(), v.clone()
    for row, p in enumerate(pos.tolist()):
        kp[row, p + 1:] = float("nan")
        vp[row, p + 1:] = float("inf")
    assert torch.equal(layers.decode_attention(q[:, :1], kp, vp,
                                               q_position=pos, **kw), ones[0])
    block = 16
    pages = [t.reshape(b * s // block, block, kv, d) for t in (kp, vp)]
    pages = [torch.cat([t, t.new_full((1, block, kv, d), float("nan"))])
             for t in pages]                       # + a poisoned trash page
    perm = torch.as_tensor(rng.permutation(b * s // block), device=cuda)
    k_pages, v_pages = (t.clone() for t in pages)
    k_pages[perm], v_pages[perm] = pages[0][:-1], pages[1][:-1]
    tables = perm.reshape(b, s // block).to(torch.int32)
    tables[0, 1:] = -1                             # unallocated: the trash
    out = paged_attention(q[:, 0].reshape(b, kv, g, d), k_pages, v_pages,
                          tables, pos, **kw)
    assert torch.equal(out.reshape(b, 1, kv * g, d), ones[0])


def _spec_engine(cfg, params, cuda, graphs, **kw):
    return _SpecRecording(cfg, params, device=cuda, graphs=graphs,
                          **{**GRAPH_ENGINE, "speculate_k": 3,
                             "draft_bits": 4, **kw})


class _SpecRecording(Engine):
    """An engine that keeps every round's live slots and its draft and
    exact token grids."""

    def _speculate_once(self):
        live = sorted(self.pool.entries)
        super()._speculate_once()
        self.grids = getattr(self, "grids", []) + [
            (self._window_host.numpy().copy(),
             self._exact_host.numpy().copy(), live)]


@pytest.mark.parametrize("attn_sc,k,bits", [
    (False, 3, 4), (False, 1, 8), (True, 2, 4)],
    ids=["float-k3-b4", "float-k1-b8", "sc-k2-b4"])
def test_graphed_speculative_engine_equals_eager_and_baseline(cuda, attn_sc,
                                                              k, bits):
    """Five requests through two slots with speculation on: the graphed
    engine's rounds give the eager engine's draft and exact grids bit for
    bit, and both engines' streams equal the sequential baseline."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(attn_sc)
    params = bind(cfg, cuda).init_params(0)
    reqs = _graph_requests(cfg)
    runs = {}
    for graphs in (False, True):
        eng = _spec_engine(cfg, params, cuda, graphs, speculate_k=k,
                           draft_bits=bits)
        runs[graphs] = (eng, eng.run(reqs))
    (eager, eager_res), (graphed, res) = runs[False], runs[True]
    assert graphed.graphs and not eager.graphs
    assert len(graphed.grids) == len(eager.grids) == \
        graphed.stats["spec_rounds"] > 0
    for i, ((gd, ge, _), (ed, ee, _)) in enumerate(zip(graphed.grids,
                                                       eager.grids)):
        np.testing.assert_array_equal(gd, ed, err_msg=f"draft, round {i}")
        np.testing.assert_array_equal(ge, ee, err_msg=f"exact, round {i}")
    for r, e, req in zip(res, eager_res, reqs):
        np.testing.assert_array_equal(r.tokens, e.tokens)
        ref = generate(cfg, params, req.prompt[None],
                       gen_tokens=req.max_new_tokens, device=cuda)
        np.testing.assert_array_equal(r.tokens, ref[0].cpu().numpy())
    for step in graphed.spec_steps().values():
        assert step.captures == 1
        assert step.replays == graphed.stats["spec_rounds"]
    assert graphed.stats["spec_draft_us"] > 0
    steps.clear_decode_steps()


def test_an_exact_draft_accepts_every_proposal_on_the_card(cuda):
    """SC attention and drafts both at 8 bits: the draft is the exact model,
    so the graphed draft's one-row paged sub-steps must propose exactly the
    verify window's argmaxes for every live slot in every round (the W-row
    window bitwise the one-row steps, end to end)."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(True)
    eng = _spec_engine(cfg, bind(cfg, cuda).init_params(0), cuda, True,
                       draft_bits=8)
    eng.run(_graph_requests(cfg))
    assert eng.grids
    for i, (window, exact, live) in enumerate(eng.grids):
        np.testing.assert_array_equal(window[live, 1:], exact[live, :3],
                                      err_msg=f"round {i}")
    steps.clear_decode_steps()


def test_graphed_round_steps_bitwise_equal_the_eager_steps(cuda):
    """One round driven by hand on a graphed and an eager engine in the
    same state (two live slots): the draft leaves ``cache.pos`` where it
    was and its scratch rows, the verify's pool and grid, and the
    rollback's zeroed cells and positions are bit for bit the eager
    steps'; after the rollback every cell past a slot's position is
    zero."""
    from repro_torch.launch import steps
    from repro_torch.models import cache_ops
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    params = bind(cfg, cuda).init_params(0)
    engines = [_spec_engine(cfg, params, cuda, graphs) for graphs in
               (False, True)]
    for eng in engines:
        for r in _graph_requests(cfg)[:2]:
            eng.submit(dataclasses.replace(r, max_new_tokens=20))
        for _ in range(8):
            if len(eng.pool.entries) == 2:
                break
            eng.step()
        assert len(eng.pool.entries) == 2

    def pool(eng):
        return [t.clone() for t in (*eng.pool.cache.k, *eng.pool.cache.v,
                                    eng.pool.cache.pos)]

    def same(a, b, what):
        for x, y in zip(a, b, strict=True):
            assert torch.equal(x, y), what

    states = [pool(e) for e in engines]
    same(*states, "before the round")
    for eng in engines:
        eng._copy_step_inputs(4)
        pos0 = eng.pool.cache.pos.clone()
        eng._draft.replay()
        torch.cuda.synchronize()
        assert torch.equal(eng.pool.cache.pos, pos0)
    same(*[pool(e) for e in engines], "after the draft")
    for eng in engines:
        eng._verify.replay()
    torch.cuda.synchronize()
    same(*[pool(e) for e in engines], "after the verify")
    assert torch.equal(engines[0]._verify.out, engines[1]._verify.out)
    assert torch.equal(engines[0]._verify.window, engines[1]._verify.window)
    for eng in engines:
        eng._rollback.accept.copy_(torch.as_tensor([1, 3],
                                                   dtype=torch.int32))
        eng._rollback.replay()
    torch.cuda.synchronize()
    same(*[pool(e) for e in engines], "after the rollback")
    eng = engines[1]
    assert torch.equal(eng.pool.cache.pos[:2], pos0[:2] + torch.as_tensor(
        [1, 3], dtype=torch.int32, device=cuda))
    tables = torch.as_tensor(eng.pool.tables, device=cuda)
    dense = cache_ops.paged_gather(eng.pool.cache, tables,
                                   block=eng.pool.block)
    for slot in range(2):
        p = int(eng.pool.cache.pos[slot])
        for leaf in (*dense.k, *dense.v):
            assert not leaf[:, slot, p:].any() and leaf[:, slot, p - 1].any()
    steps.clear_decode_steps()


def test_one_capture_per_speculative_shape_and_rebinding(cuda):
    """Graphed engines of one decode shape share its draft, verify and
    rollback steps: one capture each per (k, draft_bits) and width, a
    replay counting k x (7L + 1) SC-GEMM and k x L paged launches, all
    on the SC path (draft), or 7L + 1 and L float (verify); two engines
    with different weights used in turn serve their own weights' streams
    through them (binding packs the draft's weights anew); another k is
    another set."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    pa = bind(cfg, cuda).init_params(0)
    pb = bind(cfg, cuda).init_params(1)
    reqs = _graph_requests(cfg)
    a = _spec_engine(cfg, pa, cuda, True)
    b = _spec_engine(cfg, pb, cuda, True)
    decode = a._decode
    assert b._decode is decode and a.spec_steps() == b.spec_steps()
    n_l = cfg.n_layers
    want = {"draft": {"sc_linear": 3 * (7 * n_l + 1),
                      "paged_attention": 3 * n_l,
                      "paged_attention_sc": 3 * n_l},
            "verify": {"sc_linear": 7 * n_l + 1, "paged_attention": n_l},
            "rollback": {}}
    for name, step in a.spec_steps().items():
        assert step.captures == 1 and step.launch_counts == want[name]
    for run, (eng, params) in enumerate(((a, pa), (b, pb), (a, pa))):
        res = eng.run([dataclasses.replace(r, uid=f"{r.uid}-{run}")
                       for r in reqs])
        for r, req in zip(res, reqs):
            ref = generate(cfg, params, req.prompt[None],
                           gen_tokens=req.max_new_tokens, device=cuda)
            np.testing.assert_array_equal(r.tokens, ref[0].cpu().numpy(),
                                          err_msg=f"run {run} {r.uid}")
    c = _spec_engine(cfg, pa, cuda, True, speculate_k=1, draft_bits=8)
    assert c._decode is decode and len(decode.specs) == 6
    assert all(s.captures == 1 for s in decode.specs.values())
    assert len(steps.decode_steps()) == 1 and decode.captures == 1
    steps.clear_decode_steps()


def test_a_capture_survives_old_graphs_in_reference_cycles(cuda):
    """A dropped speculative entry's steps hold each other (decode and
    draft), so its graphs wait for the cyclic collector, and a graph
    destroyed during a capture invalidates that capture. With the
    collector set to run at nearly every allocation, a new entry of the
    same shape still captures every step (the collector runs before each
    capture, not during it) and serves the baseline's streams."""
    import gc
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    params = bind(cfg, cuda).init_params(0)
    reqs = _graph_requests(cfg)
    old = _spec_engine(cfg, params, cuda, True)
    old_steps = [old._decode, *old.spec_steps().values()]
    assert all(s.captures == 1 for s in old_steps)
    del old, old_steps
    steps.clear_decode_steps()
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng = _spec_engine(cfg, params, cuda, True)
        res = eng.run(reqs)
    finally:
        gc.set_threshold(*threshold)
    assert all(s.captures == 1 for s in eng.spec_steps().values())
    for r, req in zip(res, reqs):
        ref = generate(cfg, params, req.prompt[None],
                       gen_tokens=req.max_new_tokens, device=cuda)
        np.testing.assert_array_equal(r.tokens, ref[0].cpu().numpy(),
                                      err_msg=r.uid)
    steps.clear_decode_steps()


# ------------------------------------------------------- prefix cache

#: block 32 over chunks of 16: a verbatim repeat of a 64-token prompt
#: resumes at 48, inside its second page, which admission copies
PREFIX_ENGINE = dict(capacity=2, max_seq=96, block=32, chunk=16)


def _prefix_requests(cfg, tag="p"):
    """A shared 32-token preamble with tails of 8, 13, 0 and 32 tokens,
    then verbatim repeats of the 64-token prompt."""
    rng = np.random.default_rng(17)
    pre = rng.integers(0, cfg.vocab_size, size=(32,))
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                                 size=(n,))]).astype(np.int32)
               for n in (8, 13, 0, 32)]
    prompts += [prompts[3].copy(), prompts[3].copy()]
    gens = (6, 11, 4, 9, 7, 12)
    return [Request(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


@pytest.mark.parametrize("attn_sc", [False, True], ids=["float", "sc"])
def test_prefix_cache_graphed_streams_equal_eager_and_baseline(cuda,
                                                               attn_sc):
    """With the prefix cache (the default): the graphed engine's streams
    equal the eager engine's and the sequential baseline's, cold and over
    the warm tree, with hits, a copy-on-write admission and fewer prefill
    chunks than with the cache off."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(attn_sc)
    params = bind(cfg, cuda).init_params(0)
    reqs = _prefix_requests(cfg)
    base = [generate(cfg, params, r.prompt[None], gen_tokens=r.max_new_tokens,
                     device=cuda)[0].cpu().numpy() for r in reqs]
    off = Engine(cfg, params, device=cuda, graphs=False, prefix_cache=False,
                 **PREFIX_ENGINE)
    off.run(reqs)
    eager = Engine(cfg, params, device=cuda, graphs=False, **PREFIX_ENGINE)
    graphed = Engine(cfg, params, device=cuda, **PREFIX_ENGINE)
    assert graphed.graphs and graphed.prefix is not None
    for run in range(2):
        again = [dataclasses.replace(r, uid=f"{r.uid}-{run}") for r in reqs]
        for eng in (eager, graphed):
            res = eng.run(again)
            for r, b in zip(res, base):
                np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)
            st = eng.stats
            assert st["prefix_hits"] >= 4 and st["cow_copies"] >= 1
            assert st["prefill_chunks"] < off.stats["prefill_chunks"]
            assert eng.pool.pages_live == 0
        assert graphed.stats["prefill_chunks"] == eager.stats["prefill_chunks"]
    assert graphed.stats["prefix_misses"] == 0
    steps.clear_decode_steps()


@pytest.mark.parametrize("attn_sc", [False, True], ids=["float", "sc"])
def test_a_seeded_staging_cache_gives_the_cold_prefill_bitwise(cuda,
                                                               attn_sc):
    """A hit's chunks replay the bucket's captured graph from the resume
    offset over a staging cache seeded from the pool's pages: its last
    chunk's logits and every staging K/V row of the prompt equal a cold
    prefill's of the same prompt bit for bit."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(attn_sc)
    eng = Engine(cfg, bind(cfg, cuda).init_params(0), device=cuda,
                 **PREFIX_ENGINE)
    req = _prefix_requests(cfg)[3]                   # 64 tokens
    eng.run([dataclasses.replace(req, uid="warm")])

    def prefill(uid):
        st = eng._start_prefill(dataclasses.replace(req, uid=uid))
        while not st.done:
            eng._prefill_chunk_once(st)
        kv = [t[:, :, :req.prompt_len].clone()
              for t in (*st.step.cache.k, *st.step.cache.v)]
        return st, st.rows.copy(), kv

    tree, eng.prefix = eng.prefix, None              # a cold start
    cold, cold_rows, cold_kv = prefill("cold")
    eng.prefix = tree
    hit, rows, kv = prefill("hit")
    assert cold.match is None and hit.match is not None
    assert hit.match.resume == 48 and hit.match.cow_src is not None
    assert hit.step is cold.step and hit.step.captures == 1
    np.testing.assert_array_equal(rows, cold_rows)
    for a, b in zip(kv, cold_kv):
        assert torch.equal(a, b)
    eng.pool.unpin_pages(hit.match.pages)
    assert eng.pool.pages_live == 0
    steps.clear_decode_steps()


# ------------------------------------------------- the ssm and hybrid slice
#
# zamba2-7b's attention is 32 heads over 32 KV heads (group 1) of D 112,
# and its MLP's down projection reduces over K = 14,336; mamba2-130m and a
# 6-layer zamba2-7b (two shared-block sites) at full width serve below.

@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_kernel_at_the_hybrid_layout_equals_plain(cuda, dtype, bits):
    args = _paged(4, 32, 1, 112, 64, 6, [300, 17, 383, 128], 112, dtype,
                  cuda)
    got = paged_attention(*args, sc_bits=bits)
    want = paged_attention_torch(*args, sc_bits=bits)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    else:
        _sc_close(got, want, args[2], bits, TOL[dtype])
    # a slot alone gives its rows of the batch bit for bit
    q, k, v, tables, pos = args
    for i in range(4):
        one = paged_attention(q[i:i + 1], k, v, tables[i:i + 1],
                              pos[i:i + 1], sc_bits=bits)
        assert torch.equal(one, got[i:i + 1]), i


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_at_the_hybrid_layout_equals_plain(cuda, dtype, bits):
    """A 256-token prompt one-shot, and its two 128-row chunks over the
    384-position bucket (NaN past each chunk), against the plain version;
    the chunks' rows equal the one-shot rows bit for bit."""
    rng = np.random.default_rng(112)
    h, d, s, e = 32, 112, 256, 384
    q = torch.as_tensor(rng.standard_normal((1, s, h, d)), dtype=dtype
                        ).to(cuda).transpose(1, 2)
    k, v = (torch.as_tensor(rng.standard_normal((1, h, e, d)), dtype=dtype
                            ).to(cuda) for _ in range(2))
    one = flash_attention(q, k[:, :, :s], v[:, :, :s], q_offset=0, group=s,
                          sc_bits=bits)
    want = flash_attention_torch(q, k[:, :, :s], v[:, :, :s], q_offset=0,
                                 group=s, sc_bits=bits)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(one.float(), want.float(), **TOL[dtype])
    else:
        _sc_close(one, want, v, bits, TOL[dtype])
    for off in (0, 128):
        kx, vx = (torch.full_like(t, math.nan) for t in (k, v))
        kx[:, :, :off + 128], vx[:, :, :off + 128] = (k[:, :, :off + 128],
                                                      v[:, :, :off + 128])
        dev_off = torch.tensor(off, dtype=torch.int32, device=cuda)
        got = flash_attention(q[:, :, off:off + 128], kx, vx,
                              q_offset=dev_off, group=e, sc_bits=bits)
        torch.cuda.synchronize()
        assert torch.equal(got, one[:, :, off:off + 128]), off


@pytest.mark.parametrize("m", [1, 4, 128])
@pytest.mark.parametrize("k,n", [(14336, 3584), (7168, 3584)])
def test_fused_kernel_at_the_hybrid_k_equals_plain(cuda, m, k, n):
    """K = 14,336 (zamba2's w2) splits past ``K_BLOCK_MAX`` into several
    K blocks; the counts stay exact (14,336 x 255 < 2**24)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=cuda)
         * k ** -0.5).to(torch.bfloat16)
    pw = pack_weight(w, 8)
    assert plan(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count)[2] > 1
    got = sc_linear(x, pw)
    want = sc_linear_torch(x, pw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if m > 1:
        assert torch.equal(sc_linear(x[1:2], pw), got[1:2])


def _family_cfg(arch: str):
    cfg = dataclasses.replace(ARCHS[arch], use_sc_gemm=True, sc_bits=8)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=2 * cfg.shared_attn_every)
    return cfg.validate()


def _family_requests(cfg, lens=(128, 256, 128, 256, 128),
                     gens=(6, 11, 4, 9, 7)):
    rng = np.random.default_rng(22)
    return [Request(uid=f"r{i}",
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=(n,)).astype(np.int32),
                    max_new_tokens=g)
            for i, (n, g) in enumerate(zip(lens, gens))]


FAMILY_ENGINE = dict(max_seq=384, block=64, chunk=128)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_family_streams_one_slot_equal_four_and_chunked_one_shot(cuda, arch):
    """Full width (zamba2-7b cut to 6 layers, two sites): the streams of
    one slot, of four slots (graphed), of one-shot prefill and of the
    sequential baseline are the same tokens, so every reduction a row
    meets is fixed by the row alone."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _family_cfg(arch)
    params = bind(cfg, cuda).init_params(0)
    reqs = _family_requests(cfg)
    runs = {}
    for name, kw in (("one slot", dict(capacity=1)),
                     ("four slots", dict(capacity=4)),
                     ("one-shot", dict(capacity=4, prefill_mode="oneshot")),
                     ("eager", dict(capacity=4, graphs=False))):
        eng = Engine(cfg, params, device=cuda, **FAMILY_ENGINE, **kw)
        runs[name] = [r.tokens for r in eng.run(reqs)]
        steps.clear_decode_steps()
    base = [generate(cfg, params, r.prompt[None], gen_tokens=r.max_new_tokens,
                     device=cuda)[0].cpu().numpy() for r in reqs]
    for name, streams in runs.items():
        for r, got, want in zip(reqs, streams, base):
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {r.uid}")


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_family_graph_replays_equal_the_eager_steps(cuda, arch, mode):
    """Every decode step's logit rows of the graphed engine equal the
    eager engine's bit for bit; a captured prefill step's replays give
    the eager step's logits and every staging leaf (Mamba conv windows and
    states, the sites' K/V) bit for bit, two prompts through one staging
    buffer."""
    from repro_torch.launch import steps
    from repro_torch.models import pack_sc_weights
    steps.clear_decode_steps()
    cfg = _family_cfg(arch)
    model = bind(cfg, cuda)
    params = model.init_params(0)
    reqs = _family_requests(cfg)
    rows = {}
    for graphs in (False, True):
        eng = _Recording(cfg, params, device=cuda, graphs=graphs,
                         capacity=2, prefill_mode=mode, **FAMILY_ENGINE)
        eng.run(reqs)
        rows[graphs] = eng.rows
    assert len(rows[True]) == len(rows[False]) >= 10
    for i, (g, e) in enumerate(zip(rows[True], rows[False])):
        np.testing.assert_array_equal(g, e, err_msg=f"decode step {i}")
    steps.clear_decode_steps()
    packed = pack_sc_weights(params, cfg)
    prompts = [r.prompt for r in reqs[:2]][::-1]       # 256, then 128

    def run(step, prompt):
        out = []
        if step.chunk is None:
            step.tokens.copy_(torch.as_tensor(prompt, device=cuda)[None])
            step.replay()
            out.append(step.logits.clone())
        else:
            step.start()
            for off in range(0, len(prompt), step.chunk):
                step.tokens.copy_(torch.as_tensor(
                    prompt[off:off + step.chunk], device=cuda)[None])
                step.n_valid.fill_(step.chunk)
                step.replay()
                out.append(step.logits.clone())
        return out + [t.clone() for t in steps._tensors(step.cache)]

    def pair(**shape):
        eager = steps.PrefillStep(model, packed, **shape)
        graphed = steps.PrefillStep(model, packed, **shape)
        steps.capture(graphed)
        graphed.reset()
        assert graphed.captures == 1
        return eager, graphed

    if mode == "chunked":
        pairs = [pair(extent=256, chunk=128)] * len(prompts)
    else:
        pairs = [pair(extent=len(p)) for p in prompts]
    for prompt, (eager, graphed) in zip(prompts, pairs):
        for a, b in zip(run(eager, prompt), run(graphed, prompt)):
            assert torch.equal(a, b)


# ----------------------------------------------------- tuned launch plans


def _smollm_problems(rows: int, kind: str):
    from repro_torch.configs.shapes import Shape, sc_gemm_problems
    shape = Shape("probe", rows, 4, "decode") if kind == "decode" else \
        Shape("probe", rows, 1, "prefill")
    return sc_gemm_problems(ARCHS["smollm-360m"], shape)


@pytest.mark.parametrize("m,k,n", [
    *_smollm_problems(1, "decode"), *_smollm_problems(16, "prefill"),
    (128, 14336, 3584), (128, 3584, 14576), (4, 14336, 3584)])
def test_every_sc_gemm_candidate_equals_the_default_plan(cuda, m, k, n):
    """smollm-360m's decode (M = 4) and 16-row chunk problems, zamba2-7b's
    widest K at a 128-row chunk and a decode step: every candidate of the
    key's grid (at ``bucket_m(M)``), launched at M rows, gives the default
    plan's bits, bf16 and f32 rows."""
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(m + k + n)
    pw = pack_weight(torch.as_tensor(rng.standard_normal((k, n)),
                                     dtype=torch.float32).to(cuda), 8)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = autotune.candidate_configs(autotune.bucket_m(m), k, n, sms=sms)
    assert len(cands) >= 3
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.as_tensor(rng.standard_normal((m, k)),
                            dtype=torch.float32).to(cuda, dtype)
        want = sc_linear(x, pw)
        for cfg in cands:
            assert torch.equal(sc_linear(x, pw, config=cfg), want), cfg
    a, b = _planes(m, min(k, 960), n, 8, seed=k)
    a, b = a.to(cuda), b.to(cuda)
    want = sc_matmul_counts_signed(a, b, bits=8)
    for cfg in autotune.candidate_configs(autotune.bucket_m(m), min(k, 960),
                                          n, sms=sms):
        assert torch.equal(sc_matmul_counts_signed(a, b, bits=8,
                                                   config=cfg), want), cfg


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", [
    (15, 5, 64, 16, 64, 48), (15, 5, 64, 64, 64, 0),
    (32, 32, 112, 128, 384, 256), (28, 4, 128, 96, 256, 100)],
    ids=["smollm-chunk", "smollm-oneshot", "zamba2-chunk", "qwen2-7b"])
def test_every_flash_candidate_equals_the_default_plan(cuda, geom, dtype,
                                                       bits):
    """The serve chunk (offset on the card), a one-shot prefill, zamba2-7b's
    128-row chunk over its 384-key bucket and a G = 7 layout: every
    (heads, m-tiles) of the grid gives the default plan's bits."""
    from repro_torch.kernels import autotune
    h, kv, d, sq, skv, off = geom
    rng = np.random.default_rng(h * sq + d)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(cuda, dtype)

    q, k, v = t((1, h, sq, d)), t((1, kv, max(skv, sq), d)), \
        t((1, kv, max(skv, sq), d))
    q_offset = torch.tensor(off, dtype=torch.int32, device=cuda) \
        if geom[3] in (16, 128) else off
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = autotune.candidate_flash_configs(
        1, h, kv, sq, d, group=64, q_offset=q_offset, sc_bits=bits,
        esz=q.element_size(), sms=sms)
    want = flash_attention(q, k, v, q_offset=q_offset, group=64,
                           sc_bits=bits)
    for cfg in cands:
        got = flash_attention(q, k, v, q_offset=q_offset, group=64,
                              sc_bits=bits, config=cfg)
        assert torch.equal(got, want), cfg


def test_every_stream_candidate_equals_the_default_plan(cuda):
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(12)
    n = 1 << 20
    x = torch.as_tensor(rng.integers(0, 4096, n), dtype=torch.int32).to(cuda)
    y = torch.as_tensor(rng.integers(0, 4096, n), dtype=torch.int32).to(cuda)
    want = sc_stream_mul_cuda(x, y, bits=12)
    cands = autotune.candidate_stream_configs(n)
    assert [c.block_rows for c in cands] == [8, 1, 2, 4]
    for cfg in cands:
        assert torch.equal(sc_stream_mul_cuda(x, y, bits=12,
                                              block_rows=cfg.block_rows),
                           want)
    got = ops.sc_stream_mul(x, y, bits=12, tune=True)
    assert torch.equal(got, want)


def test_a_tuned_capture_sweeps_only_in_its_tuning_pass(cuda):
    """On a fresh cache: every graphed step's sweeps happen in its tuning
    pass, none in its warm-up or capture; the replayed decode steps'
    logit rows equal the eager engine's (the same tuned plans) bit for
    bit; a second graphed engine of the shape sweeps nothing."""
    from repro_torch.kernels import autotune
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _graph_cfg(False)
    params = bind(cfg, cuda).init_params(0)
    sweeps0 = autotune.sweeps
    graphed = _Recording(cfg, params, device=cuda, graphs=True,
                         **GRAPH_ENGINE)
    res = graphed.run(_graph_requests(cfg))
    entries = [graphed._decode, *graphed.prefill_steps().values()]
    assert all(s.captures == 1 and s.capture_sweeps == 0 for s in entries)
    assert graphed._decode.tuning_sweeps > 0
    assert sum(s.tuning_sweeps for s in entries) == autotune.sweeps - sweeps0
    swept = autotune.sweeps
    eager = _Recording(cfg, params, device=cuda, graphs=False,
                       **GRAPH_ENGINE)
    eager_res = eager.run(_graph_requests(cfg))
    assert autotune.sweeps == swept
    assert len(graphed.rows) == len(eager.rows) >= 12
    for i, (g, e) in enumerate(zip(graphed.rows, eager.rows)):
        np.testing.assert_array_equal(g, e, err_msg=f"decode step {i}")
    for r, e in zip(res, eager_res):
        np.testing.assert_array_equal(r.tokens, e.tokens)
    steps.clear_decode_steps()
    again = Engine(cfg, params, device=cuda, graphs=True, **GRAPH_ENGINE)
    again.run(_graph_requests(cfg))
    assert autotune.sweeps == swept and again._decode.tuning_sweeps == 0
    steps.clear_decode_steps()


# ---------------------------------------------------- the vlm and audio slice
#
# qwen2-vl-2b's attention is 12 heads over 2 KV heads (group 6) of D 128
# and its tied head N = 151,936 at K = 1,536; musicgen-large's is 32 heads
# over 32 KV heads (group 1) of D 64, its head 4 codebooks x 2,048 = 8,192
# at K = 2,048. Both cells serve 64-token prompts in 16-row chunks over a
# 64-token bucket, 4 slots of max_seq 256 in pages of 64.

MULTIMODAL = {"vlm": dict(h=12, kv=2, d=128), "audio": dict(h=32, kv=32, d=64)}


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(MULTIMODAL))
def test_paged_kernel_at_the_multimodal_layouts_equals_plain(cuda, layout,
                                                             dtype, bits):
    """The decode layouts (the vlm draft runs the SC path at 4 bits); a
    slot alone gives its rows of the batch bit for bit."""
    geo = MULTIMODAL[layout]
    args = _paged(4, geo["kv"], geo["h"] // geo["kv"], geo["d"], 64, 4,
                  [100, 255, 37, 64], geo["d"], dtype, cuda)
    got = paged_attention(*args, sc_bits=bits)
    want = paged_attention_torch(*args, sc_bits=bits)
    torch.cuda.synchronize()
    if bits is None:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    else:
        _sc_close(got, want, args[2], bits, TOL[dtype])
    q, k, v, tables, pos = args
    for i in range(4):
        one = paged_attention(q[i:i + 1], k, v, tables[i:i + 1],
                              pos[i:i + 1], sc_bits=bits)
        assert torch.equal(one, got[i:i + 1]), i


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(MULTIMODAL))
def test_flash_kernel_at_the_multimodal_layouts_equals_plain(cuda, layout,
                                                             dtype, bits):
    """A 64-token prompt one-shot against the plain version, and its four
    16-row chunks over the 64-token bucket (NaN past each chunk, the
    offset on the card) bit-equal to the one-shot rows; for the vlm also
    the 256-token vision prefill against the plain version."""
    geo = MULTIMODAL[layout]
    h, kv, d = geo["h"], geo["kv"], geo["d"]
    rng = np.random.default_rng(d + kv)
    lens = (64, 256) if layout == "vlm" else (64,)
    for s in lens:
        q = torch.as_tensor(rng.standard_normal((1, s, h, d)), dtype=dtype
                            ).to(cuda).transpose(1, 2)
        k, v = (torch.as_tensor(rng.standard_normal((1, kv, s, d)),
                                dtype=dtype).to(cuda) for _ in range(2))
        one = flash_attention(q, k, v, q_offset=0, group=s, sc_bits=bits)
        want = flash_attention_torch(q, k, v, q_offset=0, group=s,
                                     sc_bits=bits)
        torch.cuda.synchronize()
        if bits is None:
            torch.testing.assert_close(one.float(), want.float(),
                                       **TOL[dtype])
        else:
            _sc_close(one, want, v, bits, TOL[dtype])
        if s != 64:
            continue
        for off in range(0, s, 16):
            kx, vx = (torch.full_like(t, math.nan) for t in (k, v))
            kx[:, :, :off + 16], vx[:, :, :off + 16] = (k[:, :, :off + 16],
                                                        v[:, :, :off + 16])
            dev_off = torch.tensor(off, dtype=torch.int32, device=cuda)
            got = flash_attention(q[:, :, off:off + 16], kx, vx,
                                  q_offset=dev_off, group=s, sc_bits=bits)
            torch.cuda.synchronize()
            assert torch.equal(got, one[:, :, off:off + 16]), off


@pytest.mark.parametrize("m", [1, 4, 16, 64])
@pytest.mark.parametrize("k,n", [(1536, 151936), (8960, 1536), (1536, 256),
                                 (2048, 8192), (8192, 2048)])
def test_fused_kernel_at_the_multimodal_shapes_equals_plain(cuda, m, k, n):
    """The heads (qwen2-vl-2b's N = 151,936, musicgen-large's 8,192) and
    the other widths the cells add, at every row count they send; a row
    alone gives its row of the batch."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=cuda)
         * k ** -0.5).to(torch.bfloat16)
    pw = pack_weight(w, 8)
    got = sc_linear(x, pw)
    want = sc_linear_torch(x, pw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if m > 1:
        assert torch.equal(sc_linear(x[1:2], pw), got[1:2])


def _multimodal_cfg(arch: str):
    """Full width, cut to 2 layers."""
    return dataclasses.replace(ARCHS[arch], use_sc_gemm=True, sc_bits=8,
                               n_layers=2).validate()


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-large"])
def test_multimodal_streams_one_slot_equal_four_and_chunked_one_shot(cuda,
                                                                     arch):
    """The streams of one slot, of four (graphed), of one-shot prefill, of
    the eager engine, of the vlm's speculative engine (k = 1 at 4 bits)
    and of the sequential baseline are the same tokens (``(n, 4)`` frames
    for musicgen-large); every graphed decode step's logit rows equal the
    eager engine's bit for bit."""
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _multimodal_cfg(arch)
    params = bind(cfg, cuda).init_params(0)
    rng = np.random.default_rng(24)
    kb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    reqs = [Request(uid=f"r{i}", prompt=rng.integers(
        0, cfg.vocab_size, size=(n, *kb)).astype(np.int32),
        max_new_tokens=g)
        for i, (n, g) in enumerate(zip((64, 40, 64, 17, 64),
                                       (6, 11, 4, 9, 7)))]
    shape = dict(max_seq=256, block=64, chunk=16)
    runs, rows = {}, {}
    variants = [("one slot", dict(capacity=1)),
                ("four slots", dict(capacity=4)),
                ("one-shot", dict(capacity=4, prefill_mode="oneshot")),
                ("eager", dict(capacity=4, graphs=False))]
    if not cfg.n_codebooks:
        variants.append(("speculative", dict(capacity=4, speculate_k=1,
                                             draft_bits=4)))
    for name, kw in variants:
        eng = _Recording(cfg, params, device=cuda, **shape, **kw)
        runs[name] = [r.tokens for r in eng.run(reqs)]
        rows[name] = getattr(eng, "rows", None)
        steps.clear_decode_steps()
    base = [generate(cfg, params, r.prompt[None], gen_tokens=r.max_new_tokens,
                     device=cuda)[0].cpu().numpy() for r in reqs]
    for name, streams in runs.items():
        for r, got, want in zip(reqs, streams, base):
            assert got.shape == want.shape == (r.max_new_tokens, *kb)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {r.uid}")
    assert len(rows["four slots"]) == len(rows["eager"]) >= 5
    for i, (g, e) in enumerate(zip(rows["four slots"], rows["eager"])):
        np.testing.assert_array_equal(g, e, err_msg=f"decode step {i}")


# ------------------------------------------------------------ the moe slice
#
# A MoE projection is one launch for all experts: rows (E, M, K) against a
# batched pack (E, K, N). qwen3-moe-235b-a22b's experts are (4096, 1536)
# and (1536, 4096), llama4-maverick-400b-a17b's (5120, 8192) and (8192,
# 5120), each at M = C = 64 rows an expert; here E = 4 of them.

MOE_SHAPES = [(4096, 1536), (1536, 4096), (5120, 8192), (8192, 5120)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n", MOE_SHAPES)
def test_batched_launch_equals_plain_and_unbatched_launches(cuda, k, n,
                                                            dtype, bits):
    """At 64 rows and at 37 (not a row-tile multiple), a NaN row in one
    expert and an expert of zero rows: one batched launch, at the default
    plan and at every candidate of its grid, is bit-equal to the plain
    version and to E unbatched launches of each expert."""
    from repro_torch.kernels import autotune
    gen = torch.Generator(device=cuda).manual_seed(k + n + bits)
    w = (torch.randn((4, k, n), generator=gen, device=cuda)
         * k ** -0.5).to(dtype)
    pw = pack_weight(w, bits)
    for m in (64, 37):
        x = torch.randn((4, m, k), generator=gen, device=cuda).to(dtype)
        x[1, 5, 7] = math.nan
        x[2] = 0
        want = sc_linear_torch(x, pw)
        ones = [pack_weight(w[e], bits) for e in range(4)]
        for cfg in [None, *autotune.candidate_configs(m, k, n, sms=132,
                                                      batch=4)]:
            before = sc_linear.launches
            got = sc_linear(x, pw, config=cfg)
            assert sc_linear.launches == before + 1
            torch.cuda.synchronize()
            assert got.shape == (4, m, n) and got.dtype == dtype
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got.nan_to_num(), want.nan_to_num()), cfg
            assert bool(got[1, 5].isnan().all()) and not bool(got[2].any())
            for e in range(4):
                one = sc_linear(x[e], ones[e], config=cfg)
                assert torch.equal(one.nan_to_num(),
                                   got[e].nan_to_num()), (cfg, e)


def test_a_batched_launch_that_cannot_be_made_raises(cuda):
    """Rows of the wrong expert count, or a grid past the kernel's z
    extent, raise: nothing loops over experts or drops to the plain
    version on the card."""
    pw = pack_weight(torch.randn((4, 64, 32), device=cuda), 8)
    with pytest.raises(ConfigError, match=r"\(4, M, 64\)"):
        sc_linear(torch.randn((3, 8, 64), device=cuda), pw)
    big = pack_weight(torch.randn((4100, 32, 8), device=cuda), 8)
    before = sc_linear.launches
    with pytest.raises(ConfigError, match="grid"):
        sc_linear(torch.randn((4100, 256, 32), device=cuda), big)
    assert sc_linear.launches == before


def _moe_cfg():
    return dataclasses.replace(
        ARCHS["qwen3-moe-235b-a22b"].reduced(dtype="float32"),
        use_sc_gemm=True, sc_bits=8).validate()


def _moe_requests(cfg):
    """Prompts of at most C = 16 tokens: no prefill drops a token, so the
    streams equal the B=1 baseline's."""
    rng = np.random.default_rng(25)
    return [Request(uid=f"r{i}", prompt=rng.integers(
        0, cfg.vocab_size, size=(n,)).astype(np.int32), max_new_tokens=g)
        for i, (n, g) in enumerate(zip((9, 16, 5, 12), (6, 10, 8, 5)))]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_moe_graphed_decode_equals_eager_and_baseline(cuda, mode):
    """Reduced qwen3-moe, SC-GEMM at 8 bits: every graphed decode step's
    logit rows equal the eager engine's bit for bit, the streams equal
    the baseline, each expert projection of a replay is one launch, and
    on a fresh tuner cache every sweep happens in a tuning pass (the
    batched keys among them), none in a warm-up or a capture."""
    from repro_torch.kernels import autotune
    from repro_torch.launch import steps
    steps.clear_decode_steps()
    cfg = _moe_cfg()
    params = bind(cfg, cuda).init_params(0)
    reqs = _moe_requests(cfg)
    shape = dict(capacity=2, max_seq=32, block=8, chunk=8, prefill_mode=mode)
    rows = {}
    for graphs in (True, False):
        eng = _Recording(cfg, params, device=cuda, graphs=graphs, **shape)
        res = eng.run(reqs)
        rows[graphs] = eng.rows
        if graphs:
            entries = [eng._decode, *eng.prefill_steps().values()]
            assert all(s.captures == 1 and s.capture_sweeps == 0
                       for s in entries)
            moe_layers = sum(map(cfg.moe_at, range(cfg.n_layers)))
            dense = 4 * cfg.n_layers + 1
            assert eng._decode.launch_counts["sc_linear"] == \
                dense + 3 * moe_layers
            keys = autotune._default_cache().keys()
            assert any(key.endswith(f":e{cfg.n_experts}") for key in keys)
    assert len(rows[True]) == len(rows[False]) >= 10
    for i, (g, e) in enumerate(zip(rows[True], rows[False])):
        np.testing.assert_array_equal(g, e, err_msg=f"decode step {i}")
    base = [generate(cfg, params, r.prompt[None], gen_tokens=r.max_new_tokens,
                     device=cuda)[0].cpu().numpy() for r in reqs]
    for r, want in zip(res, base):
        np.testing.assert_array_equal(r.tokens, want, err_msg=r.uid)
    steps.clear_decode_steps()


# ---------------------------------------------------------------- training

def _train_batch(cfg, step, cuda, batch=4, seq=64):
    from repro_torch.data import PipelineConfig, TokenPipeline
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch))
    return {k: torch.as_tensor(v, device=cuda)
            for k, v in pipe.get_batch(step).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_kernels_equal_plain_versions(cuda, dtype):
    """Reduced smollm-360m, a training step's loss and gradients: with
    SC-GEMM at 8 bits, the SC-GEMM kernel's (float attention through its
    plain version) equal the plain formulation's (``mxu_split``) bit for
    bit; with exact projections, the flash kernel's within 1e-5 (float32)
    or 1e-2 (bf16) relative loss and 1e-3 / 5e-2 of each gradient leaf's
    largest magnitude of plain attention's. The counters show one SC-GEMM
    launch a projection and one flash launch a layer in each forward,
    every layer's forward twice under remat, and the head once a loss
    chunk."""
    from repro_torch import tree as tr
    from repro_torch.launch import train as tt
    from repro_torch.kernels.flash_attention import flash_attention as fk
    cfg = ARCHS["smollm-360m"].reduced(dtype=dtype, use_sc_gemm=True)
    params = bind(cfg, cuda).init_params(0)
    batch = _train_batch(cfg, 0, cuda)

    def run(**kw):
        return tt.value_and_grad(bind(dataclasses.replace(cfg, **kw), cuda),
                                 params, batch)

    sc0, fl0 = sc_linear.launches, fk.launches
    run()
    chunks = batch["tokens"].shape[1] // cfg.loss_chunk   # head calls
    assert sc_linear.launches - sc0 == 2 * 7 * cfg.n_layers + chunks
    assert fk.launches - fl0 == 2 * cfg.n_layers
    kernel = run(attn_kernel="jnp")
    plain = run(attn_kernel="jnp", sc_impl="mxu_split")
    assert torch.equal(kernel[0], plain[0])
    for a, b in zip(tr.leaves(kernel[1]), tr.leaves(plain[1])):
        assert torch.equal(a, b)
    ltol, gtol = (1e-5, 1e-3) if dtype == "float32" else (1e-2, 5e-2)
    flash = run(use_sc_gemm=False)
    ref = run(use_sc_gemm=False, attn_kernel="jnp")
    assert abs(float(flash[0]) - float(ref[0])) <= ltol * abs(float(ref[0]))
    for a, b in zip(tr.leaves(flash[1]), tr.leaves(ref[1])):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= gtol * b.float().abs().max().item()


def test_train_resumes_bit_for_bit(cuda, tmp_path):
    """Reduced smollm-360m (bf16, SC-GEMM at 8 bits) on the card: a
    ``train`` call's save restored equals its final weights; a step from a
    full state saved and restored equals the step from the state in
    memory bit for bit (the embedding's accumulating ``index_put_``
    backward sorts its indices on the card)."""
    from repro_torch import tree as tr
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as tt
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as opt_init
    cfg = ARCHS["smollm-360m"].reduced(dtype="bfloat16", use_sc_gemm=True)
    out = tt.train(cfg, steps=2, batch=4, seq=64, ckpt_dir=str(tmp_path),
                   device=cuda, log_every=100)
    m = bind(cfg, cuda)
    like = m.init_params(0)
    state = Checkpointer(tmp_path).restore(
        2, {"params": like, "opt": opt_init(like, AdamWConfig())})
    for a, b in zip(tr.leaves(state["params"]), tr.leaves(out["params"])):
        assert torch.equal(a, b) and a.device.type == "cuda"
    ck = Checkpointer(tmp_path / "state")
    ck.save(3, state)
    ck.wait()
    back = ck.restore(3, state)

    def step(s):
        return tt.train_step(m, s["params"], s["opt"],
                             _train_batch(cfg, 2, cuda), lr_peak=3e-4,
                             steps=4, optc=AdamWConfig())

    a, b = step(state), step(back)
    assert torch.equal(a[2], b[2])
    for x, y in zip(tr.leaves((a[0], a[1])), tr.leaves((b[0], b[1]))):
        assert torch.equal(x, y)


# ------------------------------------------- the kernels against the oracles

def _oracle_inputs(shapes, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dev) for s in shapes]


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
@pytest.mark.parametrize("h,kv,s,d", [(4, 2, 32, 16), (15, 5, 40, 64)])
def test_flash_kernel_matches_the_oracles(cuda, bits, h, kv, s, d):
    """The flash kernel (float32) against ``flash_attention_ref`` within
    2e-3 and, SC, against ``sc_flash_attention_ref`` within
    ``8 / (2**bits - 1)`` with the group the whole key row: the reference
    tests' tolerances (``tests/test_kernels.py:177``,
    ``tests/test_sc_attention.py:130``)."""
    from repro_torch.kernels import ref
    q, k, v = _oracle_inputs(((2, h, s, d), (2, kv, s, d), (2, kv, s, d)),
                             h + s, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, group=s, sc_bits=bits)
    assert flash_attention.launches == before + 1
    if bits is None:
        want = ref.flash_attention_ref(q, k, v, causal=True)
        torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-3)
    else:
        want = ref.sc_flash_attention_ref(q, k, v, bits=bits, causal=True)
        assert (out - want).abs().max() <= 8.0 / (2 ** bits - 1)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_kernel_sc_matches_the_decode_oracle(cuda, bits, window):
    """The paged kernel's SC path (pages of 4 keys, shuffled) and the dense
    decode layer (the paged kernel on a one-page-a-sequence view) against
    ``sc_decode_attention_ref`` within ``2 / (2**bits - 1)``
    (``tests/test_sc_attention.py:193``)."""
    from repro_torch.kernels import ref
    c, s, h, kv, d, block = 3, 16, 4, 2, 16, 4
    q, kc, vc = _oracle_inputs(((c, 1, h, d), (c, s, kv, d), (c, s, kv, d)),
                               bits, cuda)
    pos = torch.tensor([3, 9, 15], dtype=torch.int32, device=cuda)
    perm = torch.randperm(c * s // block,
                          generator=torch.Generator().manual_seed(bits))
    pages = [t.reshape(c * s // block, block, kv, d)[perm.argsort()]
             for t in (kc, vc)]
    trash = torch.zeros((1, block, kv, d), device=cuda)
    kp, vp = (torch.cat([p, trash]).contiguous() for p in pages)
    tables = perm.reshape(c, s // block).to(torch.int32).to(cuda)
    want = ref.sc_decode_attention_ref(q, kc, vc, q_position=pos, bits=bits,
                                       window=window)
    out = paged_attention(q.reshape(c, kv, h // kv, d), kp, vp, tables, pos,
                          window=window, sc_bits=bits)
    tol = 2.0 / (2 ** bits - 1)
    assert (out.reshape(c, 1, h, d) - want).abs().max() <= tol
    dense = layers.decode_attention(q, kc, vc, q_position=pos, window=window,
                                    sc_bits=bits)
    assert (dense - want).abs().max() <= tol


@pytest.mark.parametrize("bits", [4, 8])
def test_softcap_decode_on_the_card_matches_the_decode_oracle(cuda, bits):
    """Softcap layers take the gathered path on the card (the paged kernel
    takes no softcap), held to the decode oracle like the kernel."""
    from repro_torch.kernels import ref
    q, kc, vc = _oracle_inputs(((3, 1, 4, 16), (3, 12, 2, 16),
                                (3, 12, 2, 16)), bits + 50, cuda)
    pos = torch.tensor([3, 7, 11], dtype=torch.int32, device=cuda)
    out = layers.decode_attention(q, kc, vc, q_position=pos, window=6,
                                  logit_softcap=5.0, sc_bits=bits)
    want = ref.sc_decode_attention_ref(q, kc, vc, q_position=pos, bits=bits,
                                       window=6, logit_softcap=5.0)
    assert (out - want).abs().max() <= 2.0 / (2 ** bits - 1)


# ------------------------------------------- kernel operators and mesh steps

def _fake_meta(op, args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    return tuple(fake.shape), fake.dtype, fake.stride()


def test_kernel_operators_fake_meta_equals_the_real_output(cuda):
    """Each kernel operator's fake implementation gives its real output's
    shape, dtype and strides: SC-GEMM plain and batched (experts), paged
    and flash attention, float and SC, at smollm-360m's decode and chunk
    shapes and a small expert batch."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device=cuda).to(torch.bfloat16)

    ops_ = torch.ops.repro_torch
    pw, pe = pack_weight(rand(960, 2557), 8), pack_weight(rand(4, 96, 40), 8)
    pool = rand(17, 64, 5, 64)
    tables = torch.arange(16, dtype=torch.int32, device=cuda).reshape(4, 4)
    pos = torch.tensor([3, 70, 130, 255], dtype=torch.int32, device=cuda)
    q_rows = rand(1, 48, 15, 64).transpose(1, 2)
    kv_rows = rand(1, 64, 5, 64).transpose(1, 2)
    off = torch.tensor(16, dtype=torch.int32, device=cuda)
    calls = [(ops_.sc_linear, (rand(4, 960), pw.plane, pw.scale, 8,
                               pw.plane.shape[-1] - 2557, 0, 0)),
             (ops_.sc_linear, (rand(4, 7, 96), pe.plane, pe.scale, 8, 0, 0,
                               0))]
    for bits in (0, 8):
        calls += [(ops_.paged_attention, (rand(4, 5, 3, 64), pool, pool,
                                          tables, pos, 0, bits, 0.0)),
                  (ops_.paged_attention, (rand(4, 5, 3, 64), pool, pool,
                                          tables, pos, 0, bits, 50.0)),
                  (ops_.flash_attention, (q_rows, kv_rows, kv_rows, None, 16,
                                          True, 64, bits, 0, 0)),
                  (ops_.flash_attention, (q_rows, kv_rows, kv_rows, off, 0,
                                          True, 64, bits, 0, 0))]
    for op, args in calls:
        real = op(*args)
        assert _fake_meta(op, args) == (tuple(real.shape), real.dtype,
                                         real.stride()), op


def test_mesh_steps_on_one_nccl_rank_are_bit_equal(cuda):
    """On one NCCL rank (a 1x1 mesh), reduced smollm-360m in bf16 under
    SC-GEMM at 8 bits: the mesh-bound train and paged decode steps run
    through the kernel operators (launches counted) and equal
    ``launch.train.train_step`` and the eager paged decode step bit for
    bit."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch import tree as tr
    from repro_torch.launch import mesh_steps as ms
    from repro_torch.launch import steps as eager
    from repro_torch.launch import train as tt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import cache_ops, pack_sc_weights
    from repro_torch.optim import init as opt_init
    from repro_torch.parallel.sharding import distribute
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(
        dtype="bfloat16"), use_sc_gemm=True, sc_bits=8).validate()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        m = bind(cfg, cuda)
        params = m.init_params(0)
        gen = torch.Generator(device=cuda).manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device=cuda, dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}
        counters = ops.launch_counters()
        step, sh, _, optc = ms.build_train_step(cfg, mesh, warmup=1,
                                                total_steps=20)
        opt = opt_init(params, optc)
        want_p, _, want_loss, _ = tt.train_step(m, params, opt, batch,
                                                lr_peak=3e-4, steps=20,
                                                optc=optc)
        before = {n: c.launches for n, c in counters.items()}
        got_p, _, metrics = step(distribute(params, sh["params"]),
                                 distribute(opt, sh["opt"]),
                                 distribute(batch, sh["batch_fn"](batch)))
        n_sc = counters["sc_linear"].launches - before["sc_linear"]
        n_flash = (counters["flash_attention"].launches
                   - before["flash_attention"])
        assert n_sc > 0 and n_flash > 0
        assert torch.equal(metrics["loss"].full_tensor(), want_loss)
        for a, b in zip(tr.leaves(got_p), tr.leaves(want_p)):
            assert torch.equal(a.full_tensor(), b)

        pool = cache_ops.paged_init(m.init_cache, 4, 16, 16)
        for leaf in cache_ops.seq_leaves(pool):
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=cuda)
                       .to(leaf.dtype))
        pool.pos.copy_(torch.tensor([3, 20, 40, 63], device=cuda,
                                    dtype=pool.pos.dtype))
        tables = torch.arange(16, dtype=torch.int32,
                              device=cuda).reshape(4, 4)
        one = {"tokens": toks[:, :1].repeat(2, 1)}
        want_logits, want_pool = eager.paged_decode_step(
            m, pack_sc_weights(params, cfg),
            tr.tree_map(lambda t: t.clone(), pool), tables, one)
        step, sh, _ = ms.build_paged_decode_step(
            cfg, mesh, capacity=4, block=16, n_blocks=16, max_blocks=4)
        before = counters["paged_attention"].launches
        logits, got_pool = step(
            distribute(params, sh["params"]),
            distribute(tr.tree_map(lambda t: t.clone(), pool), sh["cache"]),
            distribute(tables, sh["tables"]),
            distribute(one, sh["batch_fn"](one)))
        assert counters["paged_attention"].launches > before
        assert torch.equal(logits.full_tensor(), want_logits)
        for a, b in zip(tr.leaves(got_pool), tr.leaves(want_pool)):
            assert torch.equal(a.full_tensor(), b)
    finally:
        dist.destroy_process_group()


#: the mesh engine's requests on the card: two 32-token prompts, then the
#: first again (a prefix hit whose resume page is copied on write)
ENGINE_MESH_KW = dict(capacity=2, max_seq=64, block=16, chunk=8)


def case_engine_mesh_on_one_nccl_rank(rank: int, world: int) -> dict:
    """Reduced smollm-360m (bf16, SC-GEMM at 8 bits) served by the graphed
    plain engine and then on ``default_serving_mesh()`` chunked and
    one-shot, the launch counters read around each mesh run."""
    from repro_torch.serving import default_serving_mesh
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(
        dtype="bfloat16"), use_sc_gemm=True, sc_bits=8).validate()
    params = bind(cfg, "cuda").init_params(0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)
               for _ in range(2)]
    prompts.append(prompts[0])

    def requests():
        return [Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(zip(prompts, (6, 9, 5)))]

    keys = ("prefix_hits", "cow_copies", "prefill_tokens_saved")
    out = {}
    mesh = default_serving_mesh()
    counters = ops.launch_counters()
    for mode in ("chunked", "oneshot"):
        plain = Engine(cfg, params, prefill_mode=mode, **ENGINE_MESH_KW)
        want = plain.run(requests())
        for c in counters.values():
            c.launches = 0
        engine = Engine(cfg, params, mesh=mesh, prefill_mode=mode,
                        **ENGINE_MESH_KW)
        got = engine.run(requests())
        torch.cuda.synchronize()
        out[mode] = {
            "graphs": plain.stats["decode_graphs"],
            "mesh": engine.stats["mesh"],
            "equal": all(np.array_equal(a.tokens, b.tokens)
                         for a, b in zip(got, want)),
            "stats": ({k: engine.stats.get(k) for k in keys},
                      {k: plain.stats.get(k) for k in keys}),
            "launches": {n: c.launches for n, c in counters.items()}}
    return out


def test_engine_mesh_on_one_nccl_rank_equals_the_graphed_engine(cuda,
                                                                tmp_path):
    """One NCCL rank in a process of its own (``tests/_torch_spawn.py``):
    the mesh engine's streams and prefix stats bit-equal to the graphed
    plain engine's, chunked and one-shot, through the SC-GEMM, paged and
    flash kernels."""
    from _torch_spawn import spawn
    out = spawn("test_torch_gpu:case_engine_mesh_on_one_nccl_rank", 1,
                tmp_path / "ranks", deadline_s=600, backend="nccl")[0]
    for mode, r in out.items():
        assert r["graphs"] and r["mesh"] == {"data": 1, "model": 1}, mode
        assert r["equal"], mode
        assert r["stats"][0] == r["stats"][1], (mode, r["stats"])
        for name in ("sc_linear", "paged_attention", "flash_attention"):
            assert r["launches"][name] > 0, (mode, name, r["launches"])
    assert out["chunked"]["stats"][0]["prefix_hits"] == 1
    assert out["chunked"]["stats"][0]["cow_copies"] == 1


# -- the analysis layer's contract audits on the card ----------------------

#: the kernels (launch counter names) each audit's path runs on the card
AUDIT_KERNELS = {
    "popcount-path": {"sc_stream_mul"},
    "reduction-parity": {"paged_attention"},
    "capture-counts": {"sc_linear", "paged_attention", "flash_attention"},
    "cow-protocol": {"sc_linear", "paged_attention", "flash_attention"}}


@pytest.mark.parametrize("name", [n for n, _ in contracts.AUDITS])
def test_analysis_audit_passes_on_the_card(cuda, name):
    """Each contract audit on the card, its engines graphed: the stream
    kernel, the paged kernel for both decode paths, SC-GEMM, flash and
    paged through captured steps."""
    counters = ops.launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    assert dict(contracts.AUDITS)[name](cuda) == []
    launched = {k for k, c in counters.items() if c.launches > before[k]}
    assert AUDIT_KERNELS[name] <= launched, launched


# ------------------------------------------------------------- examples

def test_examples_quickstart_on_the_card(cuda):
    """Table I, the MAE and Table II on the card equal the CPU's value for
    value; on the SC-GEMM operands the kernel (one launch) gives the
    counts of ``mxu_split``."""
    from repro_torch.core import sc_matmul
    from repro_torch.core.sc_numerics import recover_counts
    from repro_torch.examples import quickstart
    got = quickstart.main(["--device", "cuda"])
    want = quickstart.main(["--device", "cpu"])
    for key in ("table1", "mae", "table2"):
        assert got[key] == want[key], key
    a, b = quickstart.sc_gemm_operands(cuda)
    before = sc_matmul_counts_signed.launches
    kernel = sc_matmul(a, b, bits=8, impl="pallas")
    assert sc_matmul_counts_signed.launches == before + 1
    plain = sc_matmul(a, b, bits=8, impl="mxu_split")
    np.testing.assert_array_equal(recover_counts(kernel, a.cpu(), b.cpu()),
                                  recover_counts(plain, a.cpu(), b.cpu()))


def test_examples_sc_gemm_inference_on_the_card(cuda):
    """The card's numbers within the example's stated tolerances of the
    CPU's on the same parameters; every SC projection one SC-GEMM launch,
    equal to ``mxu_split``'s on the card."""
    from repro_torch.examples import sc_gemm_inference as ex
    before = sc_linear.launches
    got = ex.main(["--device", "cuda"])
    cfg_exact, cfg_sc, params, tokens = ex.inputs(cuda)
    assert sc_linear.launches - before == ex.sc_launches(cfg_sc)
    assert ex.card_mismatches(got, ex.main(["--device", "cpu"])) == []
    plain = ex.compare(cfg_exact,
                       dataclasses.replace(cfg_sc, sc_impl="mxu_split"),
                       params, tokens, cuda)
    assert {k: got[k] for k in plain} == plain


def test_examples_serve_lm_on_the_card(cuda):
    """Three families' ``(4, 16)`` streams, the same again from the same
    seed, and at temperature 0 the CPU's."""
    from repro_torch.examples import serve_lm
    out = serve_lm.main(["--device", "cuda"])
    for arch in serve_lm.ARCH_NAMES:
        assert tuple(out[arch]["tokens"].shape) == (4, 16)
        cfg, params, prompts = serve_lm.setup(arch, cuda)
        again = serve_lm.serve(cfg, params, prompts, 0.8, cuda)["tokens"]
        assert torch.equal(again, out[arch]["tokens"]), arch
        greedy = serve_lm.serve(cfg, params, prompts, 0.0, cuda)["tokens"]
        _, cpu_params, _ = serve_lm.setup(arch, "cpu")
        cpu = serve_lm.serve(cfg, cpu_params, prompts, 0.0, "cpu")["tokens"]
        assert torch.equal(greedy, cpu), arch


def test_examples_train_lm_on_the_card(cuda, capsys):
    """Two calls on one checkpoint folder: the second restores the first's
    save, the loss falls and every loss is finite."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--device", "cuda", "--steps", "8", "--batch", "8",
                         "--seq", "128"])
    assert "[train] restored step 4 from" in capsys.readouterr().out
    assert out["last"] < out["first"]
    assert all(math.isfinite(x) for x in out["losses"][0] + out["losses"][1])
    assert out["peak_bytes"] > 0
