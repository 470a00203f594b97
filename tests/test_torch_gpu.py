"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need a CUDA device and skip elsewhere; this file imports
no JAX, so it runs where the card is (the machine has no JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.) ``chip_smoke.py``
checks the same kernels at the main path's shapes; here the geometries are
the odd ones: ragged extents, every row-block width, page sizes that are
not tile multiples, windows, single-KV-head layouts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_torch)
from repro_torch.kernels.sc_matmul import (pack_signed,
                                           sc_matmul_counts_signed,
                                           sc_matmul_counts_signed_torch)
from repro_torch.launch.serve import generate
from repro_torch.models import bind, layers
from repro_torch.serving import Engine, Request

pytestmark = pytest.mark.gpu

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


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
    (4, 600, 50, 12), (3, 200, 96, 16), (7, 0, 9, 8)])
def test_sc_counts_kernel_equals_plain(cuda, m, k, n, bits):
    a, b = _planes(m, k, n, bits, seed=m * 7 + k + n)
    a, b = a.to(cuda), b.to(cuda)
    before = sc_matmul_counts_signed.launches
    got = sc_matmul_counts_signed(a, b, bits=bits)
    assert sc_matmul_counts_signed.launches == before + 1
    want = sc_matmul_counts_signed_torch(a, b, bits=bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
], ids=range(6))
def test_paged_kernel_equals_plain(cuda, geom, dtype):
    c, kv, g, d, block, mb, positions, window = geom
    args = _paged(c, kv, g, d, block, mb, positions, sum(positions), dtype,
                  cuda)
    before = paged_attention.launches
    got = paged_attention(*args, window=window)
    assert paged_attention.launches == before + 1 and got.dtype == dtype
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
    res = engine.run([Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
                      for i, (p, g) in enumerate(zip(prompts, gens))])
    for r, p, g in zip(res, prompts, gens):
        ref = generate(cfg, params, p[None], gen_tokens=g, device=cuda)
        np.testing.assert_array_equal(r.tokens, ref[0].cpu().numpy())
