"""Weights packed once and the fused SC-GEMM projection, held against the
JAX package: ``pack_weight`` planes and scales against JAX's quantization,
the fused function's plain version against the Pallas wrapper (interpret
mode) in recovered counts, bit-equality with the unfused chain, repacking
after an in-place change, engine streams with packed weights against the
JAX engine's, and the divisors built on the device.

Inputs are made with numpy from a seed and cast explicitly
(``tests/conftest.py`` turns on JAX x64 for every test)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.sc_numerics import quantize_sign_magnitude as jquant
from repro.core.sc_numerics import recover_counts as jrecover
from repro.kernels.ops import sc_matmul_pallas
from repro.models import bind as jbind
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.core import error_analysis, multipliers, sc_layers
from repro_torch.core.sc_layers import sc_dense, sc_proj
from repro_torch.core.sc_numerics import quantize_sign_magnitude
from repro_torch.core.tcu import stream_length
from repro_torch.errors import ConfigError
from repro_torch.kernels import sc_matmul as skm
from repro_torch.kernels.sc_attention import sc_quant_rows
from repro_torch.kernels.sc_matmul import (pack_signed, pack_weight, plan,
                                           sc_linear, sc_linear_torch,
                                           sc_matmul_counts_signed_torch)
from repro_torch.launch.serve import generate
from repro_torch.models.transformer import pack_sc_weights, params_to
from repro_torch.serving import Engine, Request

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

# (M, K, N): M on both sides of the 16-row tile, ragged N and K
SHAPES = [(1, 64, 40), (4, 96, 24), (16, 130, 72), (17, 33, 17),
          (64, 48, 9)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    return x, w


def _chain(x, w, bits):
    """The unfused chain: quantize both operands, pack, count, dequantize,
    cast — what every projection ran before weights were packed once."""
    qa = quantize_sign_magnitude(x.to(torch.float32), bits=bits, axis=-1)
    qb = quantize_sign_magnitude(w.to(torch.float32), bits=bits)
    counts = sc_matmul_counts_signed_torch(pack_signed(qa.sign, qa.mag, bits),
                                           pack_signed(qb.sign, qb.mag, bits),
                                           bits=bits)
    return (counts * (stream_length(bits) * qa.scale * qb.scale)).to(x.dtype)


@pytest.mark.parametrize("rows", [None, 3], ids=["whole", "blocks-of-3"])
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [40, 37])
def test_pack_weight_planes_equal_jax_quantization(bits, n, rows,
                                                   monkeypatch):
    """Also when the pack is made in blocks of 3 rows (the last one 1 row)
    at the whole weight's scale."""
    if rows:
        monkeypatch.setattr(skm, "PACK_CHUNK", rows * n)
    _, w = _operands(1, 70, n, seed=bits * 100 + n)
    pw = pack_weight(torch.as_tensor(w), bits)
    j = jquant(jnp.asarray(w), bits=bits)
    want = np.asarray(j.sign).astype(np.int64) * np.asarray(j.mag)
    assert pw.shape == (70, n) and pw.bits == bits
    assert pw.plane.dtype == (torch.int16 if bits <= 15 else torch.int32)
    assert pw.plane.shape == (70, -(-n // 8) * 8) and pw.plane.is_contiguous()
    np.testing.assert_array_equal(pw.plane[:, :n].numpy(), want)
    assert not pw.plane[:, n:].any()
    # the scale is the IEEE quotient absmax / n_max, bit for bit, as the
    # per-call quantization gives it; XLA divides JAX's by a constant
    # through its reciprocal, which may land one ulp off
    assert pw.scale.dtype == torch.float32 and pw.scale.dim() == 0
    exact = np.float32(np.abs(w).max()) / np.float32((1 << bits) - 1)
    bits_of = np.float32(pw.scale.item()).view(np.uint32)
    assert bits_of == exact.view(np.uint32)
    assert bits_of == np.float32(quantize_sign_magnitude(
        torch.as_tensor(w), bits=bits).scale.item()).view(np.uint32)
    assert abs(int(bits_of) - int(np.asarray(j.scale, np.float32)
                                  .view(np.uint32))) <= 1


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_plain_counts_equal_pallas_interpret(shape, bits):
    m, k, n = shape
    x, w = _operands(m, k, n, seed=m * 1000 + k + n + bits)
    j = sc_matmul_pallas(jnp.asarray(x), jnp.asarray(w), bits=bits, bm=8,
                         bn=128, bk=128, chunk=8, row_quant=True,
                         interpret=True)
    t = sc_linear(torch.as_tensor(x), pack_weight(torch.as_tensor(w), bits))
    assert t.dtype == torch.float32 and t.shape == (m, n)
    np.testing.assert_array_equal(
        jrecover(t.numpy(), x, w, bits=bits, row_quant=True),
        jrecover(np.asarray(j), x, w, bits=bits, row_quant=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [1, 3, 8, 12])
def test_fused_plain_equals_unfused_chain_bitwise(bits, dtype):
    x, w = _operands(6, 90, 33, seed=bits)
    xt, wt = torch.as_tensor(x).to(dtype), torch.as_tensor(w).to(dtype)
    pw = pack_weight(wt, bits)
    got = sc_linear(xt, pw)
    assert got.dtype == dtype
    assert torch.equal(got, sc_linear_torch(xt, pw))
    assert torch.equal(got, _chain(xt, wt, bits))
    # the per-call layer path (weight quantized per call) gives the same
    assert torch.equal(got, sc_dense(xt, wt, bits, "pallas"))
    assert torch.equal(got, sc_dense(xt, wt, bits, "mxu_split"))


def test_fused_rows_are_batch_invariant():
    x, w = _operands(9, 64, 20, seed=4)
    pw = pack_weight(torch.as_tensor(w), 8)
    whole = sc_linear(torch.as_tensor(x), pw)
    for i in range(9):
        assert torch.equal(whole[i:i + 1],
                           sc_linear(torch.as_tensor(x[i:i + 1]), pw))


def test_plan_fills_the_card_at_every_decode_shape():
    """Every smollm-360m decode shape launches at least one full wave on
    132 SMs; each block's K range is a whole number of 32-row stages and
    the ranges cover K."""
    for k, n in ((960, 960), (960, 320), (960, 2560), (2560, 960),
                 (960, 49152)):
        for m in (1, 4, 16, 64):
            mr, kc, splits = plan(m, n, k, 132)
            assert mr == min(16, 1 << (m - 1).bit_length())
            assert kc % 32 == 0 and kc * splits >= k > kc * (splits - 1)
            assert mr * kc <= skm.A_SMEM_ENTRIES
            blocks = -(-n // 64) * -(-m // mr) * splits
            assert blocks >= 132, (m, k, n, blocks)
    assert plan(7, 9, 0, 132)[2] == 1


def test_sc_proj_takes_the_packed_weight_and_checks_it():
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                              use_sc_gemm=True)
    x, w = _operands(5, 64, 16, seed=6)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    pw = pack_weight(wt, cfg.sc_bits)
    assert torch.equal(sc_proj(xt, wt, cfg, pw), sc_dense(xt, wt, 8))
    # a gradient takes the per-call straight-through path
    xg = xt.clone().requires_grad_(True)
    out = sc_proj(xg, wt, cfg, pw)
    out.sum().backward()
    assert torch.equal(out.detach(), sc_dense(xt, wt, 8))
    assert xg.grad is not None
    with pytest.raises(ConfigError, match="pack the parameters again"):
        sc_proj(xt, wt, cfg, pack_weight(wt, 4))
    with pytest.raises(ConfigError, match="pack the parameters again"):
        sc_proj(xt[:, :32], wt[:32], cfg, pw)


@pytest.mark.parametrize("impl,env,packed_path", [
    ("auto", None, True), ("pallas", None, True), ("pallas_tuned", None, True),
    ("ref", None, False), ("reference", None, False),
    ("mxu_split", None, False), ("auto", "ref", False),
    ("auto", "mxu_split", False), ("auto", "pallas", True),
    ("mxu_split", "pallas", False)])
def test_sc_proj_takes_the_packed_weight_only_for_the_kernel_path(
        monkeypatch, impl, env, packed_path):
    """``cfg.sc_impl`` (and ``$REPRO_SC_IMPL`` when it is "auto") still
    picks the formulation with packed weights: the kernel path's names take
    the fused function, the plain formulations their per-call path; the
    bits are the same."""
    if env is None:
        monkeypatch.delenv("REPRO_SC_IMPL", raising=False)
    else:
        monkeypatch.setenv("REPRO_SC_IMPL", env)
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                              use_sc_gemm=True, sc_impl=impl)
    x, w = _operands(5, 64, 16, seed=7)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    calls = []
    monkeypatch.setattr(sc_layers, "sc_linear",
                        lambda x, pw, **kw: calls.append(1)
                        or sc_linear(x, pw, **kw))
    got = sc_proj(xt, wt, cfg, pack_weight(wt, cfg.sc_bits))
    assert bool(calls) == packed_path
    assert torch.equal(got, sc_dense(xt, wt, 8, "mxu_split"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_fused_plain_rows_holding_nan_or_inf(bits, dtype):
    """A row holding a NaN comes out NaN, as amax and clamp_min carry it
    into the row's scale; so does a row holding an Inf at bits <= 15 (its
    scale is Inf and its magnitudes 0). The other rows keep their bits,
    and the unfused chain agrees."""
    x, w = _operands(6, 70, 24, seed=bits)
    x[1, 5], x[3, 69], x[4, 0] = np.nan, np.inf, -np.inf
    xt, wt = torch.as_tensor(x).to(dtype), torch.as_tensor(w).to(dtype)
    pw = pack_weight(wt, bits)
    got = sc_linear(xt, pw)
    assert got[[1, 3, 4] if bits <= 15 else [1]].isnan().all()
    clean = [0, 2, 5]
    assert not got[clean].isnan().any()
    assert torch.equal(got[clean], sc_linear(xt[clean], pw))
    torch.testing.assert_close(got, _chain(xt, wt, bits), rtol=0, atol=0,
                               equal_nan=True)


GENS = [3, 7, 2, 5, 4]
PROMPT_LENS = [8, 13, 5, 8, 10]


def _setup():
    jcfg = JAX_ARCHS["smollm-360m"].reduced(dtype="float32", use_sc_gemm=True)
    tcfg = ARCHS["smollm-360m"].reduced(dtype="float32", use_sc_gemm=True)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS]


def test_engine_streams_with_packed_weights_equal_jax_engine(monkeypatch):
    """The engine packs its weights once: every projection of the run goes
    through the fused function (7 a layer and the head, per decode step
    and per prefill chunk), none through the per-call path, and the streams
    equal the JAX engine's and the sequential baseline's."""
    jcfg, jp, tcfg, tp = _setup()
    prompts = _prompts()
    kw = dict(capacity=2, max_seq=max(PROMPT_LENS) + max(GENS), block=4,
              chunk=8)
    jres = JaxEngine(jcfg, jp, prefix_cache=False, **kw).run(
        [JaxRequest(uid=f"r{i}", prompt=p, max_new_tokens=g)
         for i, (p, g) in enumerate(zip(prompts, GENS))])
    engine = Engine(tcfg, tp, device="cpu", **kw)
    calls = []
    real = skm.sc_linear_torch
    monkeypatch.setattr(skm, "sc_linear_torch",
                        lambda x, pw: calls.append(x.shape) or real(x, pw))

    def per_call(*a, **k):
        raise AssertionError("a serving projection quantized its weight")

    monkeypatch.setattr(sc_layers, "sc_dense", per_call)
    res = engine.run([Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
                      for i, (p, g) in enumerate(zip(prompts, GENS))])
    st = engine.stats
    per_pass = 7 * tcfg.n_layers + 1
    assert len(calls) == per_pass * (st["decode_steps"]
                                     + st["prefill_chunks"])
    monkeypatch.undo()
    for r, j, p, g in zip(res, jres, prompts, GENS):
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
        base = generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")
        np.testing.assert_array_equal(r.tokens, base[0].numpy())


def test_weight_changed_in_place_is_packed_anew():
    """Packed planes are a snapshot of the float weights: packing again
    after an in-place change gives new planes, and an engine built from a
    tree that still holds the old planes packs anew and serves the new
    weights."""
    _, _, tcfg, tp = _setup()
    packed = pack_sc_weights(tp, tcfg)
    w1 = packed["layers"][0]["mlp"]["w1"]
    old = packed["layers"][0]["mlp"]["packed"]["w1"]
    assert w1 is tp["layers"][0]["mlp"]["w1"]
    with torch.no_grad():
        w1[:, :3] *= -2.0                  # the caller's weight, in place
    new = pack_weight(w1, tcfg.sc_bits)
    assert not torch.equal(new.plane, old.plane)
    again = pack_sc_weights(packed, tcfg)["layers"][0]["mlp"]["packed"]["w1"]
    assert torch.equal(again.plane, new.plane)
    assert torch.equal(again.scale, new.scale)

    prompts = _prompts(seed=4)[:2]
    engine = Engine(tcfg, packed, device="cpu", capacity=2, max_seq=20,
                    block=4, chunk=4)
    served = engine._params["layers"][0]["mlp"]["packed"]["w1"]
    assert torch.equal(served.plane, new.plane)
    res = engine.run([Request(uid=f"r{i}", prompt=p, max_new_tokens=4)
                      for i, p in enumerate(prompts)])
    for r, p in zip(res, prompts):
        base = generate(tcfg, tp, p[None], gen_tokens=4, device="cpu")
        np.testing.assert_array_equal(r.tokens, base[0].numpy())


def test_packed_tree_moves_with_params_to():
    _, _, tcfg, tp = _setup()
    packed = params_to(pack_sc_weights(tp, tcfg), "cpu")
    pw = packed["packed"]["head"]
    assert isinstance(pw, skm.PackedWeight)
    assert pw.shape == (tcfg.d_model, tcfg.vocab_size)
    assert pack_sc_weights(tp, dataclasses.replace(tcfg, use_sc_gemm=False)) \
        is tp


@pytest.mark.parametrize("case", ["quantize", "quantize_rows", "sc_quant_rows",
                                  "ratio", "abs_error", "emb_scale"])
def test_divisors_built_on_the_device_are_bit_equal(case):
    """Each divisor is now filled on the tensor's device instead of copied
    from the host; the results are bit-equal to the former host-built
    divisor."""
    rng = np.random.default_rng(8)
    v = torch.as_tensor((rng.standard_normal((5, 37)) * 3).astype(np.float32))
    if case in ("quantize", "quantize_rows"):
        axis = -1 if case == "quantize_rows" else None
        got = quantize_sign_magnitude(v, bits=8, axis=axis).scale
        amax = v.abs().amax() if axis is None else v.abs().amax(-1, True)
        want = amax.clamp_min(1e-12) / amax.new_tensor(255.0)
        exact = (amax.numpy().astype(np.float32) / np.float32(255))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      exact.view(np.uint32))
    elif case == "sc_quant_rows":
        got = sc_quant_rows(v, 6).scale
        amax = v.abs().amax(-1, True)
        want = amax.clamp_min(1e-12) / amax.new_tensor(63.0)
    elif case == "ratio":
        c = torch.arange(0, 3000, dtype=torch.int32)
        got = multipliers._ratio(c, 255)
        want = c.float() / c.float().new_tensor(255.0)
    elif case == "abs_error":
        fn = multipliers.MULTIPLIERS["proposed"]
        got = error_analysis._abs_error(fn, 6, torch.device("cpu"))
        x, y = error_analysis.exhaustive_grid(6, torch.device("cpu"))
        prod = x.to(torch.float32) * y
        want = torch.abs(fn(x, y, 6) - prod / prod.new_tensor(4096.0))
    else:
        cfg = ARCHS["gemma2-9b"].reduced(dtype="float32")
        assert cfg.emb_scale
        tp = {"embed": torch.as_tensor(
            rng.standard_normal((cfg.vocab_size, cfg.d_model)),
            dtype=torch.float32)}
        from repro_torch.models.transformer import _embed_tokens
        toks = torch.as_tensor([[1, 5, 7]])
        got = _embed_tokens(tp, cfg, toks)
        want = tp["embed"][toks] * torch.tensor(cfg.d_model ** 0.5)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
