"""SC attention (``cfg.attn_sc``) through the PyTorch port's model and engine,
held against the JAX package on a reduced smollm-360m (float32) with the
JAX parameters carried across.

What can be held, and to what:

* SC attention on its own (projections exact) at 4 and 8 bits: logits
  within atol 1e-4 (rtol 1e-4) and greedy tokens equal — one-shot prefill,
  dense decode, chunked prefill and paged decode.
* SC attention with 8-bit SC-GEMM: greedy tokens equal; logits within 0.5.
  SC-GEMM requantizes every activation row, and an ulp of difference that
  lands on a rounding boundary moves a magnitude one step, which later
  layers carry; the JAX package's own jitted and eager runs drift apart
  that way.
* 4-bit SC-GEMM amplifies one ulp into different tokens even between the
  JAX package's jitted and eager runs (ROADMAP Queue 3), so there only the
  port's own contract is held: engine streams equal its sequential
  baseline, in both prefill modes.

Engine streams equal the port's ``generate`` baseline and the JAX engine's
streams, chunked and one-shot, as ``tests/test_sc_attention.py`` holds the
JAX engine to its baseline."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import bind as jbind
from repro.models import cache_ops as jops
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.models import cache_ops as tops
from repro_torch.serving import Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

EXACT_PROJ = dict(rtol=1e-4, atol=1e-4)
SC_GEMM_8 = dict(rtol=0, atol=0.5)


def _setup(bits: int, sc_gemm: bool):
    kw = dict(dtype="float32", use_sc_gemm=sc_gemm, attn_sc=True,
              sc_bits=bits)
    jcfg = JAX_ARCHS["smollm-360m"].reduced(**kw)
    tcfg = ARCHS["smollm-360m"].reduced(**kw)
    jm = jbind(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, bind(tcfg, "cpu"), tp


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, n)).astype(
        np.int32)


CASES = [(4, False), (8, False), (8, True)]
IDS = ["sc4-attn", "sc8-attn", "sc8-attn-gemm"]


@pytest.mark.parametrize("bits,sc_gemm", CASES, ids=IDS)
def test_sc_attention_prefill_and_decode_equal_jax(bits, sc_gemm):
    _, jm, jp, _, tm, tp = _setup(bits, sc_gemm)
    tol = SC_GEMM_8 if sc_gemm else EXACT_PROJ
    toks = _tokens(11, seed=1)
    jdecode = jax.jit(jm.decode_step)
    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 extra_slots=4)
        tl, tc = tm.prefill_step(tp, {"tokens": torch.as_tensor(toks)},
                                 extra_slots=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        for _ in range(3):
            nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
            assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
            jl, jc = jdecode(jp, jc, {"tokens": jnp.asarray(nxt)[:, None]})
            tl, tc = tm.decode_step(tp, tc,
                                    {"tokens": torch.as_tensor(nxt)[:, None]})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


@pytest.mark.parametrize("bits,sc_gemm", CASES, ids=IDS)
def test_sc_attention_chunked_prefill_and_paged_decode_equal_jax(bits,
                                                                 sc_gemm):
    """The engine's route under SC attention: chunks into a bucket-extent
    staging cache, admission into the page pool, batched paged decode."""
    _, jm, jp, _, tm, tp = _setup(bits, sc_gemm)
    tol = SC_GEMM_8 if sc_gemm else EXACT_PROJ
    chunk, bucket, block, capacity, mb = 8, 32, 8, 2, 4
    prompts = [_tokens(19, seed=2)[0], _tokens(12, seed=3)[0]]
    jdata = jops.paged_init(jm.init_cache, capacity, capacity * mb, block)
    tdata = tops.paged_init(tm.init_cache, capacity, capacity * mb, block)
    tables = np.full((capacity, mb), -1, np.int32)
    free = [5, 2, 7, 0, 1, 3, 4, 6]
    first = []
    jchunk = jax.jit(jm.prefill_chunk_step)
    jdecode = jax.jit(jm.paged_decode_step)
    with torch.no_grad():
        for slot, prompt in enumerate(prompts):
            jc, tc = jm.init_cache(1, bucket), tm.init_cache(1, bucket)
            for off in range(0, len(prompt), chunk):
                nv = min(chunk, len(prompt) - off)
                toks = np.zeros((1, chunk), np.int32)
                toks[0, :nv] = prompt[off:off + nv]
                jl, jc = jchunk(
                    jp, jc, {"tokens": jnp.asarray(toks),
                             "n_valid": jnp.asarray([nv], jnp.int32)})
                tl, tc = tm.prefill_chunk_step(
                    tp, tc, {"tokens": torch.as_tensor(toks), "n_valid": nv})
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
            # chunked prefill equals a one-shot prefill of the prompt
            tl1, _ = tm.prefill_step(tp, {"tokens": torch.as_tensor(
                prompt[None])})
            assert torch.equal(tl, tl1)
            pages = [free.pop() for _ in range(-(-(len(prompt) + 1) // block))]
            tables[slot, :len(pages)] = pages
            jdata = jops.paged_insert(jdata, jops.truncate_seq(
                jc, len(prompt)), slot, pages, block=block)
            tdata = tops.paged_insert(tdata, tops.truncate_seq(
                tc, len(prompt)), slot, pages, block=block)
            first.append(int(np.argmax(np.asarray(jl)[0, -1])))
            assert int(tl[0, -1].argmax()) == first[-1]
        tok = np.asarray(first, np.int32)[:, None]
        jt, tt = jnp.asarray(tables), torch.as_tensor(tables)
        for _ in range(3):
            jl, jdata = jdecode(jp, jdata, jt, {"tokens": jnp.asarray(tok)})
            tl, tdata = tm.paged_decode_step(tp, tdata, tt,
                                             {"tokens": torch.as_tensor(tok)})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
            tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
            assert np.array_equal(tl[:, -1].argmax(-1).numpy()[:, None], tok)


PROMPT_LENS = [8, 13, 5, 10]
GENS = [3, 6, 2, 5]


def _prompts(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _requests(cls, prompts):
    return [cls(uid=f"r{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, GENS))]


ENGINE_KW = dict(capacity=2, max_seq=max(PROMPT_LENS) + max(GENS), block=4,
                 chunk=8)


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("bits,sc_gemm", [(4, False), (8, True)],
                         ids=["sc4-attn", "sc8-attn-gemm"])
def test_engine_sc_streams_equal_baseline_and_jax_engine(bits, sc_gemm,
                                                         mode):
    jcfg, _, jp, tcfg, _, tp = _setup(bits, sc_gemm)
    prompts = _prompts()
    jax_res = JaxEngine(jcfg, jp, prefix_cache=False, prefill_mode=mode,
                        **ENGINE_KW).run(_requests(JaxRequest, prompts))
    engine = Engine(tcfg, tp, device="cpu", prefill_mode=mode, **ENGINE_KW)
    res = engine.run(_requests(Request, prompts))
    assert engine.stats["attn_sc_bits"] == bits
    for r, j, p, g in zip(res, jax_res, prompts, GENS):
        base = generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")
        np.testing.assert_array_equal(r.tokens, base[0].numpy(),
                                      err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_engine_sc4_gemm_streams_equal_sequential_baseline(mode):
    """4-bit SC-GEMM and SC attention together: the port's batch
    invariance, streams against its own sequential baseline."""
    _, _, _, tcfg, _, tp = _setup(4, True)
    prompts = _prompts(seed=6)
    engine = Engine(tcfg, tp, device="cpu", prefill_mode=mode, **ENGINE_KW)
    for r, p, g in zip(engine.run(_requests(Request, prompts)), prompts,
                       GENS):
        base = generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")
        np.testing.assert_array_equal(r.tokens, base[0].numpy(),
                                      err_msg=r.uid)
