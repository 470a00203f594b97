"""The PyTorch port's dense transformer held against the JAX package on a
reduced smollm-360m (float32), SC-GEMM on and off, with the JAX parameters
carried across by ``repro_torch.convert``.

Tolerance: logits within atol 1e-4 (rtol 1e-4). Under SC-GEMM the
projections are integer-exact on both sides; what differs is the order of
float summation in norms and attention, and a per-row quantization scale
that may sit an ulp apart. Greedy tokens must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import bind as jbind
from repro.models import cache_ops as jops
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.models import bind
from repro_torch.models import cache_ops as tops
from repro_torch.models.transformer import init_params

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(sc: bool, arch: str = "smollm-360m"):
    jcfg = JAX_ARCHS[arch].reduced(dtype="float32", use_sc_gemm=sc)
    tcfg = ARCHS[arch].reduced(dtype="float32", use_sc_gemm=sc)
    jm = jbind(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, bind(tcfg, "cpu"), tp


def _tokens(n, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefill_and_decode_logits_equal_jax(sc):
    jm, jp, tm, tp = _setup(sc)
    toks = _tokens(11, seed=1)
    jdecode = jax.jit(jm.decode_step)
    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 extra_slots=4)
        tl, tc = tm.prefill_step(tp, {"tokens": torch.as_tensor(toks)},
                                 extra_slots=4)
        _close(tl, jl)
        for _ in range(2):
            nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
            assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
            jl, jc = jdecode(jp, jc, {"tokens": jnp.asarray(nxt)[:, None]})
            tl, tc = tm.decode_step(tp, tc,
                                    {"tokens": torch.as_tensor(nxt)[:, None]})
            _close(tl, jl)
        jh, _ = jm.forward_hidden(jp, {"tokens": jnp.asarray(toks)})
        th, _ = tm.forward_hidden(tp, {"tokens": torch.as_tensor(toks)})
        _close(th, jh)


def test_gemma2_prefill_and_decode_logits_equal_jax():
    """GELU archs (gemma2-9b; musicgen-large shares the MLP) take the tanh
    form, ``jax.nn.gelu``'s default: the exact erf form puts the logits
    ~2e-3 off. Reduced gemma2-9b in float32 with exact projections (its
    windows, softcaps, post-norms and plus-one norms on), a 23-token
    prompt, then three decode steps."""
    jm, jp, tm, tp = _setup(False, "gemma2-9b")
    toks = _tokens(23, seed=4)
    jdecode = jax.jit(jm.decode_step)
    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 extra_slots=4)
        tl, tc = tm.prefill_step(tp, {"tokens": torch.as_tensor(toks)},
                                 extra_slots=4)
        _close(tl, jl)
        for _ in range(3):
            nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
            assert np.array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
            jl, jc = jdecode(jp, jc, {"tokens": jnp.asarray(nxt)[:, None]})
            tl, tc = tm.decode_step(tp, tc,
                                    {"tokens": torch.as_tensor(nxt)[:, None]})
            _close(tl, jl)


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_chunked_prefill_then_paged_decode_equal_jax(sc):
    """The engine's route: chunked prefill into a bucket-extent staging
    cache, admission into the page pool, batched paged decode."""
    jm, jp, tm, tp = _setup(sc)
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
                _close(tl, jl)
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
            _close(tl, jl)
            tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
            assert np.array_equal(tl[:, -1].argmax(-1).numpy()[:, None], tok)


def test_own_init_has_the_jax_shapes_and_scales():
    jm, jp, tm, _ = _setup(False)
    ours = tm.init_params(0)
    jl0 = jax.tree.map(lambda x: x[0], jp["layers"][0])
    assert ours["embed"].shape == jp["embed"].shape
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(ours["layers"][0]["attn"][name].shape) == \
            jl0["attn"][name].shape
        np.testing.assert_allclose(
            float(ours["layers"][0]["attn"][name].std()),
            float(jnp.std(jl0["attn"][name])), rtol=0.2)
    assert len(ours["layers"]) == tm.cfg.n_layers
    again = tm.init_params(0)
    assert torch.equal(again["embed"], ours["embed"])


def test_sc_gradient_flows_through_the_model():
    """sc_dense's STE lets gradients reach every projection."""
    _, _, tm, tp = _setup(True)
    w = tp["layers"][0]["mlp"]["w1"].requires_grad_(True)
    hidden, _ = tm.forward_hidden(tp, {"tokens": torch.as_tensor(
        _tokens(6, seed=4))})
    hidden.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    assert float(w.grad.abs().sum()) > 0


def test_bf16_model_runs_and_tracks_float32():
    tcfg = ARCHS["smollm-360m"].reduced(use_sc_gemm=True)
    assert tcfg.dtype == "bfloat16"
    tm = bind(tcfg, "cpu")
    p16 = init_params(tcfg, 0, device="cpu")
    cfg32 = dataclasses.replace(tcfg, dtype="float32")
    p32 = {k: (v.float() if torch.is_tensor(v) else v)
           for k, v in p16.items()}
    p32["layers"] = [{k: ({kk: vv.float() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.float())
                      for k, v in layer.items()} for layer in p16["layers"]]
    toks = torch.as_tensor(_tokens(9, seed=5))
    with torch.no_grad():
        l16, _ = tm.prefill_step(p16, {"tokens": toks})
        l32, _ = bind(cfg32, "cpu").prefill_step(p32, {"tokens": toks})
    # bf16 weights and activations round at every layer; the logits must
    # still follow the float32 model's closely
    assert l16.dtype == torch.float32 and torch.isfinite(l16).all()
    corr = np.corrcoef(l16.numpy().ravel(), l32.numpy().ravel())[0, 1]
    assert corr > 0.98, corr
