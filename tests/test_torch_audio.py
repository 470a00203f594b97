"""The audio family of the PyTorch port (musicgen: ``K`` codebook tables
summed at the input, a ``K·V`` head reshaped to ``(..., K, V)``, ``(S,
K)`` prompts and ``(K,)`` tokens in the engine, the CLI and
``generate``), held against the JAX package on the CPU at the reduced
config (``ARCHS["musicgen-large"].reduced(dtype="float32")``: 2 layers,
d_model 64, 4/2 heads × 16, GELU, 4 codebooks of 256), the JAX parameters
carried across.

* ``prefill_step``, ``prefill_chunk_step``, ``decode_step``,
  ``paged_decode_step`` and ``decode_window_step`` against JAX: logits of
  shape ``(B, 1, K, V)`` within rtol/atol 1e-4 with exact projections;
  with SC-GEMM at 8 bits within 0.5 with equal greedy tokens (as
  ``tests/test_torch_hybrid.py``), the head's counts equal JAX's on the
  same rows; a tied codebook head (``tie_embeddings``) the same way
  (its SC counts in ``test_head_sc_counts_equal_jax``);
* engine streams ``(n, 4)``, paged and contiguous, chunked and one-shot:
  equal to the JAX engine's (exact projections) and to the port's
  sequential ``generate`` (SC-GEMM too), also under a page budget tight
  enough to preempt; a sampled stream depends on the request alone;
  speculation is refused, as the JAX engine refuses it; the graphed
  steps (capture replaced by a double) at codebook buffer shapes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.sc_layers import sc_proj as jsc_proj
from repro.core.sc_numerics import recover_counts as jrecover
from repro.models import bind as jbind
from repro.models import cache_ops as jops
from repro.models import transformer as jtr
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.core.sc_layers import sc_proj
from repro_torch.core.sc_numerics import recover_counts
from repro_torch.errors import ConfigError
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models import bind, pack_sc_weights
from repro_torch.models import cache_ops as tops
from repro_torch.models import transformer as ttr
from repro_torch.serving import Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

ARCH = "musicgen-large"
K, V = 4, 256
EXACT_MODEL = dict(rtol=1e-4, atol=1e-4)
SC_GEMM_8 = dict(rtol=0, atol=0.5)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX's parameters of the reduced config, drawn once (no test writes
    them; the numeric switches do not change the draws)."""
    jcfg = JAX_ARCHS[ARCH].reduced(dtype="float32")
    return jbind(jcfg).init_params(jax.random.PRNGKey(0))


def _setup(sc: bool = False, tied: bool = False):
    """The JAX config and parameters, the port's config and the parameters
    carried across; ``tied`` drops the head (the draws are otherwise
    the same)."""
    over = dict(dtype="float32", use_sc_gemm=sc, tie_embeddings=tied)
    jcfg, tcfg = JAX_ARCHS[ARCH].reduced(**over), ARCHS[ARCH].reduced(**over)
    jp = {k: v for k, v in _jax_params().items()
          if not (tied and k == "lm_head")}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _frames(rng, *lead):
    return rng.integers(0, V, (*lead, K)).astype(np.int32)


# ------------------------------------------------------------ the model


def test_init_and_convert_shapes():
    """The port's own draws and the converted JAX tree have the
    reference's shapes: a ``(K, V, d)`` embed and a ``(d, K·V)`` head (none
    when tied), packed once as ``(d, K·V)``."""
    _, jp, tcfg, tp = _setup(True)
    d = tcfg.d_model
    assert tcfg.family == "audio" and tcfg.n_codebooks == K
    own = bind(tcfg, "cpu").init_params(0)
    for tree in (own, tp):
        assert tuple(tree["embed"].shape) == (K, V, d)
        assert tuple(tree["lm_head"].shape) == (d, K * V)
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    assert pack_sc_weights(tp, tcfg)["packed"]["head"].shape == (d, K * V)
    tied = dataclasses.replace(tcfg, tie_embeddings=True)
    params = bind(tied, "cpu").init_params(0)
    assert "lm_head" not in params
    head = pack_sc_weights(params, tied)["packed"]["head"]
    assert head.shape == (d, K * V)


@pytest.mark.parametrize("sc,tied", [(False, False), (True, False),
                                     (False, True)],
                         ids=["exact", "sc", "exact-tied"])
def test_entry_points_equal_jax(sc, tied):
    """A one-shot prefill of 10 frames, the same prompt chunked into a
    12-position staging cache (4 + 4 + a padded 4 holding 2), two dense
    decode steps and two paged ones from the same cache, then a W = 2
    window: logits ``(B, 1, K, V)``, as the reference's."""
    jcfg, jp, tcfg, tp = _setup(sc, tied)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    tpp = pack_sc_weights(tp, tcfg)
    tol = SC_GEMM_8 if sc else EXACT_MODEL
    rng = np.random.default_rng(31)
    toks = _frames(rng, 1, 10)

    def close(t, j):
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
        np.testing.assert_array_equal(t.numpy().argmax(-1),
                                      np.asarray(j).argmax(-1))

    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 extra_slots=6)
        tl, tc = tm.prefill_step(tpp, {"tokens": torch.as_tensor(toks)},
                                 extra_slots=6)
        assert tl.shape == (1, 1, K, V)
        close(tl, jl)
        jst, tst = jm.init_cache(1, 12), tm.init_cache(1, 12)
        for start, nv in ((0, 4), (4, 4), (8, 2)):
            chunk = np.zeros((1, 4, K), np.int32)
            chunk[0, :nv] = toks[0, start:start + nv]
            jcl, jst = jm.prefill_chunk_step(
                jp, jst, {"tokens": jnp.asarray(chunk),
                          "n_valid": jnp.asarray([nv], jnp.int32)})
            tcl, tst = tm.prefill_chunk_step(
                tpp, tst, {"tokens": torch.as_tensor(chunk),
                           "n_valid": torch.tensor([nv], dtype=torch.int32)})
            close(tcl, jcl)
        assert int(tst.pos[0]) == int(jst.pos[0]) == 10
        jdata = jops.paged_init(jm.init_cache, 1, 5, 4)
        jdata = jops.paged_insert(jdata, jc, 0, [3, 0, 4, 1], block=4)
        tdata = tops.paged_init(tm.init_cache, 1, 5, 4)
        tops.paged_insert(tdata, tc, 0, [3, 0, 4, 1], block=4)
        tables = np.array([[3, 0, 4, 1]], np.int32)
        for _ in range(2):
            nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
            assert nxt.shape == (1, 1, K)
            jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)})
            tl, tc = tm.decode_step(tpp, tc, {"tokens": torch.as_tensor(nxt)})
            close(tl, jl)
            jpl, jdata = jm.paged_decode_step(
                jp, jdata, jnp.asarray(tables), {"tokens": jnp.asarray(nxt)})
            tpl, tdata = tm.paged_decode_step(
                tpp, tdata, torch.as_tensor(tables),
                {"tokens": torch.as_tensor(nxt)})
            assert torch.equal(tpl, tl)
            close(tpl, jpl)
        window = _frames(rng, 1, 2)
        jwl, _ = jm.decode_window_step(jp, jc, {"tokens": jnp.asarray(window)})
        twl, twc = tm.decode_window_step(tpp, tc,
                                         {"tokens": torch.as_tensor(window)})
        assert twl.shape == (1, 2, K, V) and int(twc.pos[0]) == 14
        close(twl, jwl)


@pytest.mark.parametrize("tied", [False, True], ids=["head", "tied"])
def test_head_sc_counts_equal_jax(tied):
    """The ``K·V`` head (or the tied embed permuted to ``(d, K·V)``)
    through SC-GEMM, packed once and per call: counts equal JAX's on the
    same rows, and the logits' codebook axes are the reference's."""
    jcfg, jp, tcfg, tp = _setup(True, tied)
    packed = pack_sc_weights(tp, tcfg)
    d = tcfg.d_model
    x = np.random.default_rng(5).standard_normal((2, 3, d)).astype(
        np.float32)
    w = (np.asarray(jp["embed"]).transpose(2, 0, 1).reshape(d, -1) if tied
         else np.asarray(jp["lm_head"]))
    jl = jtr.logits_from_hidden(jp, jcfg, jnp.asarray(x))
    want = jrecover(jsc_proj(jnp.asarray(x[0]), jnp.asarray(w), jcfg),
                    x[0], w, row_quant=True)
    for p in (packed["packed"]["head"], None):
        got = sc_proj(torch.as_tensor(x[0]), ttr._lm_head(tp, tcfg), tcfg, p)
        np.testing.assert_array_equal(recover_counts(got, x[0], w,
                                                     row_quant=True), want)
    with torch.no_grad():
        tl = ttr.logits_from_hidden(packed, tcfg, torch.as_tensor(x))
    assert tl.shape == (2, 3, K, V)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


# ------------------------------------------------------------ the engine

GENS = [5, 8, 3, 6]


def _prompts(lens=(9, 14, 6, 11), seed=1):
    rng = np.random.default_rng(seed)
    return [_frames(rng, n) for n in lens]


def _requests(cls, prompts, gens=GENS, tag="r", **kw):
    return [cls(uid=f"{tag}{i}", prompt=p, max_new_tokens=g, **kw)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _baseline(tcfg, tp, prompts, gens=GENS, **kw):
    return [generate(tcfg, tp, p[None], gen_tokens=g, device="cpu", **kw)[0]
            .numpy() for p, g in zip(prompts, gens)]


def _assert_streams(res, *refs):
    for i, r in enumerate(res):
        assert r.tokens.shape == (r.n_generated, K)
        for ref in refs:
            want = ref[i] if isinstance(ref[i], np.ndarray) else ref[i].tokens
            np.testing.assert_array_equal(r.tokens, want, err_msg=r.uid)


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_streams_equal_jax_engine_and_baseline(paged, mode):
    """Exact projections: ``(n, 4)`` streams equal the JAX engine's and the
    port's ``generate``; the prefix cache stays off (dense family only)."""
    jcfg, jp, tcfg, tp = _setup()
    prompts = _prompts()
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4, paged=paged,
              prefill_mode=mode)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts))
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts))
    _assert_streams(res, jres, _baseline(tcfg, tp, prompts))
    assert eng.prefix is None and not eng.stats["prefix_cache"]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_sc_engine_streams_equal_baseline(mode):
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=2)
    res = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24, block=4,
                 chunk=4, prefill_mode=mode).run(_requests(Request, prompts))
    _assert_streams(res, _baseline(tcfg, tp, prompts))


def test_tight_page_budget_preempts_and_replays_identically():
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts((4, 8, 4), seed=3)
    gens = [8, 7, 8]
    eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=16, block=4,
                 n_blocks=5, chunk=4)
    res = eng.run(_requests(Request, prompts, gens))
    assert eng.stats["preemptions"] >= 1
    _assert_streams(res, _baseline(tcfg, tp, prompts, gens))
    assert eng.stats["pages_live"] == 0


def test_a_sampled_stream_depends_on_the_request_alone():
    """``temperature > 0``: K draws a step from the request's generator, in
    codebook order. A request's stream is the same alone in one slot,
    beside other traffic in two slots, and from ``generate`` at B=1 with
    its seed; an EOS id does not stop a codebook stream."""
    _, _, tcfg, tp = _setup()
    prompts = _prompts(seed=4)
    kw = dict(temperature=0.8, eos_id=0)
    reqs = [Request(uid=f"t{i}", prompt=p, max_new_tokens=g, seed=10 + i,
                    **kw) for i, (p, g) in enumerate(zip(prompts, GENS))]
    together = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24,
                      block=4, chunk=4).run(reqs)
    alone = [Engine(tcfg, tp, device="cpu", capacity=1, max_seq=24,
                    block=4, chunk=8).run([dataclasses.replace(
                        r, uid=f"a{r.uid}")])[0] for r in reqs[:2]]
    for r, a, p, g in zip(together, alone, prompts, GENS):
        np.testing.assert_array_equal(r.tokens, a.tokens)
        base = generate(tcfg, tp, p[None], gen_tokens=g, temperature=0.8,
                        seed=int(r.uid[1:]) + 10, device="cpu")[0].numpy()
        np.testing.assert_array_equal(r.tokens, base)
    assert all(r.finished_reason == "length" and r.n_generated == g
               for r, g in zip(together, GENS))
    greedy = _baseline(tcfg, tp, prompts[:1], GENS[:1])[0]
    assert not np.array_equal(together[0].tokens, greedy)


def test_speculation_and_wrong_prompts_are_refused():
    jcfg, jp, tcfg, tp = _setup()
    for make in (lambda: Engine(tcfg, tp, device="cpu", speculate_k=2),
                 lambda: JaxEngine(jcfg, jp, speculate_k=2)):
        with pytest.raises(Exception, match="codebooks"):
            make()
    eng = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=16, block=4)
    for prompt in (np.zeros((4,), np.int32), np.zeros((4, 2), np.int32)):
        with pytest.raises(ConfigError, match=r"\(S, 4\) token ids"):
            eng.submit(Request(uid=f"x{prompt.ndim}", prompt=prompt,
                               max_new_tokens=2))


def _fake_capture(step):
    """The test double of ``steps.capture``: records a capture and leaves
    the step eager."""
    step.captures += 1


@pytest.fixture
def cached(monkeypatch):
    monkeypatch.setattr(steps, "capture", _fake_capture)
    steps.clear_decode_steps()
    yield
    steps.clear_decode_steps()


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_graphed_steps_at_codebook_shapes(cached, mode):
    """The cached steps (capture doubled) hold codebook buffers — tokens
    ``(C, 1, K)`` / ``(1, chunk, K)``, logits ``(C, 1, K, V)`` /
    ``(1, 1, K, V)`` — and serve the eager engine's streams; a
    speculative step on the entry is refused."""
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=6)
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4, prefill_mode=mode)
    graphed = Engine(tcfg, tp, device="cpu", graphs=True, **kw)
    res = graphed.run(_requests(Request, prompts))
    eager = Engine(tcfg, tp, device="cpu", **kw).run(
        _requests(Request, prompts))
    _assert_streams(res, eager, _baseline(tcfg, tp, prompts))
    d = graphed._decode
    assert d.captures == 1 and d.tokens.shape == (2, 1, K)
    assert d.logits.shape == (2, 1, K, V)
    for key, step in d.prefills.items():
        assert step.captures == 1
        assert step.tokens.shape == (1, 4 if key[0] == "chunked" else key[1],
                                     K)
        assert step.logits.shape == (1, 1, K, V)
    with pytest.raises(ConfigError, match="codebook"):
        steps.cached_verify_window_step(d, width=2)


def test_serve_cli(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--sc-gemm", "--device", "cpu",
          "--requests", "3", "--prompt-len", "8", "--gen", "4",
          "--capacity", "2", "--block", "4", "--prefill-mode", "oneshot"])
    out = capsys.readouterr().out
    assert "[serve] cpu continuous/paged/oneshot: 3 requests" in out
    assert "first stream: [[" in out
