"""The vlm family of the PyTorch port (qwen2-vl: M-RoPE and the vision
front end's patch-embedding stub in ``models/transformer.py``), held
against the JAX package on the CPU at the reduced config
(``ARCHS["qwen2-vl-2b"].reduced(dtype="float32")``: 2 layers, d_model 64,
4/2 heads × 16, M-RoPE sections (2, 3, 3)), the JAX parameters carried
across with random qkv biases.

* ``layers.apply_mrope`` within 1e-6 of JAX's on distinct (t, h, w)
  streams, at the reduced sections and at qwen2-vl-2b's (16, 24, 24) with
  head_dim 128; on broadcast positions bit-equal to the port's RoPE path;
* ``forward_hidden`` with ``visual_embeds`` and distinct
  ``mrope_positions``, ``prefill_step`` (the port's default positions
  against JAX's step fed them explicitly: the reference's own
  ``prefill_step`` needs them, ``ROADMAP.md`` Queue 3), then
  ``prefill_chunk_step``, ``decode_step``, ``paged_decode_step`` and
  ``decode_window_step``: logits within rtol/atol 1e-4 of JAX's with exact
  projections; with SC-GEMM at 8 bits within 0.5 with equal greedy tokens
  (as ``tests/test_torch_hybrid.py``), the tied head's counts equal JAX's
  on the same rows;
* engine streams, paged and contiguous: chunked equal to the JAX engine's
  (exact projections), one-shot equal to the port's chunked streams, and
  both equal to the port's sequential ``generate`` (SC-GEMM too), also
  under a page budget tight enough to preempt; speculative streams equal
  the baseline; the graphed steps with the capture replaced by a double.
"""
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
from repro.models.layers import apply_mrope as japply_mrope
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
from repro_torch.models.layers import apply_mrope, apply_rope, rope
from repro_torch.serving import Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

ARCH = "qwen2-vl-2b"
EXACT_MODEL = dict(rtol=1e-4, atol=1e-4)
SC_GEMM_8 = dict(rtol=0, atol=0.5)


def _cfgs(sc: bool = False, **kw):
    over = dict(dtype="float32", use_sc_gemm=sc, **kw)
    return JAX_ARCHS[ARCH].reduced(**over), ARCHS[ARCH].reduced(**over)


def _random_biases(jp, seed: int):
    """The JAX tree with its (zero-initialised) qkv biases drawn at random,
    so the conversion and the bias add are both exercised."""
    rng = np.random.default_rng(seed)
    layers = []
    for group in jp["layers"]:
        attn = dict(group["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                0.1 * rng.standard_normal(attn[name].shape), attn[name].dtype)
        layers.append({**group, "attn": attn})
    return {**jp, "layers": tuple(layers)}


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX's parameters of the reduced config with random qkv biases, drawn
    once (no test writes them; the numeric switches do not change the
    draws)."""
    jcfg = JAX_ARCHS[ARCH].reduced(dtype="float32")
    return _random_biases(jbind(jcfg).init_params(jax.random.PRNGKey(0)), 3)


def _setup(sc: bool = False):
    """The JAX config and parameters, the port's config and the parameters
    carried across."""
    jcfg, tcfg = _cfgs(sc)
    jp = _jax_params()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _vision_inputs(b: int, s: int, grid: int, d: int, seed: int):
    """The reference's ``input_specs`` form: ``P = grid²`` patch
    embeddings over the first ``P`` positions, their (t, h, w) ids (0,
    row, column), then text whose three ids continue from ``grid``."""
    rng = np.random.default_rng(seed)
    p = grid * grid
    pos = np.zeros((3, b, s), np.int32)
    pos[1, :, :p] = np.arange(p) // grid
    pos[2, :, :p] = np.arange(p) % grid
    pos[:, :, p:] = grid + np.arange(s - p)
    embeds = rng.standard_normal((b, p, d)).astype(np.float32)
    return pos, embeds


# ---------------------------------------------------------------- M-RoPE


@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16), ((16, 24, 24), 128)],
                         ids=["reduced", "qwen2-vl-2b"])
def test_apply_mrope_equals_jax_and_broadcast_equals_rope(sections, d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 5, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 5)).astype(np.int32)
    got = apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections,
                      1e6)
    want = japply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # one stream in all three: RoPE's tables, bit for bit
    one = torch.as_tensor(pos[0])
    cos, sin = rope(one, d, 1e6)
    assert torch.equal(apply_mrope(torch.as_tensor(x), one.expand(3, 2, 5),
                                   sections, 1e6),
                       apply_rope(torch.as_tensor(x), cos, sin))
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.as_tensor(x), one.expand(3, 2, 5), (1, 1, 1), 1e6)


# ------------------------------------------------------------ the model


def test_bind_convert_and_pack():
    """The family binds and converts (biases and the tied embed carried
    bit for bit); the tied head is packed once, as ``(d, vocab)``."""
    jcfg, jp, tcfg, tp = _setup(True)
    assert tcfg.family == "vlm" and tcfg.tie_embeddings
    assert "lm_head" not in tp
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    for l, layer in enumerate(tp["layers"]):
        for name in ("bq", "bk", "bv"):
            np.testing.assert_array_equal(
                layer["attn"][name].numpy(),
                np.asarray(jp["layers"][0]["attn"][name][l]))
    packed = pack_sc_weights(tp, tcfg)
    assert packed["packed"]["head"].shape == (tcfg.d_model, tcfg.vocab_size)


def test_forward_hidden_with_visual_embeds_equals_jax():
    """Patch embeddings over the first 16 of 24 positions and their grid
    positions: the hidden states within 1e-4 of JAX's, and not those of
    the text alone."""
    jcfg, jp, tcfg, tp = _setup()
    pos, emb = _vision_inputs(2, 24, 4, tcfg.d_model, seed=1)
    toks = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(
        np.int32)
    jh, _ = jbind(jcfg).forward_hidden(jp, {
        "tokens": jnp.asarray(toks), "visual_embeds": jnp.asarray(emb),
        "mrope_positions": jnp.asarray(pos)})
    tm = bind(tcfg, "cpu")
    with torch.no_grad():
        th, aux = tm.forward_hidden(tp, {
            "tokens": torch.as_tensor(toks),
            "visual_embeds": torch.as_tensor(emb),
            "mrope_positions": torch.as_tensor(pos)})
        text, _ = tm.forward_hidden(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **EXACT_MODEL)
    assert float(aux) == 0.0
    assert not torch.allclose(th, text, atol=1e-2)


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_entry_points_equal_jax(sc):
    """A one-shot prefill of 12 tokens with 4 patch embeddings (the port's
    default positions; JAX's fed them), the same prompt chunked into a
    16-position staging cache (8 + a padded 8 holding 4), then two
    dense decode steps, two paged ones from the same cache and a W = 3
    window."""
    jcfg, jp, tcfg, tp = _setup(sc)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    tpp = pack_sc_weights(tp, tcfg)
    tol = SC_GEMM_8 if sc else EXACT_MODEL
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 256, (1, 12)).astype(np.int32)
    emb = rng.standard_normal((1, 4, tcfg.d_model)).astype(np.float32)
    line = np.broadcast_to(np.arange(12, dtype=np.int32), (3, 1, 12))

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
        np.testing.assert_array_equal(t.numpy().argmax(-1),
                                      np.asarray(j).argmax(-1))

    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks),
                                      "visual_embeds": jnp.asarray(emb),
                                      "mrope_positions": jnp.asarray(line)},
                                 extra_slots=4)
        tl, tc = tm.prefill_step(tpp, {"tokens": torch.as_tensor(toks),
                                       "visual_embeds": torch.as_tensor(emb)},
                                 extra_slots=4)
        close(tl, jl)
        jst, tst = jm.init_cache(1, 16), tm.init_cache(1, 16)
        for start, nv in ((0, 8), (8, 4)):
            chunk = np.zeros((1, 8), np.int32)
            chunk[0, :nv] = toks[0, start:start + nv]
            jcl, jst = jm.prefill_chunk_step(
                jp, jst, {"tokens": jnp.asarray(chunk),
                          "n_valid": jnp.asarray([nv], jnp.int32)})
            tcl, tst = tm.prefill_chunk_step(
                tpp, tst, {"tokens": torch.as_tensor(chunk),
                           "n_valid": torch.tensor([nv], dtype=torch.int32)})
            close(tcl, jcl)
        assert int(tst.pos[0]) == int(jst.pos[0]) == 12
        jdata = jops.paged_init(jm.init_cache, 1, 5, 4)
        jdata = jops.paged_insert(jdata, jc, 0, [2, 0, 4, 1], block=4)
        tdata = tops.paged_init(tm.init_cache, 1, 5, 4)
        tops.paged_insert(tdata, tc, 0, [2, 0, 4, 1], block=4)
        tables = np.array([[2, 0, 4, 1]], np.int32)
        for _ in range(2):
            nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
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
        assert int(tc.pos[0]) == 14
        tc = tc._replace(pos=torch.tensor([13], dtype=torch.int32))
        jc = jc._replace(pos=jnp.asarray([13], jnp.int32))
        window = rng.integers(0, 256, (1, 3)).astype(np.int32)
        jwl, _ = jm.decode_window_step(jp, jc, {"tokens": jnp.asarray(window)})
        twl, twc = tm.decode_window_step(tpp, tc,
                                         {"tokens": torch.as_tensor(window)})
        assert twl.shape == (1, 3, tcfg.vocab_size)
        assert int(twc.pos[0]) == 16
        close(twl, jwl)


def test_tied_head_sc_counts_equal_jax():
    """The tied head (``embed.T``) through SC-GEMM, packed once and per
    call: counts equal JAX's on the same rows."""
    jcfg, jp, tcfg, tp = _setup(True)
    packed = pack_sc_weights(tp, tcfg)
    x = np.random.default_rng(4).standard_normal((5, tcfg.d_model)).astype(
        np.float32)
    w = np.asarray(jp["embed"]).T
    want = jrecover(jsc_proj(jnp.asarray(x), jnp.asarray(w), jcfg), x, w,
                    row_quant=True)
    for p in (packed["packed"]["head"], None):
        got = sc_proj(torch.as_tensor(x), tp["embed"].T, tcfg, p)
        np.testing.assert_array_equal(recover_counts(got, x, w,
                                                     row_quant=True), want)


# ------------------------------------------------------------ the engine

GENS = [5, 8, 3, 6]


def _prompts(lens=(9, 14, 6, 11), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in lens]


def _requests(cls, prompts, gens=GENS, tag="r"):
    return [cls(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _baseline(tcfg, tp, prompts, gens=GENS):
    return [generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")[0]
            .numpy() for p, g in zip(prompts, gens)]


def _assert_streams(res, *refs):
    for i, r in enumerate(res):
        for ref in refs:
            want = ref[i] if isinstance(ref[i], np.ndarray) else ref[i].tokens
            np.testing.assert_array_equal(r.tokens, want, err_msg=r.uid)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_streams_equal_jax_engine_and_baseline(paged):
    """Exact projections: the chunked engine's streams equal the JAX
    chunked engine's (the JAX one-shot engine cannot prefill without
    ``mrope_positions``, ``ROADMAP.md`` Queue 3); the one-shot engine's
    equal the chunked ones; both equal the port's ``generate``."""
    jcfg, jp, tcfg, tp = _setup()
    prompts = _prompts()
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4, paged=paged)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts))
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts))
    one = Engine(tcfg, tp, device="cpu", prefill_mode="oneshot", **kw).run(
        _requests(Request, prompts))
    _assert_streams(res, jres, one, _baseline(tcfg, tp, prompts))
    assert eng.prefix is None and not eng.stats["prefix_cache"]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_sc_engine_streams_equal_baseline(paged, mode):
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=2)
    res = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24, block=4,
                 chunk=4, paged=paged, prefill_mode=mode).run(
        _requests(Request, prompts))
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


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_speculative_streams_equal_baseline(sc):
    """The vlm family speculates, as in the reference: the verify window
    rotates its rows by M-RoPE at their positions. Streams equal the
    baseline (and, with exact projections, the JAX speculative engine's)."""
    jcfg, jp, tcfg, tp = _setup(sc)
    prompts = _prompts((9, 14, 6), seed=4)
    gens = [10, 7, 5]
    kw = dict(capacity=2, max_seq=24, block=4, speculate_k=2, draft_bits=4)
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts, gens))
    refs = [_baseline(tcfg, tp, prompts, gens)]
    if not sc:
        refs.append(JaxEngine(jcfg, jp, prefix_cache=False, **kw).run(
            _requests(JaxRequest, prompts, gens)))
    _assert_streams(res, *refs)
    assert eng.stats["spec_rounds"] > 0 and eng.pool.pages_live == 0


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
def test_graphed_steps_equal_eager_and_baseline(cached, mode):
    """The cached decode and prefill steps (capture doubled) serve the
    family: one entry, text-only buffers (no M-RoPE input), streams equal
    the eager engine's and the baseline; speculative steps hang off the
    same entry."""
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=5)
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4, prefill_mode=mode)
    graphed = Engine(tcfg, tp, device="cpu", graphs=True, **kw)
    res = graphed.run(_requests(Request, prompts))
    eager = Engine(tcfg, tp, device="cpu", **kw).run(
        _requests(Request, prompts))
    _assert_streams(res, eager, _baseline(tcfg, tp, prompts))
    d = graphed._decode
    assert d.captures == 1 and d.tokens.shape == (2, 1)
    assert d.logits.shape == (2, 1, tcfg.vocab_size)
    assert all(s.captures == 1 for s in d.prefills.values())
    spec = Engine(tcfg, tp, device="cpu", graphs=True, speculate_k=1, **kw)
    assert spec._decode is d
    _assert_streams(spec.run(_requests(Request, prompts, tag="s")),
                    eager)


def test_a_prompt_of_the_wrong_form_is_refused():
    _, _, tcfg, tp = _setup()
    eng = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=16, block=4)
    with pytest.raises(ConfigError, match=r"\(S,\) token ids"):
        eng.submit(Request(uid="x", prompt=np.zeros((4, 4), np.int32),
                           max_new_tokens=2))


def test_serve_cli(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--sc-gemm", "--device", "cpu",
          "--requests", "3", "--prompt-len", "8", "--gen", "4",
          "--capacity", "2", "--block", "4"])
    out = capsys.readouterr().out
    assert "[serve] cpu continuous/paged/chunked: 3 requests" in out

