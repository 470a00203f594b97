"""The moe family of the PyTorch port (``models/moe.py`` inside
``models/transformer.py``), held against the JAX package on the CPU at
the reduced configs (``ARCHS[arch].reduced(dtype="float32")``: 8 experts,
top-2, router groups of 32, capacity C = 16; qwen3-moe-235b-a22b in 2
layers with QK-norm, llama4-maverick-400b-a17b in 8 layers alternating
dense and MoE with a shared expert and windows of 8), the JAX parameters
carried across.

* ``route``: expert indices, positions and keep masks exactly the
  reference's slot-by-slot routing (``repro/models/moe.py:93-106``, its
  loop run here with ``jnp`` on the same probabilities), gates within
  1e-6 — a hand-made case where round-major positions decide who is
  dropped, and random groups with and without drops; the router's
  probabilities within 1e-6 of the reference's;
* ``moe_ffn``: output within 1e-5 and aux loss within 1e-6 of the
  reference's with exact projections; under SC-GEMM at 8 bits each
  expert's counts equal JAX's on the same dispatched rows (counts, not
  floats: JAX's jitted scales can sit an ulp off, ``ROADMAP.md`` Queue
  3); the shared expert both ways; a token count that is not a whole
  number of groups raises ``ConfigError`` where the reference asserts;
* the batched pack and its plain version equal one pack and one call an
  expert, bit for bit;
* every entry point's logits within 1e-4 of JAX's (exact projections),
  ``forward_hidden``'s summed aux loss within 1e-6;
* ``from_jax_params`` round trip (the router kept in float32 at bf16);
* engine streams equal the JAX engine's, chunked and one-shot (the
  one-shot prefill dropping tokens at C = 16), the port's ``generate``
  baseline, qwen3-moe's speculative streams the JAX speculative engine's,
  and the graphed steps with the capture replaced by a double.
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
from repro.models import moe as jmoe
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.core.sc_numerics import recover_counts
from repro_torch.errors import ConfigError
from repro_torch.kernels import sc_matmul as skm
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models import bind, moe, pack_sc_weights
from repro_torch.models import cache_ops as tops
from repro_torch.serving import Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

ARCHS_MOE = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
EXACT_MODEL = dict(rtol=1e-4, atol=1e-4)
EXACT_FFN = dict(rtol=0, atol=1e-5)


def _cfgs(arch: str, sc: bool = False, **kw):
    over = dict(dtype="float32", use_sc_gemm=sc, **kw)
    return JAX_ARCHS[arch].reduced(**over), ARCHS[arch].reduced(**over)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str = "float32"):
    """JAX's parameters of the reduced config, drawn once (no test writes
    them; the numeric switches do not change the draws)."""
    return jbind(JAX_ARCHS[arch].reduced(dtype=dtype)).init_params(
        jax.random.PRNGKey(0))


def _setup(arch: str, sc: bool = False):
    jcfg, tcfg = _cfgs(arch, sc)
    jp = _jax_params(arch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _moe_layer(jp, tp, cfg):
    """The first MoE layer's weights, JAX's and the port's."""
    pos = next(i for i in range(cfg.n_layers) if cfg.moe_at(i))
    gsz = cfg.group_size
    jl = jax.tree.map(lambda a: a[pos // gsz], jp["layers"][pos % gsz]["moe"])
    return jl, tp["layers"][pos]["moe"]


# ------------------------------------------------------------ routing


def _jax_route(probs, top_k: int, capacity: int):
    """The reference's routing loop (``repro/models/moe.py:88-106``) on
    given probabilities: (gates, positions) ``(ng, G, E)``, and per round
    the chosen experts, their positions and keep masks."""
    ng, g, e = probs.shape
    gates = jnp.zeros((ng, g, e), jnp.float32)
    position = jnp.zeros((ng, g, e), jnp.int32)
    counts = jnp.zeros((ng, 1, e), jnp.int32)
    masked = probs
    rounds = []
    for _ in range(top_k):
        idx = jnp.argmax(masked, axis=-1)
        onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
        gate = (masked * onehot).sum(-1, keepdims=True)
        oh = onehot.astype(jnp.int32)
        pos = counts + jnp.cumsum(oh, axis=1) - oh
        keep = (pos < capacity) & (onehot > 0)
        gates = gates + jnp.where(keep, gate * onehot, 0.0)
        position = jnp.where(keep, pos, position)
        counts = counts + oh.sum(axis=1, keepdims=True)
        masked = masked * (1.0 - onehot)
        pos_k = jnp.take_along_axis(pos, idx[..., None], -1)[..., 0]
        rounds.append((np.asarray(idx), np.asarray(pos_k),
                       np.asarray(pos_k < capacity)))
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    return np.asarray(gates), np.asarray(position), rounds


def _dense(r: moe.Routing):
    """The port's per-slot routing as the reference's ``(ng, G, E)``
    gates and positions."""
    e = r.probs.shape[-1]
    onehot = torch.nn.functional.one_hot(r.expert, e)        # (K, ng, G, E)
    gates = (r.gate[..., None] * onehot).sum(0)
    position = (torch.where(r.keep, r.position, 0)[..., None]
                * onehot).sum(0)
    return gates.numpy(), position.numpy()


def _assert_route_equal(probs: np.ndarray, top_k: int, capacity: int):
    r = moe.route(torch.as_tensor(probs), top_k, capacity)
    jg, jpos, rounds = _jax_route(jnp.asarray(probs), top_k, capacity)
    for k, (idx, pos, keep) in enumerate(rounds):
        np.testing.assert_array_equal(r.expert[k].numpy(), idx)
        np.testing.assert_array_equal(r.keep[k].numpy(), keep)
        np.testing.assert_array_equal(r.position[k].numpy(),
                                      np.where(keep, pos, 0))
    gates, position = _dense(r)
    np.testing.assert_allclose(gates, jg, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(position, jpos)
    np.testing.assert_array_equal(r.dispatch.numpy(),
                                  np.stack([k for _, _, k in rounds])
                                  & (np.stack([r.gate[i].numpy() > 0
                                               for i in range(top_k)])))
    return r


def test_round_major_positions_decide_who_is_dropped():
    """Token 0 prefers expert 0 then 1, tokens 1 and 2 expert 1 then 0, C
    = 2: round-major, expert 1's second round sees token 0 at position 2
    (dropped) after tokens 1 and 2 took 0 and 1, and expert 0's sees
    token 2 at position 2 (dropped). A token-major order would keep token
    0's second choice and drop token 2's."""
    probs = np.array([[[0.7, 0.3], [0.2, 0.8], [0.4, 0.6]]], np.float32)
    r = _assert_route_equal(probs, 2, 2)
    np.testing.assert_array_equal(r.keep.numpy()[:, 0],
                                  [[True, True, True], [False, True, False]])
    np.testing.assert_array_equal(r.position.numpy()[:, 0],
                                  [[0, 0, 1], [0, 1, 0]])


@pytest.mark.parametrize("skew,capacity", [(0.0, 16), (3.0, 16), (1.0, 4)],
                         ids=["no-drops", "skewed", "tight"])
def test_route_equals_the_reference(skew, capacity):
    """Two groups of 32 tokens over 8 experts, top-2, from a seeded
    softmax; ``skew`` piles the logits onto two experts so that capacity
    16 drops tokens."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 32, 8)).astype(np.float32)
    logits[..., :2] += skew
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    r = _assert_route_equal(probs, 2, capacity)
    assert bool((~r.keep).any()) == (skew > 0 or capacity < 16)


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_router_probs_equal_the_reference(arch):
    jcfg, jp, tcfg, tp = _setup(arch)
    jl, tl = _moe_layer(jp, tp, tcfg)
    x = np.random.default_rng(1).standard_normal((2, 16, 64)).astype(
        np.float32)
    want = jax.nn.softmax(jnp.einsum("gtd,de->gte", jnp.asarray(x),
                                     jl["router"]), axis=-1)
    got = moe.router_probs(torch.as_tensor(x), tl["router"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ the FFN


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_moe_ffn_equals_the_reference(arch):
    """64 tokens (two groups of 32) through one MoE layer, exact
    projections: output within 1e-5 and aux within 1e-6 of the
    reference's."""
    jcfg, jp, tcfg, tp = _setup(arch)
    jl, tl = _moe_layer(jp, tp, tcfg)
    x = np.random.default_rng(2).standard_normal((4, 16, 64)).astype(
        np.float32)
    want, waux = jmoe.moe_ffn(jl, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(tl, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT_FFN)
    np.testing.assert_allclose(float(aux), float(waux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_expert_counts_equal_jax_on_the_dispatched_rows(arch):
    """Each expert's three SC-GEMM projections, batched and packed once
    (and per call, expert by expert, unpacked), give JAX's counts
    (``jax.vmap`` of ``sc_proj``) on the same rows: the dispatched rows,
    the empty capacity rows (zeros) among them, and the gated hidden
    rows."""
    jcfg, jp, tcfg, tp = _setup(arch, True)
    jl, tl = _moe_layer(jp, tp, tcfg)
    packed = moe.pack_moe(tl, tcfg, skm.pack_weight)["packed"]
    x = np.random.default_rng(3).standard_normal((1, 32, 64)).astype(
        np.float32)
    r = moe.route(moe.router_probs(torch.as_tensor(x), tl["router"]),
                  tcfg.top_k, moe.moe_capacity(tcfg))
    xe, _ = moe.dispatch(torch.as_tensor(x), r, moe.moe_capacity(tcfg))
    assert bool((xe == 0).all(-1).any())        # empty capacity rows
    h = torch.nn.functional.silu(moe.sc_proj(xe, tl["w1"], tcfg,
                                             packed["w1"]))
    dense = jax.vmap(lambda a, w: jsc_proj(a, w, jcfg))
    for name, rows in (("w1", xe), ("w3", xe), ("w2", h)):
        got = moe.sc_proj(rows, tl[name], tcfg, packed[name])
        assert torch.equal(got, moe.sc_proj(rows, tl[name], tcfg))
        want = dense(jnp.asarray(rows.numpy()), jl[name])
        for e in range(tcfg.n_experts):
            a, w = rows[e].numpy(), np.asarray(jl[name][e])
            np.testing.assert_array_equal(
                recover_counts(got[e], a, w, row_quant=True),
                jrecover(want[e], a, w, row_quant=True), err_msg=name)


def test_batched_pack_and_plain_version_equal_one_an_expert():
    """``pack_weight`` of ``(E, K, N)`` stacks each expert's own pack (an
    expert of zeros included), and ``sc_linear`` on the CPU gives each
    expert's unbatched call, bit for bit; a misshapen call raises."""
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.standard_normal((3, 40, 20)).astype(np.float32))
    w[1] = 0
    pw = skm.pack_weight(w, 8)
    assert pw.experts == 3 and pw.shape == (40, 20)
    assert pw.plane.shape == (3, 40, 24) and pw.scale.shape == (3,)
    x = torch.as_tensor(rng.standard_normal((3, 5, 40)).astype(np.float32))
    out = skm.sc_linear(x, pw)
    for e in range(3):
        one = skm.pack_weight(w[e], 8)
        assert torch.equal(pw.plane[e], one.plane)
        assert torch.equal(pw.scale[e], one.scale)
        assert torch.equal(out[e], skm.sc_linear(x[e], one))
    with pytest.raises(ConfigError, match=r"\(3, M, 40\)"):
        skm.sc_linear(x[0], pw)


def test_shared_expert_equals_the_reference():
    """llama4's shared expert, a dense gated FFN on every token: within
    1e-5 of the reference's formula with exact projections; under SC-GEMM
    (packed plainly) each projection's counts equal JAX's on the same
    rows."""
    arch = "llama4-maverick-400b-a17b"
    jcfg, jp, tcfg, tp = _setup(arch)
    jl, tl = _moe_layer(jp, tp, tcfg)
    js, x = jl["shared"], np.random.default_rng(5).standard_normal(
        (2, 8, 64)).astype(np.float32)
    xj = jnp.asarray(x)
    want = (jax.nn.silu(xj @ js["w1"]) * (xj @ js["w3"])) @ js["w2"]
    got = moe.gated_ffn(tl["shared"], torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT_FFN)
    jsc, tsc = _cfgs(arch, True)
    sh = moe.pack_moe(tl, tsc, skm.pack_weight)["shared"]
    h = torch.nn.functional.silu(moe.sc_proj(torch.as_tensor(x), sh["w1"],
                                             tsc, sh["packed"]["w1"]))
    for name, rows in (("w1", x), ("w3", x), ("w2", h.numpy())):
        a, w = rows.reshape(-1, rows.shape[-1]), np.asarray(js[name])
        got = moe.sc_proj(torch.as_tensor(a), sh[name], tsc,
                          sh["packed"][name])
        want = jsc_proj(jnp.asarray(a), js[name], jsc)
        np.testing.assert_array_equal(
            recover_counts(got, a, w, row_quant=True),
            jrecover(want, a, w, row_quant=True), err_msg=name)


def test_a_partial_router_group_is_refused():
    """40 tokens are not a whole number of groups of 32: the reference
    asserts, the port raises ``ConfigError`` (and pads nothing)."""
    arch = "qwen3-moe-235b-a22b"
    jcfg, jp, tcfg, tp = _setup(arch)
    jl, tl = _moe_layer(jp, tp, tcfg)
    x = np.zeros((1, 40, 64), np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_ffn(jl, jnp.asarray(x), jcfg)
    with pytest.raises(ConfigError, match="router groups of 32"):
        moe.moe_ffn(tl, torch.as_tensor(x), tcfg)


def test_moe_capacity_is_one_rule():
    """``configs/shapes.py`` takes ``moe_capacity`` from ``models/moe.py``,
    equal to the reference's for every registered MoE arch, whole and
    reduced."""
    from repro_torch.configs import shapes
    assert shapes.moe_capacity is moe.moe_capacity
    for arch in ARCHS_MOE:
        for full in (True, False):
            j = JAX_ARCHS[arch] if full else JAX_ARCHS[arch].reduced()
            t = ARCHS[arch] if full else ARCHS[arch].reduced()
            assert moe.moe_capacity(t) == jmoe.moe_capacity(j)
    assert moe.moe_capacity(ARCHS["qwen3-moe-235b-a22b"]) == 64
    assert moe.moe_capacity(ARCHS["qwen3-moe-235b-a22b"].reduced()) == 16


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_convert_round_trip_and_layers(arch):
    """``from_jax_params`` carries every leaf across (experts stacked
    ``(E, ·, ·)``, llama4's shared expert), the router in float32 at
    bf16; the layers alternate as ``cfg.moe_at`` says; the packs are one
    batched pack a projection."""
    jcfg = JAX_ARCHS[arch].reduced(dtype="bfloat16")
    tcfg = ARCHS[arch].reduced(dtype="bfloat16", use_sc_gemm=True)
    jp = _jax_params(arch, "bfloat16")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    gsz = tcfg.group_size
    for l, layer in enumerate(tp["layers"]):
        jl = jax.tree.map(lambda a: np.asarray(a[l // gsz], np.float32),
                          jp["layers"][l % gsz])
        assert ("moe" in layer) == tcfg.moe_at(l) == ("moe" in jl)
        ffn = "moe" if "moe" in layer else "mlp"
        flat = jax.tree_util.tree_leaves_with_path(jl[ffn])
        for path, leaf in flat:
            t = layer[ffn]
            for key in path:
                t = t[key.key]
            np.testing.assert_array_equal(t.to(torch.float32).numpy(), leaf)
        if ffn == "moe":
            assert layer["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["w1"].dtype == torch.bfloat16
            assert ("shared" in layer["moe"]) == bool(tcfg.shared_expert_d_ff)
    packed = pack_sc_weights(tp, tcfg)
    mlayer = next(la for la in packed["layers"] if "moe" in la)["moe"]
    assert mlayer["packed"]["w1"].experts == tcfg.n_experts
    assert mlayer["packed"]["w2"].shape == (tcfg.moe_d_ff, tcfg.d_model)
    if tcfg.shared_expert_d_ff:
        assert mlayer["shared"]["packed"]["w1"].experts == 0


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_forward_hidden_and_summed_aux_equal_jax(arch):
    jcfg, jp, tcfg, tp = _setup(arch)
    toks = np.random.default_rng(6).integers(0, 256, (2, 16)).astype(
        np.int32)
    jh, jaux = jbind(jcfg).forward_hidden(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        th, aux = bind(tcfg, "cpu").forward_hidden(
            tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **EXACT_MODEL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_entry_points_equal_jax(arch):
    """Exact projections: a one-shot prefill of 12 tokens, the same prompt
    chunked into a 16-position staging cache (8 + a padded 8 holding 4),
    two dense and two paged decode steps of two sequences (one router
    group of 2), then a W = 3 window: logits within 1e-4 of JAX's."""
    jcfg, jp, tcfg, tp = _setup(arch)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 256, (2, 12)).astype(np.int32)

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **EXACT_MODEL)

    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 extra_slots=4)
        tl, tc = tm.prefill_step(tp, {"tokens": torch.as_tensor(toks)},
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
                tp, tst, {"tokens": torch.as_tensor(chunk),
                          "n_valid": torch.tensor([nv], dtype=torch.int32)})
            close(tcl, jcl)
        # the paged pool holds each sequence's own one-shot prefill
        tables = np.array([[2, 0, 4, 1], [3, 6, 5, 7]], np.int32)
        jdata = jops.paged_init(jm.init_cache, 2, 9, 4)
        tdata = tops.paged_init(tm.init_cache, 2, 9, 4)
        for slot in range(2):
            one = toks[slot:slot + 1]
            _, jone = jm.prefill_step(jp, {"tokens": jnp.asarray(one)})
            _, tone = tm.prefill_step(tp, {"tokens": torch.as_tensor(one)})
            jdata = jops.paged_insert(jdata, jone, slot, list(tables[slot]),
                                      block=4)
            tops.paged_insert(tdata, tone, slot, list(tables[slot]), block=4)
        for _ in range(2):
            nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
            jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)})
            tl, tc = tm.decode_step(tp, tc, {"tokens": torch.as_tensor(nxt)})
            close(tl, jl)
            jpl, jdata = jm.paged_decode_step(
                jp, jdata, jnp.asarray(tables), {"tokens": jnp.asarray(nxt)})
            tpl, tdata = tm.paged_decode_step(
                tp, tdata, torch.as_tensor(tables),
                {"tokens": torch.as_tensor(nxt)})
            close(tpl, jpl)
        tc = tc._replace(pos=torch.tensor([13, 13], dtype=torch.int32))
        jc = jc._replace(pos=jnp.asarray([13, 13], jnp.int32))
        window = rng.integers(0, 256, (2, 3)).astype(np.int32)
        jwl, _ = jm.decode_window_step(jp, jc, {"tokens": jnp.asarray(window)})
        twl, twc = tm.decode_window_step(tp, tc,
                                         {"tokens": torch.as_tensor(window)})
        assert twl.shape == (2, 3, tcfg.vocab_size)
        close(twl, jwl)


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


def _dropping_prompts():
    """Three prompts, one of 32 copies of one token: a one-shot prefill
    routes it as one group of 32, whose tokens pile onto the same experts
    past C = 16."""
    out = _prompts((9, 14, 6), seed=3)
    return out[:2] + [np.full((32,), 17, np.int32)]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_engine_streams_equal_jax_engine_and_baseline(arch, mode,
                                                      monkeypatch):
    """Exact projections: the port's streams equal the JAX engine's in the
    same prefill mode and the port's ``generate`` (a B=1 one-shot
    prefill, so it drops what the one-shot engine drops). The one-shot
    runs drop tokens (recorded from ``moe.route``); the prefix cache is
    off for the family, as in the reference."""
    jcfg, jp, tcfg, tp = _setup(arch)
    prompts = _dropping_prompts()
    gens = [6, 4, 5]
    kw = dict(capacity=2, max_seq=48, block=4, chunk=8, prefill_mode=mode)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts, gens))
    dropped = []
    route = moe.route

    def recording(probs, top_k, capacity):
        r = route(probs, top_k, capacity)
        dropped.append(bool((~r.keep).any()))
        return r

    monkeypatch.setattr(moe, "route", recording)
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts, gens))
    assert any(dropped) == (mode == "oneshot")
    assert eng.prefix is None and not eng.stats["prefix_cache"]
    _assert_streams(res, jres, _baseline(tcfg, tp, prompts, gens))


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_decode_groups_past_the_capacity_drop_as_in_jax(arch, mode,
                                                        monkeypatch):
    """A decode step routes its batch of slots as one group. With
    ``capacity_factor`` 0.5 the capacity is C = 4, and six slots serving
    one prompt send six equal tokens to the same experts: the last two of
    each step's group are dropped. Chunked, the chunks (4 rows) drop
    nothing, so every drop is in decode; one-shot, a 9-token prompt drops
    too. Exact projections; streams equal the JAX engine's in the same
    mode."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    jp = _jax_params(arch)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert moe.moe_capacity(tcfg) == 4
    prompts = _prompts((9,), seed=6) * 6
    gens = [5, 5, 5, 4, 4, 3]
    kw = dict(capacity=6, max_seq=16, block=4, chunk=4, prefill_mode=mode)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts, gens))
    groups = []
    route = moe.route

    def recording(probs, top_k, capacity):
        r = route(probs, top_k, capacity)
        groups.append((probs.shape[1], bool((~r.keep).any())))
        return r

    monkeypatch.setattr(moe, "route", recording)
    res = Engine(tcfg, tp, device="cpu", **kw).run(
        _requests(Request, prompts, gens))
    dropping = {g for g, dropped in groups if dropped}
    assert dropping == ({6} if mode == "chunked" else {6, 9})
    _assert_streams(res, jres)


def test_sc_engine_streams_equal_baseline():
    """SC-GEMM at 8 bits, chunked and one-shot: the port's baseline."""
    _, _, tcfg, tp = _setup("qwen3-moe-235b-a22b", True)
    prompts = _prompts(seed=2)
    base = _baseline(tcfg, tp, prompts)
    for mode in ("chunked", "oneshot"):
        res = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24,
                     block=4, chunk=4, prefill_mode=mode).run(
            _requests(Request, prompts))
        _assert_streams(res, base)


def test_speculative_streams_equal_jax_and_baseline():
    """qwen3-moe speculates, as in the reference (a transformer family
    without codebooks): exact projections, the verify window routing
    ``capacity · (k + 1)`` tokens as one group."""
    jcfg, jp, tcfg, tp = _setup("qwen3-moe-235b-a22b")
    prompts = _prompts((9, 14, 6), seed=4)
    gens = [10, 7, 5]
    kw = dict(capacity=2, max_seq=24, block=4, speculate_k=2, draft_bits=4)
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts, gens))
    jres = JaxEngine(jcfg, jp, prefix_cache=False, **kw).run(
        _requests(JaxRequest, prompts, gens))
    _assert_streams(res, jres, _baseline(tcfg, tp, prompts, gens))
    assert eng.stats["spec_rounds"] > 0 and eng.pool.pages_live == 0


def _halved(tree):
    """The parameter tree with every weight halved, in its own order."""
    if isinstance(tree, dict):
        return {k: _halved(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_halved(v) for v in tree]
    return tree * 0.5


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


def test_graphed_steps_equal_eager_and_baseline(cached):
    """qwen3-moe, SC-GEMM at 8 bits, through the cached steps (capture
    doubled): the entry holds one batched pack an expert projection,
    binding new weights re-packs them in place, and a speculative engine
    drafts from the same entry at 4 bits; streams equal the eager
    engine's and the baseline."""
    _, _, tcfg, tp = _setup("qwen3-moe-235b-a22b", True)
    prompts = _prompts(seed=5)
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4)
    graphed = Engine(tcfg, tp, device="cpu", graphs=True, **kw)
    res = graphed.run(_requests(Request, prompts))
    eager = Engine(tcfg, tp, device="cpu", **kw).run(
        _requests(Request, prompts))
    _assert_streams(res, eager, _baseline(tcfg, tp, prompts))
    d = graphed._decode
    packs = [p for p in steps._packs(d.params) if p.experts]
    assert len(packs) == 3 * sum(map(tcfg.moe_at, range(tcfg.n_layers)))
    # new float weights: the bind re-packs every batched pack in place
    other = _halved(tp)
    scales = [p.scale.clone() for p in packs]
    Engine(tcfg, other, device="cpu", graphs=True, **kw)
    assert all(torch.equal(a / 2, p.scale) for a, p in zip(scales, packs))
    want = pack_sc_weights(other, tcfg)
    got = [p for p in steps._packs(want) if p.experts]
    assert all(torch.equal(a.plane, b.plane) and torch.equal(a.scale, b.scale)
               for a, b in zip(packs, got))
    spec = Engine(tcfg, tp, device="cpu", graphs=True, speculate_k=1,
                  draft_bits=4, **kw)
    assert spec._decode is d
    draft = [p for p in steps._packs(d.drafts[4][1]) if p.experts]
    assert len(draft) == len(packs) and draft[0].bits == 4
    _assert_streams(spec.run(_requests(Request, prompts, tag="s")), eager)


def test_serve_cli(capsys):
    """``--arch`` of both MoE configs serves with ``--reduced`` on the
    CPU."""
    from repro_torch.launch.serve import main
    for arch in ARCHS_MOE:
        main(["--arch", arch, "--reduced", "--sc-gemm", "--device", "cpu",
              "--requests", "2", "--prompt-len", "8", "--gen", "3",
              "--capacity", "2", "--block", "4"])
    out = capsys.readouterr().out
    assert out.count("[serve] cpu continuous/paged/chunked: 2 requests") == 2
