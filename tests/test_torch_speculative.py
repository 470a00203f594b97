"""Self-speculative decoding in the PyTorch port, held against the JAX
package on the CPU.

* ``cache_ops.paged_commit_window`` and ``paged_rollback`` equal the JAX
  ops on the same pool and tables (index math: pools and positions exactly
  equal), free slots and windows running off their pages included;
* ``decode_window_step`` equals the JAX step (logits within 1e-5 with
  exact projections; under SC-GEMM the LM head's counts, recovered from
  each side's logits and hidden rows, equal), and row ``i`` of a W = 4
  window equals ``i + 1`` sequential port ``decode_step`` calls (SC-GEMM:
  bit for bit; exact projections: within 1e-5, a W-row matmul may sum in
  another order than a one-row one);
* the engine's speculative streams equal the port's sequential
  ``generate``, the port's non-speculative engine's and the JAX
  speculative engine's for (k, draft_bits) in (1, 8), (3, 8), (2, 4); k = 1
  degenerates step for step; a poisoned draft emits one exact token a
  round; preemption mid-speculation replays identically; gating refuses
  what cannot roll back or has no one right token;
* the graphed engine's speculative steps (the capture replaced by a test
  double that leaves them eager): one entry per (k, draft_bits) and
  width, one packed copy of the weights per draft width, rebinding
  re-packs it;
* the ``repro_torch.launch.serve`` CLI's ``--speculate-k`` /
  ``--draft-bits``.

Draft proposals are not held to JAX's: at 4 bits an ulp on a rounding
boundary moves a magnitude step (``ROADMAP.md``, Queue 3). The card's side
is in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.sc_numerics import recover_counts as jrecover
from repro.models import bind as jbind
from repro.models import cache_ops as jops
from repro.models import transformer as jtr
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.models import cache_ops as tops
from repro_torch.models import layers
from repro_torch.models import transformer as ttr
from repro_torch.serving import ConfigError, Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

#: logits of the port and the JAX package with exact projections
EXACT = dict(rtol=1e-5, atol=1e-5)

SMALL = dict(family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
             dtype="float32", q_block=16, kv_block=16, loss_chunk=16,
             remat=False)


def _cfgs(sc: bool = True, **kw):
    """The same reduced config (2 layers, d_model 64) on both sides."""
    fields = dict(SMALL, name="spec-dense", use_sc_gemm=sc, **kw)
    return (JaxModelConfig(**fields).validate(),
            ModelConfig(**fields).validate())


def _setup(sc: bool = True, seed: int = 0, **kw):
    jcfg, tcfg = _cfgs(sc, **kw)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(seed))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(n, s=8, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=(s,)).astype(np.int32)
            for _ in range(n)]


def _requests(cls, prompts, gens, tag="r"):
    return [cls(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _baseline(cfg, params, prompt, gen):
    return generate(cfg, params, prompt[None], gen_tokens=gen,
                    device="cpu")[0].numpy()


def _assert_baseline(cfg, params, results, prompts, gens):
    for r, p, g in zip(results, prompts, gens):
        np.testing.assert_array_equal(r.tokens, _baseline(cfg, params, p, g),
                                      err_msg=f"{r.uid}: stream diverged")


# ----------------------------------------------------------- cache ops


def _random_pools(jcfg, tcfg, n_pages, block, capacity, seed):
    """The same paged pool, filled with random K/V, on both sides."""
    rng = np.random.default_rng(seed)
    jdata = jops.paged_init(lambda b, s: jtr.init_kv_cache(jcfg, b, s),
                            capacity, n_pages, block)
    leaves = [rng.standard_normal(leaf.shape).astype(np.float32)
              for leaf in (*jdata.k, *jdata.v)]
    g = len(jdata.k)
    jdata = jdata._replace(k=tuple(jnp.asarray(x) for x in leaves[:g]),
                           v=tuple(jnp.asarray(x) for x in leaves[g:]))
    tdata = tops.paged_init(
        lambda b, s: ttr.init_kv_cache(tcfg, b, s, device="cpu"),
        capacity, n_pages, block)
    tdata = tdata._replace(k=tuple(torch.as_tensor(x.copy())
                                   for x in leaves[:g]),
                           v=tuple(torch.as_tensor(x.copy())
                                   for x in leaves[g:]))
    return jdata, tdata


def _assert_same(j, t):
    """Pools equal but for the trash page (the last), where windows of
    several slots may collide and which write lands last is the
    backend's choice; positions equal."""
    for a, b in zip((*j.k, *j.v), (*t.k, *t.v)):
        np.testing.assert_array_equal(b.numpy()[:, :-1], np.asarray(a)[:, :-1])
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))


@pytest.mark.parametrize("block", [4, 5])
def test_commit_window_and_rollback_equal_jax(block):
    """Four slots, tables of 3 pages: slot 0 mid-page, slot 1 a window
    that runs off its last allocated page, slot 2 free (all -1, its
    window into the trash page), slot 3 a window past the table's extent.
    Pools (every page but the trash page) and positions equal exactly
    after the commit and the rollback."""
    jcfg, tcfg = _cfgs()
    capacity, n_pages, mb, width = 4, 9, 3, 4
    jdata, tdata = _random_pools(jcfg, tcfg, n_pages, block, capacity, 3)
    tables = np.array([[4, 0, -1], [2, -1, -1], [-1, -1, -1], [1, 5, 7]],
                      np.int32)
    pos = np.array([block + 1, block - 2, 0, mb * block - 2], np.int32)
    jt, tt = jnp.asarray(tables), torch.as_tensor(tables)
    jdata = jdata._replace(pos=jnp.asarray(pos))
    tdata = tdata._replace(pos=torch.as_tensor(pos.copy()))
    jdense, tdense = _random_pools(jcfg, tcfg, capacity - 1, mb * block,
                                   capacity, 4)
    # a dense view: (lead, C, MB * block, KV, hd) with the advanced pos
    jdense = jtr.KVCache(k=tuple(x[:, :capacity] for x in jdense.k),
                         v=tuple(x[:, :capacity] for x in jdense.v),
                         pos=jnp.asarray(pos + width))
    tdense = ttr.KVCache(k=tuple(x[:, :capacity] for x in tdense.k),
                         v=tuple(x[:, :capacity] for x in tdense.v),
                         pos=torch.as_tensor(pos + width))
    jdata = jops.paged_commit_window(jdata, jdense, jt, block=block,
                                     width=width)
    tnew = tops.paged_commit_window(tdata, tdense, tt, block=block,
                                    width=width)
    assert tnew.k[0] is tdata.k[0]                       # in place
    _assert_same(jdata, tnew)
    accept = np.array([2, 4, 0, 1], np.int32)
    jdata = jops.paged_rollback(jdata, jt, block=block, width=width,
                                accept=jnp.asarray(accept))
    tback = tops.paged_rollback(tnew, tt, block=block, width=width,
                                accept=torch.as_tensor(accept))
    assert tback.k[0] is tdata.k[0]
    _assert_same(jdata, tback)
    np.testing.assert_array_equal(tback.pos.numpy(), pos + accept)


def test_window_token_entries_equal_the_one_row_derivation():
    """``paged_token_entry`` over a ``(C, W)`` window is column by column
    the ``(C,)`` derivation the decode step uses."""
    tables = torch.as_tensor([[3, -1], [0, 2]], dtype=torch.int32)
    wpos = torch.as_tensor([[3, 4, 5, 8], [-1, 0, 7, 9]])
    entry, off = tops.paged_token_entry(tables, wpos, block=4)
    for i in range(wpos.shape[1]):
        e, o = tops.paged_token_entry(tables, wpos[:, i], block=4)
        np.testing.assert_array_equal(entry[:, i].numpy(), e.numpy())
        np.testing.assert_array_equal(off[:, i].numpy(), o.numpy())


# ------------------------------------------------------ the window step


def _recording(monkeypatch, module):
    """Record every hidden row ``module.logits_from_hidden`` projects."""
    seen = []
    real = module.logits_from_hidden

    def rec(params, cfg, hidden):
        seen.append(hidden)
        return real(params, cfg, hidden)

    monkeypatch.setattr(module, "logits_from_hidden", rec)
    return seen


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_decode_window_step_equals_jax(monkeypatch, sc):
    """Two sequences prefilled to 7 tokens (extent 16), then a W = 4
    window at ragged positions 7 and 5: logits within 1e-5 of the JAX
    step with exact projections, the LM head's counts equal under
    SC-GEMM; the window's K/V rows and the advanced positions too."""
    jcfg, jp, tcfg, tp = _setup(sc)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    prompts = np.stack(_prompts(2, s=7, seed=5))
    jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(prompts)},
                             extra_slots=9)
    with torch.no_grad():
        tl, tc = tm.prefill_step(tp, {"tokens": torch.as_tensor(prompts)},
                                 extra_slots=9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    pos = np.array([7, 5], np.int32)
    jc = jc._replace(pos=jnp.asarray(pos))
    tc = tc._replace(pos=torch.as_tensor(pos))
    window = np.random.default_rng(6).integers(0, 128, (2, 4)).astype(
        np.int32)
    jseen = _recording(monkeypatch, jtr)
    tseen = _recording(monkeypatch, ttr)
    jl, jc = jm.decode_window_step(jp, jc, {"tokens": jnp.asarray(window)})
    with torch.no_grad():
        tl, tc = tm.decode_window_step(tp, tc,
                                       {"tokens": torch.as_tensor(window)})
    assert tl.shape == (2, 4, tcfg.vocab_size)
    np.testing.assert_array_equal(tc.pos.numpy(), pos + 4)
    np.testing.assert_array_equal(np.asarray(jc.pos), pos + 4)
    if sc:
        head = np.asarray(jp["lm_head"])
        want = jrecover(np.asarray(jl).reshape(8, -1),
                        np.asarray(jseen[-1]).reshape(8, -1), head,
                        bits=jcfg.sc_bits, row_quant=True)
        got = jrecover(tl.numpy().reshape(8, -1),
                       tseen[-1].numpy().reshape(8, -1), head,
                       bits=tcfg.sc_bits, row_quant=True)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **EXACT)
        for t, j in zip((*tc.k, *tc.v), (*jc.k, *jc.v)):
            np.testing.assert_allclose(t.numpy()[:, :, :11],
                                       np.asarray(j)[:, :, :11], **EXACT)


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_window_rows_equal_sequential_decode_steps(sc):
    """Row ``i`` of a W = 4 window at ragged positions equals the ``i +
    1``-th of four sequential one-row ``decode_step`` calls fed the same
    tokens: bit for bit under SC-GEMM (integer projections, tree sums),
    within 1e-5 with exact projections. The K/V rows written agree the
    same way."""
    _, _, tcfg, tp = _setup(sc)
    tm = bind(tcfg, "cpu")
    prompts = torch.as_tensor(np.stack(_prompts(2, s=7, seed=7)))
    window = torch.as_tensor(np.random.default_rng(8).integers(
        0, 128, (2, 4)).astype(np.int32))
    pos = torch.as_tensor([7, 4], dtype=torch.int32)
    params = ttr.pack_sc_weights(tp, tcfg)

    def fresh():
        _, cache = tm.prefill_step(params, {"tokens": prompts},
                                   extra_slots=9)
        return cache._replace(pos=pos.clone())

    with torch.no_grad():
        wl, wc = tm.decode_window_step(params, fresh(),
                                       {"tokens": window})
        sc_, rows = fresh(), []
        for i in range(4):
            logits, sc_ = tm.decode_step(params, sc_,
                                         {"tokens": window[:, i:i + 1]})
            rows.append(logits[:, 0])
    seq = torch.stack(rows, dim=1)
    cmp = np.testing.assert_array_equal if sc else (
        lambda a, b: np.testing.assert_allclose(a, b, **EXACT))
    cmp(wl.numpy(), seq.numpy())
    np.testing.assert_array_equal(wc.pos.numpy(), sc_.pos.numpy())
    for a, b in zip((*wc.k, *wc.v), (*sc_.k, *sc_.v)):
        cmp(a.numpy(), b.numpy())


@pytest.mark.parametrize("bits", [None, 4, 8], ids=["float", "sc4", "sc8"])
def test_window_attention_rows_equal_one_row_calls(bits):
    """``layers.decode_attention`` over a W = 3 window (a sliding window
    of 5, ragged positions) equals three one-row calls bit for bit: the
    plain formulation's rows are W-invariant, as the card's flattened
    kernel call is by construction."""
    rng = np.random.default_rng(11)
    b, s, kv, g, d, w = 3, 20, 2, 3, 16, 3
    q = torch.as_tensor(rng.standard_normal((b, w, kv * g, d)),
                        dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((b, s, kv, d)),
                            dtype=torch.float32) for _ in range(2))
    pos = torch.as_tensor([0, 9, 17], dtype=torch.int32)
    got = layers.decode_attention(q, k, v, q_position=pos, window=5,
                                  sc_bits=bits)
    for i in range(w):
        one = layers.decode_attention(q[:, i:i + 1], k, v,
                                      q_position=pos + i, window=5,
                                      sc_bits=bits)
        np.testing.assert_array_equal(got[:, i:i + 1].numpy(), one.numpy())


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("k,bits", [(1, 8), (3, 8), (2, 4)])
def test_speculative_streams_equal_baseline_and_jax(k, bits):
    """Every emitted token is an exact argmax over the prefix the
    sequential baseline sees: the streams equal the port's ``generate``,
    its non-speculative engine's and the JAX speculative engine's (on the
    same weights) token for token."""
    jcfg, jp, tcfg, tp = _setup()
    prompts, gens = _prompts(3), [10, 7, 5]
    eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24, block=4,
                 speculate_k=k, draft_bits=bits)
    res = eng.run(_requests(Request, prompts, gens))
    _assert_baseline(tcfg, tp, res, prompts, gens)
    plain = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24,
                   block=4).run(_requests(Request, prompts, gens))
    jres = JaxEngine(jcfg, jp, capacity=2, max_seq=24, block=4,
                     prefix_cache=False, speculate_k=k,
                     draft_bits=bits).run(_requests(JaxRequest, prompts,
                                                    gens))
    for r, p, j in zip(res, plain, jres):
        np.testing.assert_array_equal(r.tokens, p.tokens, err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
    st = eng.stats
    assert st["speculative"] and st["spec_rounds"] > 0
    assert st["generated_tokens"] == 22
    assert st["decode_steps"] == st["spec_rounds"] <= st["generated_tokens"]
    assert st["spec_drafted_tokens"] >= k * st["spec_rounds"]
    assert 0 <= st["spec_acceptance_rate"] <= 1
    assert st["spec_tokens_per_round"] >= 1
    assert st["spec_draft_us"] > 0 and st["spec_verify_us"] > 0
    assert eng.pool.pages_live == 0


class _Grids(Engine):
    """An engine that keeps, every round, the live slots and the round's
    draft and exact token grids."""

    def _speculate_once(self):
        live = sorted(self.pool.entries)
        super()._speculate_once()
        self.grids = getattr(self, "grids", []) + [
            (live, self._window_host.numpy()[:, 1:].copy(),
             self._exact_host.numpy().copy())]


def test_an_exact_draft_accepts_every_proposal():
    """With SC attention at 8 bits and drafts at 8 bits the draft is the
    exact model itself, its one-row paged sub-steps against the verify's
    window rows: every live slot's proposals equal the exact argmaxes in
    every round, so each round keeps all ``k`` (up to the budget)."""
    _, _, tcfg, tp = _setup(attn_sc=True)
    prompts, gens = _prompts(3), [10, 7, 5]
    eng = _Grids(tcfg, tp, device="cpu", capacity=2, max_seq=24, block=4,
                 speculate_k=3, draft_bits=8)
    _assert_baseline(tcfg, tp, eng.run(_requests(Request, prompts, gens)),
                     prompts, gens)
    for i, (live, draft, exact) in enumerate(eng.grids):
        np.testing.assert_array_equal(draft[live], exact[live, :3],
                                      err_msg=f"round {i}")
    assert eng.stats["spec_tokens_per_round"] > 2


def test_tokens_past_eos_count_neither_emitted_nor_accepted():
    """An exact draft (as above) keeps a whole window a round; a request
    whose EOS falls inside a window stops there, and the statistics count
    what reached its stream: the rounds' tokens are the stream's less its
    prefill token, and of them every one up to each round's ``k`` an
    accepted draft token."""
    _, _, tcfg, tp = _setup(attn_sc=True)
    prompt, k = _prompts(1)[0], 3
    ref = _baseline(tcfg, tp, prompt, 12)
    # the EOS token: first seen inside a later window, not at its end
    i = next(i for i in range(k + 2, 12)
             if i % (k + 1) and ref[i] not in ref[:i])
    eng = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=24, block=4,
                 speculate_k=k, draft_bits=8)
    (res,) = eng.run([Request(uid="eos", prompt=prompt, max_new_tokens=12,
                              eos_id=int(ref[i]))])
    assert res.finished_reason == "eos"
    np.testing.assert_array_equal(res.tokens, ref[:i + 1])
    st = eng.stats
    emitted = round(st["spec_tokens_per_round"] * st["spec_rounds"])
    assert emitted == st["generated_tokens"] - 1 == i
    full, last = divmod(i - 1, k + 1)
    assert st["spec_rounds"] == full + 1
    assert st["spec_accepted_tokens"] == k * full + last + 1
    assert st["spec_drafted_tokens"] == k * st["spec_rounds"]


def test_k1_degenerates_to_baseline_step_for_step():
    """k = 1: one draft token and a 2-row verify a round; the stream
    equals the baseline and every round advances the slot >= 1 token."""
    _, _, tcfg, tp = _setup()
    prompts, gens = _prompts(1), [12]
    eng = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=24, block=4,
                 speculate_k=1, draft_bits=8)
    _assert_baseline(tcfg, tp, eng.run(_requests(Request, prompts, gens)),
                     prompts, gens)
    st = eng.stats
    assert st["spec_rounds"] == st["decode_steps"] <= 12
    assert st["spec_tokens_per_round"] >= 1.0


class _Poisoned:
    """A draft step whose proposals are all an in-vocab token no baseline
    here emits, so every proposal is rejected. (In vocabulary: a NaN K/V
    row in the verify window would poison every row's PV sum.)"""

    def __init__(self, step, token):
        self.step, self.token = step, token

    def replay(self):
        self.step.replay()
        self.step.out.fill_(self.token)


def test_all_rejected_drafts_emit_exactly_one_token():
    """Each round emits exactly one exact token a live slot (the
    correction row); the streams still equal the baseline; acceptance
    reports zero. Rounds = the longest stream minus its prefill token."""
    _, _, tcfg, tp = _setup()
    prompts, gens = _prompts(2), [8, 6]
    eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24, block=4,
                 speculate_k=3, draft_bits=8)
    eng._draft = _Poisoned(eng._draft, tcfg.vocab_size - 1)
    res = eng.run(_requests(Request, prompts, gens))
    _assert_baseline(tcfg, tp, res, prompts, gens)
    assert all(tcfg.vocab_size - 1 not in r.tokens for r in res)
    st = eng.stats
    assert st["spec_acceptance_rate"] == 0.0
    assert st["spec_accepted_tokens"] == 0
    assert st["decode_steps"] == 7


def test_preemption_mid_speculation_replays_identically():
    """A tight page budget preempts while rounds are in flight; the
    restarted stream replays the baseline's."""
    _, _, tcfg, tp = _setup()
    prompts = [p[:4] for p in _prompts(2)]
    gens = [8, 6]
    eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=12, block=2,
                 n_blocks=8, speculate_k=2, draft_bits=8)
    _assert_baseline(tcfg, tp, eng.run(_requests(Request, prompts, gens)),
                     prompts, gens)
    assert eng.stats["preemptions"] >= 1
    assert eng.pool.pages_live == 0


def test_speculation_gating():
    _, _, tcfg, tp = _setup()
    kw = dict(device="cpu", capacity=2, max_seq=24, block=4)
    with pytest.raises(ConfigError, match="paged"):
        Engine(tcfg, tp, paged=False, speculate_k=2, **kw)
    with pytest.raises(ConfigError, match="draft_bits"):
        Engine(tcfg, tp, speculate_k=2, draft_bits=1, **kw)
    with pytest.raises(ConfigError, match="draft_bits"):
        Engine(tcfg, tp, speculate_k=2, draft_bits=9, **kw)
    with pytest.raises(ConfigError):
        Engine(tcfg, tp, speculate_k=-1, **kw)
    ssm = ModelConfig(**dict(SMALL, name="spec-ssm", family="ssm",
                             n_kv_heads=1, d_ff=0, ssm_state=16,
                             ssm_headdim=16, ssm_chunk=4)).validate()
    with pytest.raises(ConfigError, match="roll back"):
        Engine(ssm, tp, speculate_k=2, **kw)
    with pytest.raises(ConfigError, match="prefix"):
        Engine(tcfg, tp, speculate_k=2, prefix_cache=True, **kw)
    eng = Engine(tcfg, tp, speculate_k=2, **kw)
    hot = Request(uid="hot", prompt=_prompts(1)[0], max_new_tokens=4,
                  temperature=0.7)
    with pytest.raises(ConfigError, match="greedy"):
        eng.submit(hot)
    with pytest.raises(ConfigError, match="greedy"):
        eng.run([hot])
    # the config's own fields are the defaults
    spec_cfg = dataclasses.replace(tcfg, speculate_k=2, draft_bits=6)
    eng = Engine(spec_cfg, tp, **kw)
    assert (eng.speculate_k, eng.draft_bits) == (2, 6)


# ------------------------------------------------- the graphed steps


def _fake_capture(step):
    """The test double: records a capture and leaves the step eager."""
    step.captures += 1


@pytest.fixture
def cached(monkeypatch):
    """The step cache with the capture replaced, empty before and after."""
    monkeypatch.setattr(steps, "capture", _fake_capture)
    steps.clear_decode_steps()
    yield
    steps.clear_decode_steps()


def test_graphed_engine_one_entry_per_shape_and_rebinding(cached):
    """Graphed engines hang their draft, verify and rollback steps off the
    decode entry: one each per (k, draft_bits) and width, captured once,
    shared by every engine of the shape. Two engines with different
    weights used in turn each serve their own weights' streams (binding
    re-packs the draft's weights); a draft at another width is another
    entry over the same verify window."""
    _, _, tcfg, pa = _setup()
    pb = _setup(seed=1)[3]
    prompts, gens = _prompts(3), [10, 7, 5]
    kw = dict(device="cpu", capacity=2, max_seq=24, block=4, speculate_k=3,
              draft_bits=4)
    a = Engine(tcfg, pa, graphs=True, **kw)
    b = Engine(tcfg, pb, graphs=True, **kw)
    d = a._decode
    assert b._decode is d and set(d.specs) == {
        ("verify", 4), ("draft", 3, 4), ("rollback", 4)}
    assert a.spec_steps() == b.spec_steps()
    assert all(s.captures == 1 for s in d.specs.values())
    draft = d.specs[("draft", 3, 4)]
    assert draft.out.data_ptr() == d.specs[("verify", 4)].window[
        :, 1:].data_ptr()
    assert draft.weight_bytes > 0
    for run, (eng, params) in enumerate(((a, pa), (b, pb), (a, pa))):
        res = eng.run(_requests(Request, prompts, gens, f"run{run}-"))
        _assert_baseline(tcfg, params, res, prompts, gens)
    st = a.stats
    assert draft.replays == d.specs[("verify", 4)].replays == \
        d.specs[("rollback", 4)].replays
    assert all(s.captures == 1 for s in d.specs.values())
    c = Engine(tcfg, pa, graphs=True, **dict(kw, draft_bits=8))
    assert c._verify is a._verify and c._draft is not a._draft
    assert len(d.specs) == 4 and len(steps.decode_steps()) == 1
    res = c.run(_requests(Request, prompts, gens, "c-"))
    _assert_baseline(tcfg, pa, res, prompts, gens)
    assert st["spec_rounds"] == st["decode_steps"] > 0


def test_one_packed_draft_copy_per_width(cached):
    """The entry packs its weights once per draft width: draft steps of
    another ``k`` share that copy. A non-speculative engine's bind leaves
    it as it was; an engine drafting at that width packs it anew from its
    own weights when it binds, and serves their streams."""
    _, _, tcfg, pa = _setup()
    pb = _setup(seed=1)[3]
    prompts, gens = _prompts(2), [7, 5]
    kw = dict(device="cpu", capacity=2, max_seq=24, block=4, graphs=True)
    a = Engine(tcfg, pa, speculate_k=3, draft_bits=4, **kw)
    b = Engine(tcfg, pa, speculate_k=2, draft_bits=4, **kw)
    d = a._decode
    assert b._decode is d and b._draft is not a._draft
    assert b._draft.params is a._draft.params and set(d.drafts) == {4}
    planes = [p.plane.clone() for p in steps._packs(a._draft.params)]
    Engine(tcfg, pb, **kw)
    assert all(torch.equal(x, p.plane)
               for x, p in zip(planes, steps._packs(a._draft.params)))
    c = Engine(tcfg, pb, speculate_k=3, draft_bits=4, **kw)
    assert c._draft is a._draft
    assert not all(torch.equal(x, p.plane)
                   for x, p in zip(planes, steps._packs(c._draft.params)))
    _assert_baseline(tcfg, pb, c.run(_requests(Request, prompts, gens)),
                     prompts, gens)
    _assert_baseline(tcfg, pa, b.run(_requests(Request, prompts, gens, "b")),
                     prompts, gens)


def test_graphed_and_eager_speculative_engines_agree(cached):
    """The static-buffer steps of a graphed engine (eager here) and an
    eager engine's own give the same streams and statistics, under a
    budget tight enough to preempt."""
    _, _, tcfg, tp = _setup()
    prompts, gens = [p[:4] for p in _prompts(2)], [8, 6]
    kw = dict(device="cpu", capacity=2, max_seq=12, block=2, n_blocks=8,
              speculate_k=2, draft_bits=4)
    eager = Engine(tcfg, tp, **kw)
    graphed = Engine(tcfg, tp, graphs=True, **kw)
    er = eager.run(_requests(Request, prompts, gens))
    gr = graphed.run(_requests(Request, prompts, gens))
    for e, g in zip(er, gr):
        np.testing.assert_array_equal(e.tokens, g.tokens)
    for key in ("spec_rounds", "spec_accepted_tokens", "preemptions"):
        assert eager.stats[key] == graphed.stats[key]
    assert graphed.pool.cache.pos is graphed._decode.cache.pos


def test_draft_step_restores_positions_and_rollback_zeroes():
    """The draft writes scratch rows but leaves the positions where they
    were; after a round every cell past a slot's position is zero (the
    pool is a pure function of the live requests)."""
    _, _, tcfg, tp = _setup()
    eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=24, block=4,
                 speculate_k=3, draft_bits=4)
    for r in _requests(Request, _prompts(2), [12, 12]):
        eng.submit(r)
    while len(eng.pool.entries) < 2:
        eng.step()
    pool = eng.pool
    before = pool.cache.pos.clone()
    eng._copy_step_inputs(4)
    eng._draft.replay()
    np.testing.assert_array_equal(pool.cache.pos.numpy(), before.numpy())
    eng.step()
    tables = torch.as_tensor(pool.tables)
    dense = tops.paged_gather(pool.cache, tables, block=pool.block)
    for slot in pool.entries:
        p = int(pool.cache.pos[slot])
        for leaf in (*dense.k, *dense.v):
            assert not leaf[:, slot, p:].any(), (slot, p)
            assert leaf[:, slot, p - 1].any()


def test_serve_cli_speculates(capsys):
    """``--speculate-k 2`` (draft bits 4 by default) on a reduced arch on
    the CPU prints the speculative statistics."""
    tserve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                 "--sc-gemm", "--speculate-k", "2", "--requests", "2",
                 "--prompt-len", "8", "--gen", "6", "--capacity", "2",
                 "--block", "4"])
    out = capsys.readouterr().out
    assert "spec k=2@4b:" in out and "accepted" in out
    assert "tok/round" in out
