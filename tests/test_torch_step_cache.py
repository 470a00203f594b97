"""The port's per-shape decode-step cache (``launch.steps``) and the
engine's static-buffer protocol, on the CPU.

On the card a cached step is captured into a CUDA graph; here the capture
is replaced by a test double that leaves the step eager, so the keying,
the binding and the static buffers run without a card. The streams of an
engine on the cached step equal the eager engine's, the JAX engine's and
the sequential baseline's on reduced smollm-360m (float32), SC-GEMM off and
on, under a page budget tight enough to preempt between steps. The card's
side (graph replay bitwise equal to the eager step, one capture per shape,
launch counters) is in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import bind as jbind
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.serving import ConfigError, Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

#: the tight-budget workload of tests/test_torch_serving.py: 8 pages of 2
#: tokens for 2 slots, so a slot is preempted between decode steps
PROMPT_LENS = [6, 5, 6, 4]
GENS = [6, 6, 5, 6]
TIGHT = dict(capacity=2, max_seq=12, block=2, n_blocks=8, chunk=4)


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


def _cfg(sc: bool, **kw):
    return dataclasses.replace(
        ARCHS["smollm-360m"].reduced(dtype="float32", use_sc_gemm=sc),
        **kw).validate()


def _params(cfg, seed=0):
    return bind(cfg, "cpu").init_params(seed)


def _prompts(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _requests(cls, prompts, tag="r"):
    return [cls(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, GENS))]


class _Watching(Engine):
    """An engine that records the positions tensor's storage at every
    decode step."""

    def _decode_once(self):
        self.ptrs = getattr(self, "ptrs", [])
        self.ptrs.append((self.pool.cache.pos.data_ptr(),
                          self.pool.cache.pos is self._decode.cache.pos))
        return super()._decode_once()


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_static_buffer_engine_streams_equal_eager_jax_and_baseline(cached,
                                                                   sc):
    jcfg = JAX_ARCHS["smollm-360m"].reduced(dtype="float32", use_sc_gemm=sc)
    tcfg = _cfg(sc)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = _prompts()
    jax_res = JaxEngine(jcfg, jp, prefix_cache=False, **TIGHT).run(
        _requests(JaxRequest, prompts))
    eager = Engine(tcfg, tp, device="cpu", **TIGHT)
    eager_res = eager.run(_requests(Request, prompts))
    graphed = _Watching(tcfg, tp, device="cpu", graphs=True, **TIGHT)
    pos = graphed.pool.cache.pos
    res = graphed.run(_requests(Request, prompts))
    assert not eager.graphs and graphed.graphs
    assert graphed.stats["preemptions"] >= 1
    for r, e, j in zip(res, eager_res, jax_res):
        np.testing.assert_array_equal(r.tokens, e.tokens, err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
    for p, g, r in zip(prompts, GENS, res):
        base = generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")
        np.testing.assert_array_equal(r.tokens, base[0].numpy())
    # the pool's positions are the step's static buffer throughout:
    # decode steps, admissions, evictions and preemptions write it in place
    assert graphed.pool.cache.pos is pos is graphed._decode.cache.pos
    assert graphed.ptrs and all(p == (pos.data_ptr(), True)
                                for p in graphed.ptrs)
    assert graphed._decode.replays == graphed.stats["decode_steps"]


def test_one_entry_per_shape_and_none_after_churn(cached):
    cfg = _cfg(True)
    params = _params(cfg)
    first = Engine(cfg, params, device="cpu", graphs=True, **TIGHT)
    assert len(steps.decode_steps()) == 1
    step = first._decode
    first.run(_requests(Request, _prompts()))
    # admissions, evictions, preemptions and page churn are inputs
    assert first.stats["preemptions"] >= 1
    assert len(steps.decode_steps()) == 1 and step.captures == 1
    second = Engine(cfg, params, device="cpu", graphs=True, **TIGHT)
    assert second._decode is step and step.captures == 1
    second.run(_requests(Request, _prompts(seed=4)))
    assert len(steps.decode_steps()) == 1 and step.captures == 1
    assert step.replays == (first.stats["decode_steps"]
                            + second.stats["decode_steps"])


@pytest.mark.parametrize("change", [
    dict(capacity=3), dict(max_seq=16), dict(fused=False), dict(attn_sc=True),
    dict(sc_bits=6), dict(paged=False)],
    ids=["capacity", "max_blocks", "fused", "attn_sc", "sc_bits",
         "contiguous"])
def test_a_new_shape_is_a_new_entry(cached, change):
    cfg = _cfg(True)
    params = _params(cfg)
    base = Engine(cfg, params, device="cpu", graphs=True, **TIGHT)
    cfg_kw = {k: v for k, v in change.items() if k in ("attn_sc", "sc_bits")}
    eng_kw = {**TIGHT, **{k: v for k, v in change.items()
                          if k not in cfg_kw}}
    other = Engine(_cfg(True, **cfg_kw), params, device="cpu", graphs=True,
                   **eng_kw)
    assert other._decode is not base._decode
    if "max_seq" in change:
        assert other.pool.max_blocks != base.pool.max_blocks
    assert len(steps.decode_steps()) == 2
    assert base._decode.captures == other._decode.captures == 1


def test_an_engine_binding_a_shape_in_use_is_refused(cached):
    cfg = _cfg(True)
    params = _params(cfg)
    first = Engine(cfg, params, device="cpu", graphs=True, **TIGHT)
    for r in _requests(Request, _prompts()):
        first.submit(r)
    while not first.pool.entries:
        first.step()
    with pytest.raises(ConfigError, match="serves another engine"):
        Engine(cfg, params, device="cpu", graphs=True, **TIGHT)


def test_an_idle_engine_binds_its_step_back(cached):
    """Two engines of one shape with different weights, used in turn: each
    serves its own weights, through the one entry."""
    cfg = _cfg(True)
    pa, pb = _params(cfg, 0), _params(cfg, 1)
    prompts = _prompts()
    want = {}
    for name, p in (("a", pa), ("b", pb)):
        want[name] = [r.tokens for r in Engine(cfg, p, device="cpu", **TIGHT)
                      .run(_requests(Request, prompts))]
    a = Engine(cfg, pa, device="cpu", graphs=True, **TIGHT)
    b = Engine(cfg, pb, device="cpu", graphs=True, **TIGHT)
    assert a._decode is b._decode
    assert any(not np.array_equal(x, y) for x, y in zip(want["a"],
                                                          want["b"]))
    for run, (name, eng) in enumerate((("a", a), ("b", b), ("a", a))):
        got = [r.tokens for r in eng.run(_requests(Request, prompts,
                                                   f"run{run}-"))]
        for g, w in zip(got, want[name]):
            np.testing.assert_array_equal(g, w)
    assert a._decode.captures == 1


def test_an_entry_packs_its_weights_once_and_again_only_on_a_change(
        cached, monkeypatch):
    """A new entry packs its own copy of the weights once. An engine
    binding it with the weights it holds (the same tensors, unwritten
    since) packs nothing; other weights, or the same ones written in
    place, are packed anew. A draft width packed before the weights
    changed is packed anew when an engine drafting at it binds the
    entry. Every engine's streams are its eager twin's."""
    cfg = _cfg(True)
    kw = dict(capacity=2, max_seq=24, block=4)
    made, repacked = [], []
    real_pack, real_repack = steps.pack_sc_weights, steps.repack

    def pack(params, c, **k):
        if not k:
            made.append(c.sc_bits)
        return real_pack(params, c, **k)

    def repack(params, c):
        repacked.append(c.sc_bits)
        real_repack(params, c)

    monkeypatch.setattr(steps, "pack_sc_weights", pack)
    monkeypatch.setattr(steps, "repack", repack)
    prompts = _prompts()

    def serve(params, tag, **spec):
        eng = Engine(cfg, params, device="cpu", graphs=True, **kw, **spec)
        want = Engine(cfg, params, device="cpu", **kw).run(
            _requests(Request, prompts, f"{tag}-eager-"))
        for r, w in zip(eng.run(_requests(Request, prompts, tag)), want):
            np.testing.assert_array_equal(r.tokens, w.tokens, err_msg=r.uid)
        return eng

    pa, pb = _params(cfg, 0), _params(cfg, 1)
    a = serve(pa, "a")
    assert (made, repacked) == ([cfg.sc_bits], [])
    serve(pa, "a2")
    serve(pb, "b")
    assert repacked == [cfg.sc_bits]
    with torch.no_grad():
        pb["layers"][0]["mlp"]["w1"].mul_(0.5)
    serve(pb, "b2")
    assert repacked == [cfg.sc_bits] * 2
    serve(pb, "spec", speculate_k=2, draft_bits=4)
    assert made[-1] == 4 and repacked == [cfg.sc_bits] * 2
    serve(pa, "a3")
    serve(pa, "spec2", speculate_k=2, draft_bits=4)
    assert repacked == [cfg.sc_bits] * 3 + [4]
    fresh = real_pack(pa, steps.draft_config(cfg, 4))
    for got, want in zip(steps._packs(a._decode.drafts[4][1]),
                         steps._packs(fresh), strict=True):
        assert torch.equal(got.plane, want.plane)
        assert torch.equal(got.scale, want.scale)


def test_a_rebind_drops_the_warm_prefix_tree(cached):
    """Engines of one shape share one entry and its KV pool. A cache-off
    engine binding it zeroes the pool under an idle cache-on engine's warm
    prefix tree; when the warm engine binds the entry back it drops the
    tree and its retained pages, so its next prompts miss and its streams
    stay the baseline's (a hit would read the zeroed pages)."""
    cfg = _cfg(True)
    params = _params(cfg)
    rng = np.random.default_rng(9)
    pre = rng.integers(0, 256, size=(8,)).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, 256, size=(n,))])
               .astype(np.int32) for n in (4, 3, 4)]
    gens = [5, 4, 6]
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4)
    base = [generate(cfg, params, p[None], gen_tokens=g, device="cpu")[0]
            .numpy() for p, g in zip(prompts, gens)]

    def run(eng, tag):
        res = eng.run([Request(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
                       for i, (p, g) in enumerate(zip(prompts, gens))])
        for r, b in zip(res, base):
            np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)
        return eng.stats

    warm = Engine(cfg, params, device="cpu", graphs=True, **kw)
    run(warm, "a")
    assert warm.stats["prefix_retained_pages"] > 0
    assert run(warm, "b")["prefix_misses"] == 0        # all hit
    other = Engine(cfg, params, device="cpu", graphs=True,
                   prefix_cache=False, **kw)
    assert other._decode is warm._decode
    assert not warm.pool.cache.k[0].any()              # the bind zeroed it
    run(other, "c")
    st = run(warm, "d")
    assert warm._decode.owner() is warm
    assert (st["prefix_misses"], st["prefix_hits"]) == (1, 2)
    assert st["prefill_tokens_saved"] > 0
    assert warm.pool.pages_live == 0
    assert warm.pool.free_pages + len(warm.pool.retained) == \
        warm.pool.n_blocks


def test_graphs_on_the_cpu_raise():
    cfg = _cfg(False)
    with pytest.raises(ConfigError, match="need the card"):
        Engine(cfg, _params(cfg), device="cpu", graphs=True, **TIGHT)
    assert not Engine(cfg, _params(cfg), device="cpu", **TIGHT).graphs


def test_replay_adds_the_launches_its_capture_recorded(cached):
    cfg = _cfg(True)
    eng = Engine(cfg, _params(cfg), device="cpu", graphs=True, **TIGHT)
    step = eng._decode
    counters = steps.launch_counters()
    step.launch_counts = {"sc_linear": 15, "paged_attention": 2}
    before = {k: counters[k].launches for k in step.launch_counts}
    for _ in range(3):
        step.replay()
    assert {k: counters[k].launches - before[k]
            for k in step.launch_counts} == {"sc_linear": 45,
                                             "paged_attention": 6}
    for k, n in before.items():
        counters[k].launches = n
