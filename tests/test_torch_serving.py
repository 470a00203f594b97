"""The PyTorch port's serving engine: token streams equal the JAX engine's
and the port's own sequential ``generate`` baseline on the reduced dense
archs (smollm-360m, qwen2-7b, qwen2.5-14b, gemma2-9b; float32), SC-GEMM
on and off, and on smollm-360m under a page budget tight enough to force
preemption; plus the queue, pool and streaming surfaces."""
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
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.serving import (ConfigError, Engine, PagedSlotPool,
                                 PoolExhausted, Request, RequestQueue,
                                 SlotEntry, SlotPool)

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

GENS = [3, 7, 2, 5, 4]
PROMPT_LENS = [8, 13, 5, 8, 10]


#: dense archs whose engine streams are held against the JAX engine's
DENSE_ARCHS = ["smollm-360m", "qwen2-7b", "qwen2.5-14b", "gemma2-9b"]


def _setup(sc: bool, arch: str = "smollm-360m"):
    jcfg = JAX_ARCHS[arch].reduced(dtype="float32", use_sc_gemm=sc)
    tcfg = ARCHS[arch].reduced(dtype="float32", use_sc_gemm=sc)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(seed=1, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in lens]


def _requests(cls, prompts, gens, **kw):
    return [cls(uid=f"r{i}", prompt=p, max_new_tokens=g, **kw)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _baseline(cfg, params, prompts, gens):
    return [generate(cfg, params, p[None], gen_tokens=g,
                     device="cpu")[0].numpy()
            for p, g in zip(prompts, gens)]


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_engine_streams_equal_jax_engine_and_sequential_baseline(arch, sc):
    """Every dense arch, so an arch-specific layer (GELU, softcap, QKV
    bias, sliding window) cannot differ from the reference unseen."""
    jcfg, jp, tcfg, tp = _setup(sc, arch)
    prompts = _prompts()
    max_seq = max(PROMPT_LENS) + max(GENS)
    kw = dict(capacity=2, max_seq=max_seq, block=4, chunk=8)
    jax_res = JaxEngine(jcfg, jp, prefix_cache=False, **kw).run(
        _requests(JaxRequest, prompts, GENS))
    engine = Engine(tcfg, tp, device="cpu", **kw)
    res = engine.run(_requests(Request, prompts, GENS))
    base = _baseline(tcfg, tp, prompts, GENS)
    for r, j, b in zip(res, jax_res, base):
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)
        assert r.finished_reason == "length"
    st = engine.stats
    assert st["decode_steps"] < sum(g - 1 for g in GENS)     # co-batched
    assert st["pages_live"] == 0 and st["pages_in_use"] == 0


def test_tight_page_budget_preempts_and_replays_identically():
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=2, lens=[6, 5, 6, 4])
    gens = [6, 6, 5, 6]
    base = _baseline(tcfg, tp, prompts, gens)
    engine = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=12, block=2,
                    n_blocks=8, chunk=4)
    seen: dict[str, list] = {}

    def on_token(uid, index, tok, reason):
        seen.setdefault(uid, []).append((index, int(tok)))

    for r in _requests(Request, prompts, gens):
        engine.submit(r, on_token=on_token)
    res = engine.run()
    assert engine.stats["preemptions"] >= 1
    assert engine.stats["backpressure"]["decode"]
    by_uid = {r.uid: r for r in res}
    for i, b in enumerate(base):
        np.testing.assert_array_equal(by_uid[f"r{i}"].tokens, b)
        # callbacks saw every token, replays included, in stream order
        last = {}
        for index, tok in seen[f"r{i}"]:
            assert tok == b[index]
            last[index] = tok
        assert sorted(last) == list(range(len(b)))


@pytest.mark.parametrize("kw", [dict(paged=False), dict(fused=False),
                                dict(prefill_mode="oneshot"),
                                dict(continuous=False),
                                dict(prefill_budget=32)],
                         ids=["contiguous", "gather", "oneshot", "static",
                              "budget"])
def test_engine_modes_equal_the_sequential_baseline(kw):
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=3)
    base = _baseline(tcfg, tp, prompts, GENS)
    engine = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=20, block=4,
                    chunk=4, **kw)
    res = engine.run(_requests(Request, prompts, GENS))
    for r, b in zip(res, base):
        np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)


def test_stream_eos_and_static_batching():
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=4, lens=[7, 9])
    full = _baseline(tcfg, tp, prompts, [8, 8])
    eos = int(full[0][2])
    engine = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=20, block=4)
    toks = [int(t) for t in engine.stream(
        Request(uid="s", prompt=prompts[0], max_new_tokens=8, eos_id=eos))]
    cut = int(np.argmax(full[0] == eos)) + 1
    assert toks == full[0][:cut].tolist()
    res = engine.run([Request(uid="t", prompt=prompts[1], max_new_tokens=8)])
    np.testing.assert_array_equal(res[0].tokens, full[1])
    assert res[0].ttft_s <= res[0].latency_s

    gens = [2, 9, 3, 8]
    reqs = lambda: _requests(Request, _prompts(seed=5, lens=[6] * 4), gens)
    steps = {}
    for cont in (True, False):
        e = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=16, block=4,
                   continuous=cont)
        e.run(reqs())
        steps[cont] = e.stats["decode_steps"]
    assert steps[True] < steps[False]


def test_temperature_sampling_depends_on_the_request_alone():
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts(seed=6, lens=[6, 6, 6])
    kw = dict(temperature=0.8)
    alone = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=16).run(
        _requests(Request, prompts[:1], [6], seed=3, **kw))[0].tokens
    batched = Engine(tcfg, tp, device="cpu", capacity=3, max_seq=16).run(
        [Request(uid=f"r{i}", prompt=p, max_new_tokens=6, seed=3 if i == 0
                 else i, **kw) for i, p in enumerate(prompts)])[0].tokens
    np.testing.assert_array_equal(alone, batched)
    seq = generate(tcfg, tp, prompts[0][None], gen_tokens=6, temperature=0.8,
                   seed=3, device="cpu")[0].numpy()
    np.testing.assert_array_equal(alone, seq)


def test_queue_and_pools():
    q = RequestQueue([Request(uid="a", prompt=np.ones(4, np.int32),
                              max_new_tokens=1)])
    q.submit(Request(uid="b", prompt=np.ones(4, np.int32), max_new_tokens=1))
    with pytest.raises(ConfigError, match="duplicate"):
        q.submit(Request(uid="a", prompt=np.ones(4, np.int32),
                         max_new_tokens=1))
    assert q.pop().uid == "a" and q.pop().uid == "b" and not q
    with pytest.raises(ConfigError):
        Request(uid="x", prompt=np.ones(0, np.int32), max_new_tokens=1)

    _, _, tcfg, tp = _setup(False)
    m = bind(tcfg, "cpu")
    _, single = m.prefill_step(tp, {"tokens": torch.as_tensor(
        _prompts(lens=[5])[0])[None]})

    def entry(uid, gen=2):
        return SlotEntry(request=Request(uid=uid, prompt=np.ones(5, np.int32),
                                         max_new_tokens=gen),
                         admitted_at=0.0, admit_step=0)

    pool = SlotPool(m, capacity=2, max_seq=12)
    assert {pool.admit(entry("a"), single), pool.admit(entry("b"), single)} \
        == {0, 1}
    with pytest.raises(PoolExhausted, match="full"):
        pool.admit(entry("c"), single)
    pool.evict(0)
    assert pool.positions()[0] == 0 and pool.admit(entry("d"), single) == 0
    with pytest.raises(PoolExhausted, match="max_seq"):
        pool.check_fits(entry("e", gen=100).request)

    paged = PagedSlotPool(m, capacity=2, max_seq=16, block=4, n_blocks=3)
    slot = paged.admit(entry("p"), single)
    assert paged.pages_live == 2 and paged.free_pages == 1
    paged.ensure_page(slot, 8)
    with pytest.raises(PoolExhausted) as exc:
        paged.ensure_page(slot, 12)
    assert exc.value.reason == "decode" and exc.value.uid == "p"
    np.testing.assert_array_equal(paged.read(slot).k[0][:, 0, :5].numpy(),
                                  single.k[0][:, 0].numpy())
    paged.evict(slot)
    assert paged.pages_live == 0 and paged.free_pages == 3
    assert PagedSlotPool.plan(4, 256, 64) == (64, 4, 16)


def test_engine_refuses_unfittable_requests_before_any_work():
    _, _, tcfg, tp = _setup(False)
    engine = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=10)
    good = Request(uid="fits", prompt=np.ones(4, np.int32), max_new_tokens=2)
    bad = Request(uid="big", prompt=np.ones(4, np.int32), max_new_tokens=99)
    with pytest.raises(PoolExhausted, match="max_seq"):
        engine.run([good, bad])
    assert not engine.queue and not engine.pool.entries
    assert engine.run([good])[0].n_generated == 2
