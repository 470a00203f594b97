"""The copy-on-write prefix cache of the PyTorch port, held against the JAX
package on the CPU.

* ``serving.prefix.PrefixCache``: the same ``match`` / ``insert`` /
  ``reclaim`` sequence on the port's tree and the reference's gives equal
  plans, page lists and retained sets, and equal digests for a seed;
* the page-sharing cache ops (``paged_copy_page``, ``paged_zero_pages``,
  ``prefix_seed``, the ``paged_insert(start > 0)`` overlay) equal the JAX
  ops exactly on seeded random pools;
* a fuzz of pool operations (admission with and without a plan, growth,
  eviction, pins, reclaim) drives the port's ``PagedSlotPool`` and the
  reference's side by side: refcounts, retained sets, tables, free lists,
  CoW and reclaim counts and the pool's contents equal after every one;
* the engine tests of ``tests/test_paging.py`` on the prefix cache
  (gating, shared prompts, CoW, the minimal budget, the private
  fallback, tokens saved at admission, the hash seed, the shared-prefix
  schedule fuzz with the refcount ledger checked every step): with exact
  projections the port's streams and prefix stats equal the JAX engine's
  with the cache on, and its streams the port's sequential ``generate``;
  under SC-GEMM the port is held to its own cache-off run and baseline
  (JAX's jitted SC-GEMM logits drift from its eager ones, ``ROADMAP.md``
  Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _propcheck import given, settings, st
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import bind as jbind
from repro.models import cache_ops as jops
from repro.models import transformer as jtr
from repro.serving import Engine as JaxEngine
from repro.serving import PagedSlotPool as JaxPagedSlotPool
from repro.serving import PoolExhausted as JaxPoolExhausted
from repro.serving import PrefixCache as JaxPrefixCache
from repro.serving import Request as JaxRequest
from repro.serving import SlotEntry as JaxSlotEntry
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_jax_params
from repro_torch.errors import (CacheLayoutError,
                                PrefixCacheInvariantError)
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.models import cache_ops as tops
from repro_torch.models import transformer as ttr
from repro_torch.serving import (Engine, PagedSlotPool, PoolExhausted,
                                 PrefixCache, Request, SlotEntry)

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SMALL = dict(family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
             dtype="float32", q_block=16, kv_block=16, loss_chunk=16,
             remat=False)

#: the engine's prefix stats, all held equal to the JAX engine's
PREFIX_STATS = ("prefix_hits", "prefix_misses", "prefill_tokens_saved",
                "cow_copies", "prefix_reclaims", "prefix_retained_pages")


def _cfgs(sc: bool):
    """The same reduced dense config (2 layers, d_model 64) on both
    sides."""
    fields = dict(SMALL, name="pg-dense", use_sc_gemm=sc)
    return (JaxModelConfig(**fields).validate(),
            ModelConfig(**fields).validate())


def _setup(sc: bool):
    jcfg, tcfg = _cfgs(sc)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt(s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SMALL["vocab_size"], size=(s,)).astype(np.int32)


def _requests(cls, prompts, gens, tag="r"):
    return [cls(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _assert_drained(pool):
    """No live reference, no negative refcount, every page free or a warm
    (refcount-0) page the tree retains: nothing leaked."""
    assert pool.pages_live == 0
    assert (pool.refcount >= 0).all()
    assert pool.free_pages + len(pool.retained) == pool.n_blocks
    for p in pool.retained:
        assert pool.refcount[p] == 0, "retained page still referenced"


def _assert_refcount_ledger(engine):
    """Refcounts equal block-table references plus the staging prefill's
    pinned pages, and none is negative."""
    pool = engine.pool
    refs = np.zeros(pool.n_blocks, np.int64)
    for row in pool.tables:
        pages = row[row >= 0]
        if pages.size:
            np.add.at(refs, pages, 1)
    staging = engine._staging
    if staging is not None and staging.match is not None:
        np.add.at(refs, np.asarray(staging.match.pages, int), 1)
    assert (pool.refcount == refs).all(), "refcount ledger desync"
    assert (pool.refcount >= 0).all()


# ------------------------------------------------------------ the tree


def _same_plan(j, t):
    assert (t.resume, t.pages, t.block, t.hit, t.shared, t.cow_src) == \
        (j.resume, j.pages, j.block, j.hit, j.shared, j.cow_src)


@pytest.mark.parametrize("seed", [0, 7, -3, 123456789])
@pytest.mark.parametrize("block,align", [(4, 4), (8, 4), (4, 3)])
def test_prefix_cache_equals_jax(seed, block, align):
    """One sequence of inserts, matches and reclaims on both trees: the
    same plans, newly retained pages, surrendered pages and digests."""
    jt = JaxPrefixCache(block=block, seed=seed, align=align)
    tt = PrefixCache(block=block, seed=seed, align=align)
    base = _prompt(4 * block, seed=11)
    div = np.concatenate([base[:2 * block], _prompt(2 * block, seed=12)])
    other = _prompt(3 * block, seed=13)
    next_page = iter(range(100))
    refcount = np.zeros(100, np.int64)
    for prompt in (base, div, other, base[:block + 1], div):
        _same_plan(jt.match(prompt), tt.match(prompt))
        pages = [next(next_page) for _ in range(len(prompt) // block)]
        new = tt.insert(prompt, pages)
        assert new == jt.insert(prompt, pages)
        assert tt.retained_pages() == jt.retained_pages()
        assert len(tt) == len(jt)
        assert all(tt.owns(p) == jt.owns(p) for p in pages)
    for prompt in (base, div, other, base[:2 * block + 1], _prompt(9, 14)):
        _same_plan(jt.match(prompt), tt.match(prompt))
    assert tt._digest(b"", base[:block]) == jt._digest(b"", base[:block])
    refcount[list(tt.retained_pages())[:2]] = 1     # two pinned pages
    for need in (1, 2, 50):
        assert tt.reclaim(need, refcount) == jt.reclaim(need, refcount)
        assert tt.retained_pages() == jt.retained_pages()
    with pytest.raises(PrefixCacheInvariantError, match="pages for"):
        tt.insert(base, [0])


def test_prefix_hash_seed_only_permutes_keys():
    """The seed keys the digests, nothing else: plans are equal across
    seeds, digests are not."""
    prompt = np.arange(12, dtype=np.int32)
    trees = [PrefixCache(block=4, seed=s, align=4) for s in (0, 7, -3)]
    for tree in trees:
        tree.insert(prompt, [0, 1, 2])
    plans = [tree.match(prompt) for tree in trees]
    assert plans[0] == plans[1] == plans[2]
    digests = {tree._digest(b"", prompt[:4]) for tree in trees}
    assert len(digests) == 3


def test_prefix_match_ticks_only_used_pages():
    """match() refreshes only the pages its plan uses: a matched page past
    the rounded-down resume keeps its age and is the LRU victim, as in the
    reference."""
    for cls in (PrefixCache, JaxPrefixCache):
        tree = cls(block=4, align=4)
        a = np.arange(12, dtype=np.int32)
        b = np.arange(100, 108, dtype=np.int32)
        tree.insert(a, [0, 1, 2])
        tree.insert(b, [3, 4])
        m = tree.match(a)           # cap 11 -> resume 8: page 2 unused
        assert m.resume == 8 and m.pages == (0, 1)
        assert tree.reclaim(1, np.zeros(8, np.int64)) == [2]


# ------------------------------------------------------------ cache ops


def _random_pools(n_pages, block, capacity, seed):
    """The same paged pool filled with random K/V on both sides."""
    jcfg, tcfg = _cfgs(False)
    rng = np.random.default_rng(seed)
    jdata = jops.paged_init(lambda b, s: jtr.init_kv_cache(jcfg, b, s),
                            capacity, n_pages, block)
    leaves = [rng.standard_normal(leaf.shape).astype(np.float32)
              for leaf in (*jdata.k, *jdata.v)]
    g = len(jdata.k)
    pos = rng.integers(0, 20, (capacity,)).astype(np.int32)
    jdata = jtr.KVCache(k=tuple(jnp.asarray(x) for x in leaves[:g]),
                        v=tuple(jnp.asarray(x) for x in leaves[g:]),
                        pos=jnp.asarray(pos))
    tdata = ttr.KVCache(k=tuple(torch.as_tensor(x.copy())
                                for x in leaves[:g]),
                        v=tuple(torch.as_tensor(x.copy())
                                for x in leaves[g:]),
                        pos=torch.as_tensor(pos.copy()))
    return jdata, tdata


def _random_single(s1, seed):
    """The same random B=1 cache of ``s1`` positions on both sides."""
    j, t = _random_pools(1, s1, 1, seed)     # (lead, 2, s1, ...): one row
    j = jtr.KVCache(k=tuple(x[:, :1] for x in j.k),
                    v=tuple(x[:, :1] for x in j.v),
                    pos=jnp.asarray([s1], jnp.int32))
    t = ttr.KVCache(k=tuple(x[:, :1].clone() for x in t.k),
                    v=tuple(x[:, :1].clone() for x in t.v),
                    pos=torch.as_tensor([s1], dtype=torch.int32))
    return j, t


def _assert_same(j, t):
    for a, b in zip((*j.k, *j.v), (*t.k, *t.v)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))


@pytest.mark.parametrize("block", [4, 5])
def test_copy_and_zero_pages_equal_jax(block):
    jdata, tdata = _random_pools(8, block, 3, seed=block)
    for src, dst in ((2, 5), (7, 0), (3, 3)):
        jdata = jops.paged_copy_page(jdata, src, dst)
        tdata = tops.paged_copy_page(tdata, src, dst)
        _assert_same(jdata, tdata)
    for pages in ([1, 6], [], [4]):
        jdata = jops.paged_zero_pages(jdata, pages)
        tdata = tops.paged_zero_pages(tdata, pages)
        _assert_same(jdata, tdata)


@pytest.mark.parametrize("extent", [16, 6, 24])
@pytest.mark.parametrize("block", [4, 5])
def test_prefix_seed_equals_jax(block, extent):
    """Rows below the pages' extent (clipped to the staging extent) come
    from the pool, the rest stay, the position is the resume offset."""
    jdata, tdata = _random_pools(8, block, 2, seed=3)
    jone, tone = _random_single(extent, seed=4)
    pages, resume = [6, 1, 3], 2 * block
    jone = jops.prefix_seed(jone, jdata, pages, block=block, resume=resume)
    out = tops.prefix_seed(tone, tdata, pages, block=block, resume=resume)
    assert out is tone
    _assert_same(jone, tone)
    jone = jops.prefix_seed(jone, jdata, [], block=block, resume=0)
    tops.prefix_seed(tone, tdata, [], block=block, resume=0)
    _assert_same(jone, tone)


@pytest.mark.parametrize("start", [0, 3, 4, 9, 12])
def test_paged_insert_overlay_equals_jax(start):
    """``start > 0``: the pages from ``start``'s page on, cells below
    ``start`` keeping the pool's contents (the CoW copy), cells from it
    the prefill's; the last page's tail zero."""
    block, s1 = 4, 14
    jdata, tdata = _random_pools(8, block, 2, seed=5)
    jone, tone = _random_single(s1, seed=6)
    n_pages = -(-s1 // block) - start // block
    pages = [7, 2, 5, 0][:n_pages]
    jdata = jops.paged_insert(jdata, jone, 1, pages, block=block,
                              start=start)
    tdata = tops.paged_insert(tdata, tone, 1, pages, block=block,
                              start=start)
    _assert_same(jdata, tdata)
    if n_pages > 1:
        with pytest.raises(CacheLayoutError):
            tops.paged_insert(tdata, tone, 1, pages[:-1], block=block,
                              start=start)


# ---------------------------------------------------- the pool's ledger


def _pool_state(pool):
    return (pool.refcount.tolist(), sorted(pool.retained),
            pool.tables.tolist(), list(pool._free_pages), list(pool._free),
            pool.n_cow, pool.n_reclaimed, sorted(pool.entries),
            pool.pages_live, pool.available_pages)


def _assert_pools_equal(jpool, tpool):
    assert _pool_state(tpool) == _pool_state(jpool)
    assert tpool.prefix.retained_pages() == jpool.prefix.retained_pages()
    _assert_same(jpool.cache, tpool.cache)


def _both(fn_j, fn_t):
    """Run one pool operation on both sides: the same result, or the same
    typed refusal."""
    try:
        want = fn_j()
    except JaxPoolExhausted:
        with pytest.raises(PoolExhausted):
            fn_t()
        return None
    got = fn_t()
    assert got == want
    return got


def _fuzz_pools(data):
    block = data.draw(st.sampled_from([2, 4]), "block")
    capacity = data.draw(st.integers(2, 3), "capacity")
    max_seq = 16
    n_blocks = data.draw(st.integers(max_seq // block,
                                     capacity * max_seq // block), "n_blocks")
    jcfg, tcfg = _cfgs(False)
    jpool = JaxPagedSlotPool(jbind(jcfg), capacity, max_seq, block=block,
                             n_blocks=n_blocks)
    tpool = PagedSlotPool(bind(tcfg, "cpu"), capacity, max_seq, block=block,
                          n_blocks=n_blocks)
    align = data.draw(st.sampled_from([1, 2, 3]), "align")
    jpool.prefix = JaxPrefixCache(block=block, align=align)
    tpool.prefix = PrefixCache(block=block, align=align)
    return jpool, tpool


def _admit_both(jpool, tpool, prompt, gen, uid, seed):
    """The engine's admission protocol on both pools: match, pin, admit
    with the plan (or privately when it cannot fit), drop the CoW pin,
    register the full pages."""
    jm, tm = jpool.prefix.match(prompt), tpool.prefix.match(prompt)
    _same_plan(jm, tm)
    jone, tone = _random_single(len(prompt), seed=seed)
    jent = JaxSlotEntry(request=JaxRequest(uid=uid, prompt=prompt,
                                           max_new_tokens=gen),
                        admitted_at=0.0, admit_step=0)
    tent = SlotEntry(request=Request(uid=uid, prompt=prompt,
                                     max_new_tokens=gen),
                     admitted_at=0.0, admit_step=0)
    if tm.hit:
        jpool.pin_pages(jm.pages)
        tpool.pin_pages(tm.pages)
    ok = _both(lambda: jpool.can_admit(jent.request, match=jm if jm.hit
                                       else None),
               lambda: tpool.can_admit(tent.request, match=tm if tm.hit
                                       else None))
    if not ok:
        if tm.hit:
            jpool.unpin_pages(jm.pages)
            tpool.unpin_pages(tm.pages)
        return
    if tm.hit:
        slot = _both(lambda: jpool.admit_prefix(jent, jone, jm),
                     lambda: tpool.admit_prefix(tent, tone, tm))
        if tm.cow_src is not None:
            jpool.unpin_pages([jm.cow_src])
            tpool.unpin_pages([tm.cow_src])
    else:
        slot = _both(lambda: jpool.admit(jent, jone),
                     lambda: tpool.admit(tent, tone))
    full = len(prompt) // tpool.block
    new = _both(lambda: jpool.prefix.insert(
                    prompt, jpool.tables[slot, :full].tolist()),
                lambda: tpool.prefix.insert(
                    prompt, tpool.tables[slot, :full].tolist()))
    jpool.retain_pages(new)
    tpool.retain_pages(new)


@settings(max_examples=8, deadline=None)
@given(st.data())
def test_pool_ledger_equals_jax_under_random_operations(data):
    jpool, tpool = _fuzz_pools(data)
    base = _prompt(12, seed=data.draw(st.integers(0, 3), "base"))
    variants = [base, base[:8].copy(), base[:6].copy(),
                np.concatenate([base[:8], _prompt(4, seed=99)])]
    pinned = []
    for i in range(data.draw(st.integers(8, 16), "n_ops")):
        op = data.draw(st.sampled_from(["admit", "admit", "grow", "evict",
                                        "pin", "unpin", "reclaim"]),
                       f"op{i}")
        live = sorted(tpool.entries)
        if op == "admit" and tpool.has_free:
            prompt = variants[data.draw(st.integers(0, 3), f"v{i}")]
            gen = data.draw(st.integers(1, 4), f"gen{i}")
            _admit_both(jpool, tpool, prompt, gen, f"u{i}", seed=i)
        elif op == "grow" and live:
            slot = live[data.draw(st.integers(0, len(live) - 1), f"s{i}")]
            req = tpool.entries[slot].request
            pos = data.draw(st.integers(req.prompt_len,
                                        req.prompt_len
                                        + req.max_new_tokens - 1), f"p{i}")
            _both(lambda: jpool.ensure_page(slot, pos),
                  lambda: tpool.ensure_page(slot, pos))
        elif op == "evict" and live:
            slot = live[data.draw(st.integers(0, len(live) - 1), f"s{i}")]
            jpool.evict(slot)
            tpool.evict(slot)
        elif op == "pin":
            prompt = variants[data.draw(st.integers(0, 3), f"v{i}")]
            plan = tpool.prefix.match(prompt)     # both: a match ticks
            _same_plan(jpool.prefix.match(prompt), plan)
            if plan.hit:
                jpool.pin_pages(plan.pages)
                tpool.pin_pages(plan.pages)
                pinned.append(plan.pages)
        elif op == "unpin" and pinned:
            pages = pinned.pop(data.draw(st.integers(0, len(pinned) - 1),
                                         f"u{i}"))
            jpool.unpin_pages(pages)
            tpool.unpin_pages(pages)
        elif op == "reclaim":
            # a draw past the free list reclaims warm pages (zeroed); the
            # pages go straight back, zeroed and freed
            n = data.draw(st.integers(1, tpool.n_blocks), f"n{i}")
            pages = _both(lambda: jpool._take_pages(n),
                          lambda: tpool._take_pages(n))
            if pages:
                jpool.unpin_pages(pages)
                tpool.unpin_pages(pages)
        _assert_pools_equal(jpool, tpool)
    for pages in pinned:
        jpool.unpin_pages(pages)
        tpool.unpin_pages(pages)
    for slot in sorted(tpool.entries):
        jpool.evict(slot)
        tpool.evict(slot)
    _assert_pools_equal(jpool, tpool)
    _assert_drained(tpool)


def test_pool_without_a_tree_keeps_one_reference_a_page():
    """Without a prefix cache attached the ledger is the old bookkeeping:
    each owned page refcount 1, eviction zeroes and frees them all."""
    _, tcfg = _cfgs(False)
    pool = PagedSlotPool(bind(tcfg, "cpu"), 2, 16, block=4, n_blocks=6)
    _, one = _random_single(6, seed=1)
    entry = SlotEntry(request=Request(uid="a", prompt=np.ones(6, np.int32),
                                      max_new_tokens=4),
                      admitted_at=0.0, admit_step=0)
    slot = pool.admit(entry, one)
    pool.ensure_page(slot, 8)
    assert pool.refcount.tolist() == [1, 1, 1, 0, 0, 0]
    assert pool.writable(0) and pool.pages_live == 3
    pool.evict(slot)
    assert pool.free_pages == 6 and not pool.refcount.any()
    assert not pool.cache.k[0].any()


# ----------------------------------------------------------- the engine


def _serve(sc, prompts, gens, *, reruns=0, **kw):
    """Serve ``prompts`` through the port's engine with the prefix cache
    on, ``reruns`` more times on the same engine; streams are held to the
    port's ``generate`` and, with exact projections, to the JAX engine's
    (the same runs on one engine, stats equal run by run), under SC-GEMM
    to the port's cache-off engine. Returns the engine and each run's
    stats."""
    jcfg, jp, tcfg, tp = _setup(sc)
    base = [generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")[0]
            .numpy() for p, g in zip(prompts, gens)]
    engine = Engine(tcfg, tp, device="cpu", **kw)
    if sc:
        other = Engine(tcfg, tp, device="cpu", prefix_cache=False, **kw)
        want = [r.tokens for r in other.run(_requests(Request, prompts,
                                                      gens))]
    else:
        jengine = JaxEngine(jcfg, jp, **kw)
    stats = []
    for run in range(reruns + 1):
        res = engine.run(_requests(Request, prompts, gens, f"run{run}-"))
        if not sc:
            jres = jengine.run(_requests(JaxRequest, prompts, gens,
                                         f"run{run}-"))
            want = [r.tokens for r in jres]
            assert {k: engine.stats[k] for k in PREFIX_STATS} == \
                {k: jengine.stats[k] for k in PREFIX_STATS}
        for r, w, b in zip(res, want, base):
            np.testing.assert_array_equal(r.tokens, w, err_msg=r.uid)
            np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)
        _assert_drained(engine.pool)
        stats.append(dict(engine.stats))
    return engine, stats


def test_prefix_cache_gating():
    """The cache engages only where sharing is exact: paged + chunked +
    dense, as the JAX engine gates it; an ssm engine builds without it."""
    jcfg, jp, tcfg, tp = _setup(False)
    for kw in (dict(), dict(prefix_cache=False), dict(prefill_mode="oneshot"),
               dict(paged=False)):
        eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=16,
                     block=4, chunk=4, **kw)
        jeng = JaxEngine(jcfg, jp, capacity=2, max_seq=16, block=4, chunk=4,
                         **kw)
        assert (eng.prefix is None) == (jeng.prefix is None), kw
        assert eng.prefix is None or eng.pool.prefix is eng.prefix
        eng.run(_requests(Request, [_prompt(6, 1)], [2]))
        assert eng.stats["prefix_cache"] == (eng.prefix is not None)
    ssm = ModelConfig(**dict(SMALL, name="pg-ssm", family="ssm",
                             n_kv_heads=1, d_ff=0, ssm_state=16,
                             ssm_headdim=16, ssm_chunk=4)).validate()
    ssm_params = bind(ssm, "cpu").init_params(0)
    eng = Engine(ssm, ssm_params, device="cpu", capacity=2, max_seq=16,
                 block=4, chunk=4)
    assert eng.prefix is None and eng.pool.prefix is None


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefix_cache_shared_prompts_bit_identical(sc):
    """Shared prompts: streams equal while prefill work is skipped, the
    drained pool keeps the prefix warm, and a second run over the warm
    tree hits on every request."""
    base = _prompt(16, seed=21)
    prompts = [base, base.copy(),
               np.concatenate([base[:8], _prompt(8, seed=22)])]
    engine, (first, second) = _serve(sc, prompts, [4, 3, 4], reruns=1,
                                     capacity=2, max_seq=32, block=4,
                                     chunk=4)
    assert first["prefix_cache"] and first["prefix_hits"] >= 1
    assert first["prefill_tokens_saved"] > 0
    assert first["prefix_hit_rate"] > 0
    assert engine.pool.pages_in_use > 0 and len(engine.pool.retained) > 0
    assert second["prefix_hits"] == len(prompts)
    assert second["prefix_misses"] == 0
    assert second["prefill_tokens_saved"] >= first["prefill_tokens_saved"]
    assert second["prefill_chunks"] < first["prefill_chunks"]


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefix_cow_preserves_bit_identity(sc):
    """block > chunk puts the chunk-aligned resume inside a page, so
    admission copies that page; the suffix prefill overwrites only the
    rows from the resume point."""
    prompt = _prompt(16, seed=31)
    _, (stats,) = _serve(sc, [prompt, prompt.copy()], [3, 5], capacity=2,
                         max_seq=32, block=8, chunk=4)
    assert stats["cow_copies"] >= 1 and stats["prefix_hits"] >= 1


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefix_cow_admits_on_minimal_budget(sc):
    """n_blocks == pages_for(prompt + 1): the pinned CoW source frees at
    admission, so can_admit credits it instead of holding the hit until
    the empty-pool check refuses it."""
    prompt = _prompt(16, seed=51)
    _, (stats,) = _serve(sc, [prompt, prompt.copy()], [2, 2], capacity=2,
                         max_seq=24, block=8, chunk=4, n_blocks=3)
    assert stats["prefix_hits"] == 1 and stats["cow_copies"] == 1


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefix_hit_falls_back_to_private_admission(sc):
    """When even the credited plan cannot fit (the resume inside the only
    matched page, no shared page), the engine drops the plan at the
    empty-pool check and admits the completed staging cache privately;
    the seeded span still counts as saved."""
    prompt = _prompt(15, seed=52)
    _, (stats,) = _serve(sc, [prompt, prompt.copy()], [1, 1], capacity=2,
                         max_seq=16, block=8, chunk=3, n_blocks=2)
    assert stats["prefix_hits"] == 1 and stats["cow_copies"] == 0
    assert stats["prefill_tokens_saved"] == 6


def test_prefill_tokens_saved_counts_at_admission():
    """Tokens saved accrue when a hit admits, not when it stages: a
    preempted staging prefill re-stages and matches again."""
    _, _, tcfg, tp = _setup(True)
    prompt = _prompt(16, seed=53)
    engine = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=32, block=4,
                    chunk=4)
    engine.run([Request(uid="warm", prompt=prompt, max_new_tokens=2)])
    saved0 = engine._prefill_tokens_saved
    engine.submit(Request(uid="x", prompt=prompt.copy(), max_new_tokens=2))
    engine._staging = engine._start_prefill(engine.queue.pop())
    assert engine._staging.match is not None       # warm tree: a hit
    assert engine._staging.entry.prefill_offset == 12
    assert engine._prefill_tokens_saved == saved0
    _assert_refcount_ledger(engine)
    engine._preempt_youngest()                     # drop staging, requeue
    assert engine._prefill_tokens_saved == saved0
    assert engine.pool.pages_live == 0
    results = engine.run([])                       # re-stage and admit
    assert [r.uid for r in results] == ["x"]
    assert engine._prefill_tokens_saved == saved0 + 12
    base = generate(tcfg, tp, prompt[None], gen_tokens=2, device="cpu")
    np.testing.assert_array_equal(results[0].tokens, base[0].numpy())
    _assert_drained(engine.pool)


def test_lone_slot_reclaims_warm_page_its_own_pages_pin():
    """Three equal 12-token prompts, capacity 1, a 7-page budget: the third
    request attaches the first 8 tokens, recomputes blocks 4 and 5
    privately, and registers its block-5 page below the resident block-4
    page, which its own table then pins. Its decode page can only come
    from that page and its subtree; the port frees it where the JAX engine
    raises, and its stream equals the cache-off run and ``generate``."""
    jcfg, jp, tcfg, tp = _setup(False)
    prompt = np.random.default_rng(0).integers(
        0, SMALL["vocab_size"], size=(12,)).astype(np.int32)
    prompts, gens = [prompt.copy() for _ in range(3)], [1, 1, 2]
    kw = dict(capacity=1, max_seq=32, block=2, n_blocks=7, chunk=4)
    jengine = JaxEngine(jcfg, jp, **kw)
    with pytest.raises(JaxPoolExhausted):
        jengine.run(_requests(JaxRequest, prompts, gens))
    engine = Engine(tcfg, tp, device="cpu", **kw)
    for r in _requests(Request, prompts, gens):
        engine.submit(r)
    while engine.step():
        _assert_refcount_ledger(engine)
    got = {r.uid: r.tokens for r in engine.run([])}
    assert engine.pool.n_reclaimed_pinned == 1
    assert engine.pool.retained == engine.pool.prefix.retained_pages()
    cold = Engine(tcfg, tp, device="cpu", prefix_cache=False,
                  **kw).run(_requests(Request, prompts, gens))
    base = generate(tcfg, tp, prompt[None], gen_tokens=2, device="cpu")
    for w in cold:
        np.testing.assert_array_equal(got[w.uid], w.tokens)
        np.testing.assert_array_equal(
            got[w.uid], base[0].numpy()[:len(w.tokens)])
    _assert_drained(engine.pool)


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefix_hash_seed_stream_invariance(sc):
    """Streams and hit counts do not depend on the hash seed
    (``--prefix-block-hash``)."""
    base = _prompt(16, seed=41)
    outs, hits = [], []
    for seed in (0, 123456789):
        _, (stats,) = _serve(sc, [base, base.copy()], [4, 4], capacity=2,
                             max_seq=32, block=4, chunk=4,
                             prefix_hash_seed=seed)
        hits.append(stats["prefix_hits"])
    assert hits[0] == hits[1] >= 1


def _shared_prefix_case(data):
    """Many requests over one long common prompt (verbatim, a
    block-aligned ancestor, or a shared head with a divergent tail),
    sometimes under a page budget tight enough to force preemption and
    LRU reclaim of warm pages."""
    block = data.draw(st.sampled_from([2, 4]), "block")
    capacity = data.draw(st.integers(1, 2), "capacity")
    n_req = data.draw(st.integers(3, 4), "n_req")
    max_seq = 32
    rng = np.random.default_rng(data.draw(st.integers(0, 3), "base_seed"))
    base = rng.integers(0, SMALL["vocab_size"], size=(12,)).astype(np.int32)
    prompts, gens = [], []
    for i in range(n_req):
        shape = data.draw(st.sampled_from(["full", "full", "short", "div"]),
                          f"shape{i}")
        if shape == "full":
            prompt = base.copy()
        elif shape == "short":
            prompt = base[:8].copy()
        else:
            tail = rng.integers(0, SMALL["vocab_size"], size=(4,))
            prompt = np.concatenate([base[:8], tail]).astype(np.int32)
        prompts.append(prompt)
        gens.append(data.draw(st.integers(1, 4), f"gen{i}"))
    full = capacity * (max_seq // block)
    tight = max(-(-max(len(p) + g for p, g in zip(prompts, gens)) // block),
                2)
    n_blocks = tight if data.draw(st.sampled_from([0, 1]), "tight") else full
    sc = data.draw(st.sampled_from([False, True]), "sc")
    return sc, prompts, gens, dict(capacity=capacity, max_seq=max_seq,
                                   block=block, n_blocks=n_blocks, chunk=4)


def _assert_shared_prefix_schedule(data):
    sc, prompts, gens, kw = _shared_prefix_case(data)
    jcfg, jp, tcfg, tp = _setup(sc)
    engine = Engine(tcfg, tp, device="cpu", **kw)
    for r in _requests(Request, prompts, gens):
        engine.submit(r)
    while engine.step():
        _assert_refcount_ledger(engine)      # no page freed at refcount > 0
    by_uid = {r.uid: r for r in engine.run([])}
    want = None
    if not sc:
        jengine = JaxEngine(jcfg, jp, **kw)
        for r in _requests(JaxRequest, prompts, gens):
            jengine.submit(r)
        try:
            want = sorted(jengine.run([]), key=lambda r: r.uid)
        except JaxPoolExhausted:
            # the reference's lone slot cannot grow past a warm page its
            # own pages pin; the port frees that page (ROADMAP.md Queue 3)
            assert engine.pool.n_reclaimed_pinned > 0
    if want is None:
        want = Engine(tcfg, tp, device="cpu", prefix_cache=False,
                      **kw).run(_requests(Request, prompts, gens))
    else:
        def totals(e):
            return (e._n_prefix_hits, e._n_prefix_misses,
                    e._prefill_tokens_saved, e.pool.n_cow,
                    e.pool.n_reclaimed, sorted(e.pool.retained))
        assert totals(engine) == totals(jengine)
        assert engine.pool.n_reclaimed_pinned == 0
    for w in want:
        p = prompts[int(w.uid[1:])]
        g = gens[int(w.uid[1:])]
        base = generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")
        msg = f"sc={sc} {kw} plens={[len(p) for p in prompts]} gens={gens}"
        np.testing.assert_array_equal(by_uid[w.uid].tokens, w.tokens,
                                      err_msg=msg)
        np.testing.assert_array_equal(by_uid[w.uid].tokens, base[0].numpy(),
                                      err_msg=msg)
    _assert_drained(engine.pool)             # no leak at drain


@settings(max_examples=3, deadline=None)
@given(st.data())
def test_shared_prefix_streams_bit_identical_fuzz(data):
    """Shared-prefix schedules stay equal to the baseline (and, exact, to
    the JAX engine with its prefix stats), with the refcount ledger
    checked at every engine step."""
    _assert_shared_prefix_schedule(data)


@pytest.mark.slow
@settings(max_examples=20, deadline=None)
@given(st.data())
def test_shared_prefix_streams_bit_identical_fuzz_deep(data):
    """The deep sweep (``pytest -m slow``): more schedules, tight budgets
    forcing preemption churn and LRU reclaim of the warm prefix set."""
    _assert_shared_prefix_schedule(data)
