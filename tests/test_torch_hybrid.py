"""The hybrid family of the PyTorch port (``models/zamba2.py``: Mamba-2
layers with one shared attention + MLP block every ``shared_attn_every``
layers), held against the JAX package on the CPU at the reference's
serving size (4 layers, 2 sites, d_model 64, ``ssm_chunk`` 4, float32),
the JAX parameters carried across.

* prefill, chunked prefill, dense and paged decode: logits within 1e-4 of
  JAX's with exact projections, the caches (Mamba states, each site's
  K/V) too; with SC-GEMM at 8 bits the shared block's and the head's
  counts equal JAX's on the same rows, and the logits within 0.5 with
  equal greedy tokens (``ROADMAP.md`` Queue 3);
* ``from_jax_params`` round-trips the stacked Mamba layers, the shared
  block and the head, the Mamba float32 leaves kept in float32, and
  ``pack_sc_weights`` packs the shared block once for all its sites;
* the slot and paged cache ops (K/V sequence leaves paged, Mamba slot
  leaves by slot) and the pool ledger equal the JAX ones after every
  operation;
* engine streams equal the JAX engine's and the port's sequential
  ``generate`` baseline, paged and contiguous, chunked and one-shot, and
  under a page budget tight enough to preempt.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.sc_layers import sc_proj as jsc_proj
from repro.core.sc_numerics import recover_counts as jrecover
from repro.models import bind as jbind
from repro.models import cache_ops as jops
from repro.serving import Engine as JaxEngine
from repro.serving import PagedSlotPool as JaxPagedSlotPool
from repro.serving import Request as JaxRequest
from repro.serving import SlotEntry as JaxSlotEntry
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.sc_layers import sc_proj
from repro_torch.core.sc_numerics import recover_counts
from repro_torch.launch.serve import generate
from repro_torch.models import bind, pack_sc_weights
from repro_torch.models import cache_ops as tops
from repro_torch.models import zamba2 as tz
from repro_torch.models.mamba2 import F32_LEAVES
from repro_torch.serving import Engine, PagedSlotPool, Request, SlotEntry

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SMALL = dict(name="srv-hybrid", family="hybrid", n_layers=4, d_model=64,
             n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
             dtype="float32", q_block=16, kv_block=16, loss_chunk=16,
             remat=False, ssm_state=16, ssm_headdim=16, ssm_chunk=4,
             shared_attn_every=2)
EXACT_MODEL = dict(rtol=1e-4, atol=1e-4)
SC_GEMM_8 = dict(rtol=0, atol=0.5)


def _cfgs(sc: bool = False, **kw):
    fields = dict(SMALL, use_sc_gemm=sc, **kw)
    return (JaxModelConfig(**fields).validate(),
            ModelConfig(**fields).validate())


def _setup(sc: bool = False, **kw):
    jcfg, tcfg = _cfgs(sc, **kw)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _leaves(node):
    if isinstance(node, torch.Tensor):
        return [node]
    return [t for child in node for t in _leaves(child)]


def _assert_caches_equal(jcache, tcache, **tol):
    jl, tl = jax.tree.leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        if tol:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------ the model


def test_sites_and_packed_weights():
    _, tcfg = _cfgs(True)
    tp = bind(tcfg, "cpu").init_params(0)
    assert tz.n_attn_sites(tcfg) == 2
    packed = pack_sc_weights(tp, tcfg)
    shared = packed["shared"]
    assert set(shared["attn"]["packed"]) == {"wq", "wk", "wv", "wo"}
    assert set(shared["mlp"]["packed"]) == {"w1", "w3", "w2"}
    assert set(packed["packed"]) == {"head"}
    for layer in packed["layers"]:
        assert set(layer["mixer"]["packed"]) == {"in_proj", "out_proj"}
    # one set of shared planes, whatever the number of sites
    n_packs = sum(1 for t in _packs(packed))
    assert n_packs == 2 * tcfg.n_layers + 7 + 1


def _packs(tree):
    from repro_torch.kernels.sc_matmul import PackedWeight
    if isinstance(tree, PackedWeight):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _packs(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _packs(v)


def test_from_jax_params_round_trip():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.n_layers
    for i, layer in enumerate(tp["layers"]):
        for name, t in layer["mixer"].items():
            assert t.dtype == (torch.float32 if name in F32_LEAVES
                               else torch.bfloat16), name
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(jp["layers"]["mixer"][name][i], np.float32))
    for key in ("shared", "lm_head", "embed", "final_norm"):
        _same_tree(tp[key], jp[key])


def _same_tree(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for key in j:
            _same_tree(t[key], j[key])
    else:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefill_chunk_and_decode_logits_equal_jax(sc):
    """One-shot prefill of 8 tokens (4 zero slots after), the same prompt
    chunked into an 8-position staging cache (4 + a padded 4 holding 3),
    then three dense decode steps and three paged ones from the one-shot
    cache (the paged logits equal the dense ones bit for bit; with exact
    projections they and the pages are held to JAX's paged step too)."""
    jcfg, jp, tcfg, tp = _setup(sc)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    tpp = pack_sc_weights(tp, tcfg)
    tol = SC_GEMM_8 if sc else EXACT_MODEL
    rng = np.random.default_rng(21)
    toks = rng.integers(0, 128, (1, 8)).astype(np.int32)
    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                                 extra_slots=4)
        tl, tc = tm.prefill_step(tpp, {"tokens": torch.as_tensor(toks)},
                                 extra_slots=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        assert tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)
        if not sc:
            _assert_caches_equal(jc, tc, **EXACT_MODEL)
        jst, tst = jm.init_cache(1, 8), tm.init_cache(1, 8)
        for start, nv in ((0, 4), (4, 3)):
            chunk = np.zeros((1, 4), np.int32)
            chunk[0, :nv] = toks[0, start:start + nv]
            jcl, jst = jm.prefill_chunk_step(
                jp, jst, {"tokens": jnp.asarray(chunk),
                          "n_valid": jnp.asarray([nv], jnp.int32)})
            tcl, tst = tm.prefill_chunk_step(
                tpp, tst, {"tokens": torch.as_tensor(chunk),
                           "n_valid": torch.tensor([nv], dtype=torch.int32)})
            np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), **tol)
        assert int(tst.pos[0]) == int(jst.pos[0]) == 7
        if not sc:
            _assert_caches_equal(jst, tst, **EXACT_MODEL)
        # paged: the one-shot cache in pages of 4 (2 per slot) and a slot
        jdata = jops.paged_init(jm.init_cache, 1, 3, 4)
        jdata = jops.paged_insert(jdata, jc, 0, [2, 0, 1], block=4)
        tdata = tops.paged_init(tm.init_cache, 1, 3, 4)
        tops.paged_insert(tdata, tc, 0, [2, 0, 1], block=4)
        tables = np.array([[2, 0, 1]], np.int32)
        for _ in range(3):
            nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
            batch = {"tokens": nxt}
            jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)})
            tl, tc = tm.decode_step(tpp, tc, {"tokens": torch.as_tensor(nxt)})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
            assert tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)
            tpl, tdata = tm.paged_decode_step(
                tpp, tdata, torch.as_tensor(tables),
                {"tokens": torch.as_tensor(batch["tokens"])})
            # the paged step is the dense step's numerics on pages
            assert torch.equal(tpl, tl)
            if not sc:
                jpl, jdata = jm.paged_decode_step(
                    jp, jdata, jnp.asarray(tables),
                    {"tokens": jnp.asarray(batch["tokens"])})
                np.testing.assert_allclose(tpl.numpy(), np.asarray(jpl),
                                           **tol)
        if not sc:
            _assert_caches_equal(jc, tc, **EXACT_MODEL)
            _assert_caches_equal(jdata, tdata, **EXACT_MODEL)


@pytest.mark.parametrize("where", ["attn", "mlp", "head"])
def test_sc_projection_counts_equal_jax(where):
    """The shared block's and the head's SC-GEMM counts on the same rows
    equal JAX's, through the weights packed once and per call."""
    jcfg, jp, tcfg, tp = _setup(True)
    packed = pack_sc_weights(tp, tcfg)
    d = tcfg.d_model
    if where == "head":
        cases = [(jp["lm_head"], tp["lm_head"], packed["packed"]["head"])]
    elif where == "attn":
        a = packed["shared"]["attn"]
        cases = [(jp["shared"]["attn"][n].reshape(d, -1),
                  a[n].reshape(d, -1), a["packed"][n])
                 for n in ("wq", "wk", "wv")]
    else:
        m = packed["shared"]["mlp"]
        cases = [(jp["shared"]["mlp"][n], m[n], m["packed"][n])
                 for n in ("w1", "w3", "w2")]
    rng = np.random.default_rng(len(where))
    for jw, tw, pw in cases:
        x = rng.standard_normal((5, tw.shape[0])).astype(np.float32)
        w = np.asarray(jw)
        want = jrecover(jsc_proj(jnp.asarray(x), jw, jcfg), x, w,
                        row_quant=True)
        for p in (pw, None):
            got = sc_proj(torch.as_tensor(x), tw, tcfg, p)
            np.testing.assert_array_equal(
                recover_counts(got, x, w, row_quant=True), want)


# ---------------------------------------------------- cache ops, the pool


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _random_single(jm, tm, extent, seed):
    """A B=1 cache of random leaves, the same numbers on both sides."""
    rng = np.random.default_rng(seed)
    jc = jm.init_cache(1, extent)
    leaves = [_f32(rng, *x.shape) if x.dtype != jnp.int32
              else np.asarray([extent], np.int32)
              for x in jax.tree.leaves(jc)]
    j = jax.tree.unflatten(jax.tree.structure(jc),
                           [jnp.asarray(v) for v in leaves])
    it = iter(leaves)
    t = tops._map(tm.init_cache(1, extent),
                  slot=lambda _: torch.as_tensor(next(it)),
                  seq=lambda _: torch.as_tensor(next(it)))
    return j, t._replace(pos=torch.as_tensor(leaves[-1]))


def test_paged_init_builds_the_mamba_leaves_by_slot_only():
    """The paged pool is the slot layout with K/V made page pools: the
    family's ``init_cache`` is asked for ``capacity`` sequences once,
    never one a page, so no Mamba state is made per page; the pool
    equals the JAX package's."""
    jcfg, tcfg = _cfgs()
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    asked = []

    def init_cache(batch, max_seq):
        asked.append((batch, max_seq))
        return tm.init_cache(batch, max_seq)

    tdata = tops.paged_init(init_cache, 3, 6, 4)
    assert asked == [(3, 4)]
    _assert_caches_equal(jops.paged_init(jm.init_cache, 3, 6, 4), tdata)
    assert tdata.k.shape[1:3] == (7, 4) and tdata.mamba.state.shape[1] == 3
    assert tdata.k.dtype == tm.init_cache(1, 4).k.dtype


def test_slot_and_paged_ops_equal_jax():
    jcfg, tcfg = _cfgs()
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    jpool, tpool = jm.init_cache(3, 12), tm.init_cache(3, 12)
    js, ts = _random_single(jm, tm, 7, seed=1)
    jpool = jops.slot_insert(jpool, js, 1)
    tops.slot_insert(tpool, ts, 1)
    _assert_caches_equal(jpool, tpool)
    _assert_caches_equal(jops.slot_read(jpool, 1), tops.slot_read(tpool, 1))
    jpool = jops.slot_evict(jpool, 1)
    tops.slot_evict(tpool, 1)
    _assert_caches_equal(jpool, tpool)
    _assert_caches_equal(jops.truncate_seq(js, 5), tops.truncate_seq(ts, 5))
    # paged: K/V in pages of 4 (and the trash page), Mamba leaves by slot
    jdata = jops.paged_init(jm.init_cache, 3, 6, 4)
    tdata = tops.paged_init(tm.init_cache, 3, 6, 4)
    _assert_caches_equal(jdata, tdata)
    assert tdata.k.shape[1:3] == (7, 4) and tdata.mamba.state.shape[1] == 3
    tables = np.array([[4, 1, -1], [-1, -1, -1], [0, 3, -1]], np.int32)
    for slot, pages, seed in ((0, [4, 1], 2), (2, [0, 3], 3)):
        js, ts = _random_single(jm, tm, 7, seed=seed)
        jdata = jops.paged_insert(jdata, js, slot, pages, block=4)
        tops.paged_insert(tdata, ts, slot, pages, block=4)
        _assert_caches_equal(jdata, tdata)
    jdense = jops.paged_gather(jdata, jnp.asarray(tables), block=4)
    tdense = tops.paged_gather(tdata, torch.as_tensor(tables), block=4)
    _assert_caches_equal(jdense, tdense)
    # a decode step's writes: a new K/V column at each slot's position and
    # new Mamba states, folded back into the pages
    rng = np.random.default_rng(4)
    jk = jdense.k.at[:, :, 7].set(_f32(rng, 2, 3, 4, 16))
    tk = tdense.k.clone()
    tk[:, :, 7] = torch.as_tensor(np.asarray(jk[:, :, 7]))
    state = _f32(rng, *tdense.mamba.state.shape)
    jdense = jdense._replace(k=jk, pos=jdense.pos + 1, mamba=jdense.mamba
                             ._replace(state=jnp.asarray(state)))
    tdense = tdense._replace(k=tk, pos=tdense.pos + 1, mamba=tdense.mamba
                             ._replace(state=torch.as_tensor(state)))
    jdata = jops.paged_commit(jdata, jdense, jnp.asarray(tables), block=4)
    tdata = tops.paged_commit(tdata, tdense, torch.as_tensor(tables),
                              block=4)
    _assert_caches_equal(jdata, tdata)
    _assert_caches_equal(jops.paged_read(jdata, jnp.asarray(tables), 2,
                                         block=4),
                         tops.paged_read(tdata, torch.as_tensor(tables), 2,
                                         block=4))
    jdata = jops.paged_evict(jdata, 2, [0, 3])
    tops.paged_evict(tdata, 2, [0, 3])
    _assert_caches_equal(jdata, tdata)
    assert not tdata.mamba.state[:, 2].any() and not tdata.k[:, [0, 3]].any()


def _pool_state(pool):
    return (pool.tables.tolist(), list(pool._free_pages), list(pool._free),
            sorted(pool.entries), pool.pages_live, pool.available_pages)


def test_pool_ledger_equals_jax():
    """Admissions, page growth and evictions on the port's and the JAX
    ``PagedSlotPool``: tables, free lists and the cache's contents equal
    after each (pages and Mamba slot leaves written on admission, zeroed
    on eviction)."""
    jcfg, tcfg = _cfgs()
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    jpool = JaxPagedSlotPool(jm, 3, 16, block=4, n_blocks=8)
    tpool = PagedSlotPool(tm, 3, 16, block=4, n_blocks=8)
    rng = np.random.default_rng(5)
    for i in range(14):
        live = sorted(tpool.entries)
        op = ["admit", "grow", "evict"][i % 3] if live else "admit"
        if op == "admit" and tpool.has_free:
            n = int(rng.integers(2, 9))
            prompt = rng.integers(0, 128, n).astype(np.int32)
            js, ts = _random_single(jm, tm, n, seed=i)
            reqs = [cls(uid=f"u{i}", prompt=prompt, max_new_tokens=4)
                    for cls in (JaxRequest, Request)]
            if not tpool.can_admit(reqs[1]):
                assert not jpool.can_admit(reqs[0])
                continue
            a = jpool.admit(JaxSlotEntry(request=reqs[0], admitted_at=0.0,
                                         admit_step=0), js)
            b = tpool.admit(SlotEntry(request=reqs[1], admitted_at=0.0,
                                      admit_step=0), ts)
            assert a == b
        elif op == "grow" and live:
            slot = live[int(rng.integers(len(live)))]
            pos = tpool.entries[slot].request.prompt_len + 3
            jpool.ensure_page(slot, pos)
            tpool.ensure_page(slot, pos)
        elif op == "evict" and live:
            slot = live[int(rng.integers(len(live)))]
            jpool.evict(slot)
            tpool.evict(slot)
        assert _pool_state(tpool) == _pool_state(jpool)
        _assert_caches_equal(jpool.cache, tpool.cache)


# ------------------------------------------------------------ the engine

GENS = [3, 7, 2, 5]


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(n,)).astype(np.int32) for n in lens]


def _requests(cls, prompts, gens):
    return [cls(uid=f"r{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def _baseline(tcfg, tp, prompts, gens):
    return [generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")[0]
            .numpy() for p, g in zip(prompts, gens)]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_streams_equal_jax_engine_and_baseline(paged, mode):
    """SC-GEMM on, ``ssm_chunk``-aligned prompts, a chunk of 3 that both
    engines round up to 4."""
    jcfg, jp, tcfg, tp = _setup(True)
    prompts = _prompts([8, 12, 4, 8], seed=1)
    kw = dict(capacity=2, max_seq=24, block=4, chunk=3, paged=paged,
              prefill_mode=mode)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts,
                                                   GENS))
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts, GENS))
    base = _baseline(tcfg, tp, prompts, GENS)
    for r, j, b in zip(res, jres, base):
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)
    assert eng.stats["decode_steps"] < sum(g - 1 for g in GENS)
    assert eng.prefix is None and eng.chunk == 4


def test_tight_page_budget_preempts_and_replays_identically():
    """Pages for 1.5 sequences: decode-time growth preempts the youngest,
    which replays from scratch (its Mamba slot zeroed) to the same
    stream."""
    _, _, tcfg, tp = _setup(True)
    prompts = _prompts([4, 8, 4], seed=3)
    gens = [8, 7, 8]
    base = _baseline(tcfg, tp, prompts, gens)
    eng = Engine(tcfg, tp, device="cpu", capacity=2, max_seq=16, block=4,
                 n_blocks=5, chunk=4)
    res = eng.run(_requests(Request, prompts, gens))
    assert eng.stats["preemptions"] >= 1
    for r, b in zip(res, base):
        np.testing.assert_array_equal(r.tokens, b, err_msg=r.uid)
    assert eng.stats["pages_live"] == 0
