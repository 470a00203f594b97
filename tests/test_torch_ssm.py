"""The ssm family of the PyTorch port (``models/mamba2.py``,
``models/ssm_lm.py``), held against the JAX package on the CPU at the
reference's serving size (2 layers, d_model 64, ``ssm_chunk`` 4,
float32), the JAX parameters carried across.

* ``ssd_scan`` equals JAX's and the naive one-token recurrence within
  1e-5 (float32 sums in another order);
* the causal conv, the one-shot mixer with its cache, ``mamba_chunk_step``
  (a padded chunk continuing a cache) and ``mamba_decode_step`` equal
  JAX's within 1e-5;
* ssm_lm prefill, chunked prefill and decode logits: with exact
  projections within 1e-4 of JAX's; with SC-GEMM at 8 bits the counts of
  every projection equal JAX's on the same rows, and the logits within
  0.5 with equal greedy tokens (an ulp on a rounding boundary moves one
  magnitude step, ``ROADMAP.md`` Queue 3);
* ``from_jax_params`` keeps the Mamba float32 leaves in float32;
* the slot and paged cache ops and a pool ledger equal the JAX ones after
  every operation;
* engine streams equal the JAX engine's and the port's sequential
  ``generate`` baseline, paged and contiguous, chunked and one-shot
  (``tests/test_serving.py``, ``tests/test_paging.py``), and the engine
  rounds its chunk up to a multiple of ``ssm_chunk`` as the reference's
  does.
"""
import dataclasses

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
from repro.models import mamba2 as jmamba
from repro.serving import Engine as JaxEngine
from repro.serving import PagedSlotPool as JaxPagedSlotPool
from repro.serving import Request as JaxRequest
from repro.serving import SlotEntry as JaxSlotEntry
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_jax_params
from repro_torch.core.sc_layers import sc_proj
from repro_torch.core.sc_numerics import recover_counts
from repro_torch.errors import ConfigError
from repro_torch.launch.serve import generate
from repro_torch.models import bind, pack_sc_weights
from repro_torch.models import cache_ops as tops
from repro_torch.models import mamba2 as tmamba
from repro_torch.serving import Engine, PagedSlotPool, Request, SlotEntry

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SMALL = dict(name="srv-ssm", family="ssm", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=1, head_dim=16, d_ff=0, vocab_size=128,
             dtype="float32", q_block=16, kv_block=16, loss_chunk=16,
             remat=False, ssm_state=16, ssm_headdim=16, ssm_chunk=4)
EXACT = dict(rtol=1e-5, atol=1e-5)
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


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _leaves(node):
    if isinstance(node, torch.Tensor):
        return [node]
    return [t for child in node for t in _leaves(child)]


def _assert_caches_equal(jcache, tcache, **tol):
    """Every leaf, in the caches' field order, equal (or within ``tol``)."""
    jl, tl = jax.tree.leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        if tol:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------ the mixer


def _naive_scan(x, dt, a, bm, cm, state):
    """The selective SSM one position at a time: ``h = exp(-dt a) h + dt x
    ⊗ B``, ``y = h · C``."""
    ys = []
    for t in range(x.shape[1]):
        da = np.exp(-dt[:, t] * a)                          # (B, H)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * bm[:, t, None,
                                                             None, :]
        state = state * da[..., None, None] + upd
        ys.append(np.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return np.stack(ys, axis=1), state


@pytest.mark.parametrize("length,chunk,carry", [(8, 4, False), (12, 4, True),
                                                (16, 8, True)])
def test_ssd_scan_equals_jax_and_the_naive_recurrence(length, chunk, carry):
    rng = np.random.default_rng(length + chunk)
    b, h, p, n = 2, 3, 4, 5
    x = _f32(rng, b, length, h, p)
    dt = np.log1p(np.exp(_f32(rng, b, length, h))).astype(np.float32)
    a = np.linspace(1.0, 4.0, h).astype(np.float32)
    bm, cm = _f32(rng, b, length, n), _f32(rng, b, length, n)
    s0 = (_f32(rng, b, h, p, n) if carry
          else np.zeros((b, h, p, n), np.float32))
    jy, js = jmamba.ssd_scan(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk,
                             initial_state=jnp.asarray(s0))
    ty, ts = tmamba.ssd_scan(*map(torch.as_tensor, (x, dt, a, bm, cm)), chunk,
                             initial_state=torch.as_tensor(s0))
    ny, ns = _naive_scan(x, dt, a, bm, cm, s0.copy())
    for got in (ty.numpy(), np.asarray(jy)):
        np.testing.assert_allclose(got, ny, **EXACT)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **EXACT)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **EXACT)
    np.testing.assert_allclose(ts.numpy(), ns, **EXACT)
    with pytest.raises(ConfigError, match="ssm_chunk"):
        tmamba.ssd_scan(*map(torch.as_tensor, (x, dt, a, bm, cm)),
                        length + 1)


def _mixer(sc: bool = False):
    """One mixer's parameters from JAX's ``init_mamba_params`` on both
    sides (``dt_bias`` perturbed so the softplus is not at its zero)."""
    jcfg, tcfg = _cfgs(sc)
    jp = jmamba.init_mamba_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    jp = dict(jp, dt_bias=jnp.linspace(-1.0, 1.0, jcfg.ssm_heads,
                                       dtype=jnp.float32))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    if sc:
        tp = pack_sc_weights({"layers": [{"mixer": tp}]},
                             tcfg)["layers"][0]["mixer"]
    return jcfg, jp, tcfg, tp


def test_causal_conv_and_one_shot_mixer_equal_jax():
    jcfg, jp, tcfg, tp = _mixer()
    rng = np.random.default_rng(1)
    _, _, _, conv_ch = tmamba._dims(tcfg)
    x = _f32(rng, 2, 8, conv_ch)
    want = jmamba._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    ext = torch.cat([torch.zeros((2, tcfg.ssm_conv - 1, conv_ch)),
                     torch.as_tensor(x)], dim=1)
    got = tmamba._causal_conv(ext, tp["conv_w"], tp["conv_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    h = _f32(rng, 2, 8, tcfg.d_model)
    jy, jc = jmamba.mamba_block(jp, jnp.asarray(h), jcfg, return_cache=True)
    ty, tc = tmamba.mamba_block(tp, torch.as_tensor(h), tcfg,
                                return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **EXACT)
    _assert_caches_equal(jc, tc, **EXACT)


@pytest.mark.parametrize("n_valid", [4, 3, 1])
def test_chunk_step_continues_a_cache_as_jax(n_valid):
    """A padded 4-row chunk after an 8-row prefix: the rows, the conv
    window (ending at the last valid row) and the state equal JAX's."""
    jcfg, jp, tcfg, tp = _mixer()
    rng = np.random.default_rng(n_valid)
    h0, h1 = _f32(rng, 1, 8, tcfg.d_model), _f32(rng, 1, 4, tcfg.d_model)
    _, jc = jmamba.mamba_block(jp, jnp.asarray(h0), jcfg, return_cache=True)
    _, tc = tmamba.mamba_block(tp, torch.as_tensor(h0), tcfg,
                               return_cache=True)
    jy, jc2 = jmamba.mamba_chunk_step(jp, jnp.asarray(h1), jc, jcfg,
                                      jnp.int32(n_valid))
    ty = tmamba.mamba_chunk_step(tp, torch.as_tensor(h1), tc, tcfg,
                                 torch.tensor([n_valid], dtype=torch.int32))
    np.testing.assert_allclose(ty[:, :n_valid].numpy(),
                               np.asarray(jy)[:, :n_valid], **EXACT)
    _assert_caches_equal(jc2, tc, **EXACT)     # updated in place


def test_chunks_equal_the_one_shot_mixer():
    """Three 4-row chunk calls give the one-shot mixer's rows and cache
    bit for bit: the scan runs chunk by chunk in both."""
    _, _, tcfg, tp = _mixer()
    h = torch.as_tensor(_f32(np.random.default_rng(5), 1, 12, tcfg.d_model))
    one, oc = tmamba.mamba_block(tp, h, tcfg, return_cache=True)
    cache = tmamba.init_mamba_cache(tcfg, 1, torch.float32,
                                    torch.device("cpu"))
    four = torch.tensor([4], dtype=torch.int32)
    rows = [tmamba.mamba_chunk_step(tp, h[:, i:i + 4], cache, tcfg, four)
            for i in range(0, 12, 4)]
    assert torch.equal(torch.cat(rows, dim=1), one)
    assert torch.equal(cache.conv, oc.conv)
    assert torch.equal(cache.state, oc.state)


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_decode_step_equals_jax(sc):
    jcfg, jp, tcfg, tp = _mixer(sc)
    rng = np.random.default_rng(7)
    h0 = _f32(rng, 3, 8, tcfg.d_model)
    _, jc = jmamba.mamba_block(jp, jnp.asarray(h0), jcfg, return_cache=True)
    _, tc = tmamba.mamba_block(tp, torch.as_tensor(h0), tcfg,
                               return_cache=True)
    tol = SC_GEMM_8 if sc else EXACT
    for step in range(3):
        x = _f32(rng, 3, 1, tcfg.d_model)
        jy, jc = jmamba.mamba_decode_step(jp, jnp.asarray(x), jc, jcfg)
        ty = tmamba.mamba_decode_step(tp, torch.as_tensor(x), tc, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
        if not sc:
            _assert_caches_equal(jc, tc, **EXACT)


def test_decode_step_rows_do_not_depend_on_the_batch():
    """A row decoded with two others equals the row decoded alone, bit for
    bit (the conv window and the readout are ``tree_sum``s)."""
    _, _, tcfg, tp = _mixer(sc=True)
    rng = np.random.default_rng(8)
    h0 = torch.as_tensor(_f32(rng, 3, 8, tcfg.d_model))
    x = torch.as_tensor(_f32(rng, 3, 1, tcfg.d_model))
    _, tc = tmamba.mamba_block(tp, h0, tcfg, return_cache=True)
    alone = [tmamba.mamba_decode_step(
        tp, x[i:i + 1], tmamba.MambaCache(tc.conv[i:i + 1].clone(),
                                          tc.state[i:i + 1].clone()), tcfg)
        for i in range(3)]
    together = tmamba.mamba_decode_step(tp, x, tc, tcfg)
    assert torch.equal(torch.cat(alone), together)


@pytest.mark.parametrize("which", ["in_proj", "out_proj"])
def test_sc_projection_counts_equal_jax(which):
    """Each Mamba projection's SC-GEMM counts on the same rows equal JAX's
    (the packed weight the engine serves from, and the per-call path)."""
    jcfg, jp, tcfg, tp = _mixer(sc=True)
    k = tp[which].shape[0]
    x = _f32(np.random.default_rng(9), 5, k)
    w = np.asarray(jp[which])
    want = jrecover(jsc_proj(jnp.asarray(x), jp[which], jcfg), x, w,
                    row_quant=True)
    for packed in (tp["packed"][which], None):
        got = sc_proj(torch.as_tensor(x), tp[which], tcfg, packed)
        np.testing.assert_array_equal(
            recover_counts(got, x, w, row_quant=True), want)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_prefill_chunk_and_decode_logits_equal_jax(sc):
    """One-shot prefill of 8 tokens, the same prompt chunked (4 + a padded
    4 holding 3), then three decode steps from the one-shot cache."""
    jcfg, jp, tcfg, tp = _setup(sc)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    tpp = pack_sc_weights(tp, tcfg)
    tol = SC_GEMM_8 if sc else EXACT_MODEL
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128, (1, 8)).astype(np.int32)
    with torch.no_grad():
        jl, jc = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)})
        tl, tc = tm.prefill_step(tpp, {"tokens": torch.as_tensor(toks)})
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
        for _ in range(3):
            nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
            jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)})
            tl, tc = tm.decode_step(tpp, tc, {"tokens": torch.as_tensor(nxt)})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
            assert tl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)
        assert tc.pos.tolist() == np.asarray(jc.pos).tolist() == [11]


def test_paged_decode_step_is_the_decode_step():
    _, _, tcfg, tp = _setup(True)
    tm = bind(tcfg, "cpu")
    tpp = pack_sc_weights(tp, tcfg)
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, 128, (2, 4)).astype(np.int32))
    _, a = tm.prefill_step(tpp, {"tokens": toks})
    b = tops.paged_init(tm.init_cache, 2, 3, 4)
    tops.slot_insert(b, a, 0)
    tops.slot_insert(b, tops.slot_read(a, 1), 1)
    nxt = {"tokens": toks[:, :1]}
    la, _ = tm.decode_step(tpp, a, nxt)
    lb, _ = tm.paged_decode_step(tpp, b, torch.full((2, 2), -1), nxt)
    assert torch.equal(la, lb)


def test_from_jax_params_keeps_the_float32_leaves():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.n_layers
    for i, layer in enumerate(tp["layers"]):
        for name, t in layer["mixer"].items():
            want = np.asarray(jp["layers"]["mixer"][name][i])
            assert t.dtype == (torch.float32 if name in tmamba.F32_LEAVES
                               else torch.bfloat16), name
            np.testing.assert_array_equal(t.float().numpy(),
                                          want.astype(np.float32))
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["final_norm"].float().numpy(),
                                  np.asarray(jp["final_norm"], np.float32))


# ---------------------------------------------------- cache ops, the pool


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


def test_slot_and_paged_ops_equal_jax():
    jcfg, tcfg = _cfgs()
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    jpool, tpool = jm.init_cache(3, 8), tm.init_cache(3, 8)
    js, ts = _random_single(jm, tm, 8, seed=1)
    jpool = jops.slot_insert(jpool, js, 1)
    tops.slot_insert(tpool, ts, 1)
    _assert_caches_equal(jpool, tpool)
    _assert_caches_equal(jops.slot_read(jpool, 1), tops.slot_read(tpool, 1))
    jpool = jops.slot_evict(jpool, 1)
    tops.slot_evict(tpool, 1)
    _assert_caches_equal(jpool, tpool)
    _assert_caches_equal(jops.truncate_seq(js, 5), tops.truncate_seq(ts, 5))
    # paged: no sequence leaf, so the pool keeps the slot layout
    jdata = jops.paged_init(jm.init_cache, 3, 4, 4)
    tdata = tops.paged_init(tm.init_cache, 3, 4, 4)
    _assert_caches_equal(jdata, tdata)
    tables = np.array([[0, 1], [-1, -1], [2, -1]], np.int32)
    jdata = jops.paged_insert(jdata, js, 2, [2], block=4)
    tops.paged_insert(tdata, ts, 2, [2], block=4)
    _assert_caches_equal(jdata, tdata)
    jdense = jops.paged_gather(jdata, jnp.asarray(tables), block=4)
    tdense = tops.paged_gather(tdata, torch.as_tensor(tables), block=4)
    _assert_caches_equal(jdense, tdense)
    jdata = jops.paged_commit(jdata, jdense._replace(pos=jdense.pos + 1),
                              jnp.asarray(tables), block=4)
    tdata = tops.paged_commit(tdata, tdense._replace(pos=tdense.pos + 1),
                              torch.as_tensor(tables), block=4)
    _assert_caches_equal(jdata, tdata)
    jdata = jops.paged_evict(jdata, 2, [2])
    tops.paged_evict(tdata, 2, [2])
    _assert_caches_equal(jdata, tdata)
    assert not any(t[:, 2].any() for t in _leaves(tdata.mamba))


def _pool_state(pool):
    return (pool.tables.tolist(), list(pool._free_pages), list(pool._free),
            sorted(pool.entries), pool.pages_live, pool.available_pages)


def test_pool_ledger_equals_jax():
    """Admissions, page growth and evictions on the port's and the JAX
    ``PagedSlotPool``: tables, free lists and the cache's contents (slot
    leaves written on admission, zeroed on eviction) equal after each."""
    jcfg, tcfg = _cfgs()
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    jpool = JaxPagedSlotPool(jm, 3, 16, block=4, n_blocks=8)
    tpool = PagedSlotPool(tm, 3, 16, block=4, n_blocks=8)
    rng = np.random.default_rng(3)
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


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_streams_equal_jax_engine_and_baseline(paged, mode):
    """SC-GEMM on, ``ssm_chunk``-aligned prompts (the one-shot scan takes
    whole chunks) and a chunk of 3 that both engines round up to 4."""
    jcfg, jp, tcfg, tp = _setup(True)
    prompts = _prompts([8, 12, 4, 8], seed=1)
    kw = dict(capacity=2, max_seq=24, block=4, chunk=3, paged=paged,
              prefill_mode=mode)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts,
                                                   GENS))
    eng = Engine(tcfg, tp, device="cpu", **kw)
    res = eng.run(_requests(Request, prompts, GENS))
    base = [generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")[0]
            for p, g in zip(prompts, GENS)]
    for r, j, b in zip(res, jres, base):
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, b.numpy(), err_msg=r.uid)
    assert eng.stats["decode_steps"] < sum(g - 1 for g in GENS)
    assert eng.prefix is None


def test_chunked_engine_pads_a_final_chunk_as_jax():
    """Prompts that end inside a chunk (chunked prefill pads the last one,
    ``dt = 0`` on its pad rows): streams equal the JAX engine's; one-shot
    refuses them with a typed error, where the reference's scan asserts."""
    jcfg, jp, tcfg, tp = _setup(True)
    prompts = _prompts([9, 13, 5, 6], seed=2)
    kw = dict(capacity=2, max_seq=24, block=4, chunk=4)
    jres = JaxEngine(jcfg, jp, **kw).run(_requests(JaxRequest, prompts,
                                                   GENS))
    res = Engine(tcfg, tp, device="cpu", **kw).run(
        _requests(Request, prompts, GENS))
    for r, j in zip(res, jres):
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
    one = Engine(tcfg, tp, device="cpu", prefill_mode="oneshot", **kw)
    with pytest.raises(ConfigError, match="ssm_chunk"):
        one.run(_requests(Request, prompts[:1], GENS[:1]))


def test_engine_rounds_its_chunk_to_ssm_chunk():
    jcfg, jp, tcfg, tp = _setup()
    for chunk, want in ((1, 4), (4, 4), (5, 8), (16, 16)):
        eng = Engine(tcfg, tp, device="cpu", capacity=1, max_seq=16,
                     chunk=chunk)
        jeng = JaxEngine(jcfg, jp, capacity=1, max_seq=16, chunk=chunk)
        assert eng.chunk == jeng.chunk == want
        assert eng.prefill_budget == want
        assert all(b % 4 == 0 for b in eng.buckets)
    dense = dataclasses.replace(tcfg, family="dense", d_ff=128, ssm_state=0)
    assert Engine(dense.validate(), bind(dense, "cpu").init_params(0),
                  device="cpu", capacity=1, max_seq=16, chunk=5).chunk == 5


@pytest.mark.parametrize("arch,mode", [("mamba2-130m", "chunked"),
                                       ("mamba2-130m", "oneshot"),
                                       ("zamba2-7b", "chunked")])
def test_serve_cli_serves_the_family_on_the_cpu(capsys, arch, mode):
    """``python -m repro_torch.launch.serve --arch mamba2-130m`` (and
    zamba2-7b) as a user runs it, reduced, on the CPU: prompts of one
    reduced ``ssm_chunk`` (16), the chunk rounded up to it."""
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--reduced", "--device", "cpu", "--sc-gemm",
          "--requests", "3", "--prompt-len", "16", "--gen", "4",
          "--capacity", "2", "--block", "4", "--prefill-mode", mode])
    out = capsys.readouterr().out
    assert f"[serve] cpu continuous/paged/{mode}: 3 requests" in out
