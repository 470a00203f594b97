"""The prefill half of the port's compiled-step cache (``launch.steps``
``PrefillStep``, ``cached_chunked_prefill_step``, ``cached_prefill_step``)
and the chunk step it captures, on the CPU.

The chunk step keeps its offset and valid length on the device (so a CUDA
graph can capture it): held chunk by chunk against the JAX package's
``prefill_chunk_step`` on a reduced smollm-360m (float32), logits within
1e-5 with exact projections and the LM head's SC-GEMM counts equal through
``recover_counts``. A staging buffer reused by a later prompt, or by a
prompt restarted after preemption, gives the bits a fresh one gives. The
engine's streams, chunked and one-shot, equal the JAX engine's and the
sequential baseline's, with the CUDA graph capture replaced by a test
double that leaves the steps eager; the number of prefill entries stays
bounded. The card's side (replays bitwise equal to the eager steps, the
flash kernel with its offset read on the device) is in
``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core.sc_numerics import recover_counts as jrecover
from repro.models import bind as jbind
from repro.models import transformer as jtransformer
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.errors import ConfigError
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import sc_matmul
from repro_torch.launch import steps
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import Engine, Request

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _tuner_cache(tmp_path, monkeypatch):
    """Both packages' autotuner caches in the test's own directory
    (``pallas_tuned`` and ``tune=True`` sweep and write them), never the
    default paths."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))

EXACT = dict(rtol=1e-5, atol=1e-5)
#: the tight-budget workload of tests/test_torch_step_cache.py: 8 pages of 2
#: tokens for 2 slots, so a slot (or the staging prefill) is preempted
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


def _cfgs(sc: bool, kernel: str = "auto"):
    kw = dict(dtype="float32", use_sc_gemm=sc)
    tcfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(**kw),
                               attn_kernel=kernel).validate()
    return JAX_ARCHS["smollm-360m"].reduced(**kw), tcfg


def _setup(sc: bool, kernel: str = "auto"):
    jcfg, tcfg = _cfgs(sc, kernel)
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,)).astype(
        np.int32)


def _chunks(prompt, chunk):
    """(tokens (1, chunk) zero-padded, n_valid) of each chunk."""
    for off in range(0, len(prompt), chunk):
        nv = min(chunk, len(prompt) - off)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :nv] = prompt[off:off + nv]
        yield toks, nv


def _recording(monkeypatch, module):
    """Record every hidden row ``module.logits_from_hidden`` projects."""
    seen = []
    real = module.logits_from_hidden

    def rec(params, cfg, hidden):
        seen.append(hidden)
        return real(params, cfg, hidden)

    monkeypatch.setattr(module, "logits_from_hidden", rec)
    return seen


# ------------------------------------------------- the chunk step vs JAX


@pytest.mark.parametrize("kernel", ["auto", "pallas_tuned"],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_device_offset_chunk_step_equals_jax(monkeypatch, sc, kernel):
    """A 19-token prompt in chunks of 8 into a 32-token staging cache, the
    valid length an int32 tensor and the offset the cache's own position:
    each chunk's logits within 1e-5 of the JAX step's with exact
    projections; under SC-GEMM the LM head's counts, recovered from each
    side's logits and hidden row, equal. ``pallas_tuned`` sends the
    attention through the flash kernel's wrapper (its plain version here)
    with the offset as a tensor."""
    jcfg, jp, tcfg, tp = _setup(sc, kernel)
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    jseen = _recording(monkeypatch, jtransformer)
    tseen = _recording(monkeypatch, ttransformer)
    jc, tc = jm.init_cache(1, 32), tm.init_cache(1, 32)
    prompt = _prompt(19, seed=2)
    with torch.no_grad():
        for toks, nv in _chunks(prompt, 8):
            jl, jc = jm.prefill_chunk_step(
                jp, jc, {"tokens": jnp.asarray(toks),
                         "n_valid": jnp.asarray([nv], jnp.int32)})
            tl, tc = tm.prefill_chunk_step(
                tp, tc, {"tokens": torch.as_tensor(toks),
                         "n_valid": torch.tensor([nv], dtype=torch.int32)})
            assert tl.shape == (1, 1, tcfg.vocab_size)
            if not sc:
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           **EXACT)
                continue
            head = np.asarray(jp["embed"]).T
            want = jrecover(np.asarray(jl), np.asarray(jseen[-1]), head,
                            bits=jcfg.sc_bits, row_quant=True)
            got = jrecover(tl.numpy(), tseen[-1].numpy(), head,
                           bits=tcfg.sc_bits, row_quant=True)
            np.testing.assert_array_equal(got, want)
    assert int(tc.pos[0]) == int(np.asarray(jc.pos)[0]) == 19
    if not sc:
        for t, j in zip((*tc.k, *tc.v), (*jc.k, *jc.v)):
            np.testing.assert_allclose(t[:, :, :19].numpy(),
                                       np.asarray(j)[:, :, :19], **EXACT)


# -------------------------------------------------- reused staging buffers


def _run_prompt(step, prompt, chunk, n_chunks=None):
    """Start ``prompt`` on ``step`` and run its chunks (all, or the first
    ``n_chunks``); returns each chunk's logits."""
    step.start()
    out = []
    for i, (toks, nv) in enumerate(_chunks(prompt, chunk)):
        if n_chunks is not None and i == n_chunks:
            break
        step.tokens.copy_(torch.as_tensor(toks))
        step.n_valid.fill_(nv)
        step.replay()
        out.append(step.logits.clone())
    return out


@pytest.mark.parametrize("kernel", ["auto", "pallas_tuned"],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("case", ["short-after-long", "restart-after-preempt"])
def test_a_reused_staging_buffer_equals_a_fresh_one(case, kernel):
    """The staging cache keeps an earlier prompt's K/V past the new
    prompt's position (finite stale values): every chunk's logits, the
    prompt's K/V and the position are bitwise those of a fresh step."""
    _, _, tcfg, tp = _setup(True, kernel)
    tm = bind(tcfg, "cpu")
    chunk, bucket = 8, 32
    long, short = _prompt(30, seed=3), _prompt(11, seed=4)
    reused = steps.PrefillStep(tm, tp, extent=bucket, chunk=chunk)
    if case == "short-after-long":
        _run_prompt(reused, long, chunk)
        prompt = short
    else:
        _run_prompt(reused, long, chunk, n_chunks=2)    # then preempted
        prompt = long
    got = _run_prompt(reused, prompt, chunk)
    fresh = steps.PrefillStep(tm, tp, extent=bucket, chunk=chunk)
    want = _run_prompt(fresh, prompt, chunk)
    n = len(prompt)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    for g, w in zip((*reused.cache.k, *reused.cache.v),
                    (*fresh.cache.k, *fresh.cache.v)):
        assert torch.equal(g[:, :, :n], w[:, :, :n])
    assert int(reused.cache.pos[0]) == int(fresh.cache.pos[0]) == n
    if case == "short-after-long":
        # the staging cache did hold other values past the prompt
        assert not torch.equal(reused.cache.k[0], fresh.cache.k[0])


def test_one_shot_step_equals_the_prefill_function():
    """The one-shot step's static cache and logits are the prefill's."""
    _, _, tcfg, tp = _setup(True)
    tm = bind(tcfg, "cpu")
    prompt = _prompt(13, seed=5)
    step = steps.PrefillStep(tm, tp, extent=13)
    step.tokens.copy_(torch.as_tensor(prompt)[None])
    step.replay()
    with torch.no_grad():
        logits, cache = tm.prefill_step(tp, {"tokens": torch.as_tensor(
            prompt)[None]})
    assert torch.equal(step.logits, logits)
    for g, w in zip((*step.cache.k, *step.cache.v, step.cache.pos),
                    (*cache.k, *cache.v, cache.pos)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------- engine


def _requests(cls, prompts, tag="r"):
    return [cls(uid=f"{tag}{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, GENS))]


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
@pytest.mark.parametrize("sc", [False, True], ids=["exact", "sc"])
def test_engine_streams_equal_jax_engine_and_baseline(cached, sc, mode):
    """Both prefill modes through the step objects, eager and on the cached
    steps (the capture doubled), under a page budget that preempts: the
    streams equal the JAX engine's and the sequential baseline's, and a
    prefill step's replays are the run's prefill chunks or prefills."""
    jcfg, jp, tcfg, tp = _setup(sc)
    prompts = [_prompt(n, seed=10 + i) for i, n in enumerate(PROMPT_LENS)]
    jax_res = JaxEngine(jcfg, jp, prefix_cache=False, prefill_mode=mode,
                        **TIGHT).run(_requests(JaxRequest, prompts))
    runs = {}
    for graphs in (None, True):
        eng = Engine(tcfg, tp, device="cpu", graphs=graphs,
                     prefill_mode=mode, **TIGHT)
        runs[graphs] = (eng, eng.run(_requests(Request, prompts)))
    eng, res = runs[True]
    assert not runs[None][0].graphs and eng.graphs
    assert eng.stats["preemptions"] >= 1
    for (r, e), j in zip(zip(res, runs[None][1]), jax_res):
        np.testing.assert_array_equal(r.tokens, e.tokens, err_msg=r.uid)
        np.testing.assert_array_equal(r.tokens, j.tokens, err_msg=r.uid)
    for p, g, r in zip(prompts, GENS, res):
        base = generate(tcfg, tp, p[None], gen_tokens=g, device="cpu")
        np.testing.assert_array_equal(r.tokens, base[0].numpy())
    entries = eng.prefill_steps()
    calls = "prefill_chunks" if mode == "chunked" else "prefills"
    assert sum(s.replays for s in entries.values()) == eng.stats[calls]
    assert all(s.captures == 1 for s in entries.values())
    assert eng.stats["prefill_captures"] == len(entries)
    # no second copy of the weights: the prefill steps run on the decode
    # entry's own
    assert all(s.params is eng._decode.params for s in entries.values())


def test_prefill_entries_stay_bounded_through_churn(cached):
    """Chunked: at most one entry a prompt bucket, whatever the prompts;
    one-shot: one a prompt length. A second run of the same prompts makes
    no entry and no capture."""
    _, _, tcfg, tp = _setup(True)
    lens = [3, 9, 17, 30, 5, 12, 33, 31, 8]
    prompts = [_prompt(n, seed=n) for n in lens]
    reqs = [Request(uid=f"r{i}", prompt=p, max_new_tokens=3)
            for i, p in enumerate(prompts)]
    kw = dict(capacity=2, max_seq=40, block=4, chunk=8)
    chunked = Engine(tcfg, tp, device="cpu", graphs=True, **kw)
    assert chunked.buckets == (8, 16, 32, 40)
    chunked.run(reqs)
    keys = set(chunked.prefill_steps())
    assert keys == {("chunked", b, 8) for b in (8, 16, 32, 40)}
    assert chunked.stats["prefill_captures"] == 4
    chunked.run([dataclasses.replace(r, uid=r.uid + "x") for r in reqs])
    assert set(chunked.prefill_steps()) == keys
    assert chunked.stats["prefill_captures"] == 0
    assert all(s.captures == 1 for s in chunked.prefill_steps().values())
    oneshot = Engine(tcfg, tp, device="cpu", graphs=True,
                     prefill_mode="oneshot", **kw)
    # the same decode entry: its prefill entries are shared
    assert oneshot._decode is chunked._decode
    for tag in ("a", "b"):
        oneshot.run([dataclasses.replace(r, uid=r.uid + tag) for r in reqs])
    oneshot_keys = {k for k in oneshot.prefill_steps() if k[0] == "oneshot"}
    assert oneshot_keys == {("oneshot", n) for n in lens}
    assert oneshot.stats["prefill_captures"] == 0
    assert len(oneshot.prefill_steps()) == len(keys) + len(set(lens))


def test_a_graphed_prefill_step_on_the_cpu_raises():
    """The capture needs the card; nothing runs eagerly in its place."""
    _, _, tcfg, tp = _setup(False)
    step = steps.PrefillStep(bind(tcfg, "cpu"), tp, extent=16, chunk=8)
    with pytest.raises(ConfigError, match="need the card"):
        steps.capture(step)
    assert step.captures == 0 and step.launch_counts == {}


# ---------------------------------------------- the flash kernel's offset


@pytest.mark.parametrize("sq", [1, 5, 16, 17, 64])
@pytest.mark.parametrize("bits,esz", [(None, 2), (None, 4), (8, 2)],
                         ids=["bf16", "f32", "sc8"])
def test_plan_with_a_tensor_offset_is_one_grid(sq, bits, esz):
    """An offset held on the card plans one launch for every offset: the
    worst-case m-tile count, which covers the m-tiles of the rows at every
    offset (so each row keeps its tile and slot), and an SC head split
    taken from that count, not from the offset's value."""
    plans = {fa.plan(1, 15, 5, sq, 64, 1024,
                     torch.tensor(off, dtype=torch.int32), bits, esz=esz,
                     sms=132) for off in range(0, 256)}
    assert len(plans) == 1
    p = plans.pop()
    tiles = fa.m_tile_count(sq, torch.tensor(0, dtype=torch.int32))
    assert tiles == -(-(sq - 1) // fa.BLOCK_Q) + 1
    assert p.grid[0] == -(-tiles // p.m_tiles)
    for off in range(0, 256):
        need = fa.m_tile_count(sq, off)
        assert need <= tiles and need == len(
            {fa.row_tile(off + i)[0] for i in range(sq)})
    if bits is not None:
        # heads shrink while the worst-case grid is under the SM count
        assert 1 * tiles * 5 * -(-3 // p.heads) >= 132 or p.heads == 1


@pytest.mark.parametrize("bits", [None, 8], ids=["float", "sc8"])
def test_flash_wrapper_takes_a_tensor_offset(bits):
    """On the CPU the wrapper's plain version builds the positions from
    the tensor offset: bitwise the int offset's result, and a tensor of
    another dtype or size is refused."""
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.standard_normal((1, 4, 8, 16)),
                        dtype=torch.float32)
    k, v = (torch.as_tensor(rng.standard_normal((1, 2, 32, 16)),
                            dtype=torch.float32) for _ in range(2))
    for off in (0, 5, 16, 24):
        want = fa.flash_attention(q, k, v, q_offset=off, group=16,
                                  sc_bits=bits)
        got = fa.flash_attention(q, k, v, q_offset=torch.tensor(
            off, dtype=torch.int32), group=16, sc_bits=bits)
        assert torch.equal(got, want), off
    for bad in (torch.tensor(3), torch.tensor([1, 2], dtype=torch.int32)):
        with pytest.raises(ConfigError, match="q_offset"):
            fa.flash_attention(q, k, v, q_offset=bad, group=16)


# --------------------------------------------------------- SC-GEMM scratch


def test_a_scratch_scope_keeps_its_tables_apart():
    """Inside ``scratch_scope`` the SC-GEMM scratch comes from the step's
    table; a larger call outside it, on the same stream key, grows the
    shared table and leaves the step's tensors alone."""
    cpu = torch.device("cpu")
    shared_before = dict(sc_matmul._SCRATCH)
    mine: dict = {}
    with sc_matmul.scratch_scope(mine):
        c, w = sc_matmul._scratch(cpu, 7, 10, 100)
    assert set(mine) == {(None, 7)} and mine[(None, 7)] == (c, w)
    assert dict(sc_matmul._SCRATCH) == shared_before
    c2, w2 = sc_matmul._scratch(cpu, 7, 1 << 13, 1 << 21)
    assert c2.numel() >= 1 << 13 and mine[(None, 7)][0] is c
    assert mine[(None, 7)][1] is w and w.numel() < w2.numel()
    sc_matmul._SCRATCH.pop((None, 7))
