"""The serving engine on a mesh (``serving.Engine(mesh=...)``), on gloo
ranks (``tests/_torch_spawn.py``): every rank builds the same engine and
serves the same requests through the mesh-bound step builders on
``DTensor``s.

* Reduced smollm-360m under SC-GEMM (8 bits) on the meshes (2, 1) and
  (1, 2) at world 2 and (2, 2) at world 4, in four modes: chunked with
  the prefix cache (the last prompt repeats the second, so it hits and
  copies a page on write), one-shot, speculative (``speculate_k=2,
  draft_bits=4``) and the contiguous pool (``paged=False``). Streams,
  ``prefix_*`` stats and ``cow_copies`` equal the port's one-rank engine
  (``mesh=None``) and the JAX engine's (its default mesh, run here in
  the parent on the same weights).
* Exact float32 projections, chunked, on (1, 2) and (2, 2): streams equal
  the JAX engine's (a K split is an all-reduce of partial sums, so only
  the streams are held).
* One reduced config of each other family (gemma2-9b, qwen3-moe, mamba2,
  zamba2, musicgen with its codebooks, qwen2-vl with text prompts),
  chunked, on (1, 2), and llama4 and mamba2 chunked on (2, 1): streams
  equal the port's one-rank engine's.
* A tight page budget on (2, 1) preempts and replays the same streams;
  the gather decode (``fused=False``) on (2, 1) serves the one-rank
  engine's streams.
* ``parallel.context``'s shard-local writes (``index_copy_``,
  ``write_box_``, ``narrow_whole``) on an axis split over ``data`` equal
  the plain writes, across the ranks' boundary and within one rank.
* Every rank's streams are identical; ``graphs=True`` with a mesh, a
  ``device`` of another type than the mesh's, and
  ``default_serving_mesh()`` outside a one-rank group raise
  ``ConfigError``.

The parent computes its references while the ranks serve.
"""
import os
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_spawn import spawn

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

DEADLINE_S = 300
PARAMS_ENV = "REPRO_TORCH_ENGINE_MESH_PARAMS"
KW = dict(capacity=2, max_seq=32, block=8, chunk=4)
#: the second prompt comes again last: a prefix hit that copies its
#: resume page on write
LENS, GENS = (8, 16, 5, 16), (3, 5, 4, 3)
MODES = {"chunked": {}, "oneshot": dict(prefill_mode="oneshot"),
         "speculative": dict(speculate_k=2, draft_bits=4),
         "contiguous": dict(paged=False)}
FAMILIES = ("gemma2-9b", "qwen3-moe-235b-a22b", "mamba2-130m", "zamba2-7b",
            "musicgen-large", "qwen2-vl-2b")
#: served chunked on (2, 1), each sequence's rows on one rank
DATA_SPLIT_FAMILIES = ("llama4-maverick-400b-a17b", "mamba2-130m")
TIGHT = dict(capacity=2, max_seq=12, block=2, n_blocks=8, chunk=4)
TIGHT_LENS, TIGHT_GENS = (6, 5, 6, 4), (6, 6, 5, 6)
STATS = ("prefix_hits", "prefix_misses", "prefill_tokens_saved",
         "cow_copies", "prefix_reclaims", "prefix_retained_pages",
         "preemptions")


def _meshes(world: int):
    return ((2, 1), (1, 2)) if world == 2 else ((2, 2),)


def _cfg(arch: str, sc: bool):
    from repro_torch.configs.registry import ARCHS
    return ARCHS[arch].reduced(dtype="float32", use_sc_gemm=sc, sc_bits=8)


def _prompts(cfg, lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    kb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    out = [rng.integers(0, cfg.vocab_size, (n, *kb)).astype(np.int32)
           for n in lens]
    if lens == LENS:
        out[3] = out[1]
    return out


def _requests(cls, cfg, lens=LENS, gens=GENS):
    return [cls(uid=f"r{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(_prompts(cfg, lens), gens))]


def _serve(engine, cfg, lens=LENS, gens=GENS) -> dict:
    from repro_torch.serving import Request
    res = engine.run(_requests(Request, cfg, lens, gens))
    return {"tokens": [r.tokens for r in res],
            "stats": {k: engine.stats.get(k) for k in STATS}}


def _refusals(mesh, cfg, params) -> dict:
    """Each must raise ConfigError naming its cause: graphs=True on a
    mesh, a device that is not the mesh's, the default mesh in a group of
    more than one rank."""
    from repro_torch.errors import ConfigError
    from repro_torch.serving import Engine, default_serving_mesh
    out = {}
    for name, cause, make in (
            ("graphs", "graph", lambda: Engine(cfg, params, mesh=mesh,
                                               graphs=True, **KW)),
            ("device", "device", lambda: Engine(cfg, params, mesh=mesh,
                                                device="meta", **KW)),
            ("default_mesh", "2 ranks", default_serving_mesh)):
        try:
            make()
            out[name] = False
        except ConfigError as e:
            out[name] = cause in str(e)
    return out


def _shard_writes(mesh) -> dict:
    """The shard-local cache writes of ``parallel.context`` on a tensor
    whose written axis is split over ``data``, each against its plain
    version: a write that crosses the ranks' boundary and one that misses
    a rank's range."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.parallel.context import (index_copy_, narrow_whole,
                                              write_box_)
    g = torch.Generator().manual_seed(0)
    base = torch.randn(1, 10, 3, 4, generator=g)
    src = torch.randn(1, 4, 3, 4, generator=g)
    place = [Shard(1), Replicate()]

    def placed():
        return DTensor.from_local(base.clone(), mesh,
                                  [Replicate(), Replicate()]
                                  ).redistribute(mesh, place)

    out = {}
    for name, idx in (("index_copy", [3, 4, 5, 6]),
                      ("index_copy_one_rank", [9, 7, 6, 8])):
        idx = torch.tensor(idx)
        want = base.clone().index_copy_(1, idx, src)
        got = placed()
        index_copy_(got, 1, idx, src)
        out[name] = torch.equal(got.full_tensor(), want)
    want = base.clone()
    want[:, 3:7] = src
    got = placed()
    write_box_(got, (0, 3), src)
    out["write_box"] = torch.equal(got.full_tensor(), want)
    got = narrow_whole(placed(), 1, 7)
    out["narrow_whole"] = (got.placements == (Replicate(), Replicate())
                           and torch.equal(got.full_tensor(), base[:, :7]))
    return out


def case_engine_mesh(rank: int, world: int) -> dict:
    """Every mode on every mesh of this world size (module docstring)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import Engine
    shared = torch.load(os.environ[PARAMS_ENV], weights_only=False)
    out = {}
    for shape in _meshes(world):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        cfg = _cfg("smollm-360m", True)
        for mode, kw in MODES.items():
            out[(shape, "smollm-360m", True, mode)] = _serve(
                Engine(cfg, shared, mesh=mesh, **KW, **kw), cfg)
        if shape[1] > 1:
            exact = _cfg("smollm-360m", False)
            out[(shape, "smollm-360m", False, "chunked")] = _serve(
                Engine(exact, shared, mesh=mesh, **KW), exact)
        if shape == (2, 1):
            out["refusals"] = _refusals(mesh, cfg, shared)
            out["shard_writes"] = _shard_writes(mesh)
            out[(shape, "smollm-360m", True, "tight")] = _serve(
                Engine(cfg, shared, mesh=mesh, **TIGHT), cfg, TIGHT_LENS,
                TIGHT_GENS)
            out[(shape, "smollm-360m", True, "gather")] = _serve(
                Engine(cfg, shared, mesh=mesh, fused=False, **KW), cfg)
    return out


def case_families(rank: int, world: int) -> dict:
    """One reduced config of each other family, chunked, on (1, 2); then
    ``DATA_SPLIT_FAMILIES`` on (2, 1)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    out = {}
    for shape, archs in (((1, 2), FAMILIES), ((2, 1), DATA_SPLIT_FAMILIES)):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        for arch in archs:
            cfg = _cfg(arch, True)
            params = bind(cfg, "cpu").init_params(0)
            out[(shape, arch, True, "chunked")] = _serve(
                Engine(cfg, params, mesh=mesh, **KW), cfg)
    return out


def _one_rank(cfg, params, lens=LENS, gens=GENS, **kw) -> dict:
    from repro_torch.serving import Engine
    return _serve(Engine(cfg, params, device="cpu", **kw), cfg, lens, gens)


def _jax_streams(arch: str, sc: bool, jp, mode: str) -> list:
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.serving import Engine as JaxEngine
    from repro.serving import Request as JaxRequest
    jcfg = JAX_ARCHS[arch].reduced(dtype="float32", use_sc_gemm=sc,
                                   sc_bits=8)
    engine = JaxEngine(jcfg, jp, **KW, **MODES[mode])
    res = engine.run(_requests(JaxRequest, _cfg(arch, sc)))
    return {"tokens": [r.tokens for r in res],
            "stats": {k: engine.stats.get(k) for k in STATS}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results, by (case, world): the smollm-360m cells at
    world 2 and 4 and the families at world 2, spawned together, and the
    parent's references computed meanwhile."""
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import bind as jbind
    from repro_torch.convert import from_jax_params
    from repro_torch.models import bind
    root = tmp_path_factory.mktemp("engine_mesh")
    jcfg = JAX_ARCHS["smollm-360m"].reduced(dtype="float32")
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         _cfg("smollm-360m", True), device="cpu")
    torch.save(tp, root / "params.pt")
    got, errors = {}, []

    def ranks(case, world):
        try:
            got[(case, world)] = spawn(f"test_torch_engine_mesh:{case}",
                                       world, root / f"{case}{world}",
                                       deadline_s=DEADLINE_S)
        except BaseException as e:      # re-raised in the parent below
            errors.append(e)

    os.environ[PARAMS_ENV] = str(root / "params.pt")
    try:
        threads = [threading.Thread(target=ranks, args=a) for a in (
            ("case_engine_mesh", 2), ("case_engine_mesh", 4),
            ("case_families", 2))]
        for t in threads:
            t.start()
        want = {}
        for sc in (True, False):
            cfg = _cfg("smollm-360m", sc)
            for mode in MODES if sc else ("chunked",):
                want[("port", sc, mode)] = _one_rank(cfg, tp, **KW,
                                                     **MODES[mode])
                want[("jax", sc, mode)] = _jax_streams("smollm-360m", sc, jp,
                                                       mode)
        want[("port", True, "gather")] = _one_rank(
            _cfg("smollm-360m", True), tp, fused=False, **KW)
        want[("port", True, "tight")] = _one_rank(
            _cfg("smollm-360m", True), tp, TIGHT_LENS, TIGHT_GENS, **TIGHT)
        for arch in dict.fromkeys(FAMILIES + DATA_SPLIT_FAMILIES):
            fcfg = _cfg(arch, True)
            want[("port", arch)] = _one_rank(
                fcfg, bind(fcfg, "cpu").init_params(0), **KW)
        for t in threads:
            t.join()
    finally:
        del os.environ[PARAMS_ENV]
    if errors:
        raise errors[0]
    return got, want


def _cells(got, key_filter):
    return [(world, key, r) for world, ranks in got.items()
            for key, r in ranks[0].items()
            if isinstance(key, tuple) and key_filter(key)]


def _same_streams(a: dict, b: dict) -> bool:
    return len(a["tokens"]) == len(b["tokens"]) and all(
        np.array_equal(x, y) for x, y in zip(a["tokens"], b["tokens"]))


def test_every_rank_serves_the_same_streams(served):
    got, _ = served
    assert set(got) == {("case_engine_mesh", 2), ("case_engine_mesh", 4),
                        ("case_families", 2)}
    for (_, world), ranks in got.items():
        assert len(ranks) == world
        for key, r in ranks[0].items():
            if isinstance(key, tuple):
                for other in ranks[1:]:
                    assert _same_streams(r, other[key]), (world, key)


@pytest.mark.parametrize("mode", list(MODES))
def test_sc_streams_equal_the_one_rank_engine_and_jax(served, mode):
    got, want = served
    cells = _cells(got, lambda k: k[1:] == ("smollm-360m", True, mode))
    assert {c[1][0] for c in cells} == {(2, 1), (1, 2), (2, 2)}
    port, ref = want[("port", True, mode)], want[("jax", True, mode)]
    for world, key, r in cells:
        assert _same_streams(r, port), (world, key)
        assert _same_streams(r, ref), (world, key)
        assert r["stats"] == port["stats"], (world, key)
        for k in STATS[:6]:
            assert r["stats"][k] == ref["stats"][k], (world, key, k)


def test_the_prefix_cache_hits_and_copies_on_write(served):
    got, _ = served
    for world, key, r in _cells(got, lambda k: k[1:] == ("smollm-360m",
                                                         True, "chunked")):
        st = r["stats"]
        assert st["prefix_hits"] == 1 and st["cow_copies"] >= 1, (key, st)
        assert st["prefill_tokens_saved"] > 0, (key, st)


def test_exact_streams_equal_jax(served):
    got, want = served
    cells = _cells(got, lambda k: k[1:] == ("smollm-360m", False, "chunked"))
    assert {c[1][0] for c in cells} == {(1, 2), (2, 2)}
    for world, key, r in cells:
        assert _same_streams(r, want[("jax", False, "chunked")]), key
        assert _same_streams(r, want[("port", False, "chunked")]), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_serves_on_a_mesh(served, arch):
    got, want = served
    cells = _cells(got, lambda k: k[:2] == ((1, 2), arch))
    assert len(cells) == 1
    _, key, r = cells[0]
    assert _same_streams(r, want[("port", arch)]), key
    if arch == "musicgen-large":
        assert all(t.shape[1:] == (4,) for t in r["tokens"])


@pytest.mark.parametrize("arch", DATA_SPLIT_FAMILIES)
def test_families_serve_with_sequences_split_over_data(served, arch):
    """llama4 (windows, a shared expert, top-1 routing) and mamba2 (the
    recurrent state) on (2, 1): each rank holds one slot's rows, and the
    streams equal the one-rank engine's."""
    got, want = served
    cells = _cells(got, lambda k: k[:2] == ((2, 1), arch))
    assert len(cells) == 1
    _, key, r = cells[0]
    assert _same_streams(r, want[("port", arch)]), key


def test_a_tight_budget_preempts_and_replays_the_streams(served):
    got, want = served
    cells = _cells(got, lambda k: k[3] == "tight")
    assert len(cells) == 1
    r, port = cells[0][2], want[("port", True, "tight")]
    assert r["stats"]["preemptions"] > 0
    assert _same_streams(r, port) and r["stats"] == port["stats"]


def test_the_gather_decode_serves_on_a_mesh(served):
    got, want = served
    cells = _cells(got, lambda k: k[3] == "gather")
    assert len(cells) == 1
    r, port = cells[0][2], want[("port", True, "gather")]
    assert _same_streams(r, port) and r["stats"] == port["stats"]
    assert _same_streams(r, want[("port", True, "chunked")])


@pytest.mark.parametrize("what", ["graphs", "device", "default_mesh"])
def test_a_mesh_engine_refuses(served, what):
    got, _ = served
    for rank in got[("case_engine_mesh", 2)]:
        assert rank["refusals"][what], what


@pytest.mark.parametrize("what", ["index_copy", "index_copy_one_rank",
                                  "write_box", "narrow_whole"])
def test_shard_local_writes_equal_the_plain_writes(served, what):
    got, _ = served
    for rank in got[("case_engine_mesh", 2)]:
        assert rank["shard_writes"][what], what


def test_default_serving_mesh_needs_a_process_group():
    from repro_torch.errors import ConfigError
    from repro_torch.serving import default_serving_mesh
    with pytest.raises(ConfigError, match="process group"):
        default_serving_mesh()
