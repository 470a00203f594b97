"""The port's distribution on several CPU ranks: ``torch.distributed`` on
gloo with a ``file://`` rendezvous in the test's temporary directory, one
spawn a world size (its checks bundled, each rank writing what it saw to a
file the tests read).

World 4: a ``(2, 2)`` ``("data", "model")`` mesh — ``named`` placements
(a tuple entry splits one dim over two mesh dims in JAX's major-to-minor
order), a reduced dense model placed by ``param_pspecs`` (local shapes are
the global ones over the axis sizes, ``full_tensor()`` gives the source's
bits), ``shard_activations`` under a scope, ``compressed_psum``; and
``pipeline_forward`` at S = 4 (a ``("stage",)`` mesh) and S = 2 (the
``"stage"`` axis of a ``(2, 2)`` ``("data", "stage")`` mesh), with an MLP
stack and with a reduced dense transformer's layers split over the stages
(SC-GEMM at 8 bits, plain versions), bit-equal to the sequential forward.

``compressed_psum`` is held within ``(world - 1) · eps32 · Σ_r |a_r| /
world`` of the rank-ordered mean of each rank's round trip ``a_r =
dequantize8(quantize8(x_r))``: the worst rounding of a four-term float32
sum in another order than the ranks'.

World 1: ``pipeline_forward`` on ``tests/test_substrate.py``'s case and
``compressed_psum``, each bit-equal to the JAX package's (``shard_map`` on
a one-device mesh).

No hang outlives the test: every group is made with a 60 s
timeout, and the parent waits for its children to a deadline of its own,
then kills them and fails. Children re-import this module, so JAX is
imported only inside the tests that compare with it.
"""
import dataclasses
import math
import multiprocessing as mp
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

#: the parent's deadline for one spawn, start to the last child's exit
DEADLINE_S = 150
GROUP_TIMEOUT = timedelta(seconds=60)


# ----------------------------------------------------------- the children

def _rank_main(case: str, rank: int, world: int, root: str) -> None:
    """One rank: join the group, run ``case``, save what it saw; on an
    exception write the traceback and exit non-zero."""
    import sys
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(root)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'rendezvous'}", rank=rank,
            world_size=world, timeout=GROUP_TIMEOUT)
        try:
            result = CASES[case](rank, world)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)


def _spawn(case: str, world: int, root: Path) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks; each rank's saved result."""
    root.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(case, r, world, str(root)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = {r: (root / f"rank{r}.err").read_text() for r in range(world)
            if (root / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still ran at the {DEADLINE_S}s deadline"
    assert not errs, "\n".join(f"rank {r}:\n{e}" for r, e in errs.items())
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(root / f"rank{r}.pt") for r in range(world)]


def _reduced(n_layers: int | None = None, **kw):
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    if n_layers is not None:
        kw["n_layers"] = n_layers
    return dataclasses.replace(cfg, **kw).validate()


def _mlp_stage(p, x):
    return torch.tanh(x @ p["w1"]) @ p["w2"]


def _mlp_stack(n_stages: int, d: int = 16, b: int = 8):
    gen = torch.Generator().manual_seed(5)
    params = {"w1": torch.randn((n_stages, d, 2 * d), generator=gen) * 0.3,
              "w2": torch.randn((n_stages, 2 * d, d), generator=gen) * 0.3}
    x = torch.randn((b, 6, d), generator=gen)
    return params, x


def _layer_stages(cfg, n_stages: int):
    """The reduced model's layers split into ``n_stages`` contiguous
    slices, each leaf stacked on a leading stage dim; the embedded batch;
    the stage function (``block_forward`` with ``full_attend``)."""
    from repro_torch import tree as tr
    from repro_torch.models import bind
    from repro_torch.models.transformer import (_embed, block_forward,
                                                full_attend)
    params = bind(cfg, "cpu").init_params(0)
    per = cfg.n_layers // n_stages
    slices = [params["layers"][s * per:(s + 1) * per]
              for s in range(n_stages)]
    stacked = tr.tree_map(lambda *ls: torch.stack(ls), *slices)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (8, 12), generator=gen)
    x = _embed(params, cfg, {"tokens": tokens})

    def stage_fn(layers, h):
        b, s = h.shape[:2]
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        for i, layer in enumerate(layers):
            h = block_forward(layer, h, cfg,
                              full_attend(cfg, pos, cfg.window_at(i)))
        return h

    whole = x
    with torch.no_grad():
        for layer_slice in slices:
            whole = stage_fn(layer_slice, whole)
    return stacked, x, stage_fn, whole


def _pipelines(rank: int, world: int) -> dict:
    """S = 4 on a ``("stage",)`` mesh and S = 2 on the ``"stage"`` axis of
    a ``(2, 2)`` ``("data", "stage")`` mesh: the MLP stack and the
    transformer's layers, against the sequential forward."""
    from repro_torch import tree as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline_parallel import pipeline_forward
    out = {}
    cfg = _reduced(n_layers=4, use_sc_gemm=True)
    for n, shape, axes in ((4, (4,), ("stage",)),
                           (2, (2, 2), ("data", "stage"))):
        mesh = make_mesh(shape, axes, device_type="cpu")
        params, x = _mlp_stack(n)
        seq = x
        for s in range(n):
            seq = _mlp_stage(tr.tree_map(lambda p: p[s], params), seq)
        got = pipeline_forward(_mlp_stage, params, x, mesh=mesh,
                               axis="stage", n_microbatches=4)
        out[f"mlp_s{n}"] = (got, seq)
        stacked, emb, stage_fn, whole = _layer_stages(cfg, n)
        with torch.no_grad():
            got = pipeline_forward(stage_fn, stacked, emb, mesh=mesh,
                                   axis="stage", n_microbatches=4)
        out[f"layers_s{n}"] = (got, whole)
    return out


def _mesh_case(rank: int, world: int) -> dict:
    """The (2, 2) mesh's checks, then the pipelines."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch import tree as tr
    from repro_torch.errors import ConfigError
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.launch.steps import activation_spec
    from repro_torch.models import bind
    from repro_torch.optim.grad_compression import compressed_psum
    from repro_torch.optim.adamw import dequantize8, quantize8
    from repro_torch.parallel import named, param_pspecs
    from repro_torch.parallel.context import (activation_sharding_scope,
                                              batch_axes, constrain,
                                              shard_activations)
    from repro_torch.parallel.sharding import P, NamedSharding, distribute
    out: dict = {}
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    coord = tuple(mesh.get_coordinate())
    try:
        make_production_mesh(device_type="cpu")
    except ConfigError:
        out["production_refused"] = True

    # -- placements, and the shard a rank holds under a tuple entry
    cases = {P("data", "model"): (Shard(0), Shard(1)),
             P("model", "data"): (Shard(1), Shard(0)),
             P(("data", "model"), None): (Shard(0), Shard(0)),
             P(None, "model"): (Replicate(), Shard(1)),
             P(): (Replicate(), Replicate())}
    out["placements"] = all(
        named(mesh, {"a": spec})["a"].placements == want
        for spec, want in cases.items())
    try:
        NamedSharding(mesh, P(("model", "data"))).placements
    except ConfigError:
        out["reversed_tuple_refused"] = True
    src = torch.arange(8.0)
    dt = distribute_tensor(src, mesh,
                           named(mesh, P(("data", "model"))).placements)
    # JAX's ("data", "model") dim: data major, model minor
    out["tuple_shard"] = torch.equal(dt.to_local(),
                                     src.chunk(4)[coord[0] * 2 + coord[1]])

    # -- a reduced dense model placed by param_pspecs
    cfg = _reduced()
    params = bind(cfg, "cpu").init_params(0)
    specs = param_pspecs(cfg, params, mesh)
    placed = distribute(params, named(mesh, specs))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    local_ok, full_ok, sharded = True, True, 0
    for spec, src_t, d in zip(tr.leaves(specs, is_leaf=lambda s:
                                        isinstance(s, P)),
                              tr.leaves(params), tr.leaves(placed)):
        want = list(src_t.shape)
        for i, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    want[i] //= sizes[a]
                    sharded += 1
        local_ok &= list(d.to_local().shape) == want
        full_ok &= torch.equal(d.full_tensor(), src_t)
    out["params"] = {"local_shapes": local_ok, "full_tensor": full_ok,
                     "sharded_dims": sharded,
                     "leaves": len(tr.leaves(params))}

    # -- the residual stream under an activation scope
    gen = torch.Generator().manual_seed(11)
    h = torch.randn((4, 8, cfg.d_model), generator=gen)
    hd = distribute_tensor(h, mesh, (Replicate(), Replicate()))
    spec = activation_spec(mesh)
    same_outside = (shard_activations(hd) is hd
                    and constrain(hd, spec) is hd and batch_axes() is None)
    with activation_sharding_scope(NamedSharding(mesh, spec)):
        moved = shard_activations(hd)
        axes = batch_axes()
        plain_same = shard_activations(h) is h
        kv = constrain(hd, P(axes, None, None))
    out["activations"] = {
        "outside_unchanged": same_outside, "plain_unchanged": plain_same,
        "placements": moved.placements == (Shard(0), Shard(1)),
        "full": torch.equal(moved.full_tensor(), h),
        "batch_axes": axes,
        "constrain": kv.placements == (Shard(0), Replicate())}

    # -- compressed_psum against the rank-ordered mean of the round trips
    xs = [torch.randn((1000,), generator=torch.Generator().manual_seed(r))
          * (r + 1) for r in range(world)]
    trips = [dequantize8(quantize8(x), x.shape, x.dtype) for x in xs]
    want = trips[0]
    for t in trips[1:]:
        want = want + t
    want = want / torch.tensor(float(world))
    got = compressed_psum(xs[rank].clone())
    bound = ((world - 1) * torch.finfo(torch.float32).eps
             * sum(t.abs() for t in trips) / world)
    out["psum"] = {"got": got, "within": bool(((got - want).abs()
                                               <= bound).all()),
                   "max_err": float((got - want).abs().max())}
    dist.barrier()
    out.update(_pipelines(rank, world))
    return out


def _one_rank_case(rank: int, world: int) -> dict:
    """``tests/test_substrate.py``'s pipeline case and compressed_psum on a
    world of one."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.grad_compression import compressed_psum
    from repro_torch.parallel.pipeline_parallel import pipeline_forward
    mesh = make_mesh((1,), ("stage",), device_type="cpu")
    w = torch.ones((1, 4, 4), dtype=torch.float32) * 0.5
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    pipe = pipeline_forward(lambda p, xx: xx @ p, w, x, mesh=mesh,
                            axis="stage", n_microbatches=4)
    g = torch.randn((3, 300), generator=torch.Generator().manual_seed(9))
    return {"pipe": pipe, "g": g, "psum": compressed_psum(g.clone())}


CASES = {"mesh": _mesh_case, "one": _one_rank_case}


# ----------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn("mesh", 4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _spawn("one", 1, tmp_path_factory.mktemp("world1"))


def test_production_mesh_is_refused_off_its_world(world4):
    assert all(r.get("production_refused") for r in world4)


def test_named_placements_on_a_2x2_mesh(world4):
    for r in world4:
        assert r["placements"] and r["reversed_tuple_refused"]
        assert r["tuple_shard"]


def test_params_distributed_by_param_pspecs_reassemble(world4):
    for r in world4:
        p = r["params"]
        assert p["local_shapes"] and p["full_tensor"]
        assert p["sharded_dims"] > p["leaves"] // 2   # most leaves split


def test_shard_activations_under_a_scope(world4):
    for r in world4:
        a = r["activations"]
        assert a["outside_unchanged"] and a["plain_unchanged"]
        assert a["placements"] and a["full"] and a["constrain"]
        assert a["batch_axes"] == "data"


def test_compressed_psum_within_its_bound(world4):
    for r in world4:
        assert r["psum"]["within"], r["psum"]["max_err"]
    # every rank holds the same mean
    for r in world4[1:]:
        assert torch.equal(r["psum"]["got"], world4[0]["psum"]["got"])


@pytest.mark.parametrize("what", ["mlp_s4", "mlp_s2", "layers_s4",
                                  "layers_s2"])
def test_pipeline_forward_bit_equal_to_sequential(world4, what):
    for r in world4:
        got, want = r[what]
        assert got.shape == want.shape
        assert torch.equal(got, want)


def test_one_rank_pipeline_equals_jax(world1):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.parallel.pipeline_parallel import pipeline_forward
    mesh = Mesh(np.array(jax.devices()[:1]), ("stage",))
    w = jnp.ones((1, 4, 4), jnp.float32) * 0.5
    x = jnp.arange(8 * 4, dtype=jnp.float32).reshape(8, 4)
    want = pipeline_forward(lambda p, xx: xx @ p, w, x, mesh=mesh,
                            axis="stage", n_microbatches=4)
    np.testing.assert_array_equal(world1[0]["pipe"].numpy(),
                                  np.asarray(want))


def test_one_rank_compressed_psum_equals_jax(world1):
    import jax
    from jax.sharding import Mesh, PartitionSpec
    from repro.optim.grad_compression import compressed_psum
    mesh = Mesh(np.array(jax.devices()[:1]), ("i",))
    f = jax.shard_map(lambda v: compressed_psum(v, "i"), mesh=mesh,
                      in_specs=PartitionSpec(), out_specs=PartitionSpec())
    g = world1[0]["g"].numpy()
    want = np.asarray(f(jax.numpy.asarray(g, dtype=jax.numpy.float32)))
    got = world1[0]["psum"].numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # at one rank: the quantizer's round trip itself
    from repro_torch.optim.adamw import dequantize8, quantize8
    trip = dequantize8(quantize8(world1[0]["g"]), (3, 300))
    assert torch.equal(world1[0]["psum"], trip)
    assert not math.isnan(float(world1[0]["psum"].sum()))
