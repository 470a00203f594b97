"""The port's sharding rules (``parallel/sharding.py``, the spec helpers of
``launch/steps.py``) against the JAX package's, leaf for leaf, for all ten
registered architectures × meshes (1, 1), (2, 2), (16, 16) and
(2, 16, 16) × strategies ``tp_sp`` and ``dp``.

Both sides get shape-only trees: the port its ``meta`` tensors
(``steps.abstract_params``, ``init_cache`` on ``meta``), the JAX package
``jax.eval_shape`` trees and a stand-in mesh object holding only
``axis_names`` and ``devices.shape`` — all its rules read
(``src/repro/parallel/sharding.py:33-66``). Specs compare as tuples of
entries (``None``, a name, or a tuple of names).

Parameters: the reference stacks layers on a leading axis (a tuple over
group positions for the transformer families, one stacked dict for the
Mamba ones); a port layer ``l`` maps to the reference's leaf as
``convert.from_jax_params`` maps it, and its spec must be the reference's
without the stacking dim's leading ``None``. Caches have one layout in
both packages and compare path for path. Quantized moments are shaped by
the tree they come from (a stacked leaf's blocks are not a layer's), so
the reference's ``opt_pspecs`` is also called on the port's own moment
shapes and must give the port's specs.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import steps as jsteps
from repro.models import bind as jbind
from repro.models import cache_ops as jcache_ops
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import Quantized8 as JQ8
from repro.parallel import sharding as jsh
from repro_torch import tree as tr
from repro_torch.configs.registry import ARCHS
from repro_torch.errors import ConfigError
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh, production_mesh
from repro_torch.models import bind, cache_ops
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import Quantized8
from repro_torch.parallel import sharding as sh

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("tp_sp", "dp")
_MAMBA = ("ssm", "hybrid")


def _meshes(name):
    shape, axes = MESHES[name]
    jmesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return AbstractMesh(shape, axes), jmesh


def _cfgs(arch, strategy):
    return (dataclasses.replace(ARCHS[arch], sharding_strategy=strategy),
            dataclasses.replace(JAX_ARCHS[arch], sharding_strategy=strategy))


def _entry(e):
    return tuple(e) if isinstance(e, (tuple, list)) else e


def _spec(s) -> tuple:
    return tuple(_entry(e) for e in s)


def _jkey(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jax_flat(tree) -> dict:
    """{path of str keys: spec tuple} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(_jkey(k) for k in path): _spec(s) for path, s in flat}


def _port_flat(tree) -> dict:
    items = tr.flatten_with_path(tree, is_leaf=sh.is_spec)[0]
    return {tuple(str(k) for k in path): _spec(s) for path, s in items}


def _reference_path(cfg, path: tuple) -> tuple:
    """The reference's path of a port parameter leaf (``convert``'s
    layer mapping), and whether it is stacked."""
    if path[0] != "layers":
        return path, False
    layer, rest = int(path[1]), path[2:]
    if cfg.family in _MAMBA:
        return ("layers", *rest), True
    return ("layers", str(layer % cfg.group_size), *rest), True


def _assert_params_match(cfg, port_specs, jax_specs):
    port, ref = _port_flat(port_specs), _jax_flat(jax_specs)
    assert port, "no leaves"
    seen = set()
    for path, spec in port.items():
        jpath, stacked = _reference_path(cfg, path)
        want = ref[jpath]
        if stacked:
            assert want[0] is None, (jpath, want)
            want = want[1:]
        assert spec == want, (path, spec, want)
        seen.add(jpath)
    assert seen == set(ref), set(ref) - seen


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The port's and the reference's abstract params (built once an arch:
    the trees are shapes, and every test only reads them)."""
    return (steps.abstract_params(ARCHS[arch]),
            jsteps.abstract_params(JAX_ARCHS[arch]))


@functools.lru_cache(maxsize=None)
def _opt_trees(arch):
    """The port's quantized and float optimizer states, the reference's
    float one."""
    params, jparams = _trees(arch)
    return (steps.abstract_opt_state(ARCHS[arch], params,
                                     AdamWConfig(quantize_moments=True)),
            steps.abstract_opt_state(ARCHS[arch], params, AdamWConfig()),
            jsteps.abstract_opt_state(JAX_ARCHS[arch], jparams,
                                      JaxAdamWConfig()))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_pspecs_equal_jax(arch, mesh, strategy):
    cfg, jcfg = _cfgs(arch, strategy)
    pm, jm = _meshes(mesh)
    params, jparams = _trees(arch)
    _assert_params_match(cfg, sh.param_pspecs(cfg, params, pm),
                         jsh.param_pspecs(jcfg, jparams, jm))


def _batches(cfg, b, s):
    tok = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    shapes = {"tokens": tok, "labels": tok}
    if cfg.mrope_sections is not None:
        shapes["mrope_positions"] = (3, b, s)
    port = {k: torch.empty(v, dtype=torch.int32, device="meta")
            for k, v in shapes.items()}
    ref = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in shapes.items()}
    return port, ref


def _caches(arch, batch, max_seq):
    port = bind(ARCHS[arch], "meta").init_cache(batch, max_seq)
    ref = jax.eval_shape(lambda: jbind(JAX_ARCHS[arch]).init_cache(batch,
                                                                    max_seq))
    return port, ref


def _pools(arch, capacity=4, n_blocks=8, block=16):
    m, jm = bind(ARCHS[arch], "meta"), jbind(JAX_ARCHS[arch])
    port = cache_ops.paged_init(m.init_cache, capacity, n_blocks, block)
    ref = jax.eval_shape(lambda: jcache_ops.paged_init(
        jm.init_cache, capacity, n_blocks, block))
    return port, ref


def _same_paths(port_specs, jax_specs):
    port, ref = _port_flat(port_specs), _jax_flat(jax_specs)
    assert port == ref


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_batch_cache_and_pool_pspecs_equal_jax(arch, mesh, strategy):
    """``batch_pspecs`` (with ``mrope_positions`` for the vlm), the
    decode cache at batch 1 (sequence-sharded on a data axis) and 8,
    the slot pool, the paged pool and its tables, ``activation_spec``."""
    cfg, jcfg = _cfgs(arch, strategy)
    pm, jm = _meshes(mesh)
    for b in (8, 32):
        port, ref = _batches(cfg, b, 64)
        _same_paths(sh.batch_pspecs(cfg, port, pm),
                    jsh.batch_pspecs(jcfg, ref, jm))
    for b in (1, 8):
        port, ref = _caches(arch, b, 64)
        _same_paths(sh.cache_pspecs(cfg, port, pm, batch_size=b),
                    jsh.cache_pspecs(jcfg, ref, jm, batch_size=b))
    port, ref = _caches(arch, 4, 64)
    _same_paths(sh.slot_pool_pspecs(cfg, port, pm, capacity=4),
                jsh.slot_pool_pspecs(jcfg, ref, jm, capacity=4))
    port, ref = _pools(arch)
    _same_paths(sh.paged_pool_pspecs(cfg, port, pm),
                jsh.paged_pool_pspecs(jcfg, ref, jm))
    assert _spec(sh.paged_tables_pspec(pm)) == _spec(
        jsh.paged_tables_pspec(jm))
    assert _spec(steps.activation_spec(pm, strategy)) == _spec(
        jsteps.activation_spec(jm, strategy))


def _to_jax_moments(tree):
    """The port's moment tree as the reference's types (dicts and lists
    kept; each leaf a ShapeDtypeStruct, a quantized one a JAX
    ``Quantized8``)."""
    if isinstance(tree, Quantized8):
        return JQ8(q=jax.ShapeDtypeStruct(tuple(tree.q.shape), jnp.int8),
                   scale=jax.ShapeDtypeStruct(tuple(tree.scale.shape),
                                              jnp.float32))
    if isinstance(tree, dict):
        return {k: _to_jax_moments(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax_moments(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _to_jax_specs(tree):
    if sh.is_spec(tree):
        return JP(*tree)
    if isinstance(tree, dict):
        return {k: _to_jax_specs(v) for k, v in tree.items()}
    return [_to_jax_specs(v) for v in tree]


def _moment_specs(specs, which):
    return tr.flatten_with_path(specs[which], is_leaf=sh.is_spec)[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_opt_pspecs_equal_jax(arch, mesh):
    """Quantized moments: the reference's rule on the port's own moment
    shapes gives the port's specs, and each spec fits its moment's blocks;
    float moments follow their parameter's spec (the reference's, through
    the layer mapping)."""
    pm, jm = _meshes(mesh)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    params, jparams = _trees(arch)
    opt, fopt, jfopt = _opt_trees(arch)
    p_specs = sh.param_pspecs(cfg, params, pm)
    got = steps.opt_pspecs(cfg, opt, p_specs, pm)
    jopt = {"m": _to_jax_moments(opt["m"]), "v": _to_jax_moments(opt["v"]),
            "step": jax.ShapeDtypeStruct((), jnp.int32)}
    want = jsteps.opt_pspecs(jcfg, jopt, _to_jax_specs(p_specs), jm)
    for which in ("m", "v"):
        ours = [(p, _spec(s)) for p, s in _moment_specs(got, which)]
        ref = jax.tree_util.tree_flatten_with_path(
            want[which], is_leaf=lambda x: isinstance(x, JP))[0]
        assert [tuple(str(k) for k in p) for p, _ in ours] == [
            tuple(_jkey(k) for k in p) for p, _ in ref]
        assert [s for _, s in ours] == [_spec(s) for _, s in ref]
    assert _spec(got["step"]) == ()
    # float moments follow the parameters, as the reference's do
    fspecs = steps.opt_pspecs(cfg, fopt, p_specs, pm)
    jp_specs = jsh.param_pspecs(jcfg, jparams, jm)
    jf = jsteps.opt_pspecs(jcfg, jfopt, jp_specs, jm)
    _assert_params_match(cfg, fspecs["m"], jf["m"])


def test_production_meshes_and_their_refusals():
    assert production_mesh() == AbstractMesh((16, 16), ("data", "model"))
    assert production_mesh(multi_pod=True).size == 512
    pm = production_mesh(multi_pod=True)
    spec = sh.P(("pod", "data"), "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(pm, spec) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(pm, sh.P(None, ("data",))) == (
        Replicate(), Shard(1), Replicate())
    for bad in (sh.P(("data", "pod")), sh.P("stage"), sh.P("data", "data")):
        with pytest.raises(ConfigError):
            sh.placements(pm, bad)
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    with pytest.raises(ConfigError, match="256"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ConfigError, match="process group"):
        make_mesh((1, 1), ("data", "model"), device_type="cpu")


def test_spec_entries_normalize_as_jax():
    for entries in ((("data",), None), ((), "model"), (("pod", "data"),),
                    (["data", "model"], None)):
        assert _spec(sh.P(*entries)) == _spec(JP(*entries))
