"""Logical-axis sharding rules: params, batches and decode caches (port of
``repro/parallel/sharding.py``), placed on a ``torch.distributed``
``DeviceMesh`` as DTensor placements.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod. Policy (the reference's):

* **TP** over ``model``: attention QKV/O, MLP d_ff, vocab/embedding, experts.
* **FSDP (ZeRO-3)** over ``data``: every matrix's other large dim. Weights
  are *replicated* across pods — cross-pod traffic is the gradient
  all-reduce only.
* Batch over ``("pod", "data")``; decode caches shard batch and either KV
  heads (if divisible by the model-axis size) or head_dim over ``model``.
  A batch smaller than the data axes (``long_500k``) shards the cache's
  *sequence* axis over ``data``.

A rule takes a mesh as a named ``DeviceMesh`` or a
:class:`repro_torch.launch.mesh.AbstractMesh` (names and shape alone), so
the rules of the production meshes can be computed on one host.

The port's trees differ from the reference's in one way: the reference
stacks a model's layers on a leading axis (a tuple over group positions
for the transformer, one stacked dict for the Mamba families), whose spec
entry is ``None``; the port keeps one dict per layer in a list. So the
port's spec for a layer's leaf is the reference's without its leading
``None``, and ``wo``'s head count is its ``shape[-3]`` in both. Caches
have the reference's layouts (``(stack, B, S, KV, hd)`` K/V leaves).

:func:`named` turns a spec into a :class:`NamedSharding`, whose
``placements`` are DTensor's: for each mesh dimension ``Shard(d)`` where
that axis appears at tensor dim ``d``, else ``Replicate()``. A tuple entry
``("pod", "data")`` shards one tensor dim over both, the first axis
major, as JAX orders it; DTensor splits over mesh dimensions left to
right, so a tuple's axes must be in the mesh's order.
:func:`distribute` places a tree by its shardings (``jax.device_put``'s
counterpart).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.errors import ConfigError
from repro_torch.launch.mesh import mesh_axes

__all__ = ["P", "DATA_AXES", "fit_spec", "param_pspecs", "batch_pspecs",
           "cache_pspecs", "slot_pool_pspecs", "paged_pool_pspecs",
           "paged_tables_pspec", "NamedSharding", "named", "placements",
           "distribute", "is_spec"]

DATA_AXES = ("pod", "data")          # batch / FSDP axes (pod may be absent)


def _entry(axis):
    """A spec entry: ``None``, an axis name, or a tuple of names; a tuple
    of one name is that name and an empty one ``None``, as JAX's
    ``PartitionSpec`` holds them."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``'s counterpart): one
    entry per tensor dim, each ``None`` (replicated), a mesh axis name, or a
    tuple of names (that dim split over all of them)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def _axis_size(mesh, axis) -> int:
    sizes = mesh_axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes.get(a, 1) for a in axis)
    return sizes.get(axis, 1)


def _data_axis(mesh):
    return tuple(a for a in DATA_AXES if a in mesh_axes(mesh)) or None


def _fsdp_axis(mesh):
    # FSDP over "data" only (pods replicate weights; module docstring)
    return "data" if "data" in mesh_axes(mesh) else None


def fit_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop partitioning on any dim the axis size does not evenly divide —
    every shard of a placed tensor has one shape."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None if i >= len(shape) else axis)
            continue
        out.append(axis if shape[i] % _axis_size(mesh, axis) == 0 else None)
    return P(*out[: len(shape)])


def _spec_for(path: tuple, leaf, cfg: ModelConfig, mesh) -> P:
    keys = [str(k) for k in path]
    name = keys[-1]
    fsdp = _fsdp_axis(mesh)
    ndim = leaf.dim()

    def wrap(*spec):
        return P(*(spec + (None,) * (ndim - len(spec))))

    # ---- embeddings / head
    if name == "embed":
        if cfg.n_codebooks:                      # (K, V, d)
            return P(None, "model", fsdp)
        return P("model", fsdp)                  # (V, d)
    if name == "lm_head":
        return P(fsdp, "model")                  # (d, V)

    # ---- norms, scalars, biases on d_model
    if name.startswith("ln") or name in ("final_norm", "gate_norm", "q_norm",
                                         "k_norm", "dt_bias", "A_log", "D",
                                         "conv_b"):
        return wrap()
    if name in ("bq", "bk", "bv"):
        return wrap("model", None)               # (heads, head_dim)

    # ---- MoE experts (E, d, f) / (E, f, d); router (d, E)
    if "moe" in keys and name in ("w1", "w3"):
        return wrap("model", fsdp, None)
    if "moe" in keys and name == "w2":
        return wrap("model", None, fsdp)
    if name == "router":
        return wrap(fsdp, None)

    # ---- attention projections: (d, heads, head_dim) / (heads, head_dim,
    # d). Heads shard over "model" when divisible, otherwise head_dim.
    model_size = _axis_size(mesh, "model")
    if name in ("wq", "wk", "wv"):
        if leaf.shape[-2] % model_size == 0:
            return wrap(fsdp, "model", None)
        return wrap(fsdp, None, "model")
    if name == "wo":
        if leaf.shape[-3] % model_size == 0:
            return wrap("model", None, fsdp)
        return wrap(None, "model", fsdp)

    # ---- dense projections
    if name in ("w1", "w3", "in_proj"):
        return wrap(fsdp, "model")               # (d, out)
    if name in ("w2", "out_proj"):
        return wrap("model", fsdp)               # (in, d)
    if name == "conv_w":
        return wrap(None, "model")               # (width, channels)

    return wrap()                                # fallback: replicate


def _strip_model(spec: P) -> P:
    """DP-only strategy: drop the model axis from a spec (pure FSDP
    layout, for models too small to amortize TP/SP collectives)."""
    def strip(axis):
        if axis == "model":
            return None
        if isinstance(axis, tuple):
            return tuple(a for a in axis if a != "model")
        return axis
    return P(*(strip(a) for a in spec))


def param_pspecs(cfg: ModelConfig, params: Any, mesh) -> Any:
    dp_only = getattr(cfg, "sharding_strategy", "tp_sp") == "dp"

    def one(path, leaf):
        spec = _spec_for(path, leaf, cfg, mesh)
        if dp_only:
            spec = _strip_model(spec)
        return fit_spec(spec, tuple(leaf.shape), mesh)

    return tr.tree_map_with_path(one, params)


def batch_pspecs(cfg: ModelConfig, batch: Any, mesh) -> Any:
    data = _data_axis(mesh)
    axes = mesh_axes(mesh)
    if getattr(cfg, "sharding_strategy", "tp_sp") == "dp":
        all_axes = tuple(a for a in DATA_AXES if a in axes)
        if "model" in axes:
            all_axes = all_axes + ("model",)
        data = all_axes or None

    def spec(path, leaf):
        if str(path[-1]) == "mrope_positions":   # (3, B, S)
            return fit_spec(P(None, data), tuple(leaf.shape), mesh)
        return fit_spec(P(data), tuple(leaf.shape), mesh)

    return tr.tree_map_with_path(spec, batch)


def _seq_sharded(batch_size: int, mesh) -> bool:
    """A batch too small for the data axes shards sequence instead."""
    sizes = mesh_axes(mesh)
    return batch_size < math.prod(sizes[a] for a in DATA_AXES if a in sizes)


def _is_kv(path: tuple) -> bool:
    return str(path[-1]) in ("k", "v") or (
        len(path) >= 2 and str(path[-2]) in ("k", "v"))


def cache_pspecs(cfg: ModelConfig, cache: Any, mesh, *,
                 batch_size: int) -> Any:
    data = _data_axis(mesh)
    model_size = mesh_axes(mesh).get("model", 1)
    kv_shardable = cfg.n_kv_heads % model_size == 0
    seq_mode = _seq_sharded(batch_size, mesh)

    def spec(path, leaf):
        name = str(path[-1])
        if leaf.dim() == 0:
            return P()
        if name == "pos":                        # per-sequence (B,) positions
            raw = P(data if not seq_mode else None)
        elif _is_kv(path):                       # (stack, B, S, KV, hd)
            if seq_mode:
                raw = P(None, None, "data", None, "model")
            elif kv_shardable:
                raw = P(None, data, None, "model", None)
            else:
                raw = P(None, data, None, None, "model")
        elif name == "state":                    # mamba (L, B, H, P, N)
            raw = P(None, data if not seq_mode else None, "model")
        elif name == "conv":                     # (L, B, width, channels)
            raw = P(None, data if not seq_mode else None, None, "model")
        else:
            raw = P()
        return fit_spec(raw, tuple(leaf.shape), mesh)

    return tr.tree_map_with_path(spec, cache)


def slot_pool_pspecs(cfg: ModelConfig, cache: Any, mesh, *,
                     capacity: int) -> Any:
    """Cache pspecs for a serving slot pool: a decode cache whose batch
    axis is the fixed slot capacity, so slots shard exactly like batch."""
    return cache_pspecs(cfg, cache, mesh, batch_size=capacity)


def paged_pool_pspecs(cfg: ModelConfig, cache: Any, mesh) -> Any:
    """Cache pspecs for a paged serving pool: K/V leaves ``(lead,
    n_blocks + 1, block, KV, hd)`` keep the page axis unsharded (the host
    hands out page ids) and shard KV heads — or head_dim when the heads do
    not divide the model axis — so a table entry means the same page on
    every shard; slot leaves (SSM state / conv) keep the slot axis whole
    and shard channels over ``model``."""
    model_size = mesh_axes(mesh).get("model", 1)
    kv_shardable = cfg.n_kv_heads % model_size == 0

    def spec(path, leaf):
        name = str(path[-1])
        if leaf.dim() == 0 or name == "pos":
            return P()
        if _is_kv(path):
            raw = (P(None, None, None, "model", None) if kv_shardable
                   else P(None, None, None, None, "model"))
        elif name == "state":                    # mamba (L, C, H, P, N)
            raw = P(None, None, "model")
        elif name == "conv":                     # (L, C, width, channels)
            raw = P(None, None, None, "model")
        else:
            raw = P()
        return fit_spec(raw, tuple(leaf.shape), mesh)

    return tr.tree_map_with_path(spec, cache)


def paged_tables_pspec(mesh) -> P:
    """The ``(capacity, max_blocks)`` block tables: replicated, so the
    paged kernel's table walk reads only shard-local pages."""
    del mesh
    return P(None, None)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec``, one a mesh dimension: ``Shard(d)``
    where that axis appears at tensor dim ``d``, else ``Replicate()``.
    Raises :class:`ConfigError` for an axis the mesh lacks, an axis used
    twice, or a tuple entry whose axes are not in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    dims: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ConfigError(f"spec {spec!r}: the mesh has no axis "
                                  f"{a!r} (axes {tuple(names)})")
            if a in dims:
                raise ConfigError(f"spec {spec!r} uses axis {a!r} twice")
            dims[a] = d
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ConfigError(f"spec {spec!r}: the axes {axes} of one dim "
                              f"must follow the mesh's order {tuple(names)}")
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


def named(mesh, pspecs: Any) -> Any:
    """The tree of ``pspecs`` with each spec a :class:`NamedSharding` on
    ``mesh``."""
    return tr.tree_map(lambda s: NamedSharding(mesh, s), pspecs,
                       is_leaf=is_spec)


def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` placed by its :class:`NamedSharding` (a tree
    of one structure) as a DTensor (``distribute_tensor``; every rank
    passes the whole tensor)."""
    from torch.distributed.tensor import distribute_tensor
    return tr.tree_map(lambda t, s: distribute_tensor(t, s.mesh,
                                                      s.placements),
                       tree, shardings)
