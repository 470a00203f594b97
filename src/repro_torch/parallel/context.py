"""Activation-sharding context (port of ``repro/parallel/context.py``).

Model code is mesh-agnostic; a launcher installs the residual stream's
sharding here and the model applies it at layer-group boundaries (at the
start of every layer group of a whole-sequence forward or a prefill
chunk). The default layout is *sequence parallelism*: tokens shard over
the ``model`` axis between blocks.

The scope holds a :class:`~repro_torch.parallel.sharding.NamedSharding`
(a spec on a mesh) or a bare spec. Under a scope a DTensor is
redistributed to the scope's placements (a bare spec is read on the
tensor's own mesh); a plain tensor, which lives on one rank, is returned
as it is. Outside a scope every function returns its input object
unchanged, at the cost of one ``ContextVar`` read.

The other helpers let model code written for one tensor run on
``DTensor``s (``launch/mesh_steps.py``) without changing what a plain
tensor does: index writes that DTensor cannot place in place
(:func:`write_positions_`, :func:`index_put_`, :func:`index_copy_`),
layouts that keep a head group, a router group or a gathered table on
one rank (:func:`whole_groups`, :func:`whole_groups_grad`,
:func:`split_leading_over_data`, :func:`whole_rows`, :func:`gathered`),
and a :func:`reshape` that gathers where a PyTorch release refuses to
flatten a split dim. Each returns a plain tensor's result unchanged.
"""
from __future__ import annotations

import contextlib
import sys
from contextvars import ContextVar

from .sharding import NamedSharding, P, placements

_ACTIVATION_SPEC: ContextVar = ContextVar("activation_spec", default=None)

__all__ = ["activation_sharding_scope", "shard_activations", "constrain",
           "batch_axes", "is_dtensor", "gathered", "write_positions_",
           "split_leading_over_data", "whole_groups", "whole_groups_grad",
           "index_copy_", "index_put_", "reshape", "whole_rows"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (never true before
    ``torch.distributed.tensor`` is imported, which this does not do)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def gathered(x):
    """``x`` whole on this rank: a ``DTensor``'s ``full_tensor()``, any
    other tensor as it is. For the small integer tensors (routing
    indices) whose scatters DTensor has no rule for."""
    return x.full_tensor() if is_dtensor(x) else x


def split_leading_over_data(x):
    """A ``DTensor`` ``x`` with its leading axis over the mesh's data axes
    (where they divide it) and every other axis whole on each rank; any
    other tensor as it is. The MoE router groups take this layout: a
    group's routing is a running count over its tokens."""
    if not is_dtensor(x):
        return x
    from .sharding import DATA_AXES, fit_spec
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data = tuple(a for a in DATA_AXES if sizes.get(a, 1) > 1) or None
    spec = fit_spec(P(data, *([None] * (x.dim() - 1))), tuple(x.shape), mesh)
    return x.redistribute(mesh, placements(mesh, spec))


def whole_rows(x, lead: int = 1):
    """A ``DTensor`` ``x`` with its ``lead`` leading axes whole on every
    rank (its other placements kept); any other tensor as it is. For a
    table of rows that an index gathers from, any index naming any row:
    gather the axes before flattening them into rows, so no strided
    split is ever gathered."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim < lead else p
        for p in x.placements])


def whole_groups(x, dim: int, groups: int):
    """A ``DTensor`` ``x`` whose axis ``dim`` (query heads) is about to be
    split into ``groups`` (KV heads) x the heads a group: that axis
    gathered where the mesh axes splitting it do not divide ``groups``,
    so no rank holds part of a group; any other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % x.dim()
    split = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            split *= size
    if groups % split == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


def whole_groups_grad(x, dim: int, groups: int):
    """``x`` itself, whose gradient gets :func:`whole_groups` on the way
    back: for a flattened ``(..., heads·hd)`` input whose backward view
    splits the axis into heads again."""
    if not is_dtensor(x):
        return x
    return _WholeGroupsGrad.apply(x, dim, groups)


def _whole_groups_grad_fn():
    import torch

    class WholeGroupsGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dim, groups):
            ctx.split = (dim, groups)
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return whole_groups(g, *ctx.split), None, None

    return WholeGroupsGrad


def reshape(x, *shape):
    """``x.reshape(*shape)``. A ``DTensor`` that this PyTorch will not
    flatten as it lies (a release without strided shards refuses to
    flatten dims whose inner one is split) is first gathered on every
    dim but its first."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    try:
        return x.reshape(*shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate, Shard
        return x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim > 0 else p
            for p in x.placements]).reshape(*shape)


def index_put_(dst, index: tuple, value) -> None:
    """``dst[index] = value`` in place, ``index`` a tuple of integer
    tensors of one shape addressing ``dst``'s leading axes. On a
    ``DTensor`` whose addressed axes are whole on every rank (a page
    pool's page axes), each rank writes its own shard: the indices
    gathered whole, ``value`` placed as the written slice of ``dst``
    lies, and the write done on the local tensors (DTensor has no
    ``index_put_`` rule in every PyTorch it runs on)."""
    if not is_dtensor(dst):
        dst[index] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    n, lead = len(index), index[0].dim()
    if any(isinstance(p, Shard) and p.dim < n for p in dst.placements):
        raise ValueError("index_put_: an addressed axis of the destination "
                         "is split over ranks")
    mesh = dst.device_mesh
    place = [Shard(p.dim - n + lead) if isinstance(p, Shard) else Replicate()
             for p in dst.placements]
    idx = tuple(gathered(i) if is_dtensor(i) else i for i in index)
    if not is_dtensor(value):
        from torch.distributed.tensor import DTensor
        value = DTensor.from_local(value, mesh,
                                   [Replicate()] * mesh.ndim)
    local = value.redistribute(mesh, place).to_local()
    dst.to_local()[tuple(i.to_local() if is_dtensor(i) else i
                         for i in idx)] = local


def index_copy_(dst, dim: int, index, src) -> None:
    """``dst.index_copy_(dim, index, src)``; on a ``DTensor``, which may
    not change ``dst``'s layout in place, the out-of-place copy placed
    back into ``dst`` (``copy_``)."""
    if is_dtensor(dst):
        dst.copy_(dst.index_copy(dim, index, src))
    else:
        dst.index_copy_(dim, index, src)


def write_positions_(dst, pos, value) -> None:
    """``dst[b, pos[b]] = value[b]`` for every ``b`` whose ``pos[b]`` lies
    in ``[0, S)`` (``dst (B, S, ...)``, ``pos (B,)``, ``value (B, ...)``),
    in place, as a select over the whole of ``dst``: a mask of the
    written cells, ``torch.where``, ``copy_`` back into ``dst``'s layout.
    The decode caches' row write in this form is what a sharded
    ``DTensor`` cache takes (DTensor has no in-place index write that
    keeps a sharded layout)."""
    import torch
    b, s = dst.shape[:2]
    cells = torch.arange(s, device=pos.device)[None, :] == \
        pos.to(torch.long)[:, None]
    mask = cells.reshape(b, s, *([1] * (dst.dim() - 2)))
    value = value[:, None].to(dst.dtype)
    if is_dtensor(dst):
        # the mask and the row laid out as dst is, so the select runs on
        # each rank's shard (a mismatch would gather the whole cache)
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh, place = dst.device_mesh, dst.placements

        def laid_out(t, want):
            if not is_dtensor(t):     # whole on every rank already
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
            return t.redistribute(mesh, want)

        mask = laid_out(mask, [p if isinstance(p, Shard) and p.dim < 2
                               else Replicate() for p in place])
        value = laid_out(value, [p if isinstance(p, Shard) and p.dim != 1
                                 else Replicate() for p in place])
    dst.copy_(torch.where(mask, value, dst))


_WholeGroupsGrad = _whole_groups_grad_fn()


@contextlib.contextmanager
def activation_sharding_scope(spec: NamedSharding | P | None):
    token = _ACTIVATION_SPEC.set(spec)
    try:
        yield
    finally:
        _ACTIVATION_SPEC.reset(token)


def _redistribute(x, mesh, spec: P):
    """``x`` in ``spec``'s layout, an axis dropped where it does not
    divide its dim (``fit_spec``: a batch of one stays whole) or has one
    device (splitting over it changes nothing, and DTensor would refuse
    to flatten the dim it splits)."""
    from torch.distributed.tensor import DTensor
    from .sharding import fit_spec
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh if mesh is None else mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def live(entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a is not None and sizes[a] > 1)
        return kept or None

    spec = fit_spec(P(*(live(e) for e in spec)), tuple(x.shape), mesh)
    return x.redistribute(mesh, placements(mesh, spec))


def shard_activations(x):
    """Constrain a ``(B, S, d)`` residual-stream tensor, if a scope is
    active."""
    active = _ACTIVATION_SPEC.get()
    if active is None:
        return x
    if isinstance(active, NamedSharding):
        return _redistribute(x, active.mesh, active.spec)
    return _redistribute(x, None, active)


def constrain(x, spec: P):
    """Constrain any tensor to ``spec`` on the active scope's mesh (a no-op
    outside a scope or under a bare spec, which names no mesh)."""
    active = _ACTIVATION_SPEC.get()
    if not isinstance(active, NamedSharding):
        return x
    return _redistribute(x, active.mesh, spec)


def batch_axes():
    """The batch axis names of the active residual spec (or None)."""
    active = _ACTIVATION_SPEC.get()
    if active is None:
        return None
    spec = active.spec if isinstance(active, NamedSharding) else active
    return spec[0] if len(spec) else None
