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
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

from .sharding import NamedSharding, P, placements

_ACTIVATION_SPEC: ContextVar = ContextVar("activation_spec", default=None)

__all__ = ["activation_sharding_scope", "shard_activations", "constrain",
           "batch_axes"]


@contextlib.contextmanager
def activation_sharding_scope(spec: NamedSharding | P | None):
    token = _ACTIVATION_SPEC.set(spec)
    try:
        yield
    finally:
        _ACTIVATION_SPEC.reset(token)


def _redistribute(x, mesh, spec: P):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh if mesh is None else mesh
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
