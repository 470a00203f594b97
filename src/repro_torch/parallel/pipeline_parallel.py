"""GPipe-style pipeline parallelism over ``torch.distributed`` (port of
``repro/parallel/pipeline_parallel.py``).

Stages hold contiguous layer slices, one rank a stage along one mesh
dimension; microbatches stream through point-to-point transfers, and the
bubble is the standard (S-1)/(M+S-1). The schedule is the reference's
tick for tick: ``M + S - 1`` ticks; at tick ``t`` stage 0 injects
microbatch ``t`` (zeros once the microbatches are drained), every stage
runs ``stage_fn``, the last stage records its result at slot
``t - (S - 1)``, and the ring ``i → i+1 mod S`` moves each stage's output
on (the reference's ``ppermute``, here one ``batch_isend_irecv``). The
outputs then reach every rank by a broadcast from the last stage, which
gives the bits of the reference's ``psum`` of one-hot-masked outputs.

``stage_fn(stage_params, x)`` is any per-stage function; tests drive it
with an MLP stack and with a transformer's layers and hold it bit-equal
to the unpipelined forward.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tr
from repro_torch.errors import ConfigError

__all__ = ["pipeline_forward"]


def _axis_group(mesh, axis: str):
    """(process group, this rank's index on ``axis``, the axis's size, the
    global ranks along it in order)."""
    import torch.distributed as dist
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ConfigError(f"the mesh has no axis {axis!r} (axes {names})")
    group = mesh.get_group(axis)
    return (group, mesh.get_local_rank(axis), mesh.size(names.index(axis)),
            dist.get_process_group_ranks(group))


def pipeline_forward(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                     mesh, axis: str = "stage",
                     n_microbatches: int) -> torch.Tensor:
    """Run ``x`` through S pipeline stages laid out on mesh dimension
    ``axis`` of the ``DeviceMesh`` ``mesh``.

    ``stage_params``: a tree whose leaves have leading dim S (one slice a
    stage; this rank takes its own). ``x: (B, ...)`` with ``B %
    n_microbatches == 0``, the same on every rank. Returns the last
    stage's output for the full batch on every rank.
    """
    import torch.distributed as dist
    group, stage, n_stages, ranks = _axis_group(mesh, axis)
    b = x.shape[0]
    if n_microbatches < 1 or b % n_microbatches:
        raise ConfigError(f"batch {b} does not split into {n_microbatches} "
                          f"microbatches")
    mb = b // n_microbatches
    micro = x.reshape(n_microbatches, mb, *x.shape[1:])
    params = tr.tree_map(lambda p: p[stage], stage_params)
    last = n_stages - 1
    nxt, prev = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]

    buf = torch.zeros_like(micro[0])
    outputs = torch.zeros_like(micro)
    for t in range(n_microbatches + n_stages - 1):
        if stage == 0:
            # stage 0 injects microbatch t (or zeros once drained)
            x_in = micro[t] if t < n_microbatches else torch.zeros_like(buf)
        else:
            x_in = buf
        y = stage_fn(params, x_in)
        slot = t - last
        if stage == last and slot >= 0:   # the last stage records slot t-(S-1)
            outputs[slot] = y
        if n_stages == 1:
            buf = y                       # the ring of one stage is itself
            continue
        recv = torch.empty_like(y)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, recv, prev, group)])
        for req in reqs:
            req.wait()
        buf = recv
    if n_stages > 1:
        dist.broadcast(outputs, src=ranks[last], group=group)
    return outputs.reshape(b, *x.shape[1:])
