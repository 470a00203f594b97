"""``DTensor`` sharding rules of the port's kernel operators.

The kernels are custom operators (``torch.ops.repro_torch.*``, registered
by their wrappers in ``kernels/``), so a ``DTensor`` reaches them through
DTensor's dispatch: it picks one of the placements listed here for each
mesh dimension, redistributes the operands to it, and calls the operator
on the local shards. Each rule keeps every operand's reduction axis
whole on a rank, so a shard's result is bit-equal to its slice of the
unsharded result:

* ``sc_linear`` (rows ``(M, K)`` or ``(E, M, K)`` against a packed plane
  ``(K, L)`` or ``(E, K, L)``): K is never split — a row's quantization
  scale is its whole-K abs-max, and the plane was packed at its whole
  weight's scale (``kernels.sc_matmul.pack_weight``), which stays
  replicated. Rows may split over any axis, experts over any axis (rows,
  plane and scales together), and the plane's columns where it has no
  padding columns.
* ``paged_attention`` (``q (C, KV, G, D)``, pages ``(P, block, KV, D)``):
  slots with their table rows and positions, or KV heads with the pages'
  KV axis; the page axis and D stay whole.
* ``flash_attention`` (``q (B, H, Sq, D)``, ``k, v (B, KV, Skv, D)``):
  the batch, or the heads together with the KV heads (each rank's query
  heads read its own KV heads); positions stay whole, since the causal
  mask is absolute.

An SC-GEMM plane is never sent: NCCL and gloo move no int16, so the
rule may slice a plane but not gather it, and the float weight is
gathered over K before it is packed (``kernels.sc_matmul.pack_weight``
of a ``DTensor``); rows that meet a plane split over its columns are
gathered instead. :func:`register` installs the rules once (DTensor's
own strategy registry, with an input filter that ``register_sharding``
does not take); the mesh-bound steps (``launch/mesh_steps.py``) call
it.
"""
from __future__ import annotations

import torch

__all__ = ["register"]

_REGISTERED = False


def _spec(arg):
    """An argument of an ``OpSchema`` as DTensor's strategy functions see
    it: a tensor's current spec, anything else as it is."""
    from torch.distributed.tensor._op_schema import OpStrategy
    if isinstance(arg, OpStrategy):
        return arg.strategies[0].output_spec
    return arg


def _install(op, rules, static_from: int, keep: tuple[int, ...] = ()):
    """Register ``rules(*args)`` (single-mesh-dimension placement lists
    ``[out, *inputs]``, expanded over every mesh dimension) for ``op``,
    hashing its non-tensor arguments from ``static_from`` on into
    DTensor's sharding cache. The inputs at ``keep`` (integer planes,
    which NCCL and gloo cannot send) may be sliced further but never
    gathered or moved: a mesh dimension that shards one keeps its
    placement."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import (
        expand_to_full_mesh_op_strategy)

    def strategy(op_schema):
        args = [_spec(a) for a in op_schema.args_schema]

        def unmoved(input_specs, _out) -> bool:
            tensors = [a for a in args if hasattr(a, "placements")]
            for i in keep:
                have = tensors[i].placements
                want = input_specs[i].placements
                if any(h != w and not isinstance(h, Replicate)
                       for h, w in zip(have, want)):
                    return False
            return True

        return expand_to_full_mesh_op_strategy(
            op_schema.get_mesh_from_args(), op_schema, rules(*args),
            input_index=1, is_valid_strategy_cb=unmoved if keep else None)

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, strategy, RuntimeSchemaInfo(static_argnum=static_from,
                                        needs_pytree=True))


def register() -> None:
    """Install the rules (idempotent). Importing the kernel wrappers
    registers the operators first."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard

    import repro_torch.kernels.flash_attention  # noqa: F401
    import repro_torch.kernels.paged_attention  # noqa: F401
    import repro_torch.kernels.sc_matmul  # noqa: F401
    ops = torch.ops.repro_torch
    R = Replicate()

    def sc_linear(x, plane, scale, bits, pad, mr, kc):
        # [out, x, plane, scale]
        if len(plane.shape) == 3:                 # experts (E, K, L)
            rules = [[R, R, R, R],
                     [Shard(0), Shard(0), Shard(0), Shard(0)],
                     [Shard(1), Shard(1), R, R]]
            if pad == 0:
                rules.append([Shard(2), R, Shard(2), R])
            return rules
        lead = len(x.shape) - 1
        rules = [[R, R, R, R]] + [[Shard(d), Shard(d), R, R]
                                  for d in range(lead)]
        if pad == 0:
            rules.append([Shard(lead), R, Shard(1), R])
        return rules

    def paged_attention(q, k_pages, v_pages, tables, q_positions, window,
                        sc_bits):
        # [out, q, k_pages, v_pages, tables, q_positions]
        return [[R] * 6,
                [Shard(0), Shard(0), R, R, Shard(0), Shard(0)],
                [Shard(1), Shard(1), Shard(2), Shard(2), R, R]]

    def flash_attention(q, k, v, q_offset_t, q_offset, causal, group,
                        sc_bits, heads, m_tiles):
        # [out, q, k, v, q_offset_t]
        off = None if q_offset_t is None else R
        return [[R, R, R, R, off]] + [
            [Shard(d), Shard(d), Shard(d), Shard(d), off] for d in (0, 1)]

    _install(ops.sc_linear.default, sc_linear, 3, keep=(1,))
    _install(ops.paged_attention.default, paged_attention, 5)
    _install(ops.flash_attention.default, flash_attention, 4)
    _REGISTERED = True
