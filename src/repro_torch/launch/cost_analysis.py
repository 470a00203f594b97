"""Per-rank cost accounting of a step and the three-term roofline: the
counterpart of the reference's ``repro/launch/hlo_analysis.py``.

The reference walks the partitioned HLO text of an AOT-compiled step. The
port has no HLO: a step is eager PyTorch on ``DTensor``s. So
:func:`count_step` runs rank 0's program itself, under a
``FakeTensorMode`` (no storage is allocated; with the ``fake`` process
group a 256- or 512-rank mesh lives in one process) and counts every
operator the rank runs on its local shards — DTensor's own redistributions
included, and not the global shape propagation DTensor runs beside them:

* matmul FLOPs of the local shapes (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``): ``2·M·N·K`` a problem;
* the kernels' work by their own rules, from the custom operators'
  shapes (``torch.ops.repro_torch.*``): SC-GEMM ``2·M·N·K`` operations
  and SC attention at the int8 peak (:data:`PEAK_INT8_OPS`), float
  attention at :data:`PEAK_FLOPS`; :func:`sc_bound` and
  :func:`flash_bound` are the rules ``chip_smoke.py`` takes its kernel
  bounds from;
* an HBM-byte model: every other operator reads its operands and writes
  its result once (an eager step fuses nothing), a view moves nothing,
  each kernel moves what its rule says;
* collective bytes by kind, by the reference's convention: the result's
  bytes (the gathered size for an all-gather; a reduce-scatter's result
  understates its traffic by the group size);
* memory: the placed arguments' bytes, the outputs' bytes (apart from
  those that alias an argument, as a cache written in place does), and
  the peak of the bytes live in tensors the step made (the temp term).

Constants: NVIDIA H100 SXM data-sheet figures (dense), not measurements:
989e12 bf16 FLOP/s, 1979e12 int8 op/s, 67e12 float32 FLOP/s (outside the
tensor cores), 3.35e12 HBM bytes/s, and a link rate a rank per mesh axis:
450e9 bytes/s (NVLink) for an axis within one 8-GPU node, 50e9 (one
400 Gb/s NIC a GPU) for an axis that spans nodes. Float32 matmuls count at
the bf16 peak, as the reference counts every dot at its one peak.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch

__all__ = ["CollectiveStats", "Roofline", "roofline_terms", "count_step",
           "StepCount", "fake_mode", "sc_bound", "flash_bound", "link_bw",
           "PEAK_FLOPS",
           "PEAK_INT8_OPS", "PEAK_FP32", "HBM_BW", "LINK_BW", "NODE_GPUS"]

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per GPU (H100 SXM data sheet)
PEAK_INT8_OPS = 1979e12      # int8 dense op/s per GPU (data sheet)
PEAK_FP32 = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU (data sheet)
#: bytes/s a rank sends over one mesh axis: within an 8-GPU NVLink node,
#: and across nodes (one 400 Gb/s NIC a GPU)
LINK_BW = {"node": 450e9, "cross_node": 50e9}
NODE_GPUS = 8


def sc_bound(m: int, k: int, n: int, esz: int, experts: int = 1):
    """Least time of one fused SC-GEMM launch of ``experts`` problems
    (M, K, N): the rows (``esz`` bytes an element) and the int16 weight
    plane read once and the output written once, against ``2·M·N·K``
    operations a problem at the int8 tensor-core peak (the rate of the
    cheapest type the counts could go through). Returns (ms, bound_by,
    bytes, ops)."""
    nbytes = experts * (m * k * esz + k * (-(-n // 8) * 8) * 2
                        + m * n * esz + 4)
    ops = 2 * m * n * k * experts
    t_b, t_o = nbytes / HBM_BW, ops / PEAK_INT8_OPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, ops)


def flash_bound(q, k, q_offset, bits):
    """Least time for one flash call ``q (B, H, Sq, D)``, ``k (B, KV, Skv,
    D)``: q read and out written once, and the K/V rows the causal rows
    need read once, against the QKᵀ and PV operations those rows need, at
    the peak for the operands' type. Returns (ms, bound_by, bytes,
    ops)."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    keys = sum(min(skv, q_offset + i + 1) for i in range(sq))
    kv_rows = min(skv, q_offset + sq)
    esz = q.element_size()
    nbytes = esz * (2 * b * h * sq * d + 2 * b * kv * kv_rows * d)
    ops = 4 * b * h * d * keys
    rate = (PEAK_INT8_OPS if bits else PEAK_FLOPS
            if q.dtype == torch.bfloat16 else PEAK_FP32)
    bound = max(nbytes / HBM_BW, ops / rate) * 1e3
    return bound, ("bytes" if nbytes / HBM_BW >= ops / rate
                   else "operations"), nbytes, ops


def link_bw(mesh_shape: tuple[int, ...]) -> float:
    """The per-rank link rate of the slowest axis a step's collectives may
    cross: an axis is within a node while the product of the sizes of it
    and the axes after it (the minor, fastest-varying ones) is at most
    :data:`NODE_GPUS`."""
    inner, rate = 1, LINK_BW["node"]
    for size in reversed(mesh_shape):
        inner *= size
        if size > 1 and inner > NODE_GPUS:
            rate = LINK_BW["cross_node"]
    return rate


@dataclass
class CollectiveStats:
    """One rank's counts: collective bytes by kind, matmul FLOPs, SC
    (int8-rate) operations and modelled HBM bytes."""
    total_bytes: float = 0.0
    by_kind: dict = field(default_factory=dict)
    op_count: int = 0
    flops: float = 0.0
    hbm_bytes: float = 0.0
    sc_ops: float = 0.0

    def add(self, kind: str, nbytes: float, times: float = 1.0):
        self.total_bytes += nbytes * times
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + nbytes * times
        self.op_count += 1


@dataclass
class Roofline:
    """All byte and FLOP quantities are PER RANK (rank 0's local program);
    ``model_flops`` is the GLOBAL useful 6·N·D count."""
    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    model_flops: float = 0.0
    sc_ops: float = 0.0
    link_bw: float = LINK_BW["node"]

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS + self.sc_ops / PEAK_INT8_OPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS per rank / counted FLOPs (SC operations included)."""
        per_chip = self.model_flops / max(self.n_chips, 1)
        work = self.flops + self.sc_ops
        return per_chip / work if work else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOP rate at the roofline step time over the bf16 peak
        (an MFU upper bound)."""
        if self.step_time_s == 0:
            return 0.0
        per_chip = self.model_flops / max(self.n_chips, 1)
        return (per_chip / self.step_time_s) / PEAK_FLOPS

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "sc_ops": self.sc_ops, "link_bw": self.link_bw,
        }


def roofline_terms(stats: CollectiveStats, *, n_chips: int,
                   model_flops: float,
                   mesh_shape: tuple[int, ...] | None = None) -> Roofline:
    """The roofline of a rank's counts (:func:`count_step`), its link rate
    the slowest axis of ``mesh_shape`` (:func:`link_bw`)."""
    return Roofline(flops=stats.flops, hbm_bytes=stats.hbm_bytes,
                    collective_bytes=stats.total_bytes, n_chips=n_chips,
                    model_flops=model_flops, sc_ops=stats.sc_ops,
                    link_bw=link_bw(mesh_shape or (n_chips,)))


# ------------------------------------------------------------ counting

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor_coalesced": "reduce-scatter"}
_MATMULS = ("mm", "bmm", "addmm", "baddbmm")
#: bookkeeping that touches no data
_FREE = {"device", "empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "is_same_size", "_local_scalar_dense"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    """The tensors of an operator's arguments or results (nested tuples,
    lists and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


@dataclass
class StepCount:
    """What :func:`count_step` saw: the counts and the memory terms."""
    stats: CollectiveStats
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    ops: int

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` keys."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "alias_size_in_bytes": self.alias_bytes,
                "temp_size_in_bytes": self.temp_bytes}


class _Live:
    """Bytes live in storages a step made, and their peak."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self.seen: set[int] = set()

    def made(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.seen:
            return
        n = st.nbytes()
        self.seen.add(key)
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self.seen.discard(key)
        self.now -= n


def _local_op_bytes(func, args, out) -> int:
    """Operands plus result, or nothing for a view (the result aliases an
    operand without a copy)."""
    schema = func._schema
    if any(r.alias_info is not None and not r.alias_info.is_write
           for r in schema.returns):
        return 0
    return sum(_nbytes(t) for t in _tensors(args)) + sum(
        _nbytes(t) for t in _tensors(out))


def _kernel_work(name: str, args) -> tuple[float, float, float]:
    """(bytes, float FLOPs, int8-rate operations) of one kernel operator
    call by its rule."""
    if name == "sc_linear":
        x, plane, _, _, pad = args[:5]
        experts = plane.shape[0] if plane.dim() == 3 else 1
        m, k = x.shape[-2], plane.shape[-2]
        _, _, nbytes, ops = sc_bound(m, k, plane.shape[-1] - pad,
                                     x.element_size(), experts)
        return nbytes, 0.0, ops
    if name == "flash_attention":
        q, k, _, off_t, off, _, _, bits = args[:8]
        offset = (k.shape[2] - q.shape[2]) if off_t is not None else off
        _, _, nbytes, ops = flash_bound(q, k, max(offset, 0), bits)
        return nbytes, (0.0 if bits else ops), (ops if bits else 0.0)
    if name == "paged_attention":
        q, k_pages, _, tables, _, _, bits = args[:7]
        c, kv, g, d = q.shape
        keys = tables.shape[1] * k_pages.shape[1]     # a full table row
        esz = q.element_size()
        nbytes = esz * (2 * c * kv * g * d + 2 * c * kv * keys * d) \
            + _nbytes(tables)
        ops = 4 * c * kv * g * d * keys
        return nbytes, (0.0 if bits else ops), (ops if bits else 0.0)
    raise KeyError(name)


@contextlib.contextmanager
def _dtensor_hooks(flag: list):
    """While a step is counted: mark DTensor's global shape propagation
    (it runs each new op once on whole-shape fake tensors) so its ops are
    not counted as the rank's, and let DTensor work out a strided shard's
    offsets (index arithmetic it does on small tensors, read back with
    ``tolist``) on real tensors, which a fake mode cannot read."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    prop = DTensor._op_dispatcher.sharding_propagator
    inner = prop._propagate_tensor_meta_non_cached
    # the helper as _StridedShard defines it (a PyTorch release that
    # does not define it there computes no offsets of its own)
    name = "local_shard_size_and_offset"
    raw = _StridedShard.__dict__.get(name)
    offsets = raw.__func__ if isinstance(raw, staticmethod) else raw

    def propagate(*a, **kw):
        flag[0] += 1
        try:
            return inner(*a, **kw)
        finally:
            flag[0] -= 1

    memo: dict = {}

    def strided(*a, **kw):
        # a pure function of its arguments, asked again for every op
        key = (tuple(map(repr, a)), tuple(sorted(kw.items())))
        if key not in memo:
            with unset_fake_temporarily():
                memo[key] = offsets(*a, **kw)
        return memo[key]

    prop._propagate_tensor_meta_non_cached = propagate
    if raw is not None:
        setattr(_StridedShard, name, staticmethod(strided)
                if isinstance(raw, staticmethod) else strided)
    try:
        yield
    finally:
        prop._propagate_tensor_meta_non_cached = inner
        if raw is not None:
            setattr(_StridedShard, name, raw)


def fake_mode():
    """A ``FakeTensorMode`` that :func:`count_step` counts under: build a
    step's inputs inside it (``with fake_mode() as mode: ...``), then
    pass it to :func:`count_step` with them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class CountingFakeMode(FakeTensorMode):
        """Counts the operators it runs while ``counting`` is set."""
        counting = False
        stats = live = None
        paused = [0]
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if self.counting and not self.paused[0]:
                self._count(func, args, kwargs, out)
            return out

        def _count(self, func, args, kwargs, out):
            from repro_torch.parallel.context import is_dtensor
            if any(is_dtensor(t) for t in _tensors((args, kwargs))):
                return      # DTensor's own call: its local ops follow
            stats = self.stats
            self.ops += 1
            name = func._schema.name.split("::")[-1]
            if func.namespace == "repro_torch":
                nbytes, flops, ops = _kernel_work(name, args)
                stats.hbm_bytes += nbytes
                stats.flops += flops
                stats.sc_ops += ops
            elif func.namespace == "_c10d_functional":
                if name in _COLLECTIVES:
                    nbytes = sum(_nbytes(t) for t in _tensors(out))
                    stats.add(_COLLECTIVES[name], nbytes)
                    stats.hbm_bytes += 2 * nbytes
            elif name not in _FREE:
                if name in _MATMULS:
                    a, b = args[-2], args[-1]
                    stats.flops += 2.0 * a.numel() * b.shape[-1]
                stats.hbm_bytes += _local_op_bytes(func, (args, kwargs), out)
            for t in _tensors(out):
                if t.device.type != "meta":
                    self.live.made(t)

    return CountingFakeMode(allow_non_fake_inputs=True)


def count_step(fn, *args, mode) -> tuple[Any, StepCount]:
    """Run ``fn(*args)`` as rank 0 under ``mode`` (a :func:`fake_mode`,
    which the arguments were made in) and count what it does (module
    docstring). Returns (its outputs, the :class:`StepCount`)."""
    from repro_torch.parallel.context import is_dtensor

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    arg_storages = {}
    for t in _tensors(args):
        st = local(t).untyped_storage()
        arg_storages[id(st)] = st.nbytes()
    mode.stats, mode.live, mode.ops = CollectiveStats(), _Live(), 0
    mode.live.seen.update(arg_storages)
    mode.paused = [0]
    with mode, _dtensor_hooks(mode.paused):
        mode.counting = True
        try:
            out = fn(*args)
        finally:
            mode.counting = False
    fresh, alias = {}, {}
    for t in _tensors(out):
        st = local(t).untyped_storage()
        (alias if id(st) in arg_storages else fresh)[id(st)] = st.nbytes()
    out_bytes = sum(fresh.values())
    return out, StepCount(stats=mode.stats,
                          argument_bytes=sum(arg_storages.values()),
                          output_bytes=out_bytes,
                          alias_bytes=sum(alias.values()),
                          temp_bytes=max(mode.live.peak - out_bytes, 0),
                          ops=mode.ops)
