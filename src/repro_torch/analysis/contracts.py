"""Contract audits of the port: what the AST lints cannot see.

The lints catch what code *says*; these audits run the code and check
what it *does*. PyTorch has no jaxpr, so where the JAX package traced a
function (``repro/analysis/contracts.py``), an audit here runs it on
small inputs under a ``TorchDispatchMode`` (:func:`record_ops`) and reads
every ATen operator it dispatched: its name, output dtypes and, for a
reduction, the length of the axis it reduced. The engine audits run short
schedules and read the engine's own counters.

* :func:`audit_popcount_path` — the deterministic-SC claim: the stream
  multiplier (``ops.sc_stream_mul``; the CUDA kernel on the card) makes
  only integer and bool tensors and counts what its plain version counts,
  its CUDA source names no floating-point type, and the SC-GEMM closed
  form (``sc_matmul_reference``, ``sc_matmul_mxu_split``) makes no
  float16 or bfloat16 tensor anywhere.
* :func:`audit_reduction_parity` — the port's form of einsum parity: the
  paged plain version and the gathered dense decode attention reduce
  their scores over D and their PV over keys with the same reduction
  structure (:func:`reductions`: the same sequence of reductions over
  axes of the same padded length), all in float32, and give the same
  bits; on the card both also run the one paged kernel. GQA and full-MHA.
* :func:`audit_capture_counts` — the port's form of compile counts: a
  mixed-length schedule makes at most one prefill step (and capture) per
  prompt bucket and exactly one decode entry, captured once; a second
  engine of the shape on the same schedule captures nothing and streams
  the same tokens. On the CPU, where no graph can be captured,
  ``steps.capture`` is swapped for the duration for a stand-in that only
  counts (the tests' double), so the step cache is what is audited.
* :func:`audit_cow_protocol` — the prefix cache's sharing contract:
  stepped by hand through a shared-prefix schedule, the refcount ledger
  equals the block-table references plus the staging pins, every live
  slot's next write page is writable, the schedule shares (hits and a
  copy-on-write copy) and the drain leaks nothing.

Run as ``PYTHONPATH=src python -m repro_torch.analysis.contracts
[--device cpu|cuda]``: the card by default, which must be there (no
silent CPU run); exit 1 on any violated contract.
"""
from __future__ import annotations

import argparse
import contextlib
import re
import sys
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import resolve_device
from repro_torch.errors import (ConfigError, EngineInvariantError,
                                PrefixCacheInvariantError)

__all__ = ["OpRecord", "record_ops", "half_precision_ops", "reductions",
           "audit_popcount_path", "audit_reduction_parity",
           "audit_capture_counts", "audit_cow_protocol", "cow_prompts",
           "audit_config", "AUDITS", "run_audits", "main"]

_HALF = (torch.float16, torch.bfloat16)
#: Operators that sum or take an extreme over an axis, by their ATen
#: packet name; their reduced length is input elements over output
#: elements (contractions: the inner axis).
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod",
           "logsumexp", "_softmax", "nansum", "std", "var"}
_CONTRACT = {"mm", "bmm", "addmm", "baddbmm", "dot", "mv"}


# ------------------------------------------------------------ recording

@dataclass(frozen=True)
class OpRecord:
    """One dispatched operator: ``name`` (``aten.add.Tensor``), the
    dtypes of its tensor outputs, and ``reduced``, the padded
    length of the axis it reduced: a reduction's input elements over its
    output elements, a contraction's inner axis, or for a pairwise
    halving add (:func:`repro_torch.models.layers.tree_sum`'s level: two
    adjacent halves of one tensor along an axis) twice the half's length;
    None for any other operator."""
    name: str
    dtypes: tuple[torch.dtype, ...]
    reduced: int | None = None

    @property
    def packet(self) -> str:
        return self.name.split(".")[1] if "." in self.name else self.name


def _halving(a: torch.Tensor, b: torch.Tensor) -> int | None:
    """Twice the halves' length when ``a`` and ``b`` are the two adjacent
    halves of one tensor along an axis (``x.narrow(d, 0, p)`` and
    ``x.narrow(d, p, p)``), else None."""
    if (a.shape != b.shape or a.device != b.device or a.dim() == 0
            or a.untyped_storage().data_ptr()
            != b.untyped_storage().data_ptr()):
        return None
    gap = b.storage_offset() - a.storage_offset()
    axes = [i for i in range(a.dim())
            if a.shape[i] and gap == a.shape[i] * a.stride(i)]
    if not axes:
        return None
    # halves of length 1 also match an inner axis of the same extent;
    # the halved axis is the outer one (the largest stride)
    return 2 * a.shape[max(axes, key=a.stride)]


def _outputs(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    return []


def _reduced(packet: str, args, outs) -> int | None:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if packet == "add" and len(tensors) == 2:
        return _halving(*tensors)
    if packet in _REDUCE and tensors and outs:
        return max(tensors[0].numel(), 1) // max(outs[0].numel(), 1)
    if packet in _CONTRACT and tensors:
        inner = tensors[-2] if packet in ("addmm", "baddbmm") else tensors[0]
        return inner.shape[-1] if inner.dim() else 1
    return None


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _outputs(out)
        name = str(func)
        packet = name.split(".")[1] if "." in name else name
        self.records.append(OpRecord(name, tuple(t.dtype for t in outs),
                                     _reduced(packet, args, outs)))
        return out


def record_ops(fn: Callable, *args, **kwargs) -> tuple[Any, list[OpRecord]]:
    """``fn(*args, **kwargs)`` and every ATen operator it dispatched, in
    order. A custom operator (the kernels' ``repro_torch::*``) is one
    record: what its implementation runs is not seen."""
    with _Recorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.records


def half_precision_ops(records: list[OpRecord]) -> list[str]:
    """Lines naming every operator that made a float16 or bfloat16
    tensor (empty == the path is free of half precision)."""
    return [f"{r.name} -> {dt}" for r in records for dt in r.dtypes
            if dt in _HALF]


def reductions(records: list[OpRecord]) -> list[tuple[str, int, str]]:
    """The reduction structure: ``(operator, reduced length, dtype)`` of
    every reduction, contraction and pairwise halving add, in order."""
    return [(r.packet, r.reduced, str(r.dtypes[0]).replace("torch.", ""))
            for r in records if r.reduced is not None and r.dtypes]


# --------------------------------------------------------------- audits

def _seeded(shape, seed: int, dev, dtype=torch.float32) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=dev)


def audit_popcount_path(device=None, bits: int = 8) -> list[str]:
    """No float tensor in the stream multiplier, counts equal to its
    plain version, no floating-point type in its CUDA source; no
    half-precision tensor in the SC-GEMM closed form."""
    import importlib
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.sc_bitops import sc_stream_mul_torch

    # the module: the package's ``sc_matmul`` is the function
    sc_matmul = importlib.import_module("repro_torch.core.sc_matmul")
    dev = resolve_device(device)
    problems: list[str] = []
    rng = np.random.default_rng(0)
    x, y = (torch.as_tensor(rng.integers(0, 1 << bits, (8, 128)),
                            dtype=torch.int32, device=dev) for _ in range(2))
    counts, records = record_ops(ops.sc_stream_mul, x, y, bits=bits)
    for r in records:
        for dt in r.dtypes:
            if dt.is_floating_point or dt.is_complex:
                problems.append(
                    f"popcount path: {r.name} produces {dt} — the stream "
                    f"multiplier must be integer-only")
    want = sc_stream_mul_torch(x.cpu(), y.cpu(), bits=bits)
    if counts.dtype != torch.int32 or not torch.equal(counts.cpu(), want):
        problems.append(
            f"popcount path: ops.sc_stream_mul on {dev} ({counts.dtype}) "
            f"differs from its plain version at "
            f"{int((counts.cpu() != want).sum())} of {want.numel()} pairs")
    source = (build.CSRC / "sc_bitops.cu").read_text()
    floats = sorted(set(re.findall(
        r"\b(float\w*|double|__half\w*|__nv_bfloat16|__fdiv\w*|rintf?"
        r"|powf?)\b", source)))
    if floats or "__popc" not in source:
        problems.append(
            f"popcount path: sc_bitops.cu names {floats or 'no __popc'} — "
            f"the stream kernel must popcount integer words only")

    a = _seeded((16, 32), 1, dev)
    b = _seeded((32, 8), 2, dev)
    for name in ("sc_matmul_reference", "sc_matmul_mxu_split"):
        fn = getattr(sc_matmul, name)
        _, records = record_ops(fn, a, b, bits=bits)
        for cast in half_precision_ops(records):
            problems.append(f"{name}: {cast} on the SC popcount path")
    return problems


def _decode_args(c: int, kv: int, g: int, d: int, block: int,
                 max_blocks: int, dev):
    """A paged pool of ``c`` slots with their own pages (the last page is
    the trash page) and its gathered dense view, seeded."""
    n_pages = c * max_blocks + 1
    q = _seeded((c, kv, g, d), 3, dev)
    k_pages = _seeded((n_pages, block, kv, d), 4, dev)
    v_pages = _seeded((n_pages, block, kv, d), 5, dev)
    tables = torch.arange(c * max_blocks, dtype=torch.int32,
                          device=dev).reshape(c, max_blocks)
    pos = torch.full((c,), block + 1, dtype=torch.int32, device=dev)
    s = block * max_blocks
    dense = [p[tables.long()].reshape(c, s, kv, d) for p in (k_pages,
                                                            v_pages)]
    return q, k_pages, v_pages, tables, pos, dense


def audit_reduction_parity(device=None) -> list[str]:
    """The paged plain version and the gathered dense decode attention
    reduce alike, in float32, to the same bits; on the card the paged
    kernel and the dense path's kernel route are one operator."""
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.models import layers

    dev = resolve_device(device)
    problems: list[str] = []
    for label, (kv, g) in (("GQA", (2, 2)), ("full-MHA", (4, 1))):
        c, d, block, max_blocks = 2, 16, 8, 2
        q, k_pages, v_pages, tables, pos, (k, v) = _decode_args(
            c, kv, g, d, block, max_blocks, dev)
        out_p, rec_p = record_ops(
            lambda: paged.paged_attention_torch(q, k_pages, v_pages, tables,
                                                pos))
        # the gathered dense path as the models run it on the CPU; on the
        # card decode_attention is the kernel (below), so its plain
        # formulation is called by name
        dense = layers.decode_attention if dev.type == "cpu" \
            else layers._decode_attention_plain
        out_d, rec_d = record_ops(
            lambda: dense(q.reshape(c, 1, kv * g, d), k, v,
                          q_position=pos.long()))
        red_p, red_d = reductions(rec_p), reductions(rec_d)
        if red_p != red_d:
            problems.append(
                f"reduction parity ({label}): paged plain version reduces "
                f"{red_p} != gathered dense path {red_d}")
        for source, red in (("paged plain version", red_p),
                            ("dense path", red_d)):
            for op, n, dtype in red:
                if dtype != "float32":
                    problems.append(
                        f"reduction parity ({label}): {source} {op} over "
                        f"{n} accumulates in {dtype}, not float32")
        if not torch.equal(out_p.reshape(out_d.shape), out_d):
            problems.append(
                f"reduction parity ({label}): paged plain version and "
                f"dense path differ by "
                f"{float((out_p.reshape(out_d.shape) - out_d).abs().max())}")
        if dev.type != "cuda":
            continue
        # the kernel routes: the tuner's plan looked up once outside the
        # recording, so what is recorded is the call itself
        for _ in range(2):
            out_k, rec_k = record_ops(
                lambda: paged.paged_attention(q, k_pages, v_pages, tables,
                                              pos))
            out_dk, rec_dk = record_ops(
                lambda: layers.decode_attention(q.reshape(c, 1, kv * g, d),
                                                k, v, q_position=pos))
        kernels = [[r.name for r in rec if r.name.startswith("repro_torch")]
                   for rec in (rec_k, rec_dk)]
        if kernels[0] != ["repro_torch.paged_attention.default"] \
                or kernels[1] != kernels[0]:
            problems.append(
                f"reduction parity ({label}): paged kernel route "
                f"{kernels[0]} != dense kernel route {kernels[1]}")
        if not torch.equal(out_k.reshape(out_dk.shape), out_dk):
            problems.append(
                f"reduction parity ({label}): the paged kernel over pages "
                f"and over the dense view differ by "
                f"{float((out_k.reshape(out_dk.shape) - out_dk).abs().max())}")
    return problems


def audit_config(name: str):
    """The JAX package's tiny dense audit config (SC-GEMM on, float32)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=name, family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        dtype="float32", q_block=16, kv_block=16, loss_chunk=16,
        remat=False, use_sc_gemm=True).validate()


def _weights(cfg, params, dev):
    from repro_torch.models import bind
    return bind(cfg, dev).init_params(0) if params is None else params


@contextlib.contextmanager
def _graph_captures(dev: torch.device) -> Iterator[None]:
    """Graphed engines on ``dev``: on the card the real capture; on the
    CPU ``steps.capture`` swapped for a stand-in that counts captures and
    leaves the step eager, restored on exit."""
    from repro_torch.launch import steps
    if dev.type == "cuda":
        yield
        return

    def count(step):
        step.captures += 1

    real = steps.capture
    steps.capture = count
    try:
        yield
    finally:
        steps.capture = real


def audit_capture_counts(device=None, *, cfg=None,
                         params=None) -> list[str]:
    """A mixed-length schedule stays within one prefill step (and
    capture) a prompt bucket and one decode entry captured once; a second
    engine of the shape captures nothing. ``cfg``/``params`` default to
    :func:`audit_config`'s model and seed-0 weights."""
    from repro_torch.launch import steps
    from repro_torch.serving import Engine, Request

    dev = resolve_device(device)
    cfg = cfg or audit_config("contract-audit-dense")
    params = _weights(cfg, params, dev)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(s,)).astype(np.int32)
               for s in (3, 5, 9, 12)]
    shape = dict(capacity=2, max_seq=32, chunk=4)

    def run(tag):
        engine = Engine(cfg, params, device=dev, graphs=True, **shape)
        res = engine.run([Request(uid=f"{tag}-{i}", prompt=p,
                                  max_new_tokens=4)
                          for i, p in enumerate(prompts)])
        return engine, res

    problems: list[str] = []
    steps.drop_decode_steps(cfg)
    try:
        with _graph_captures(dev):
            first, res1 = run("audit")
            entries1 = [s for k, s in steps.decode_steps().items()
                        if k[0] == cfg]
            prefills1 = len(first.prefill_steps())
            second, res2 = run("again")
            entries2 = [s for k, s in steps.decode_steps().items()
                        if k[0] == cfg]
    finally:
        steps.drop_decode_steps(cfg)
    buckets = first.stats["buckets"]
    for what, n in (("prefill steps", prefills1),
                    ("prefill captures", first.stats["prefill_captures"]),
                    ("prefill steps after a second engine",
                     len(second.prefill_steps()))):
        if n > len(buckets):
            problems.append(
                f"capture count: {n} {what} exceeds the bucket bound "
                f"len({buckets}) = {len(buckets)}")
    for when, entries in (("after the schedule", entries1),
                          ("after a second engine", entries2)):
        if len(entries) != 1 or entries[0].captures != 1:
            problems.append(
                f"capture count: {len(entries)} decode entries for the "
                f"shape {when}, captured "
                f"{[e.captures for e in entries]} times — expected exactly "
                f"one, captured once")
    if second._decode is not first._decode:
        problems.append("capture count: the second engine of the shape "
                        "made its own decode entry")
    if second.stats["prefill_captures"] or \
            len(second.prefill_steps()) != prefills1:
        problems.append(
            f"capture count: a second run of the schedule captured "
            f"{second.stats['prefill_captures']} prefill steps "
            f"({len(second.prefill_steps())} steps against {prefills1}) — "
            f"expected none")
    for a, b in zip(res1, res2):
        if not np.array_equal(a.tokens, b.tokens):
            problems.append(f"capture count: {b.uid}'s stream differs from "
                            f"the first run's {a.uid}")
    return problems


def cow_prompts(vocab: int) -> list[np.ndarray]:
    """The shared-prefix schedule's prompts: two identical 16-token
    prompts (an aligned full match: a copy-on-write at admission) and one
    sharing their first 8 tokens."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, vocab, size=(16,)).astype(np.int32)
    return [base.copy(), base.copy(),
            np.concatenate([base[:8], rng.integers(0, vocab, size=(6,))
                            .astype(np.int32)])]


def cow_engine(cfg, params, dev):
    """The schedule's engine, its requests queued: block 8 > chunk 4, so
    the chunk-aligned resume lands mid-page and the aligned full match
    copies a real page at admission."""
    from repro_torch.serving import Engine, Request
    engine = Engine(cfg, params, capacity=2, max_seq=32, block=8, chunk=4,
                    device=dev)
    for i, p in enumerate(cow_prompts(cfg.vocab_size)):
        engine.queue.submit(Request(uid=f"cow-{i}", prompt=p,
                                    max_new_tokens=5))
    return engine


def audit_cow_protocol(device=None, *, cfg=None, params=None) -> list[str]:
    """A shared-prefix schedule never writes into a shared (refcount > 1)
    or prefix-retained page without a preceding copy, and the refcount
    ledger stays the block tables' references plus the staging pins."""
    from repro_torch.launch import steps

    dev = resolve_device(device)
    cfg = cfg or audit_config("contract-audit-prefix")
    params = _weights(cfg, params, dev)
    steps.drop_decode_steps(cfg)
    try:
        return _cow_protocol(cow_engine(cfg, params, dev))
    finally:
        steps.drop_decode_steps(cfg)


def _cow_protocol(engine) -> list[str]:
    pool = engine.pool
    problems: list[str] = []

    def check_step(step_ix: int) -> None:
        refs = np.zeros(pool.n_blocks, np.int64)
        for slot in pool.entries:
            live = pool.tables[slot][pool.tables[slot] >= 0]
            np.add.at(refs, live, 1)
        st = engine._staging
        if st is not None and st.match is not None:
            np.add.at(refs, np.asarray(st.match.pages), 1)
        if not np.array_equal(refs, pool.refcount):
            problems.append(
                f"cow protocol: step {step_ix}: refcount ledger "
                f"{pool.refcount.tolist()} != table references + pins "
                f"{refs.tolist()}")
        for slot, entry in pool.entries.items():
            page = int(pool.tables[slot, entry.next_write_pos // pool.block])
            if page >= 0 and not pool.writable(page):
                problems.append(
                    f"cow protocol: step {step_ix}: slot {slot} "
                    f"({entry.request.uid!r}) would write page {page} with "
                    f"refcount {int(pool.refcount[page])} "
                    f"(retained={page in pool.retained}) without a copy")

    step_ix = 0
    check_step(step_ix)
    try:
        while engine.step():
            step_ix += 1
            check_step(step_ix)
    except (EngineInvariantError, PrefixCacheInvariantError) as e:
        # the pool's own ledger check caught the break first
        problems.append(f"cow protocol: step {step_ix + 1}: the engine "
                        f"raised {type(e).__name__}: {e}")
        return problems

    if engine._n_prefix_hits < 2:
        problems.append(
            f"cow protocol: schedule produced {engine._n_prefix_hits} "
            f"prefix hits — the audit never exercised sharing")
    if pool.n_cow < 1:
        problems.append(
            "cow protocol: schedule produced no CoW copy — the aligned "
            "full match must copy the resume page at admission")
    if (pool.refcount != 0).any():
        problems.append(
            f"cow protocol: drained pool leaks references "
            f"{pool.refcount.tolist()}")
    if pool.free_pages + len(pool.retained) != pool.n_blocks:
        problems.append(
            f"cow protocol: drained pool leaks pages — {pool.free_pages} "
            f"free + {len(pool.retained)} retained != {pool.n_blocks}")
    return problems


# ----------------------------------------------------------------- main

AUDITS: tuple[tuple[str, Callable[..., list[str]]], ...] = (
    ("popcount-path", audit_popcount_path),
    ("reduction-parity", audit_reduction_parity),
    ("capture-counts", audit_capture_counts),
    ("cow-protocol", audit_cow_protocol),
)


def run_audits(device=None) -> list[str]:
    """Every audit on ``device`` (the card by default), a ``[PASS]`` or
    ``[FAIL]`` line each; returns every problem found."""
    dev = resolve_device(device)
    problems: list[str] = []
    for name, audit in AUDITS:
        found = audit(dev)
        status = "FAIL" if found else "PASS"
        print(f"[{status}] contract audit: {name} ({dev})")
        for p in found:
            print(f"       {p}")
        problems.extend(found)
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.contracts",
        description="the port's contract audits (the card by default)")
    p.add_argument("--device", choices=("cpu", "cuda"), default=None,
                   help="where to run (default: the card, which must be "
                        "there; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except ConfigError as e:
        print(f"repro-torch-analysis contracts: {e}", file=sys.stderr)
        return 2
    problems = run_audits(dev)
    n = len(problems)
    print(f"repro-torch-analysis contracts: {n} violation"
          f"{'' if n == 1 else 's'}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
