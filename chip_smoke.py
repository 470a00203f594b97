#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts on
the GPU: builds its CUDA kernels from this checkout's sources, holds each
kernel against its plain PyTorch version on the card, runs the paper's
multiplier over exhaustive operand grids and its Table II / Fig. 1(b)
rows, then serves requests through the port's engine at smollm-360m's
full width — float attention, then SC attention — and at mamba2-130m's
and zamba2-7b's (the ssm and hybrid families), and checks the streams
against the sequential baseline.

    python3 chip_smoke.py            # one CUDA card; ~8 minutes
    python3 chip_smoke.py --only build,flash   # a subset, for debugging

Phases (each raises on failure, so any failure exits non-zero):

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. build the four kernels (one ``nvcc`` per source, started together;
   each library keyed by its source and the shared header);
3. SC-GEMM: the counts entry exactly equal to its plain version at the
   main path's shapes, ragged shapes and other plane widths; the fused
   projection (rows quantized in the kernel, a weight packed once, output
   dequantized) bit-equal to its plain version and to the unfused chain
   at every smollm-360m decode and prefill shape (M = 1, 4, 16, 64),
   ragged shapes, bits 1-8 and 16, f32 and bf16, rows holding a NaN or an
   Inf; rows equal their 1-row calls; per shape at M = 4, 16 and 64 the
   fused call's ms and device ms, the old chain's, plain and bound ms; a
   decode step's device ms at 1, 2 and 4 blocks per SM (the K split);
   then mamba2-130m's and zamba2-7b's shapes (K up to 14,336, N up to
   32,000) at M = 1, 4, 128 and 256, bit-equal to the plain version, and
   at M = 4 and 128 timed and summed to a decode step and a prefill chunk
   of each;
4. paged decode-attention kernel vs its plain version at smollm's layout,
   f32 and bf16, float and SC at 4 and 8 bits, fragmented tables, windows,
   a single-KV-head layout (SC), zamba2-7b's layout (KV 32, G 1, D 112;
   float and SC); kernel ms, device ms, plain and bound ms
   of both paths at the serve shape (MB 4) and a long context (MB 64, up
   to 4,096 keys); then bitwise paging invariance (block 16, 32, 48, 64,
   256 and the dense view) and batch invariance (a slot alone against
   four together), any difference failing the phase;
5. flash-attention kernel vs its plain version: f32 and bf16, float and SC
   at 4 and 8 bits, D 64, 112 and 128, G 3, 2 and 1, ragged Sq/Skv,
   smollm's and zamba2-7b's one-shot and chunked shapes (a 128-row chunk
   over the 384-position bucket timed), and the long prompts L1-L3 (2,048 tokens:
   smollm one-shot, its last chunk, qwen2-7b's width; bf16, float and SC);
   kernel (back to back and device), plain, bound and (float)
   ``scaled_dot_product_attention`` ms at the serve shapes and L1-L3 (a
   chunk call with its offset as an int32 on the card, as a captured
   chunk passes it, the host offset's device ms beside it); every offset
   read on the card must give the host offset's bits; then chunked rows
   must equal one-shot rows bit for bit through the kernel, with garbage
   or NaN in the staging cache past the chunk (smollm's 16-row chunks and
   zamba2-7b's 128-row ones);
6. the bit-parallel stream kernel through ``ops.sc_stream_mul`` on every
   operand pair at B = 5, 6, 7, 8, 10 and 12 (16,777,216 pairs), counter
   set to 0 just before: counts exactly equal to the plain version and
   the closed form (and the bit-level oracle at B <= 8); seeded samples
   of 2^20 pairs at B = 9, 11 and 16, ragged sizes 1, 31 and 100,003, 3-D
   shapes, a view at storage offset 1, empty operands, block widths
   1/4/8; kernel (back to back and device), plain and bound ms at B = 8,
   10 and 12;
7. ``launch.paper``'s Table II and Fig. 1(b) rows on the card, each equal
   to the same row computed on the CPU;
8. a reduced smollm-360m (float32) cross-check: prefill logits on the
   card agree with the CPU's, and the engine's streams on both are
   compared;
9. serve 8 requests at full width (smollm-360m, bf16, SC-GEMM on, random
   weights from seed 0) through ``Engine(capacity=4, max_seq=256, block=64,
   chunk=16)``, first with ``graphs=False`` (every step dispatched
   operator by operator), then graphed (the default on the card: each
   decode step one replay of the shape's captured CUDA graph, captured
   once when the engine is built, and each prefill chunk or one-shot
   prefill one replay of its shape's graph, captured at first use) twice
   on one engine, the first run capturing its prefill shape and the
   second none; for each run, the launch counters, set to 0 just before,
   must show the kernels on every decode step and prefill chunk (and a
   capture's warm-up runs), exactly one fused SC-GEMM launch per
   projection, one capture a prefill shape, one replay a prefill call and
   225 SC-GEMM and 32 flash launches a prefill replay; streams must equal
   the sequential ``generate`` baseline on the card; decode ms/step,
   tokens/s, TTFT p50 and peak memory side by side (eager against the
   graphed second run);
10. the same with SC attention at 8 bits, chunked and then one-shot
    prefill, each against the sequential baseline;
11. ``serve_spec``: the ``serve`` cell's model, requests and baseline
    served by self-speculative rounds, ``(k, draft_bits)`` = (3, 4) with
    ``graphs=False``, then (1, 4), (3, 4) and (3, 8) graphed, and the
    ``serve_sc`` cell (SC attention at 8 bits) drafting at 8 bits, graphed
    (each graphed engine's second run is the cell): streams must equal
    the sequential baseline; the counters, set to 0 just before each
    run, must show ``k`` x 225 + 225 SC-GEMM and ``32 k + 32`` paged
    launches a round, ``32 k`` of them on the SC path (all of them in the
    ``serve_sc`` cell), and the prefill's; graphed, the draft, verify and
    rollback steps each captured once, when the engine is built, and
    replayed once a round; the ``serve_sc`` cell's draft is the exact
    model, so every proposal within a slot's budget must equal the
    verify's argmax and be accepted; tokens/s, TTFT p50, ms a round, the
    draft's and the verify's device µs a round (CUDA events), acceptance,
    tokens a round, peak memory and the draft's packed weights, beside
    the non-speculative cells' graphed tokens/s;
12. ``serve_prefix``: the reference's default serve, prefix cache on, over
    one shared 128-token preamble (cache off, eager, graphed cold and
    warm, speculative, a rebind), its stats held to the script's plan;
13. a ``torch.profiler`` pass over two full-width decode steps, eager and
    then graphed, and over two chunks of a 240-token prompt's chunked
    prefill, eager and then graphed: device time by kernel, host time by
    operator, kernel launches, host API calls and synchronizations per
    step or chunk, the device's busy share, the graphed step's and
    chunk's wall split, and the kernel records of the graphed steps and
    chunks against the launches their capture recorded;
14. ``serve_ssm`` and ``serve_hybrid``: mamba2-130m and zamba2-7b as
    registered, whole (zamba2-7b's 81 layers and 27 shared-block sites;
    nothing cut), SC-GEMM at 8 bits, float attention, random weights
    from seed 0: 8 requests of 128- and 256-token prompts (whole
    ``ssm_chunk``s) and 16-64 new tokens through ``Engine(capacity=4,
    max_seq=384, block=64, chunk=128)``, chunked then one-shot, each eager
    and then graphed twice on one engine; every run against the
    sequential baseline, the counters showing one SC-GEMM launch a
    projection (48 a step or chunk for mamba2-130m, 352 for zamba2-7b) and
    one paged or flash launch a site; tokens/s, TTFT p50, decode ms/step,
    a 128-row prefill chunk's ms (eager and graphed), peak memory,
    launches, and a ``torch.profiler`` pass over two graphed decode steps
    (device time by kernel; kernel records held to the capture's
    launches), taken before the serving runs.

The line before the last is a JSON object with one entry per kernel,
its ``launches`` the sum over every serving run of phases 9-12 and 14 (the
attention kernels' float and SC entries split as their wrappers counted
them); the last line is ``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json`` (``$CHIP_SMOKE_OUT`` names another directory).
Nothing of JAX or of the JAX package is imported.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# where the full report goes ($CHIP_SMOKE_OUT overrides; build/ is ignored)
OUT_DIR = Path(os.environ.get("CHIP_SMOKE_OUT", ROOT / "build"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8 and bf16
# tensor-core ops/s, float32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
BF16_OPS_S = 989e12
FP32_OPS_S = 67e12

# population counts (__popc) per clock per SM at compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic-instruction throughput table)
POPC_PER_CLK_SM = 16

# smollm-360m projection shapes (K, N) and their calls per decode step:
# q, o (960, 960); k, v (960, 320); w1, w3 (960, 2560); w2 (2560, 960) in
# each of 32 layers, and the tied LM head (960, 49152) once.
SC_SHAPES = {(960, 960): 64, (960, 320): 64, (960, 2560): 64,
             (2560, 960): 32, (960, 49152): 1}
N_LAYERS = 32

# The family cells' projection shapes (K, N) and their calls per decode
# step. mamba2-130m: in_proj (768, 3352) and out_proj (1536, 768) in each
# of 24 layers (its tied head is a float product). zamba2-7b: in_proj
# (3584, 14576) and out_proj (7168, 3584) in each of 81 Mamba layers;
# q, k, v, o (3584, 3584), w1, w3 (3584, 14336) and w2 (14336, 3584) at
# each of 27 shared-block sites; the head (3584, 32000) once.
FAMILY_SC_SHAPES = {
    "mamba2-130m": {(768, 3352): 24, (1536, 768): 24},
    "zamba2-7b": {(3584, 14576): 81, (7168, 3584): 81, (3584, 3584): 108,
                  (3584, 14336): 54, (14336, 3584): 27, (3584, 32000): 1}}
#: the row counts the family cells send through those shapes (each held
#: bit-equal to the plain version), and the ones timed
FAMILY_SC_ROWS = (1, 4, 128, 256)
FAMILY_SC_TIMED = (4, 128)


def log(msg: str) -> None:
    print(msg, flush=True)


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls, CUDA events
    around the whole run, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(got, want, *, rtol, atol, v=None, bits=None, what=""):
    """Kernel vs plain version. Float: ``allclose(rtol, atol)``. SC: the
    scores and planes repeat the plain float32 operations one for one, so
    the same tolerance holds for all but 1% of the elements; a probability
    within an ulp of a rounding boundary may move one magnitude step, so
    no element may differ by more than one output quantization step
    ``max|v| / (2**bits - 1)`` plus the float tolerance. Returns the max
    abs error."""
    import torch
    from repro_torch.kernels.flash_attention import sc_tolerance
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = err.max().item() if err.numel() else 0.0
    loose = ~torch.isclose(got, want, rtol=rtol, atol=atol)
    if bits is None:
        ok = not bool(loose.any())
    else:
        step = sc_tolerance(v, bits)
        ok = (worst <= step + atol + rtol * want.abs().max().item()
              and loose.float().mean().item() <= 0.01)
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max abs err {worst}")
    return worst


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_card() -> str:
    out = _card_line()
    log(out)
    return out


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build()
    total = time.perf_counter() - t0
    log(f"[build] {total:.1f}s wall for {', '.join(build.SOURCES)} "
        f"(per source: " + ", ".join(f"{k} {v:.1f}s" for k, v in
                                     seconds.items()) + ")")
    logs = {name: build.ptxas_log(name) for name in build.SOURCES}
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"wall_s": total, "per_source_s": seconds, "ptxas": logs}


def _planes(m, k, n, bits, gen, dev):
    """Signed planes of quantized random-normal operands, as the model
    makes them (per-row A scales, per-tensor B scale)."""
    import torch
    from repro_torch.core.sc_numerics import quantize_sign_magnitude
    from repro_torch.kernels.sc_matmul import pack_signed
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    qa = quantize_sign_magnitude(a, bits=bits, axis=-1)
    qb = quantize_sign_magnitude(b, bits=bits)
    return (pack_signed(qa.sign, qa.mag, bits),
            pack_signed(qb.sign, qb.mag, bits))


def _sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def _sc_bound(m, k, n, esz):
    """Least time of one fused projection: the rows (``esz`` bytes an
    element) and the int16 weight plane read once and the output written
    once, against ``2·M·N·K`` operations at the int8 tensor-core peak
    (the rate of the cheapest type the counts could go through). Returns
    (ms, bound_by, bytes, ops)."""
    nbytes = m * k * esz + k * (-(-n // 8) * 8) * 2 + m * n * esz + 4
    ops = 2 * m * n * k
    t_b, t_o = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations",
            nbytes, ops)


def device_ms(fn, kernel: str, iters: int = 20,
              one_launch: bool = False) -> float | None:
    """Mean device milliseconds a call of the kernels whose name holds
    ``kernel``, from a ``torch.profiler`` trace of ``iters`` calls (the
    kernel's own time, without the host's cost of a call); None when the
    trace holds no device time. ``one_launch``: each call launches one
    such kernel, so the mean is over the kernel records the trace holds
    (a trace that lost a record does not read low)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in found)
    calls = sum(e.count for e in found) if one_launch else iters
    return us / 1e3 / calls if us > 0 else None


def phase_sc_gemm() -> dict:
    """SC-GEMM on the card. The counts entry (signed planes in, float32
    counts out) must equal its plain version exactly at the main path's
    shapes, ragged shapes and other plane widths. The fused projection
    (``sc_linear``: rows quantized in the kernel, a weight packed once,
    dequantized output) must equal its plain version bit for bit at every
    smollm-360m decode and prefill shape (M = 1, 4, 16, 64), ragged
    shapes, bits 1-8 and 16, f32 and bf16, and must equal the unfused
    chain; rows holding a NaN or an Inf must come out NaN in both. Times
    at M = 4, 16 and 64 with the weight cycled from HBM: fused, the old
    chain (quantize both operands, pack, count, dequantize, cast), the
    plain version, and the bound; then a decode step's device time with
    the K split aimed at 1, 2 and 4 blocks per SM."""
    import torch
    from repro_torch.core.sc_numerics import quantize_sign_magnitude
    from repro_torch.core.tcu import stream_length
    from repro_torch.kernels import sc_matmul as skm
    from repro_torch.kernels.sc_matmul import (pack_signed, pack_weight,
                                               plan, sc_linear,
                                               sc_linear_torch,
                                               sc_matmul_counts_signed,
                                               sc_matmul_counts_signed_torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    # the counts entry: main-path shapes, ragged shapes, other plane widths
    cases = [(m, k, n, 8) for m in (4, 16) for (k, n) in SC_SHAPES]
    cases += [(7, 1000, 333, 8), (37, 129, 65, 8), (1, 960, 960, 8),
              (64, 960, 320, 8), (4, 960, 960, 4), (4, 200, 96, 16),
              (20, 200, 99, 16), (3, 4000, 50, 12)]
    for m, k, n, bits in cases:
        a, b = _planes(m, k, n, bits, gen, dev)
        got = sc_matmul_counts_signed(a, b, bits=bits)
        want = sc_matmul_counts_signed_torch(a, b, bits=bits)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"SC-GEMM counts differ at M={m} K={k} "
                                 f"N={n} bits={bits}: {bad} entries")
        rows.append({"entry": "counts", "M": m, "K": k, "N": n,
                     "bits": bits, "exact": True})
    log(f"[sc_gemm] counts entry: {len(cases)} cases exactly equal to the "
        f"plain version")

    def chain(x, w, bits):
        """The unfused chain a projection ran before weights were packed
        once: quantize both operands, pack, count, dequantize, cast."""
        qa = quantize_sign_magnitude(x.to(torch.float32), bits=bits, axis=-1)
        qb = quantize_sign_magnitude(w.to(torch.float32), bits=bits)
        counts = sc_matmul_counts_signed(pack_signed(qa.sign, qa.mag, bits),
                                         pack_signed(qb.sign, qb.mag, bits),
                                         bits=bits)
        return (counts * (stream_length(bits) * qa.scale * qb.scale)
                ).to(x.dtype)

    # the fused projection: bit-equal to its plain version and the chain
    bf16, f32 = torch.bfloat16, torch.float32
    fused = [(m, k, n, 8, bf16) for m in (1, 4, 16, 64)
             for (k, n) in SC_SHAPES]
    fused += [(7, 1000, 333, 8, bf16), (37, 129, 65, 8, f32),
              (5, 33, 17, 8, f32), (17, 96, 200, 8, bf16),
              (20, 200, 99, 16, f32), (4, 200, 96, 16, bf16)]
    fused += [(m, 200, 96, bits, f32) for bits in range(1, 9)
              for m in (4, 20)]
    for m, k, n, bits, dtype in fused:
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(dtype)
        pw = pack_weight(w, bits)
        got = sc_linear(x, pw)
        want = sc_linear_torch(x, pw)
        ref = chain(x, w, bits)
        torch.cuda.synchronize()
        for other, what in ((want, "plain version"), (ref, "chain")):
            if got.dtype != dtype or not torch.equal(got, other):
                bad = (got != other).sum().item()
                raise AssertionError(
                    f"fused SC-GEMM differs from its {what} at M={m} K={k} "
                    f"N={n} bits={bits} {dtype}: {bad} entries")
        rows.append({"entry": "fused", "M": m, "K": k, "N": n, "bits": bits,
                     "dtype": str(dtype)[6:], "bitwise_equal": True})
    log(f"[sc_gemm] fused entry: {len(fused)} cases bit-equal to the plain "
        f"version and the unfused chain")

    # rows holding a NaN or an Inf come out NaN, as in the plain version
    for bits, dtype, k in ((8, bf16, 960), (8, f32, 960), (16, f32, 200)):
        x = torch.randn((6, k), generator=gen, device=dev)
        x[1, 5], x[3, k - 1], x[4, 0] = math.nan, math.inf, -math.inf
        x = x.to(dtype)
        pw = pack_weight(torch.randn((k, 320), generator=gen,
                                     device=dev).to(dtype), bits)
        got, want = sc_linear(x, pw), sc_linear_torch(x, pw)
        nan = torch.tensor([False, True, False, True, True, False],
                           device=dev)
        if not (torch.equal(got.isnan().all(1), nan)
                and torch.equal(got.isnan(), want.isnan())
                and torch.equal(got[~nan], want[~nan])):
            raise AssertionError(f"fused SC-GEMM rows holding NaN/Inf at "
                                 f"bits={bits} {dtype} differ from the plain "
                                 f"version")
    log("[sc_gemm] rows holding a NaN or an Inf come out NaN, as in the "
        "plain version; the other rows are bit-equal")

    # batch invariance: each row of an M-row call equals its 1-row call
    for m, (k, n) in ((4, (960, 960)), (64, (2560, 960))):
        x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
        pw = pack_weight(torch.randn((k, n), generator=gen,
                                     device=dev).to(bf16), 8)
        whole = sc_linear(x, pw)
        for i in range(m):
            if not torch.equal(whole[i:i + 1], sc_linear(x[i:i + 1], pw)):
                raise AssertionError(f"fused SC-GEMM row {i} of M={m} "
                                     f"differs from its 1-row call")
    log("[sc_gemm] every row of M=4 and M=64 calls equals its 1-row call")

    # times: bf16 rows as the model passes them, weights cycled from HBM
    # (every layer's weights evict the last one's from the 50 MB L2)
    timing = []
    for m in (4, 16, 64):
        for (k, n), calls in SC_SHAPES.items():
            x = torch.randn((m, k), generator=gen, device=dev).to(bf16)
            w = (torch.randn((k, n), generator=gen, device=dev)
                 * k ** -0.5).to(bf16)
            copies = max(1, math.ceil(128e6 / (k * n * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            pws = [pack_weight(v, 8) for v in ws]
            it = iter(range(1 << 30))
            row = {"M": m, "K": k, "N": n, "calls_per_decode_step": calls}
            mr, kc, splits = plan(m, n, k, sms)
            row.update(mr=mr, kc=kc, splits=splits,
                       blocks=-(-n // 64) * -(-m // mr) * splits)

            def call():
                return sc_linear(x, pws[next(it) % len(pws)])
            row["ms"] = cuda_ms(call, iters=50)
            row["device_ms"] = device_ms(call, "sc_gemm_kernel")
            row["chain_ms"] = cuda_ms(lambda: chain(
                x, ws[next(it) % len(ws)], 8), iters=10)
            row["plain_ms"] = cuda_ms(lambda: sc_linear_torch(x, pws[0]),
                                      iters=2, warmup=1)
            bound, by, nbytes, ops = _sc_bound(m, k, n, 2)
            row.update(bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            timing.append(row)
            log(f"[sc_gemm] M={m:2d} K={k:4d} N={n:5d} ({row['blocks']} "
                f"blocks, {splits} K splits): fused {row['ms']:.4f} ms a "
                f"call, device {_ms(row['device_ms'])}, old chain "
                f"{row['chain_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
                f"bound {bound:.4f} ms ({by})")

    def per_step(m, key):
        vals = [r[key] for r in timing if r["M"] == m]
        if None in vals:
            return None
        return sum(r["calls_per_decode_step"] * v for r, v in
                   zip((r for r in timing if r["M"] == m), vals))

    step = {key: per_step(4, key) for key in
            ("ms", "device_ms", "chain_ms", "plain_ms", "bound_ms")}
    log(f"[sc_gemm] one decode step (M=4, {sum(SC_SHAPES.values())} fused "
        f"calls): {step['ms']:.3f} ms of calls, device "
        f"{_ms(step['device_ms'])}; old chain {step['chain_ms']:.3f} ms, "
        f"plain {step['plain_ms']:.1f} ms, bound {step['bound_ms']:.4f} ms")
    prefill = {}
    for m in (16, 64):
        prefill[m] = {key: per_step(m, key) for key in
                      ("ms", "device_ms", "chain_ms", "bound_ms")}
        p = prefill[m]
        log(f"[sc_gemm] one prefill pass at M={m} (225 calls): "
            f"{p['ms']:.3f} ms of calls, device {_ms(p['device_ms'])}; old "
            f"chain {p['chain_ms']:.3f} ms, bound {p['bound_ms']:.4f} ms")

    # the K split's aim (kernels/sc_matmul.py BLOCKS_PER_SM): a decode
    # step's device time at 1, 2 and 4 blocks per SM, weights cycled
    aim = skm.BLOCKS_PER_SM
    split_sweep = {1: 0.0, 2: 0.0, 4: 0.0}
    try:
        for (k, n), calls in SC_SHAPES.items():
            x = torch.randn((4, k), generator=gen, device=dev).to(bf16)
            pws = [pack_weight(torch.randn((k, n), generator=gen,
                                           device=dev).to(bf16), 8)
                   for _ in range(max(1, math.ceil(128e6 / (k * n * 2))))]
            it = iter(range(1 << 30))
            for bps in split_sweep:
                skm.BLOCKS_PER_SM = bps
                dms = device_ms(lambda: sc_linear(
                    x, pws[next(it) % len(pws)]), "sc_gemm_kernel")
                if split_sweep[bps] is not None:
                    split_sweep[bps] = None if dms is None \
                        else split_sweep[bps] + calls * dms
    finally:
        skm.BLOCKS_PER_SM = aim
    log(f"[sc_gemm] one decode step's device time by the K split's aim in "
        f"blocks per SM (the wrapper's is {aim}): " + ", ".join(
            f"{b}: {_ms(v)}" for b, v in split_sweep.items()))
    families = _sc_gemm_families(gen, dev, sms)
    return {"cases": rows, "timing": timing, "decode_step": step,
            "prefill_pass": prefill, "blocks_per_sm_sweep": split_sweep,
            "sms": sms, "families": families}


def _sc_gemm_families(gen, dev, sms) -> dict:
    """The fused projection at the family cells' shapes
    (``FAMILY_SC_SHAPES``), bf16 rows at every row count the cells run —
    M = 1 (the sequential baseline's steps and a prefill's last row
    through the head), 4 (a decode step), 128 (a prefill chunk) and 256
    (a one-shot prefill of a 256-token prompt) — bit-equal to its plain
    version (zamba2's w2 runs K = 14,336, four K blocks past
    ``K_BLOCK_MAX``); then at M = 4 and 128, per shape, the fused call's
    ms and device ms, the plain version's and the bound, weights cycled
    from HBM, summed to a decode step and a chunk of each model."""
    import torch
    from repro_torch.kernels.sc_matmul import (pack_weight, plan, sc_linear,
                                               sc_linear_torch)
    out = {}
    for arch, shapes in FAMILY_SC_SHAPES.items():
        rows = []
        for m in FAMILY_SC_ROWS:
            for (k, n), calls in shapes.items():
                x = torch.randn((m, k), generator=gen,
                                device=dev).to(torch.bfloat16)
                w = (torch.randn((k, n), generator=gen, device=dev)
                     * k ** -0.5).to(torch.bfloat16)
                pws = [pack_weight(w, 8)]
                got = sc_linear(x, pws[0])
                want = sc_linear_torch(x, pws[0])
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    bad = (got != want).sum().item()
                    raise AssertionError(
                        f"fused SC-GEMM differs from its plain version at "
                        f"{arch}'s M={m} K={k} N={n}: {bad} entries")
                del got, want
                if m not in FAMILY_SC_TIMED:
                    log(f"[sc_gemm] {arch} M={m:3d} K={k:5d} N={n:5d}: "
                        f"bit-equal to the plain version")
                    continue
                pws += [pack_weight(w.clone(), 8) for _ in range(
                    max(0, math.ceil(128e6 / (k * n * 2)) - 1))]
                it = iter(range(1 << 30))
                mr, kc, splits = plan(m, n, k, sms)

                def call():
                    return sc_linear(x, pws[next(it) % len(pws)])
                row = {"M": m, "K": k, "N": n, "calls_per_step": calls,
                       "splits": splits, "ms": cuda_ms(call, iters=20),
                       "device_ms": device_ms(call, "sc_gemm_kernel",
                                              iters=10),
                       "plain_ms": cuda_ms(lambda: sc_linear_torch(
                           x, pws[0]), iters=1, warmup=0)}
                bound, by, nbytes, ops = _sc_bound(m, k, n, 2)
                row.update(bound_ms=bound, bound_by=by)
                rows.append(row)
                del pws
                log(f"[sc_gemm] {arch} M={m:3d} K={k:5d} N={n:5d} ({splits} "
                    f"K splits): bit-equal to the plain version; fused "
                    f"{row['ms']:.4f} ms a call, device "
                    f"{_ms(row['device_ms'])}, plain {row['plain_ms']:.3f} "
                    f"ms, bound {bound:.4f} ms ({by})")
        sums = {}
        for m, what in ((4, "decode_step"), (128, "prefill_chunk")):
            sel = [r for r in rows if r["M"] == m]
            sums[what] = {key: (None if any(r[key] is None for r in sel) else
                                sum(r["calls_per_step"] * r[key]
                                    for r in sel))
                          for key in ("ms", "device_ms", "plain_ms",
                                      "bound_ms")}
            t = sums[what]
            log(f"[sc_gemm] {arch} one {what.replace('_', ' ')} (M={m}, "
                f"{sum(shapes.values())} fused calls): {t['ms']:.3f} ms of "
                f"calls, device {_ms(t['device_ms'])}, plain "
                f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms")
        out[arch] = {"timing": rows, **sums}
    return out


def _paged_case(dtype, window, positions, gen, dev, c=4, kv=5, g=3, d=64,
                block=64, mb=4):
    """smollm's decode layout with fragmented tables: pages of each slot
    scattered over the pool, -1 past each slot's last page."""
    import torch
    n_pages = c * mb + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = torch.full((c, mb), -1, dtype=torch.int32, device=dev)
    used = 0
    for i, p in enumerate(positions):
        need = p // block + 1
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    q = torch.randn((c, kv, g, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((n_pages, block, kv, d), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn((n_pages, block, kv, d), generator=gen,
                    device=dev).to(dtype)
    qpos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, k, v, tables, qpos


def _paginate(k_rows, v_rows, block, gen):
    """Dense rows (C, S, KV, D) laid out in pages of ``block`` keys
    scattered over a pool, the trash page last; ``block=None`` is the dense
    view (one page per slot, as ``layers.decode_attention`` passes it)."""
    import torch
    c, s, kv, d = k_rows.shape
    if block is None:
        return k_rows, v_rows, torch.arange(c, dtype=torch.int32,
                                            device=k_rows.device)[:, None]
    mb = -(-s // block)
    perm = torch.randperm(c * mb, generator=gen, device=k_rows.device)
    pools = []
    for rows in (k_rows, v_rows):
        pool = torch.zeros((c * mb + 1, block, kv, d), dtype=rows.dtype,
                           device=rows.device)
        pool[perm] = torch.nn.functional.pad(
            rows, (0, 0, 0, 0, 0, mb * block - s)).reshape(c * mb, block,
                                                           kv, d)
        pools.append(pool)
    return pools[0], pools[1], perm.reshape(c, mb).to(torch.int32)


def _paged_invariance(gen, dev) -> list[str]:
    """Bitwise paging and batch invariance of the paged kernel at smollm's
    layout: the same slots' rows at block 16, 32, 48, 64 and 256 and as
    the dense view, and each slot alone against all four together, must
    give identical outputs. Returns what differed."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((4, 5, 3, 64), generator=gen, device=dev).to(dtype)
        k_rows, v_rows = (torch.randn((4, 700, 5, 64), generator=gen,
                                      device=dev).to(dtype) for _ in range(2))
        pos = torch.tensor([650, 255, 37, 699], dtype=torch.int32,
                           device=dev)
        for bits in (None, 4, 8):
            for window in (None, 300):
                outs = {block: paged_attention(
                    q, *_paginate(k_rows, v_rows, block, gen), pos,
                    window=window, sc_bits=bits)
                    for block in (None, 16, 32, 48, 64, 256)}
                what = f"{str(dtype)[6:]} sc_bits={bits} window={window}"
                differ = [b for b, o in outs.items()
                          if not torch.equal(o, outs[None])]
                if differ:
                    bad.append(f"paging: {what}, blocks {differ} differ "
                               f"from the dense view")
                kp, vp, tables = _paginate(k_rows, v_rows, 64, gen)
                alone = [i for i in range(4) if not torch.equal(
                    paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                    pos[i:i + 1], window=window,
                                    sc_bits=bits), outs[64][i:i + 1])]
                if alone:
                    bad.append(f"batch: {what}, slots {alone} alone differ "
                               f"from the batch")
                log(f"[paged] invariance {what}: paging "
                    f"{'ok' if not differ else 'DIFFERS'}, batch "
                    f"{'ok' if not alone else 'DIFFERS'}")
    return bad


def phase_paged() -> dict:
    """The paged kernel against its plain version; back-to-back and device
    time of both paths at the serve shape (positions [100, 255, 37, 64],
    MB 4) and at a long context (MB 64, positions up to 4095); then bitwise
    paging and batch invariance, which fail the phase on any difference
    (checked last, so the times are printed either way)."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # f32: the kernel reassociates the softmax sums over 32-token tiles
    # (online rescaling) against the plain version's one exact softmax, a
    # few float32 ulps; bf16: both cast the float32 result to bf16 once,
    # so they may land one bf16 ulp (2**-8 relative) apart. SC: the same,
    # plus one quantization step at most (check_close).
    tol = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
    f32, bf16 = torch.float32, torch.bfloat16
    main, long = [100, 255, 37, 64], [4095, 2900, 1500, 4000]
    # (dtype, window, positions, sc_bits, layout overrides, timed as)
    cases = [(f32, None, main, None, {}, "serve"),
             (bf16, None, main, None, {}, "serve"),
             (f32, 40, main, None, {}, None),
             (bf16, 40, [200, 3, 130, 191], None, {}, None),
             (f32, None, [0, 63, 127, 191], None, {}, None),
             (bf16, None, long, None, dict(mb=64), "long")]
    for bits in (4, 8):
        cases += [(f32, None, main, bits, {}, "serve"),
                  (bf16, None, main, bits, {}, "serve"),
                  (f32, 40, [200, 3, 130, 191], bits, {}, None),
                  (bf16, None, [0, 63, 127, 191], bits, {}, None),
                  (f32, None, [90, 17, 255, 0], bits, dict(kv=1, g=1), None),
                  (bf16, 33, [90, 17, 255, 130], bits, dict(kv=1, g=1, d=128,
                                                           block=32, mb=8),
                   None)]
    cases.append((bf16, None, long, 8, dict(mb=64), "long"))
    # zamba2-7b's decode layout: 32 KV heads, group 1, D 112, block 64,
    # max_seq 384 (MB 6)
    hybrid = dict(kv=32, g=1, d=112, mb=6)
    for bits in (None, 4, 8):
        cases += [(f32, None, [300, 17, 383, 128], bits, hybrid, None),
                  (bf16, None, [300, 17, 383, 128], bits, hybrid,
                   "hybrid" if bits in (None, 8) else None)]
    rows = []
    for dtype, window, positions, bits, geom, shape in cases:
        q, k, v, tables, qpos = _paged_case(dtype, window, positions, gen,
                                            dev, **geom)
        got = paged_attention(q, k, v, tables, qpos, window=window,
                              sc_bits=bits)
        want = paged_attention_torch(q, k, v, tables, qpos, window=window,
                                     sc_bits=bits)
        torch.cuda.synchronize()
        rtol, atol = tol[dtype]
        err = check_close(got, want, rtol=rtol, atol=atol, v=v, bits=bits,
                          what=f"paged ({dtype}, window {window}, sc_bits "
                               f"{bits}, positions {positions}, {geom})")
        c, kv, g, d = q.shape
        row = {"dtype": str(dtype).replace("torch.", ""), "window": window,
               "positions": positions, "sc_bits": bits, "layout": {
                   "C": c, "KV": kv, "G": g, "D": d, "block": k.shape[1],
                   "MB": tables.shape[1]}, "max_abs_err": err,
               "shape": shape}
        if shape:
            def call():
                return paged_attention(q, k, v, tables, qpos, window=window,
                                       sc_bits=bits)
            ms = cuda_ms(call, iters=200)
            dev_ms = device_ms(call, "paged_decode")
            plain_ms = cuda_ms(lambda: paged_attention_torch(
                q, k, v, tables, qpos, window=window, sc_bits=bits),
                iters=20)
            esz = q.element_size()
            rows_read = sum(min(p + 1, window or p + 1) for p in positions)
            nbytes = (2 * rows_read * kv * d * esz + 2 * q.numel() * esz
                      + tables.numel() * 4 + qpos.numel() * 4)
            ops = 4 * rows_read * kv * g * d
            rate = (INT8_OPS_S if bits else BF16_OPS_S
                    if dtype == torch.bfloat16 else FP32_OPS_S)
            bound = max(nbytes / HBM_BYTES_S, ops / rate) * 1e3
            row.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=bound,
                       bound_by="bytes" if nbytes / HBM_BYTES_S >= ops / rate
                       else "operations", bytes=nbytes, ops=ops)
        rows.append(row)
        timing = (f", {shape} shape: kernel {row['ms']:.4f} ms, device "
                  f"{_ms(row['device_ms'])}, plain {row['plain_ms']:.3f} "
                  f"ms, bound {row['bound_ms']:.5f} ms" if shape else "")
        log(f"[paged] {row['dtype']:8s} sc={bits} window={window} "
            f"pos={positions} {geom or ''}: max abs err {err:.2e}{timing}")
    bad = _paged_invariance(gen, dev)
    if bad:
        raise AssertionError("paged kernel is not invariant: "
                             + "; ".join(bad))
    return {"cases": rows}


def _flash_inputs(dtype, b, h, kv, sq, skv, d, gen, dev, model_layout):
    """Random q, k, v in the kernel's (B, heads, S, D) shape; with
    ``model_layout`` they are transposed views of (B, S, heads, D) tensors,
    as the model passes them."""
    import torch

    def rnd(heads, s):
        if model_layout:
            return torch.randn((b, s, heads, d), generator=gen, device=dev
                               ).to(dtype).transpose(1, 2)
        return torch.randn((b, heads, s, d), generator=gen,
                           device=dev).to(dtype)
    return rnd(h, sq), rnd(kv, skv), rnd(kv, skv)


def _flash_bound(q, k, q_offset, bits):
    """Least time for one call: q read and out written once, and the K/V
    rows the causal rows need read once, against the QKᵀ and PV operations
    those rows need, at the peak for the operands' type."""
    import torch
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    keys = sum(min(skv, q_offset + i + 1) for i in range(sq))
    kv_rows = min(skv, q_offset + sq)
    esz = q.element_size()
    nbytes = esz * (2 * b * h * sq * d + 2 * b * kv * kv_rows * d)
    ops = 4 * b * h * d * keys
    rate = (INT8_OPS_S if bits else BF16_OPS_S if q.dtype == torch.bfloat16
            else FP32_OPS_S)
    bound = max(nbytes / HBM_BYTES_S, ops / rate) * 1e3
    return bound, ("bytes" if nbytes / HBM_BYTES_S >= ops / rate
                   else "operations"), nbytes, ops


#: Long-prompt flash calls, bf16, group 1024 (the registered kv_block):
#: (name, b, h, kv, sq, skv, d, q_offset) — smollm-360m's one-shot prefill
#: of 2,048 tokens, the last 16-row chunk of its chunked prefill, and
#: qwen2-7b's attention width one-shot.
LONG_PROMPTS = (("L1", 1, 15, 5, 2048, 2048, 64, 0),
                ("L2", 1, 15, 5, 16, 2048, 64, 2032),
                ("L3", 1, 28, 4, 2048, 2048, 128, 0))


def _flash_chunk_invariance(gen, dev) -> list[str]:
    """Chunked rows == one-shot rows, bit for bit, through the kernel: a
    64-token prompt one-shot (group 64) against 16-row chunks at their
    staging offsets over larger extents (group = extent), as the engine's
    two prefill modes and the baseline run; each chunk with its offset as
    a host int and as an int32 on the card (what a captured chunk reads);
    the staging cache past the chunk holds large garbage, or NaN. The same
    at zamba2-7b's attention (H = KV = 32, D 112): a 256-token prompt
    one-shot against 128-row chunks at 0 and 128 over 256 and 384
    positions. Returns what differed."""
    import torch
    bad = []
    for geom in ((15, 5, 64, 64, 16, (64, 128, 256)),
                 (32, 32, 112, 256, 128, (256, 384))):
        bad += _flash_chunks_equal_one_shot(gen, dev, *geom)
    return bad


def _flash_chunks_equal_one_shot(gen, dev, h, kv, d, s, rows, extents):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        for bits in (None, 4, 8):
            q, k, v = _flash_inputs(dtype, 1, h, kv, s, s, d, gen, dev, True)
            one = flash_attention(q, k, v, q_offset=0, group=s, sc_bits=bits)
            differ = []
            for fill in ("garbage", "nan"):
                for off in range(0, s, rows):
                    for extent in extents:
                        kx = 50 * torch.randn((1, kv, extent, d),
                                              generator=gen, device=dev)
                        vx = 50 * torch.randn((1, kv, extent, d),
                                              generator=gen, device=dev)
                        kx, vx = kx.to(dtype), vx.to(dtype)
                        kx[:, :, :s], vx[:, :, :s] = k, v
                        if fill == "nan":
                            kx[:, :, off + rows:] = math.nan
                            vx[:, :, off + rows:] = math.nan
                        for where in ("host", "device"):
                            o = off if where == "host" else torch.tensor(
                                off, dtype=torch.int32, device=dev)
                            got = flash_attention(q[:, :, off:off + rows],
                                                  kx, vx, q_offset=o,
                                                  group=extent, sc_bits=bits)
                            torch.cuda.synchronize()
                            if not torch.equal(got,
                                               one[:, :, off:off + rows]):
                                differ.append(f"{fill} {off}/{extent} "
                                              f"offset on the {where}")
            what = f"{str(dtype)[6:]} sc={bits} H={h} KV={kv} D={d}"
            if differ:
                bad.append(f"{what}: chunks {differ} differ from the "
                           f"one-shot rows")
            log(f"[flash] chunked rows == one-shot rows {what} ({rows}-row "
                f"chunks of a {s}-token prompt over "
                f"{'/'.join(map(str, extents))}, offset on the host and on "
                f"the card, garbage or NaN past the chunk): "
                f"{'ok' if not differ else 'DIFFERS'}")
    return bad


def phase_flash() -> dict:
    """The flash kernel against its plain version at every geometry and at
    the long prompts L1-L3 (float and SC 8-bit); back-to-back and device
    ms of every timed call (the serve shapes and L1-L3) beside the plain
    version's, the bound and (float) ``scaled_dot_product_attention``;
    then bitwise chunk invariance, NaN staging included, which fails the
    phase on any difference (checked last, so the times print either
    way)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    # f32: sums reassociated (kernel: per key tile with online rescaling;
    # plain: pairwise tree sums per group); bf16: one bf16 rounding of the
    # output on each side. SC: the same plus one quantization step
    # (check_close).
    tol = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
    # (b, h, kv, sq, skv, d, q_offset, group, model layout, causal)
    geoms = [(1, 15, 5, 64, 64, 64, 0, 64, True, True),     # smollm one-shot
             (1, 15, 5, 16, 64, 64, 48, 64, True, True),    # chunk at 48 / 64
             (1, 15, 5, 16, 128, 64, 16, 128, True, True),  # chunk at 16 / 128
             (1, 15, 5, 16, 256, 64, 0, 256, True, True),   # chunk at 0 / 256
             (2, 6, 2, 37, 53, 128, 16, 24, False, True),   # D 128, ragged
             (2, 4, 4, 45, 45, 128, 0, 32, False, True),    # G 1, D 128
             (1, 4, 2, 70, 100, 64, 30, 100, False, True),  # G 2, ragged
             (1, 4, 2, 33, 47, 64, 0, 16, False, False),    # not causal
             # zamba2-7b: H 32, KV 32, D 112; one-shot, and chunks of 128
             # rows at 128 and 256 over the 384-position bucket
             (1, 32, 32, 128, 128, 112, 0, 128, True, True),
             (1, 32, 32, 128, 384, 112, 128, 384, True, True),
             (1, 32, 32, 128, 384, 112, 256, 384, True, True)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for bits in (None, 4, 8):
            for b, h, kv, sq, skv, d, off, group, model, causal in geoms:
                q, k, v = _flash_inputs(dtype, b, h, kv, sq, skv, d, gen,
                                        dev, model)
                kw = dict(causal=causal, q_offset=off, group=group,
                          sc_bits=bits)
                got = flash_attention(q, k, v, **kw)
                want = flash_attention_torch(q, k, v, **kw)
                # the offset read on the card (a worst-case grid) gives the
                # host offset's bits
                on_card = flash_attention(q, k, v, **{**kw, "q_offset": (
                    torch.tensor(off, dtype=torch.int32, device=dev))})
                torch.cuda.synchronize()
                rtol, atol = tol[dtype]
                shape = (b, h, kv, sq, skv, d, off, group, causal)
                if not torch.equal(on_card, got):
                    raise AssertionError(f"flash {dtype} sc={bits} {shape}: "
                                         f"the offset read on the card gives "
                                         f"other bits than the host offset")
                err = check_close(got, want, rtol=rtol, atol=atol, v=v,
                                  bits=bits, what=f"flash {dtype} sc={bits} "
                                                  f"{shape}")
                rows.append({"dtype": str(dtype).replace("torch.", ""),
                             "sc_bits": bits, "shape": shape,
                             "max_abs_err": err})
            log(f"[flash] {str(dtype)[6:]:8s} sc={bits}: {len(geoms)} shapes "
                f"agree, max abs err "
                f"{max(r['max_abs_err'] for r in rows[-len(geoms):]):.2e}")

    def lib_call(q, k, v, off):
        """SDPA on the same inputs: K/V heads repeated for GQA outside the
        timed call; ``is_causal`` where the mask is the plain lower
        triangle (its fastest backend), else an explicit boolean mask."""
        h, kv = q.shape[1], k.shape[1]
        sq, skv = q.shape[2], k.shape[2]
        kr = k.repeat_interleave(h // kv, dim=1)
        vr = v.repeat_interleave(h // kv, dim=1)
        if off == 0 and sq == skv:
            return lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                          is_causal=True)
        mask = (off + torch.arange(sq, device=dev)[:, None]
                >= torch.arange(skv, device=dev)[None, :])
        return lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=mask)

    def timed(q, k, v, off, group, bits, iters, plain_iters,
              on_card=False):
        """``on_card``: the offset as an int32 on the card, as a captured
        chunk passes it (the kernel's times); the host offset's device
        time beside it."""
        kw = dict(q_offset=off, group=group, sc_bits=bits)
        run_kw = kw if not on_card else {**kw, "q_offset": torch.tensor(
            off, dtype=torch.int32, device=dev)}
        row = {"ms": cuda_ms(lambda: flash_attention(q, k, v, **run_kw),
                             iters=iters),
               "device_ms": device_ms(
                   lambda: flash_attention(q, k, v, **run_kw), "flash_fwd",
                   iters=min(iters, 20)),
               "offset_on_card": on_card,
               "host_offset_device_ms": None if not on_card else device_ms(
                   lambda: flash_attention(q, k, v, **kw), "flash_fwd",
                   iters=min(iters, 20)),
               "plain_ms": cuda_ms(lambda: flash_attention_torch(q, k, v,
                                                                 **kw),
                                   iters=plain_iters, warmup=1),
               "library_ms": None, "library_device_ms": None}
        if bits is None:
            lib = lib_call(q, k, v, off)
            row["library_ms"] = cuda_ms(lib, iters=iters)
            row["library_device_ms"] = device_ms(lib, "",
                                                 iters=min(iters, 20))
        bound, by, nbytes, ops = _flash_bound(q, k, off, bits)
        row.update(bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
        return row

    def show(tag, row):
        lib = (f", SDPA {row['library_ms']:.4f} ms (device "
               f"{_ms(row['library_device_ms'])})"
               if row["library_ms"] is not None else "")
        card = (f" (offset on the card; host offset device "
                f"{_ms(row['host_offset_device_ms'])})"
                if row.get("offset_on_card") else "")
        log(f"[flash] {tag}: kernel {row['ms']:.4f} ms, device "
            f"{_ms(row['device_ms'])}{card}, plain {row['plain_ms']:.3f} "
            f"ms{lib}, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")

    # the long prompts: the kernel against its plain version, then timed
    h, kv, d = 15, 5, 64
    long_rows = {}
    for bits in (None, 8):
        key = "float" if bits is None else f"sc{bits}"
        for name, b, hh, kvh, sq, skv, dd, off in LONG_PROMPTS:
            q, k, v = _flash_inputs(torch.bfloat16, b, hh, kvh, sq, skv, dd,
                                    gen, dev, True)
            kw = dict(q_offset=off, group=1024, sc_bits=bits)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_torch(q, k, v, **kw)
            torch.cuda.synchronize()
            err = check_close(got, want, rtol=tol[torch.bfloat16][0],
                              atol=tol[torch.bfloat16][1], v=v, bits=bits,
                              what=f"flash {name} sc={bits}")
            del got, want
            row = timed(q, k, v, off, 1024, bits, iters=20, plain_iters=1)
            row.update(name=name, shape=(b, hh, kvh, sq, skv, dd, off, 1024),
                       max_abs_err=err)
            long_rows.setdefault(key, {})[name] = row
            show(f"bf16 sc={bits} {name} B={b} H={hh} KV={kvh} Sq={sq} "
                 f"Skv={skv} D={dd} offset={off} (max abs err {err:.2e})",
                 row)

    # timing at the main path's shapes (bf16): the four chunk calls of a
    # 64-token prompt's chunked prefill over its 64-token bucket, and one
    # one-shot call; SDPA (float only) is the library yardstick, never
    # called by the port
    timing = {}
    for bits in (None, 8):
        calls = [(16, 64, off) for off in (0, 16, 32, 48)] + [(64, 64, 0)]
        per = []
        for sq, skv, off in calls:
            q, k, v = _flash_inputs(torch.bfloat16, 1, h, kv, sq, skv, d,
                                    gen, dev, True)
            row = timed(q, k, v, off, skv, bits, iters=100, plain_iters=10,
                        on_card=sq < skv)
            row.update(sq=sq, skv=skv, q_offset=off)
            per.append(row)
            show(f"bf16 sc={bits} Sq={sq} Skv={skv} offset={off}", row)
        chunked = per[:4]
        key = "float" if bits is None else f"sc{bits}"
        timing[key] = {
            "calls": per, "long_prompts": long_rows[key],
            "chunked_prefill": {name: (None if any(c[name] is None
                                                   for c in chunked) else
                                       sum(c[name] for c in chunked))
                                for name in ("ms", "device_ms", "plain_ms",
                                             "library_ms", "library_device_ms",
                                             "bound_ms",
                                             "host_offset_device_ms")}}

    # zamba2-7b's chunk: 128 rows at offset 256 over the 384-position
    # bucket, H = KV = 32, D 112, the offset on the card
    for bits in (None, 8):
        q, k, v = _flash_inputs(torch.bfloat16, 1, 32, 32, 128, 384, 112,
                                gen, dev, True)
        row = timed(q, k, v, 256, 384, bits, iters=50, plain_iters=5,
                    on_card=True)
        key = "float" if bits is None else f"sc{bits}"
        timing[key]["hybrid_chunk"] = row
        show(f"bf16 sc={bits} zamba2-7b chunk Sq=128 Skv=384 offset=256 "
             f"H=KV=32 D=112", row)

    bad = _flash_chunk_invariance(gen, dev)
    if bad:
        raise AssertionError("flash kernel: chunked rows differ from the "
                             "one-shot rows: " + "; ".join(bad))
    return {"cases": rows, "invariance": "bitwise", "timing": timing}


def _stream_bound(pairs: int, bits: int) -> tuple[float, str, int, int]:
    """Least time for the stream product of ``pairs`` operand pairs: one
    popcount per pair and 32-bit word at the card's population-count rate
    (SMs x max SM clock), against two int32 read and one written per pair
    at the HBM rate."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popcounts = pairs * ((1 << bits) // 32)
    nbytes = 12 * pairs
    t_ops = popcounts / (POPC_PER_CLK_SM * sms * _sm_clock_hz())
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, popcounts)


def phase_stream() -> dict:
    """The paper's bit-parallel multiplier through ``ops.sc_stream_mul`` on
    every operand pair at B = 5, 6, 7, 8, 10 and 12: the launch counter,
    set to 0 just before, must show one kernel launch per grid; each grid's
    counts must equal the plain version's and the closed form's exactly
    (and the bit-level oracle's at B <= 8). Then seeded samples of 2^20
    pairs at B = 9, 11 and 16 (random operands: msb differs inside a
    warp), ragged sizes 1, 31 and 100,003, 3-D shapes, a view at storage
    offset 1 (not 16-byte aligned), empty operands and every block width;
    kernel (back to back and device), plain and bound ms at B = 8, 10 and
    12."""
    import torch
    from repro_torch.core.error_analysis import exhaustive_grid
    from repro_torch.core.multipliers import (proposed_bitlevel,
                                              proposed_closed_form)
    from repro_torch.kernels import ops
    from repro_torch.kernels.sc_bitops import (sc_stream_mul_cuda,
                                               sc_stream_mul_torch)
    dev = torch.device("cuda")
    widths = (5, 6, 7, 8, 10, 12)
    grids = {bits: exhaustive_grid(bits, dev) for bits in widths}
    torch.cuda.synchronize()
    sc_stream_mul_cuda.launches = 0
    got = {bits: ops.sc_stream_mul(x, y, bits=bits)
           for bits, (x, y) in grids.items()}
    torch.cuda.synchronize()
    launches = sc_stream_mul_cuda.launches
    if launches != len(widths):
        raise AssertionError(f"stream kernel launched {launches} times for "
                             f"{len(widths)} grids")

    def same(a, b, what):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).sum().item() if a.shape == b.shape else "shape"
            raise AssertionError(f"stream {what}: {bad} counts differ")
        return (a.long() - b.long()).abs().max().item() if a.numel() else 0

    err = 0
    for bits, (x, y) in grids.items():
        err = max(err, same(got[bits], sc_stream_mul_torch(x, y, bits=bits),
                            f"B={bits} vs plain"),
                  same(got[bits], proposed_closed_form(x, y, bits=bits),
                       f"B={bits} vs closed form"))
        checked = "plain, closed form"
        if bits <= 8:
            same(got[bits], proposed_bitlevel(x, y, bits=bits),
                 f"B={bits} vs bit level")
            checked += ", bit level"
        log(f"[stream] B={bits:2d}: all {x.numel():,} pairs exactly equal "
            f"({checked})")

    gen = torch.Generator(device=dev).manual_seed(4)

    def operands(bits, shape):
        return [torch.randint(0, 1 << bits, shape, generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2)]

    for bits in (9, 11, 16):
        x, y = operands(bits, (1 << 20,))
        out = ops.sc_stream_mul(x, y, bits=bits)
        err = max(err, same(out, sc_stream_mul_torch(x, y, bits=bits),
                            f"B={bits} sample vs plain"),
                  same(out, proposed_closed_form(x, y, bits=bits),
                       f"B={bits} sample vs closed form"))
    log("[stream] seeded samples of 1,048,576 pairs at B = 9, 11, 16: "
        "exactly equal (plain, closed form)")
    for bits, shape in ((8, (1,)), (12, (31,)), (8, (100_003,)),
                        (10, (7, 33, 65)), (9, (3, 1, 257))):
        x, y = operands(bits, shape)
        out = ops.sc_stream_mul(x, y, bits=bits)
        same(out, proposed_closed_form(x, y, bits=bits),
             f"B={bits} shape {shape}")
        same(out, sc_stream_mul_torch(x, y, bits=bits),
             f"B={bits} shape {shape} vs plain")
        for rows in (1, 4, 8):
            same(ops.sc_stream_mul(x, y, bits=bits, block_rows=rows), out,
                 f"B={bits} shape {shape} block_rows={rows}")
    x, y = operands(12, (100_004,))
    xv, yv = x[1:], y[1:]           # storage offset 1: 4 bytes past 16
    if xv.data_ptr() % 16 == 0:
        raise AssertionError("stream: the offset view is 16-byte aligned")
    out = ops.sc_stream_mul(xv, yv, bits=12)
    same(out, proposed_closed_form(xv, yv, bits=12), "offset view")
    same(out, ops.sc_stream_mul(xv.clone(), yv.clone(), bits=12),
         "offset view vs its copy")
    for shape in ((0,), (3, 0, 5)):
        empty = torch.zeros(shape, dtype=torch.int32, device=dev)
        out = ops.sc_stream_mul(empty, empty, bits=8)
        if out.shape != empty.shape or out.dtype != torch.int32:
            raise AssertionError(f"stream: empty {shape} gave {out.shape}")
    log("[stream] ragged 1, 31 and 100,003 pairs, 3-D shapes kept, a view "
        "at storage offset 1, empty operands, block_rows 1/4/8: all equal")

    timing = {}
    for bits in (8, 10, 12):
        x, y = grids[bits]
        ms = cuda_ms(lambda: ops.sc_stream_mul(x, y, bits=bits),
                     iters={8: 200, 10: 100, 12: 20}[bits])
        plain_ms = cuda_ms(lambda: sc_stream_mul_torch(x, y, bits=bits),
                           iters=1 if bits == 12 else 3, warmup=1)
        bound, by, nbytes, popcounts = _stream_bound(x.numel(), bits)
        # the kernel's own device time, without the host's cost of a call
        dev_ms = device_ms(lambda: ops.sc_stream_mul(x, y, bits=bits),
                           "sc_stream_mul_kernel", iters=10, one_launch=True)
        timing[bits] = {"pairs": x.numel(), "ms": ms, "plain_ms": plain_ms,
                        "device_ms": dev_ms, "bound_ms": bound,
                        "bound_by": by, "bytes": nbytes,
                        "popcounts": popcounts}
        log(f"[stream] B={bits:2d} exhaustive ({x.numel():,} pairs): kernel "
            f"{ms:.4f} ms a call (device time {_ms(dev_ms)}), plain "
            f"{plain_ms:.1f} ms, bound {bound:.4f} ms ({by})")
    return {"launches": launches, "max_abs_err": err, "timing": timing,
            "widths": widths}


def phase_paper() -> dict:
    """``launch.paper``'s Table II and Fig. 1(b) rows on the card; each
    row's ``derived`` must equal the same row computed on the CPU."""
    from repro_torch.launch.paper import SUITES
    rows = {dev: [r for fn in SUITES.values() for r in fn(dev)]
            for dev in ("cuda", "cpu")}
    for card, cpu in zip(rows["cuda"], rows["cpu"], strict=True):
        if (card["name"], card["derived"]) != (cpu["name"], cpu["derived"]):
            raise AssertionError(f"paper row {card['name']}: card "
                                 f"{card['derived']!r} != CPU "
                                 f"{cpu['derived']!r}")
        log(f"[paper] {card['name']},{card['us_per_call']},"
            f"{card['derived'].replace(',', ';')}  (CPU {cpu['us_per_call']} "
            f"us)")
    log(f"[paper] {len(rows['cuda'])} rows on the card equal the CPU's")
    return rows


def _workload(cfg, n, prompt_len, gen_lo, gen_hi, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=f"req-{i}",
                    prompt=rng.integers(0, cfg.vocab_size, size=(prompt_len,),
                                        dtype=np.int32),
                    max_new_tokens=int(rng.integers(gen_lo, gen_hi + 1)))
            for i in range(n)]


def phase_small_model() -> dict:
    """Reduced smollm-360m (float32, SC-GEMM on): prefill logits on the card
    agree with the CPU's within 1e-3; engine streams on both are compared."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import bind
    from repro_torch.models.transformer import params_to
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                              use_sc_gemm=True).validate()
    cpu = bind(cfg, "cpu")
    params = cpu.init_params(0)
    reqs = _workload(cfg, 5, 20, 4, 12, seed=3)
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, params, device=dev, capacity=2, max_seq=40,
                     block=32, chunk=16, prefix_cache=False)
        streams[dev] = [r.tokens for r in eng.run(reqs)]
    same = all(np.array_equal(a, b) for a, b in zip(streams["cpu"],
                                                    streams["cuda"]))
    toks = torch.as_tensor(reqs[0].prompt)[None]
    with torch.no_grad():
        l_cpu, _ = cpu.prefill_step(params, {"tokens": toks})
        l_gpu, _ = bind(cfg, "cuda").prefill_step(
            params_to(params, "cuda"), {"tokens": toks.cuda()})
    err = (l_gpu.cpu() - l_cpu).abs().max().item()
    # the card's and the CPU's float functions (exp, rsqrt, cos) differ in
    # the last ulp, which can move an SC quantization step; the logits are
    # held to a tolerance and the streams' agreement is reported
    log(f"[small] reduced smollm f32 SC: card streams == CPU streams: {same}; "
        f"prefill logits max abs err {err:.2e} (tolerance 1e-3)")
    if not err < 1e-3:
        raise AssertionError(f"card vs CPU prefill logits differ by {err}")
    return {"streams_equal": same, "prefill_logits_max_abs_err": err}


def _serve_launch_counters():
    """The serving path's launch counters: every wrapper's but the stream
    multiplier's, the attention wrappers' SC paths (``*_sc``) apart."""
    from repro_torch.launch.steps import launch_counters
    return {name: c for name, c in launch_counters().items()
            if name != "sc_stream_mul"}


def _serve_engine(cfg, params, mode, graphs, max_seq=256, chunk=16):
    from repro_torch.serving import Engine
    return Engine(cfg, params, device="cuda", capacity=4, max_seq=max_seq,
                  block=64, chunk=chunk, prefill_mode=mode,
                  prefix_cache=False, speculate_k=0, graphs=graphs)


def _path_counts(cfg) -> tuple[int, int]:
    """(SC-GEMM projections, attention sites) of one decode step or
    prefill call of ``cfg``'s family: dense, 7 a layer and the LM head;
    ssm, ``in_proj`` and ``out_proj`` a Mamba layer (the tied head is a
    float product); hybrid, those, 7 at each shared-block site and the
    head."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers, 0
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.shared_attn_every
        return 2 * cfg.n_layers + 7 * sites + 1, sites
    return 7 * cfg.n_layers + 1, cfg.n_layers


def _serve_run(cfg, eng, reqs, mode, baseline, *, run: int = 1,
               captured: int = 0, name: str | None = None):
    """One engine run at full width: counters set to 0 just before and read
    just after; streams checked against the sequential baseline. Graphed,
    the engine's decode step must have been captured once, when it was
    built (``captured`` new entries then), with one fused SC-GEMM launch a
    projection and one paged launch an attention site, and never again;
    each prefill shape of the requests (a bucket chunked, a prompt length
    one-shot) must be captured once, at first use in run 1 and never in
    run 2, with one SC-GEMM launch a projection and one flash launch an
    attention site a replay, and one replay a prefill chunk or prefill
    (``_path_counts``: 225 and 32 at smollm-360m)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import steps as step_cache
    from repro_torch.launch.steps import WARMUP_RUNS, bucket_for
    graphs = eng.graphs
    n_proj, sites = _path_counts(cfg)
    shapes = {(bucket_for(r.prompt_len, eng.buckets), eng.chunk)
              if mode == "chunked" else r.prompt_len for r in reqs}
    graphs0 = len(step_cache.decode_steps())
    step = eng._decode
    decode_replays0 = step.replays
    replays0 = {k: s.replays for k, s in eng.prefill_steps().items()}
    # a request's TTFT runs from its enqueue stamp: stamp all of them now,
    # as they are submitted together, not when the list was built
    now = time.perf_counter()
    # (a later run of the same engine takes new uids: the queue refuses
    # one it has seen)
    reqs = [dataclasses.replace(r, enqueued_at=now, uid=r.uid if run == 1
                                else f"{r.uid}-run{run}") for r in reqs]
    counters = _serve_launch_counters()
    # engines of earlier runs are gone: only this one's memory is counted
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    results = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()
    sc_attn = sites if cfg.attn_sc else 0
    reserved = torch.cuda.memory_reserved()
    steps = st["decode_steps"]
    name = name or ("serve_sc" if cfg.attn_sc else "serve")
    tag = (f"[{name}:{mode}{':graphed' if graphs else ':eager'}"
           f"{f':run{run}' if run > 1 else ''}]")
    prefill_calls = (st["prefill_chunks"] if mode == "chunked"
                     else st["prefills"])
    prefill_graph = None
    if graphs:
        want = {"sc_linear": n_proj}
        if sites:
            want["paged_attention"] = sites
        if sc_attn:
            want["paged_attention_sc"] = sc_attn
        log(f"{tag} decode graph: captured {step.captures} time(s), "
            f"{captured} new while building this engine, replayed "
            f"{step.replays} times in all; a replay counts "
            f"{step.launch_counts}")
        if (captured != (1 if run == 1 else 0) or step.captures != 1
                or step.replays - decode_replays0 != steps
                or len(step_cache.decode_steps()) != graphs0
                or step.launch_counts != want):
            raise AssertionError(f"{tag} decode graph: {step.captures} "
                                 f"captures, counts {step.launch_counts} "
                                 f"(want {want})")
        entries = eng.prefill_steps()
        want_p = {"sc_linear": n_proj}
        if sites:
            want_p["flash_attention"] = sites
        if sc_attn:
            want_p["flash_attention_sc"] = sc_attn
        replays = {k: s.replays - replays0.get(k, 0)
                   for k, s in entries.items()}
        prefill_graph = {"shapes": [list(k) for k in entries],
                         "captures": [s.captures for s in entries.values()],
                         "replays_this_run": list(replays.values()),
                         "new_captures": st["prefill_captures"],
                         "launch_counts": [s.launch_counts
                                           for s in entries.values()]}
        log(f"{tag} prefill graphs: shapes {prefill_graph['shapes']}, "
            f"captured {prefill_graph['captures']} time(s), "
            f"{st['prefill_captures']} new in this run, replayed "
            f"{list(replays.values())} times for {prefill_calls} prefill "
            f"calls; a replay counts {prefill_graph['launch_counts']}")
        if (len(entries) != len(shapes)
                or any(s.captures != 1 for s in entries.values())
                or st["prefill_captures"] != (len(shapes) if run == 1
                                              else 0)
                or sum(replays.values()) != prefill_calls
                or any(s.launch_counts != want_p
                       for s in entries.values())):
            raise AssertionError(f"{tag} prefill graphs: {prefill_graph} "
                                 f"for {prefill_calls} prefill calls (want "
                                 f"shapes {sorted(shapes)}, each captured "
                                 f"once, in run 1, counting {want_p})")
    log(f"{tag} {st['requests']} requests, {st['generated_tokens']} tokens "
        f"in {st['wall_s']:.2f}s: {st['tok_per_s']:.2f} tok/s, TTFT p50 "
        f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode {st['decode_ms_per_step']:.2f}"
        f" ms/step over {steps} steps, {st['prefill_chunks']} prefill chunks, "
        f"{st['prefills']} prefills, {st['preemptions']} preemptions, peak "
        f"pages {st['peak_pages']}/{st['n_blocks']}")
    log(f"{tag} launches: SC-GEMM {launches['sc_linear']} fused (counts "
        f"entry {launches['sc_matmul_counts']}), paged "
        f"attention {launches['paged_attention']} (>= {steps} x {sites}), "
        f"flash attention {launches['flash_attention']} (= "
        f"{st['prefill_chunks'] if mode == 'chunked' else st['prefills']}"
        f" x {sites}, and {sites} a warm-up run of a capture in this "
        f"run); max_memory_allocated {peak / 2**30:.3f} GiB, "
        f"memory_reserved {reserved / 2**30:.3f} GiB")
    if steps < 1:
        raise AssertionError("the engine ran no decode step")
    # one fused launch per projection (``_path_counts``), on every
    # decode step and every prefill call; no weight is quantized on
    # the way (the counts entry, which takes planes quantized per call, is
    # never reached). A prefill capture in this run adds its warm-up's
    # eager runs (launch.steps.WARMUP_RUNS), which launch the kernels too.
    warm = WARMUP_RUNS * st.get("prefill_captures", 0) if graphs else 0
    projections = n_proj * (steps + prefill_calls + warm)
    if launches["sc_linear"] != projections or launches["sc_matmul_counts"]:
        raise AssertionError(f"SC-GEMM: {launches['sc_linear']} fused and "
                             f"{launches['sc_matmul_counts']} counts-entry "
                             f"launches for {projections} projections")
    if launches["paged_attention"] < steps * sites:
        raise AssertionError(f"paged kernel launched "
                             f"{launches['paged_attention']} times in "
                             f"{steps} decode steps")
    # one flash launch per layer per prefill call (chunk or one-shot)
    if prefill_calls < 1 or launches["flash_attention"] != \
            (prefill_calls + warm) * sites:
        raise AssertionError(f"flash kernel launched "
                             f"{launches['flash_attention']} times for "
                             f"{prefill_calls} prefill calls")
    # every attention launch took the cell's path: SC, or float
    for name in ("paged_attention", "flash_attention"):
        if launches[f"{name}_sc"] != (launches[name] if sc_attn else 0):
            raise AssertionError(f"{tag} {launches[f'{name}_sc']} of "
                                 f"{launches[name]} {name} launches on the "
                                 f"SC path")
    mismatched = []
    for req, res, ref in zip(reqs, results, baseline):
        if res.n_generated != req.max_new_tokens:
            raise AssertionError(f"{req.uid}: {res.n_generated} tokens, "
                                 f"asked {req.max_new_tokens}")
        if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"{req.uid}: token out of vocabulary")
        if not np.array_equal(ref, res.tokens):
            first = int(np.argmax(ref != res.tokens))
            mismatched.append(f"{req.uid} first differs at {first}")
    log(f"{tag} {len(reqs) - len(mismatched)}/{len(reqs)} streams identical "
        f"to the sequential baseline")
    if mismatched:
        raise AssertionError(f"{tag} engine streams differ from the "
                             f"sequential baseline: " + "; ".join(mismatched))
    return {"stats": {k: v for k, v in st.items() if k != "backpressure"},
            "launches": launches, "max_memory_allocated": peak,
            "memory_reserved": reserved,
            "decode_graph": {"captures": step.captures,
                             "replays": step.replays,
                             "launch_counts": step.launch_counts}
            if graphs else None,
            "prefill_graph": prefill_graph,
            "first_stream": results[0].tokens[:16].tolist(),
            "streams": [r.tokens.tolist() for r in results]}


def _side_by_side(tag, eager, graphed) -> dict:
    """The eager and graphed runs of one cell on one line each side."""
    keys = (("decode_ms_per_step", "decode ms/step", 1.0),
            ("tok_per_s", "tokens/s", 1.0), ("ttft_p50_s", "TTFT p50 ms", 1e3))
    out = {}
    for key, what, scale in keys:
        out[key] = [eager["stats"][key], graphed["stats"][key]]
    out["max_memory_allocated_gib"] = [eager["max_memory_allocated"] / 2**30,
                                       graphed["max_memory_allocated"] / 2**30]
    log(f"{tag} eager -> graphed: " + ", ".join(
        f"{what} {eager['stats'][key] * scale:.2f} -> "
        f"{graphed['stats'][key] * scale:.2f}" for key, what, scale in keys)
        + f", peak allocated {out['max_memory_allocated_gib'][0]:.3f} -> "
        f"{out['max_memory_allocated_gib'][1]:.3f} GiB")
    return out


def _serve_phase(attn_sc: bool, modes) -> dict:
    """Serve 8 requests (64-token prompts, 16-64 new tokens) at smollm-360m's
    full width with SC-GEMM on, in each prefill mode, against the
    sequential B=1 ``generate`` baseline on the card (batch invariance)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(ARCHS["smollm-360m"], use_sc_gemm=True,
                              attn_sc=attn_sc, sc_bits=8).validate()
    t0 = time.perf_counter()
    params = bind(cfg, "cuda").init_params(0)
    torch.cuda.synchronize()
    tag = "[serve_sc]" if attn_sc else "[serve]"
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, SC-GEMM "
        f"{cfg.sc_bits}-bit, attention "
        f"{'SC %d-bit' % cfg.sc_bits if attn_sc else 'float'}; init "
        f"{time.perf_counter() - t0:.1f}s")
    # warm-up: first calls load the kernels and PyTorch's own modules
    Engine(cfg, params, device="cuda", capacity=4, max_seq=256, block=64,
           chunk=16, prefix_cache=False, graphs=False).run(
        _workload(cfg, 1, 20, 2, 2, seed=99))
    reqs = _workload(cfg, 8, 64, 16, 64, seed=5)
    t1 = time.perf_counter()
    baseline = [generate(cfg, params, r.prompt[None],
                         gen_tokens=r.max_new_tokens,
                         device="cuda")[0].cpu().numpy() for r in reqs]
    log(f"{tag} sequential baseline: {len(reqs)} requests in "
        f"{time.perf_counter() - t1:.1f}s")
    out = {}
    for mode in modes:
        # no cached step is alive during the eager run, so its peak memory
        # is the eager engine's own; the graphed engine then captures anew:
        # its decode step when it is built, its prefill shape at first use
        # in its first run; the second run is the graphed cell
        steps.clear_decode_steps()
        eager = _serve_run(cfg, _serve_engine(cfg, params, mode, False),
                           reqs, mode, baseline)
        n0 = len(steps.decode_steps())
        eng = _serve_engine(cfg, params, mode, True)
        first = _serve_run(cfg, eng, reqs, mode, baseline,
                           captured=len(steps.decode_steps()) - n0)
        graphed = _serve_run(cfg, eng, reqs, mode, baseline, run=2)
        del eng
        graphed["first_run"] = first
        graphed["eager"] = eager
        graphed["eager_vs_graphed"] = _side_by_side(
            f"{tag[:-1]}:{mode}]", eager, graphed)
        if mode == "chunked":
            _SERVE_CELLS[attn_sc] = {
                "baseline": baseline,
                "tok_per_s": graphed["stats"]["tok_per_s"]}
        fs = first["stats"]
        log(f"{tag[:-1]}:{mode}] graphed first run (its prefill capture "
            f"included): tokens/s {fs['tok_per_s']:.2f}, TTFT p50 "
            f"{fs['ttft_p50_s'] * 1e3:.2f} ms, peak allocated "
            f"{first['max_memory_allocated'] / 2**30:.3f} GiB")
        out[mode] = graphed
    steps.clear_decode_steps()
    return out


def phase_serve() -> dict:
    return _serve_phase(False, ("chunked",))["chunked"]


#: The family cells' traffic: 8 requests of 128- and 256-token prompts (a
#: whole number of ssm_chunk = 128 tokens, so the one-shot prefill and the
#: sequential baseline take them) and 16-64 new tokens, through
#: ``Engine(capacity=4, max_seq=384, block=64, chunk=128)``.
FAMILY_PROMPTS, FAMILY_MAX_SEQ, FAMILY_CHUNK = (128, 256), 384, 128


def _family_workload(cfg, seed):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    lens = [FAMILY_PROMPTS[i % 2] for i in range(8)]
    return [Request(uid=f"req-{i}",
                    prompt=rng.integers(0, cfg.vocab_size, size=(n,),
                                        dtype=np.int32),
                    max_new_tokens=int(rng.integers(16, 65)))
            for i, n in enumerate(lens)]


def _family_chunk_ms(eng, cfg, tag: str, n: int = 2) -> dict:
    """A prefill chunk as the engine drives it (the inputs copied in, the
    bucket's step run or replayed), on a prompt of the longest
    ``FAMILY_PROMPTS`` length: wall ms a chunk over ``n`` passes of its
    chunks (two of 128 rows at 256 tokens), each ending in a
    synchronize; graphed, the replay's device ms back to back too (CUDA
    events, the staging position put back before each)."""
    import numpy as np
    import torch
    from repro_torch.serving import Request
    rng = np.random.default_rng(17)
    length = FAMILY_PROMPTS[-1]
    req = Request(uid=f"{tag}-chunk", prompt=rng.integers(
        0, cfg.vocab_size, size=(length,), dtype=np.int32), max_new_tokens=1)
    st = eng._start_prefill(req)
    step, walls = st.step, []
    for _ in range(n):
        step.start()
        st.entry.prefill_offset = 0
        for _ in range(length // FAMILY_CHUNK):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._prefill_chunk_once(st)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    out = {"wall_ms": sum(walls) / len(walls), "replay_ms": None}
    if eng.graphs:
        # the last chunk again: its offset put back before each replay
        saved = step.cache.pos - FAMILY_CHUNK

        def replay():
            step.cache.pos.copy_(saved)
            step.replay()
        out["replay_ms"] = cuda_ms(replay, 4, warmup=0)
    log(f"{tag} prefill chunk ({FAMILY_CHUNK} rows of a {length}-token "
        f"prompt): "
        f"{out['wall_ms']:.3f} ms a chunk"
        + (f", replay {out['replay_ms']:.3f} ms on the device back to back"
           if out["replay_ms"] is not None else ""))
    return out


def _family_phase(arch: str, name: str) -> dict:
    """Serve the ``FAMILY_*`` traffic at ``arch``'s full width and depth
    (SC-GEMM at 8 bits, float attention, random weights from seed 0),
    chunked and one-shot, each eager and then graphed twice on one engine
    (the second run the cell), every run against the sequential B=1
    ``generate`` baseline."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate
    from repro_torch.models import bind
    cfg = dataclasses.replace(ARCHS[arch], use_sc_gemm=True,
                              sc_bits=8).validate()
    n_proj, sites = _path_counts(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = bind(cfg, "cuda").init_params(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in steps._tensors(params))
    log(f"[{name}] {cfg.name} ({cfg.family}): {cfg.n_layers} Mamba-2 layers "
        f"(d_model {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} "
        f"heads x {cfg.ssm_headdim}, state {cfg.ssm_state}, conv "
        f"{cfg.ssm_conv}), {sites} shared-block attention sites"
        + (f" ({cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
           f"{cfg.d_ff})" if sites else "")
        + f", vocab {cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B "
        f"parameters; SC-GEMM {cfg.sc_bits}-bit ({n_proj} projections a "
        f"step), attention float; init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    # where a graphed decode step's time goes, its kernels by name and the
    # trace's records held to the capture's launches, taken before the
    # serving runs: after them the trace has lost one record in 704
    # (PERF.md, open questions)
    profile = _profile_engine(cfg, params, True, f"{name}:profile")
    steps.clear_decode_steps()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reqs = _family_workload(cfg, seed=7)
    t1 = time.perf_counter()
    baseline = [generate(cfg, params, r.prompt[None],
                         gen_tokens=r.max_new_tokens,
                         device="cuda")[0].cpu().numpy() for r in reqs]
    torch.cuda.synchronize()
    log(f"[{name}] sequential baseline: {len(reqs)} requests "
        f"({sum(r.prompt_len for r in reqs)} prompt tokens, "
        f"{sum(r.max_new_tokens for r in reqs)} new) in "
        f"{time.perf_counter() - t1:.1f}s, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    out = {"n_layers": cfg.n_layers, "parameters": n_params}
    for mode in ("chunked", "oneshot"):
        steps.clear_decode_steps()
        gc.collect()
        eng = _serve_engine(cfg, params, mode, False, FAMILY_MAX_SEQ,
                            FAMILY_CHUNK)
        eager = _serve_run(cfg, eng, reqs, mode, baseline, name=name)
        if mode == "chunked":
            eager["prefill_chunk"] = _family_chunk_ms(
                eng, cfg, f"[{name}:{mode}:eager]")
        del eng
        gc.collect()
        n0 = len(steps.decode_steps())
        eng = _serve_engine(cfg, params, mode, True, FAMILY_MAX_SEQ,
                            FAMILY_CHUNK)
        first = _serve_run(cfg, eng, reqs, mode, baseline, name=name,
                           captured=len(steps.decode_steps()) - n0)
        graphed = _serve_run(cfg, eng, reqs, mode, baseline, run=2,
                             name=name)
        if mode == "chunked":
            graphed["prefill_chunk"] = _family_chunk_ms(
                eng, cfg, f"[{name}:{mode}:graphed]")
        del eng
        graphed["first_run"] = first
        graphed["eager"] = eager
        graphed["eager_vs_graphed"] = _side_by_side(f"[{name}:{mode}]",
                                                    eager, graphed)
        fs = first["stats"]
        log(f"[{name}:{mode}] graphed first run (its captures included): "
            f"tokens/s {fs['tok_per_s']:.2f}, TTFT p50 "
            f"{fs['ttft_p50_s'] * 1e3:.2f} ms, peak allocated "
            f"{first['max_memory_allocated'] / 2**30:.3f} GiB")
        out[mode] = graphed
    steps.clear_decode_steps()
    out["profile"] = profile
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_ssm() -> dict:
    return _family_phase("mamba2-130m", "serve_ssm")


def phase_serve_hybrid() -> dict:
    return _family_phase("zamba2-7b", "serve_hybrid")


#: what ``serve_spec`` takes from ``serve`` (key False) and ``serve_sc``
#: (key True): the baseline streams and the chunked cell's graphed
#: tokens/s (absent when that phase did not run in this call)
_SERVE_CELLS: dict = {}
#: (k, draft_bits, graphs, SC attention): the last is the ``serve_sc``
#: cell drafting at its own 8 bits, an exact draft
SPEC_RUNS = ((3, 4, False, False), (1, 4, True, False), (3, 4, True, False),
             (3, 8, True, False), (3, 8, True, True))


def _record_grids(eng) -> list:
    """Wrap ``eng``'s round to keep, every round, each live slot's
    remaining budget and the round's draft and exact token grids."""
    grids = []
    inner = eng._speculate_once

    def recording():
        budget = {slot: e.request.max_new_tokens - e.n_generated
                  for slot, e in eng.pool.entries.items()}
        inner()
        grids.append((budget, eng._window_host.numpy()[:, 1:].copy(),
                      eng._exact_host.numpy().copy()))

    eng._speculate_once = recording
    return grids


def _serve_spec_run(cfg, eng, reqs, baseline, *, run: int = 1) -> dict:
    """One speculative engine run at full width, counters set to 0 just
    before and read just after; streams checked against the sequential
    baseline; every launch accounted for, by path: ``k + 1`` steps' worth
    of SC-GEMM and paged launches a round (the draft's ``k`` on the SC
    path, the verify's on the cell's), the prefill's SC-GEMM and flash
    launches, a prefill capture's warm-up runs. Graphed, each of the
    draft, verify and rollback steps was captured once, when the engine
    was built, and replays once a round. An exact draft (SC attention,
    drafting at the cell's own bits) must agree with the verify on every
    proposal the budget lets count, and all of them must be accepted."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.steps import WARMUP_RUNS
    k, bits, graphs = eng.speculate_k, eng.draft_bits, eng.graphs
    exact_draft = cfg.attn_sc and bits == cfg.sc_bits
    tag = (f"[serve_spec:k{k}@{bits}b{':sc' if cfg.attn_sc else ''}:"
           f"{'graphed' if graphs else 'eager'}"
           f"{':run2' if run > 1 else ''}]")
    spec = eng.spec_steps()
    replays0 = {name: s.replays for name, s in spec.items()}
    grids = _record_grids(eng) if exact_draft else None
    now = time.perf_counter()
    reqs = [dataclasses.replace(r, enqueued_at=now, uid=r.uid if run == 1
                                else f"{r.uid}-run{run}") for r in reqs]
    counters = _serve_launch_counters()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    results = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    if grids is not None:
        del eng._speculate_once
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()
    rounds = st["spec_rounds"]
    prefill_calls = st["prefill_chunks"]
    warm = WARMUP_RUNS * st["prefill_captures"] if graphs else 0
    per_step = 7 * N_LAYERS + 1
    sc_verify = N_LAYERS if cfg.attn_sc else 0
    flash = N_LAYERS * (prefill_calls + warm)
    want = {"sc_linear": per_step * ((k + 1) * rounds + prefill_calls
                                     + warm),
            "sc_matmul_counts": 0,
            "paged_attention": N_LAYERS * (k + 1) * rounds,
            "paged_attention_sc": (N_LAYERS * k + sc_verify) * rounds,
            "flash_attention": flash,
            "flash_attention_sc": flash if cfg.attn_sc else 0}
    steps_seen = {name: {"captures": s.captures,
                         "replays": s.replays - replays0[name],
                         "launch_counts": s.launch_counts}
                  for name, s in spec.items()}
    log(f"{tag} {st['requests']} requests, {st['generated_tokens']} tokens "
        f"in {st['wall_s']:.2f}s: {st['tok_per_s']:.2f} tok/s, TTFT p50 "
        f"{st['ttft_p50_s'] * 1e3:.1f} ms; {rounds} rounds at "
        f"{st['decode_ms_per_step']:.2f} ms a round (draft "
        f"{st['spec_draft_us']:.0f} us, verify {st['spec_verify_us']:.0f} "
        f"us of device time a round); acceptance "
        f"{st['spec_acceptance_rate']:.4f}, {st['spec_tokens_per_round']:.3f}"
        f" tokens a round (all slots); {prefill_calls} prefill chunks, "
        f"{st['preemptions']} preemptions; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB, the draft's packed weights "
        f"{eng._draft.weight_bytes / 2**30:.3f} GiB")
    log(f"{tag} launches: {launches} (want {want}: a round "
        f"{per_step * (k + 1)} SC-GEMM = {k} x {per_step} + {per_step}, "
        f"{N_LAYERS * (k + 1)} paged = {N_LAYERS} x {k} SC + {N_LAYERS} "
        f"{'SC' if cfg.attn_sc else 'float'})")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    if graphs:
        log(f"{tag} step graphs: " + ", ".join(
            f"{name} captured {v['captures']}, replayed {v['replays']} "
            f"(a replay counts {v['launch_counts']})"
            for name, v in steps_seen.items()))
        verify = {"sc_linear": per_step, "paged_attention": N_LAYERS}
        if sc_verify:
            verify["paged_attention_sc"] = sc_verify
        want_counts = {"draft": {"sc_linear": k * per_step,
                                 "paged_attention": k * N_LAYERS,
                                 "paged_attention_sc": k * N_LAYERS},
                       "verify": verify, "rollback": {}}
        for name, v in steps_seen.items():
            if (v["captures"] != 1 or v["replays"] != rounds
                    or v["launch_counts"] != want_counts[name]):
                raise AssertionError(f"{tag} {name} step: {v}, want one "
                                     f"capture, {rounds} replays, counts "
                                     f"{want_counts[name]}")
    if rounds < 1 or st["decode_steps"] != rounds:
        raise AssertionError(f"{tag} {rounds} rounds, "
                             f"{st['decode_steps']} decode steps")
    exact = None
    if grids is not None:
        # a proposal counts while the budget can keep it: past that the
        # draft's scratch K/V resolve to the shared trash page
        counted = sum(min(k, left) for budget, _, _ in grids
                      for left in budget.values())
        differ = [f"round {i} slot {slot}"
                  for i, (budget, draft, ex) in enumerate(grids)
                  for slot, left in budget.items()
                  if not np.array_equal(draft[slot, :min(k, left)],
                                        ex[slot, :min(k, left)])]
        exact = {"rounds": len(grids), "proposals_within_budget": counted,
                 "accepted": st["spec_accepted_tokens"],
                 "rounds_differing": len(differ)}
        log(f"{tag} exact draft: {counted} proposals within budget over "
            f"{len(grids)} rounds, {st['spec_accepted_tokens']} accepted; "
            f"the draft grid differs from the exact grid in {len(differ)} "
            f"slot-rounds")
        if differ or st["spec_accepted_tokens"] != counted:
            raise AssertionError(f"{tag} the exact draft was not accepted "
                                 f"in full: {exact}; " + "; ".join(differ[:8]))
    mismatched = []
    for req, res, ref in zip(reqs, results, baseline):
        if res.n_generated != req.max_new_tokens:
            raise AssertionError(f"{req.uid}: {res.n_generated} tokens, "
                                 f"asked {req.max_new_tokens}")
        if not np.array_equal(ref, res.tokens):
            first = int(np.argmax(ref != res.tokens))
            mismatched.append(f"{req.uid} first differs at {first}")
    log(f"{tag} {len(reqs) - len(mismatched)}/{len(reqs)} streams identical "
        f"to the sequential baseline")
    if mismatched:
        raise AssertionError(f"{tag} speculative streams differ from the "
                             f"sequential baseline: " + "; ".join(mismatched))
    return {"stats": {k2: v for k2, v in st.items() if k2 != "backpressure"},
            "launches": launches, "max_memory_allocated": peak,
            "draft_weight_bytes": eng._draft.weight_bytes,
            "steps": steps_seen if graphs else None, "exact_draft": exact,
            "streams": [r.tokens.tolist() for r in results]}


def _spec_cfg(attn_sc: bool):
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(ARCHS["smollm-360m"], use_sc_gemm=True,
                               attn_sc=attn_sc, sc_bits=8).validate()


def phase_serve_spec() -> dict:
    """The ``serve`` cell served by self-speculative rounds: (3, 4) eager,
    then (1, 4), (3, 4), (3, 8) graphed, and the ``serve_sc`` cell (SC
    attention at 8 bits) drafting at 8 bits, an exact draft, graphed;
    each graphed engine built on an empty step cache (its own decode
    entry, one draft's weights) and run twice, the second run the cell;
    every run against its cell's sequential baseline."""
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    out = {}
    for attn_sc in (False, True):
        # one cell's weights alive at a time, so each run's peak is its own
        cfg = _spec_cfg(attn_sc)
        params = bind(cfg, "cuda").init_params(0)
        reqs = _workload(cfg, 8, 64, 16, 64, seed=5)
        baseline = _SERVE_CELLS.get(attn_sc, {}).get("baseline")
        name = "serve_sc" if attn_sc else "serve"
        if baseline is None:
            t1 = time.perf_counter()
            baseline = [generate(cfg, params, r.prompt[None],
                                 gen_tokens=r.max_new_tokens,
                                 device="cuda")[0].cpu().numpy()
                        for r in reqs]
            log(f"[serve_spec] the {name} cell's sequential baseline: "
                f"{len(reqs)} requests in {time.perf_counter() - t1:.1f}s")
        else:
            log(f"[serve_spec] the {name} cell's sequential baseline")
        for k, bits, graphs, sc in SPEC_RUNS:
            if sc != attn_sc:
                continue
            steps.clear_decode_steps()
            eng = Engine(cfg, params, device="cuda", capacity=4,
                         max_seq=256, block=64, chunk=16, prefix_cache=False,
                         speculate_k=k, draft_bits=bits, graphs=graphs)
            first = _serve_spec_run(cfg, eng, reqs, baseline)
            cell = first
            if graphs:
                cell = _serve_spec_run(cfg, eng, reqs, baseline, run=2)
                cell["first_run"] = first
            del eng
            out[f"k{k}_b{bits}{'_sc' if attn_sc else ''}_"
                f"{'graphed' if graphs else 'eager'}"] = cell
        del params
    steps.clear_decode_steps()
    tps = {attn_sc: _SERVE_CELLS.get(attn_sc, {}).get("tok_per_s")
           for attn_sc in (False, True)}
    log("[serve_spec] tokens/s beside the non-speculative graphed cells' "
        "(serve " + (f"{tps[False]:.2f}" if tps[False] else "not run")
        + ", serve_sc " + (f"{tps[True]:.2f}" if tps[True] else "not run")
        + "): " + ", ".join(
            f"{name} {r['stats']['tok_per_s']:.2f} (acceptance "
            f"{r['stats']['spec_acceptance_rate']:.3f}, "
            f"{r['stats']['spec_tokens_per_round']:.2f} tokens a round, "
            f"{r['stats']['decode_ms_per_step']:.2f} ms a round)"
            for name, r in out.items()))
    out["serve_graphed_tok_per_s"] = tps[False]
    out["serve_sc_graphed_tok_per_s"] = tps[True]
    return out


def phase_serve_sc() -> dict:
    return _serve_phase(True, ("chunked", "oneshot"))


#: the ``serve_prefix`` cell's geometry: the ``serve`` cells' engine
PREFIX_ENGINE = dict(capacity=4, max_seq=256, block=64, chunk=16)


def _prefix_workload(cfg):
    """8 requests: six prompts are one shared 128-token preamble and a
    distinct suffix of 32 or 64 tokens (160 and 192 tokens); two repeat
    the first 192-token prompt verbatim (a client retrying), so they match
    its three full pages and resume at 176, inside the third, which
    admission copies. New tokens 16-64, prompt + new <= 256."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(21)
    pre = rng.integers(0, cfg.vocab_size, size=(128,))
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size,
                                                 size=(n,))]).astype(np.int32)
               for n in (32, 64, 32, 64, 32, 64)]
    prompts += [prompts[1].copy(), prompts[1].copy()]
    return [Request(uid=f"req-{i}", prompt=p, max_new_tokens=int(
                rng.integers(16, min(64, 256 - len(p)) + 1)))
            for i, p in enumerate(prompts)]


def _prefix_plan(reqs, warm: bool) -> dict:
    """The prefix stats the engine must report, counted here from the
    prompts alone: requests stage in submission order, each after the one
    before it was admitted and registered its full pages, so a prompt
    matches the longest run of full pages it shares with an earlier prompt
    (with any prompt of the workload once the tree is ``warm``); resume is
    that span capped at ``len - 1`` tokens, rounded down to a chunk; the
    page holding a resume inside a matched page is copied."""
    import numpy as np
    block, chunk = PREFIX_ENGINE["block"], PREFIX_ENGINE["chunk"]
    out = {"prefix_hits": 0, "prefix_misses": 0, "prefill_tokens_saved": 0,
           "cow_copies": 0, "chunks": 0}
    for i, r in enumerate(reqs):
        pages = 0
        for other in (reqs if warm else reqs[:i]):
            n = min(len(r.prompt), len(other.prompt)) // block
            same = 0
            while (same < n and np.array_equal(
                    r.prompt[same * block:(same + 1) * block],
                    other.prompt[same * block:(same + 1) * block])):
                same += 1
            pages = max(pages, same)
        resume = min(pages * block, r.prompt_len - 1) // chunk * chunk
        out["prefix_hits" if resume else "prefix_misses"] += 1
        out["prefill_tokens_saved"] += resume
        out["cow_copies"] += bool(resume % block)
        out["chunks"] += -(-(r.prompt_len - resume) // chunk)
    return out


def _prefix_checks(tag, eng, cell, plan, off) -> None:
    """What every ``serve_prefix`` run must hold beside ``_serve_run``'s
    checks: streams equal the cache-off run's; the drained pool holds no
    live page and leaks none; hits, misses, CoW copies, tokens saved and
    prefill chunks are the plan's, fewer chunks than the cache off."""
    st = cell["stats"]
    pool = eng.pool
    got = {k: st[k] for k in ("prefix_hits", "prefix_misses",
                              "prefill_tokens_saved", "cow_copies")}
    got["chunks"] = st["prefill_chunks"]
    leaked = [p for p in pool.retained if pool.refcount[p]]
    log(f"{tag} prefix: {got['prefix_hits']} hits, {got['prefix_misses']} "
        f"misses, {got['prefill_tokens_saved']} prefill tokens saved, "
        f"{got['cow_copies']} CoW copies, {got['chunks']} prefill chunks "
        f"(plan {plan}; cache off {off['stats']['prefill_chunks']}); after "
        f"the drain {pool.pages_live} pages live, {pool.free_pages} free + "
        f"{len(pool.retained)} retained of {pool.n_blocks}, "
        f"{st['prefix_reclaims']} reclaimed")
    if cell["streams"] != off["streams"]:
        raise AssertionError(f"{tag} streams differ from the cache-off run's")
    if (pool.pages_live or leaked
            or pool.free_pages + len(pool.retained) != pool.n_blocks):
        raise AssertionError(f"{tag} the drained pool leaks: "
                             f"{pool.pages_live} live, {leaked} retained "
                             f"and referenced")
    if (got != plan or not st["prefix_cache"] or got["cow_copies"] < 1
            or got["chunks"] >= off["stats"]["prefill_chunks"]):
        raise AssertionError(f"{tag} prefix stats {got}, want {plan} with "
                             f"a CoW copy and fewer chunks than "
                             f"{off['stats']['prefill_chunks']}")


def phase_serve_prefix() -> dict:
    """The reference's default serve, prefix cache on, at smollm-360m's full
    width (SC-GEMM at 8 bits, float attention) over a shared-preamble
    workload, against the cache off (graphed, second run): eager; graphed
    twice on one engine (the second run, over the warm tree, the cell);
    graphed with speculation (k 3, 4 bits); and a rebind — a cache-off
    engine of the shape binds the shared entry (zeroing its pool) between
    two runs of a warm engine, whose tree must go: its next run misses
    first and its streams stay the baseline's."""
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    cfg = _spec_cfg(False)
    params = bind(cfg, "cuda").init_params(0)
    reqs = _prefix_workload(cfg)
    t1 = time.perf_counter()
    baseline = [generate(cfg, params, r.prompt[None],
                         gen_tokens=r.max_new_tokens,
                         device="cuda")[0].cpu().numpy() for r in reqs]
    log(f"[serve_prefix] {len(reqs)} requests (prompts "
        f"{[r.prompt_len for r in reqs]}, new tokens "
        f"{[r.max_new_tokens for r in reqs]}); sequential baseline in "
        f"{time.perf_counter() - t1:.1f}s")
    cold, warm = _prefix_plan(reqs, False), _prefix_plan(reqs, True)

    def engine(graphs, prefix_cache, **kw):
        return Engine(cfg, params, device="cuda", prefix_cache=prefix_cache,
                      graphs=graphs, **PREFIX_ENGINE, **kw)

    def graphed(prefix_cache, tag, **kw):
        """A graphed engine on an empty step cache, run twice."""
        steps.clear_decode_steps()
        eng = engine(True, prefix_cache, **kw)
        first = _serve_run(cfg, eng, reqs, "chunked", baseline, name=tag,
                           captured=len(steps.decode_steps()))
        return eng, first

    out = {}
    eng, first = graphed(False, "serve_prefix:off")
    off = _serve_run(cfg, eng, reqs, "chunked", baseline, run=2,
                     name="serve_prefix:off")
    off["first_run"] = first
    out["off"] = off
    del eng

    steps.clear_decode_steps()
    eng = engine(False, True)
    cell = _serve_run(cfg, eng, reqs, "chunked", baseline, name="serve_prefix")
    _prefix_checks("[serve_prefix:eager]", eng, cell, cold, off)
    out["eager"] = cell
    del eng

    eng, first = graphed(True, "serve_prefix")
    _prefix_checks("[serve_prefix:graphed]", eng, first, cold, off)
    cell = _serve_run(cfg, eng, reqs, "chunked", baseline, run=2,
                      name="serve_prefix")
    _prefix_checks("[serve_prefix:graphed:run2]", eng, cell, warm, off)
    cell["first_run"] = first
    out["graphed"] = cell
    del eng

    steps.clear_decode_steps()
    eng = engine(True, True, speculate_k=3, draft_bits=4)
    cell = _serve_spec_run(cfg, eng, reqs, baseline)
    _prefix_checks("[serve_prefix:spec:k3@4b]", eng, cell, cold, off)
    out["spec"] = cell
    del eng

    # the rebind: the cache-off engine binds the warm engine's entry
    warm_eng, first = graphed(True, "serve_prefix:rebind")
    other = engine(True, False)
    if other._decode is not warm_eng._decode:
        raise AssertionError("[serve_prefix:rebind] the two engines hold "
                             "different decode entries")
    bound = _serve_run(cfg, other, reqs, "chunked", baseline, run=3,
                       name="serve_prefix:rebind:off")
    del other
    again = _serve_run(cfg, warm_eng, reqs, "chunked", baseline, run=4,
                       name="serve_prefix:rebind")
    _prefix_checks("[serve_prefix:rebind:run4]", warm_eng, again, cold, off)
    again["first_run"] = first
    again["bound_between"] = bound
    out["rebind"] = again
    del warm_eng
    steps.clear_decode_steps()

    card = _card_line()
    rows = (("tokens/s", "tok_per_s", 1.0, "{:.2f}"),
            ("TTFT p50 ms", "ttft_p50_s", 1e3, "{:.1f}"),
            ("decode ms/step", "decode_ms_per_step", 1.0, "{:.2f}"),
            ("prefill chunks", "prefill_chunks", 1, "{}"))
    on = out["graphed"]
    log(f"[serve_prefix] {card}: cache off -> on (graphed second runs; on "
        f"= the warm tree): " + ", ".join(
            f"{what} {fmt.format(off['stats'][key] * scale)} -> "
            f"{fmt.format(on['stats'][key] * scale)}"
            for what, key, scale, fmt in rows)
        + f", hits/misses {on['stats']['prefix_hits']}/"
        f"{on['stats']['prefix_misses']}, tokens saved "
        f"{on['stats']['prefill_tokens_saved']}, CoW copies "
        f"{on['stats']['cow_copies']}, peak "
        f"{off['max_memory_allocated'] / 2**30:.3f} -> "
        f"{on['max_memory_allocated'] / 2**30:.3f} GiB; cold graphed run: "
        f"tokens/s {on['first_run']['stats']['tok_per_s']:.2f}, TTFT p50 "
        f"{on['first_run']['stats']['ttft_p50_s'] * 1e3:.1f} ms, "
        f"{on['first_run']['stats']['prefill_chunks']} chunks (its prefill "
        f"capture included)")
    out["card"] = card
    return out


#: kernel record name -> the wrapper counter its launches add to
RECORDS = {"sc_gemm_kernel": "sc_linear",
           "paged_decode_kernel": "paged_attention",
           "flash_fwd_": "flash_attention"}

def _traced(run, wall_ms: float):
    """``run()`` (steps or chunks; it returns how many it ran) under
    ``torch.profiler``, and the trace's summary (``_trace_summary``) with
    ``steps``, that count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = run()
        torch.cuda.synchronize()
    out = _trace_summary(prof, n, wall_ms)
    out["steps"] = n
    return out


def _check_records(tag: str, per: dict, counts: dict) -> None:
    """A graphed replay's kernel records in the trace must equal the
    launches its capture recorded, wrapper by wrapper."""
    if any(per[rec] != counts.get(name, 0) for rec, name in RECORDS.items()):
        raise AssertionError(f"{tag} a replay's kernel records {per} differ "
                             f"from the launches its capture recorded "
                             f"{counts}")


def _profile_engine(cfg, params, graphs: bool, tag: str = "profile") -> dict:
    """``torch.profiler`` over two decode steps of one engine (4 requests
    in 4 slots), against the wall time of two unprofiled steps. Graphed,
    the trace's kernel records a step must equal the launches the capture
    recorded."""
    import torch
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, device="cuda", capacity=4, max_seq=256,
                 block=64, chunk=16, prefix_cache=False, graphs=graphs)
    for r in _workload(cfg, 4, 16, 12, 12, seed=7):
        eng.submit(r)
    while eng.pool.n_free:             # admit all four (prefill unprofiled)
        eng.step()
    # the same decode steps' wall time without the profiler's overhead
    torch.cuda.synchronize()
    steps0, t0 = eng._step, time.perf_counter()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (eng._step - steps0)
    tag = f"[{tag}:graphed]" if graphs else f"[{tag}:eager]"

    def two_steps():
        steps0 = eng._step
        for _ in range(2):
            eng.step()
        return eng._step - steps0
    summary = _traced(two_steps, wall_ms)
    steps = summary["steps"]
    split = _graphed_step_split(eng, wall_ms) if graphs else None
    while eng.step():
        pass
    out = {"graphs": graphs, "decode_steps": steps,
           "wall_ms_per_step": wall_ms, "graphed_step_split": split,
           **summary}
    _log_trace(tag, out, steps, "step", "decode steps")
    busy = out["device_busy_share"]
    device_ms = out["device_ms_per_step"]
    if graphs:
        log(f"{tag} a step's {wall_ms:.3f} ms: graph replay "
            f"{split['replay_ms']:.3f} ms on the device back to back "
            f"(kernels {_ms(device_ms)}), the logits' copy to "
            f"the host {split['logits_copy_ms']:.3f} ms, the rest "
            f"{split['rest_ms']:.3f} ms (inputs' copies, the scheduler, "
            f"sampling)")
        counts = eng._decode.launch_counts
        per_step = out["kernel_records_per_step"]
        out["captured_launch_counts"] = counts
        log(f"{tag} kernel records a replay: sc_gemm_kernel "
            f"{per_step['sc_gemm_kernel']:g} (captured "
            f"{counts.get('sc_linear', 0)}), paged_decode_kernel "
            f"{per_step['paged_decode_kernel']:g} (captured "
            f"{counts.get('paged_attention', 0)})")
        if busy:
            _check_records(tag, per_step, counts)
    return out


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


#: kernels whose device time and records the profile phase reads by name
OUR_KERNELS = ("sc_gemm_kernel", "paged_decode_kernel", "flash_fwd_")


def _trace_summary(prof, steps: int, wall_ms: float) -> dict:
    """A ``torch.profiler`` trace of ``steps`` steps (decode steps or
    prefill chunks) in numbers a step: device time by kernel, host time by
    operator, kernel launches, host API calls and synchronizations, our
    kernels' device time and records, and the device's busy share against
    ``wall_ms``, the unprofiled wall time a step."""
    dev_us = _dev_us
    averages = prof.key_averages()
    events = [e for e in averages if dev_us(e) > 0]
    kernels = [e for e in events if not e.key.startswith(("aten::", "cuda"))]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in averages
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    # every CUDA API call (cuda* and cu*) the host made, by name: a graphed
    # step's launch is one cudaGraphLaunch
    api = {e.key: e.count / max(steps, 1) for e in averages
           if re.match(r"cu(da)?[A-Z]", e.key)}
    # the host waits for the device: a stream or device synchronize (a
    # pageable host-to-device copy and every device-to-host copy make one)
    syncs = {k: v for k, v in api.items()
             if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaMemcpyAsync", "cudaMemcpy")}
    by_kernel = sorted(((dev_us(e) / 1e3 / max(steps, 1), e.count // max(
        steps, 1), e.key[:90]) for e in kernels), reverse=True)
    ours = {key: 0.0 for key in OUR_KERNELS}
    records = {key: 0 for key in OUR_KERNELS}
    for e in kernels:
        for key in ours:
            if key in e.key:
                ours[key] += dev_us(e) / 1e3 / max(steps, 1)
                records[key] += e.count
    host = sorted(((e.self_cpu_time_total / 1e3 / max(steps, 1),
                    e.count // max(steps, 1), e.key[:60])
                   for e in averages
                   if e.key.startswith("aten::")), reverse=True)
    # no device time at all means the profiler did not trace the card
    busy = device_ms / steps / wall_ms if device_ms > 0 else None
    return {"device_ms_per_step": device_ms / steps if busy else None,
            "device_busy_share": busy,
            "top_host_ops": [{"self_cpu_ms_per_step": ms,
                              "calls_per_step": n, "name": name}
                             for ms, n, name in host[:10]],
            "kernel_launches_per_step": launches / max(steps, 1),
            "host_api_calls_per_step": api,
            "host_syncs_per_step": syncs,
            "ours_ms_per_step": ours,
            "kernel_records_per_step": {k: v / max(steps, 1)
                                        for k, v in records.items()},
            "top_kernels": [{"ms_per_step": ms, "calls_per_step": n,
                             "name": name}
                            for ms, n, name in by_kernel[:12]]}


def _log_trace(tag: str, out: dict, n: int, unit: str, what: str) -> None:
    """One trace's line and its top kernels and host operators."""
    busy = out["device_busy_share"]
    api = out["host_api_calls_per_step"]
    ours = out["ours_ms_per_step"]
    busy_txt = (f"{out['device_ms_per_step']:.2f} ms/{unit} of kernels "
                f"(device busy {100 * busy:.1f}%)" if busy else
                "device time not measured (no CUDA events in the trace)")
    log(f"{tag} {n} {what} under torch.profiler; {out[f'wall_ms_per_{unit}']:.2f} ms/{unit} "
        f"wall unprofiled, {busy_txt}, "
        f"{out['kernel_launches_per_step']:.0f} kernel launches/{unit}, "
        f"host API calls/{unit} {sum(api.values()):.0f}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(api.items()))
        + f"; SC-GEMM {ours['sc_gemm_kernel']:.3f} ms, paged "
        f"{ours['paged_decode_kernel']:.3f} ms, flash "
        f"{ours['flash_fwd_']:.3f} ms per {unit}")
    for row in out["top_kernels"][:8]:
        log(f"{tag}   device {row['ms_per_step']:8.3f} ms/{unit} "
            f"{row['calls_per_step']:5d} calls  {row['name']}")
    for row in out["top_host_ops"][:8]:
        log(f"{tag}   host {row['self_cpu_ms_per_step']:8.3f} ms/{unit} "
            f"{row['calls_per_step']:5d} calls  {row['name']}")


def _graphed_step_split(eng, wall_ms: float, n: int = 20) -> dict:
    """A graphed decode step's wall time in parts: ``n`` replays back to
    back timed with CUDA events (the graph's time on the device, gaps
    between its kernels included), ``n`` copies of the logit rows to the
    host, and the rest. The replays write K/V at positions the next real
    steps write again before they read them; the positions are put back."""
    import torch
    step = eng._decode
    saved = step.cache.pos.clone()
    replay_ms = cuda_ms(step.replay, n, warmup=0)
    step.cache.pos.copy_(saved)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng._rows(step.logits)
    copy_ms = (time.perf_counter() - t0) * 1e3 / n
    return {"replay_ms": replay_ms, "logits_copy_ms": copy_ms,
            "rest_ms": wall_ms - replay_ms - copy_ms}


def _profile_prefill(cfg, params, graphs: bool, n: int = 6) -> dict:
    """A chunk of a chunked prefill, eager or graphed: chunks of 16 tokens
    of a 240-token prompt (bucket 256) driven as the engine drives them
    (pinned inputs copied in, the bucket's step replayed), ``n`` timed
    unprofiled (wall ms a chunk, ending in a synchronize) and two under
    ``torch.profiler``. Graphed, the chunk's wall time is split into the
    replay's device time back to back (CUDA events, the staging position
    put back before each) and the rest, and the trace must hold 225
    SC-GEMM and 32 flash kernel records a chunk and no kernel launch from
    the host."""
    import torch
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, device="cuda", capacity=4, max_seq=256,
                 block=64, chunk=16, prefix_cache=False, graphs=graphs)
    req = _workload(cfg, 1, 240, 1, 1, seed=11)[0]
    st = eng._start_prefill(req)     # graphed: captures the bucket's step
    step = st.step
    eng._prefill_chunk_once(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng._prefill_chunk_once(st)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    tag = "[profile:prefill:graphed]" if graphs else "[profile:prefill:eager]"

    def two_chunks():
        for _ in range(2):
            eng._prefill_chunk_once(st)
        return 2
    summary = _traced(two_chunks, wall_ms)
    first = 16 * (n + 1)
    out = {"graphs": graphs, "prompt": req.prompt_len, "bucket": st.bucket,
           "wall_ms_per_chunk": wall_ms, **summary}
    _log_trace(tag, out, 2, "chunk", f"prefill chunks (offsets "
               f"{first}, {first + 16})")
    if graphs:
        saved = step.cache.pos.clone()

        def replay():
            step.cache.pos.copy_(saved)
            step.replay()

        replay_ms = cuda_ms(replay, 10, warmup=0)
        out["graphed_chunk_split"] = {"replay_ms": replay_ms,
                                      "rest_ms": wall_ms - replay_ms}
        counts = step.launch_counts
        per = out["kernel_records_per_step"]
        log(f"{tag} a chunk's {wall_ms:.3f} ms: graph replay "
            f"{replay_ms:.3f} ms on the device back to back (kernels "
            f"{_ms(out['device_ms_per_step'])}), the rest "
            f"{wall_ms - replay_ms:.3f} ms (the inputs' copies, the "
            f"scheduler's bookkeeping); kernel records a replay: "
            f"sc_gemm_kernel {per['sc_gemm_kernel']:g}, flash "
            f"{per['flash_fwd_']:g} (captured {counts})")
        if out["kernel_launches_per_step"]:
            raise AssertionError(f"{tag} a graphed chunk launched "
                                 f"{out['kernel_launches_per_step']} kernels "
                                 f"from the host")
        if out["device_busy_share"]:
            _check_records(tag, per, counts)
    return out


def phase_profile() -> dict:
    """Where a decode step's and a prefill chunk's time goes, eager and
    graphed: device time by kernel, host time by operator, host API calls,
    and the device's busy share against the wall time of unprofiled steps
    or chunks of the same engine."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import bind
    cfg = dataclasses.replace(ARCHS["smollm-360m"],
                              use_sc_gemm=True).validate()
    params = bind(cfg, "cuda").init_params(0)
    out = {"eager": _profile_engine(cfg, params, graphs=False),
           "graphed": _profile_engine(cfg, params, graphs=True)}
    steps.clear_decode_steps()
    out["prefill"] = {"eager": _profile_prefill(cfg, params, graphs=False),
                      "graphed": _profile_prefill(cfg, params, graphs=True)}
    steps.clear_decode_steps()
    e, g = out["prefill"]["eager"], out["prefill"]["graphed"]
    log("[profile:prefill] eager -> graphed a chunk: wall "
        f"{e['wall_ms_per_chunk']:.3f} -> {g['wall_ms_per_chunk']:.3f} ms, "
        f"host API calls {sum(e['host_api_calls_per_step'].values()):.0f} "
        f"-> {sum(g['host_api_calls_per_step'].values()):.0f}, device "
        f"{_ms(e['device_ms_per_step'])} -> {_ms(g['device_ms_per_step'])}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script measures "
              "the port on the card and has nothing to run without one",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import exact_float32
    exact_float32()   # float32 products in full float32, TF32 off

    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))   # a debugging subset: no result
    t0 = time.perf_counter()
    card = phase_card()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    phases = (("build", phase_build), ("sc_gemm", phase_sc_gemm),
              ("paged", phase_paged), ("flash", phase_flash),
              ("stream", phase_stream), ("paper", phase_paper),
              ("small_model", phase_small_model), ("serve", phase_serve),
              ("serve_sc", phase_serve_sc), ("serve_spec", phase_serve_spec),
              ("serve_prefix", phase_serve_prefix),
              ("profile", phase_profile),
              ("serve_ssm", phase_serve_ssm),
              ("serve_hybrid", phase_serve_hybrid))
    for name, fn in phases:
        if only is None or name in only:
            report[name] = fn()
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    if only is not None:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / "chip_smoke_partial.json").write_text(
            json.dumps(report, indent=1, default=str))
        log(f"[done] phases {sorted(only)} passed; no result line for a "
            f"subset")
        return 0

    src = "src/repro_torch/kernels/csrc"
    step = report["sc_gemm"]["decode_step"]
    paged = report["paged"]["cases"]
    serve, serve_sc = report["serve"], report["serve_sc"]
    stream = report["stream"]["timing"][12]

    def paged_row(bits, shape):
        return next(r for r in paged if r["dtype"] == "bfloat16"
                    and r["sc_bits"] == bits and r["shape"] == shape)

    def paged_entry(name, bits, launches):
        row, long_row = paged_row(bits, "serve"), paged_row(bits, "long")
        hybrid_row = paged_row(bits, "hybrid")
        dev_ms = row["device_ms"]
        return {"name": name, "route": "cuda",
                "source": f"{src}/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:194",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in paged
                                   if r["sc_bits"] == bits),
                "ms": N_LAYERS * row["ms"],
                "plain_ms": N_LAYERS * row["plain_ms"],
                "bound_ms": N_LAYERS * row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "device_ms": None if dev_ms is None else N_LAYERS * dev_ms,
                "unit": f"one smollm-360m decode step: 32 calls at C=4 KV=5 "
                        f"G=3 D=64 block=64 MB=4 bf16"
                        f"{' SC %d-bit' % bits if bits else ''}, positions "
                        f"{row['positions']}",
                "long_context_call": {
                    key: long_row[key] for key in
                    ("positions", "ms", "device_ms", "plain_ms", "bound_ms",
                     "bound_by")} | {"MB": long_row["layout"]["MB"]},
                "hybrid_call": {
                    key: hybrid_row[key] for key in
                    ("positions", "layout", "ms", "device_ms", "plain_ms",
                     "bound_ms", "bound_by")}}

    def flash_entry(name, key, bits, launches):
        timing = report["flash"]["timing"][key]
        t = timing["chunked_prefill"]
        lib, dev_ms = t["library_ms"], t["device_ms"]
        by = {c["bound_by"] for c in timing["calls"][:4]}
        longs = timing["long_prompts"]
        return {"name": name, "route": "cuda",
                "source": f"{src}/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:91",
                "launches": launches,
                "max_abs_err": max([r["max_abs_err"] for r in
                                    report["flash"]["cases"]
                                    if r["sc_bits"] in ((None,) if bits is None
                                                        else (4, 8))]
                                   + [r["max_abs_err"]
                                      for r in longs.values()]),
                "ms": N_LAYERS * t["ms"], "plain_ms": N_LAYERS * t["plain_ms"],
                "bound_ms": N_LAYERS * t["bound_ms"],
                "bound_by": by.pop() if len(by) == 1 else "bytes",
                "library_ms": None if lib is None else N_LAYERS * lib,
                "device_ms": None if dev_ms is None else N_LAYERS * dev_ms,
                "unit": "one 64-token prompt's chunked prefill: 32 layers x 4 "
                        "chunk calls (16 rows at offsets 0/16/32/48 over the "
                        "64-token bucket, the offset read on the card), "
                        "H=15 KV=5 D=64 bf16"
                        + (f" SC {bits}-bit" if bits else ""),
                "long_prompt_call": {
                    n: {k2: r[k2] for k2 in
                        ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "library_device_ms")}
                    for n, r in longs.items()},
                "hybrid_chunk_call": {
                    k2: timing["hybrid_chunk"][k2] for k2 in
                    ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "library_device_ms")}}

    def runs(cell):
        """A cell's serving runs, each counted from 0: the cell itself,
        the graphed first run, the eager run beside it and (the rebind)
        the run of the engine that bound its entry in between."""
        yield cell
        for key in ("first_run", "eager", "bound_between"):
            if isinstance(cell.get(key), dict):
                yield from runs(cell[key])

    # every serving run's counters, the attention launches by path as the
    # wrappers counted them (``*_sc``: the SC path's)
    served = [r for cell in (serve, *serve_sc.values(),
                             *(c for c in report["serve_spec"].values()
                               if isinstance(c, dict)),
                             *(c for c in report["serve_prefix"].values()
                               if isinstance(c, dict)),
                             *(report[f][mode] for f in ("serve_ssm",
                                                         "serve_hybrid")
                               for mode in ("chunked", "oneshot")))
              for r in runs(cell)]
    total = {name: sum(r["launches"][name] for r in served)
             for name in served[0]["launches"]}
    kernels = [
        {"name": "sc_gemm", "route": "cuda",
         "source": f"{src}/sc_matmul.cu",
         "replaces": "src/repro/kernels/sc_matmul.py:89",
         "launches": total["sc_linear"],
         "max_abs_err": 0.0,
         "ms": step["ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"],
         "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in
                                     report["sc_gemm"]["timing"]
                                     if r["M"] == 4) else "operations"),
         "library_ms": None, "device_ms": step["device_ms"],
         "chain_ms": step["chain_ms"],
         "unit": "one smollm-360m decode step at M=4: 225 fused calls "
                 "(32 layers x 7 projections + the LM head), bf16 rows",
         "families": {
             arch: {what: fam[what] for what in ("decode_step",
                                                 "prefill_chunk")}
             for arch, fam in report["sc_gemm"]["families"].items()}},
        paged_entry("paged_attention", None,
                    total["paged_attention"] - total["paged_attention_sc"]),
        paged_entry("paged_attention_sc", 8, total["paged_attention_sc"]),
        flash_entry("flash_attention", "float", None,
                    total["flash_attention"] - total["flash_attention_sc"]),
        flash_entry("flash_attention_sc", "sc8", 8,
                    total["flash_attention_sc"]),
        {"name": "sc_stream_mul", "route": "cuda",
         "source": f"{src}/sc_bitops.cu",
         "replaces": "src/repro/kernels/sc_bitops.py:84",
         "launches": report["stream"]["launches"],
         "max_abs_err": report["stream"]["max_abs_err"],
         "ms": stream["ms"], "plain_ms": stream["plain_ms"],
         "bound_ms": stream["bound_ms"], "bound_by": stream["bound_by"],
         "library_ms": None, "device_ms": stream["device_ms"],
         "unit": "exhaustive B=12 grid, 16,777,216 pairs",
         "exhaustive_grids": {
             f"B={bits}": {k2: t[k2] for k2 in
                           ("pairs", "ms", "device_ms", "plain_ms",
                            "bound_ms", "bound_by")}
             for bits, t in report["stream"]["timing"].items()}},
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    log(f"[done] {report['seconds']:.1f}s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
