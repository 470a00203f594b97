#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts on
the GPU: builds its CUDA kernels from this checkout's sources, holds each
kernel against its plain PyTorch version on the card, then serves requests
through the port's engine at smollm-360m's full width and checks the
streams against the sequential baseline.

    python3 chip_smoke.py            # one CUDA card; ~10 minutes at most
    python3 chip_smoke.py --only build,sc_gemm   # a subset, for debugging

Phases (each raises on failure, so any failure exits non-zero):

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. build both kernels (one ``nvcc`` per source, started together);
3. SC-GEMM counts kernel vs its plain version at the main path's shapes
   (decode M=4 and chunked-prefill M=16) plus ragged and other-width
   cases — counts must be exactly equal; kernel ms, plain ms and the bound;
4. paged decode-attention kernel vs its plain version at smollm's layout,
   f32 and bf16, fragmented tables, one windowed case;
5. a reduced smollm-360m (float32) cross-check: prefill logits on the
   card agree with the CPU's, and the engine's streams on both are
   compared;
6. serve 8 requests at full width (smollm-360m, bf16, SC-GEMM on, random
   weights from seed 0) through ``Engine(capacity=4, max_seq=256, block=64,
   chunk=16)``; the launch counters, set to 0 just before, must show both
   kernels on every decode step; streams must equal the sequential
   ``generate`` baseline on the card;
7. a ``torch.profiler`` pass over two full-width decode steps: device
   time by kernel and host time by operator (where a step's time goes).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json`` (``$CHIP_SMOKE_OUT`` names another directory).
Nothing of JAX or of the JAX package is imported.
"""
from __future__ import annotations

import json
import math
import os
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

# smollm-360m projection shapes (K, N) and their calls per decode step:
# q, o (960, 960); k, v (960, 320); w1, w3 (960, 2560); w2 (2560, 960) in
# each of 32 layers, and the tied LM head (960, 49152) once.
SC_SHAPES = {(960, 960): 64, (960, 320): 64, (960, 2560): 64,
             (2560, 960): 32, (960, 49152): 1}
N_LAYERS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
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


def phase_sc_gemm() -> dict:
    import torch
    from repro_torch.kernels.sc_matmul import (sc_matmul_counts_signed,
                                               sc_matmul_counts_signed_torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # exactness: main-path shapes, a ragged shape, and other plane widths
    cases = [(m, k, n, 8) for m in (4, 16) for (k, n) in SC_SHAPES]
    cases += [(7, 1000, 333, 8), (37, 129, 65, 8), (1, 960, 960, 8),
              (64, 960, 320, 8), (4, 960, 960, 4), (4, 200, 96, 16)]
    for m, k, n, bits in cases:
        a, b = _planes(m, k, n, bits, gen, dev)
        got = sc_matmul_counts_signed(a, b, bits=bits)
        want = sc_matmul_counts_signed_torch(a, b, bits=bits)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"SC-GEMM counts differ at M={m} K={k} "
                                 f"N={n} bits={bits}: {bad} entries")
        timed = bits == 8 and (k, n) in SC_SHAPES and m in (4, 16)
        row = {"M": m, "K": k, "N": n, "bits": bits, "exact": True}
        if timed:
            # cycle through enough copies of B that it comes from HBM, as
            # it does on the decode path (every layer's weights evict the
            # last one's from the 50 MB L2)
            copies = [b] + [b.clone() for _ in
                            range(max(0, math.ceil(128e6 / b.nbytes) - 1))]
            it = iter(range(1 << 30))
            ms = cuda_ms(lambda: sc_matmul_counts_signed(
                a, copies[next(it) % len(copies)], bits=bits), iters=50)
            plain_ms = cuda_ms(lambda: sc_matmul_counts_signed_torch(
                a, b, bits=bits), iters=2, warmup=1)
            nbytes = (m * k + k * n) * a.element_size() + m * n * 4
            ops = 2 * m * n * k
            bound = max(nbytes / HBM_BYTES_S, ops / INT8_OPS_S) * 1e3
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes" if nbytes / HBM_BYTES_S
                       >= ops / INT8_OPS_S else "operations",
                       bytes=nbytes, ops=ops)
            log(f"[sc_gemm] M={m:3d} K={k:5d} N={n:6d}: exact, kernel "
                f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({row['bound_by']})")
        else:
            log(f"[sc_gemm] M={m:3d} K={k:5d} N={n:6d} bits={bits}: exact")
        rows.append(row)
    # one decode step at M = capacity = 4: every projection once
    step = {key: 0.0 for key in ("ms", "plain_ms", "bound_ms")}
    for r in rows:
        if r.get("ms") is not None and r["M"] == 4:
            calls = SC_SHAPES[(r["K"], r["N"])]
            for key in step:
                step[key] += calls * r[key]
    log(f"[sc_gemm] one decode step (M=4, {sum(SC_SHAPES.values())} calls): "
        f"kernel {step['ms']:.3f} ms, plain {step['plain_ms']:.1f} ms, "
        f"bound {step['bound_ms']:.4f} ms")
    return {"cases": rows, "decode_step": step}


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


def phase_paged() -> dict:
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # f32: the kernel reassociates the softmax sums over 32-token tiles
    # (online rescaling) against the plain version's one exact softmax, a
    # few float32 ulps; bf16: both cast the float32 result to bf16 once,
    # so they may land one bf16 ulp (2**-8 relative) apart.
    tol = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
    cases = [(torch.float32, None, [100, 255, 37, 64]),
             (torch.bfloat16, None, [100, 255, 37, 64]),
             (torch.float32, 40, [100, 255, 37, 64]),
             (torch.bfloat16, 40, [200, 3, 130, 191]),
             (torch.float32, None, [0, 63, 127, 191])]
    rows = []
    for dtype, window, positions in cases:
        q, k, v, tables, qpos = _paged_case(dtype, window, positions, gen,
                                            dev)
        got = paged_attention(q, k, v, tables, qpos, window=window)
        want = paged_attention_torch(q, k, v, tables, qpos, window=window)
        torch.cuda.synchronize()
        rtol, atol = tol[dtype]
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol):
            raise AssertionError(f"paged kernel disagrees ({dtype}, window "
                                 f"{window}, positions {positions}): max abs "
                                 f"err {err}")
        ms = cuda_ms(lambda: paged_attention(q, k, v, tables, qpos,
                                             window=window), iters=200)
        plain_ms = cuda_ms(lambda: paged_attention_torch(
            q, k, v, tables, qpos, window=window), iters=20)
        c, kv, g, d = q.shape
        esz = q.element_size()
        rows_read = sum(min(p + 1, window or p + 1) for p in positions)
        nbytes = (2 * rows_read * kv * d * esz + 2 * q.numel() * esz
                  + tables.numel() * 4 + qpos.numel() * 4)
        ops = 4 * rows_read * kv * g * d
        rate = BF16_OPS_S if dtype == torch.bfloat16 else FP32_OPS_S
        bound = max(nbytes / HBM_BYTES_S, ops / rate) * 1e3
        row = {"dtype": str(dtype).replace("torch.", ""), "window": window,
               "positions": positions, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_S >= ops / rate
               else "operations", "bytes": nbytes, "ops": ops}
        rows.append(row)
        log(f"[paged] {row['dtype']:8s} window={window} pos={positions}: "
            f"max abs err {err:.2e} (rtol {rtol}, atol {atol}), kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.5f} ms")
    return {"cases": rows}


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
                     block=32, chunk=16)
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


def phase_serve() -> dict:
    import numpy as np
    import torch
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.sc_matmul import sc_matmul_counts_signed
    from repro_torch.launch.serve import generate
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(ARCHS["smollm-360m"],
                              use_sc_gemm=True).validate()
    t0 = time.perf_counter()
    params = bind(cfg, "cuda").init_params(0)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, SC-GEMM "
        f"{cfg.sc_bits}-bit; init {time.perf_counter() - t0:.1f}s")

    def engine():
        return Engine(cfg, params, device="cuda", capacity=4, max_seq=256,
                      block=64, chunk=16, prefix_cache=False, speculate_k=0)

    # warm-up: first calls load the kernels and PyTorch's own modules
    engine().run(_workload(cfg, 1, 20, 2, 2, seed=99))
    reqs = _workload(cfg, 8, 64, 16, 64, seed=5)
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc_matmul_counts_signed.launches = 0
    paged_attention.launches = 0
    results = eng.run(reqs)
    torch.cuda.synchronize()
    launches = {"sc_matmul_counts": sc_matmul_counts_signed.launches,
                "paged_attention": paged_attention.launches}
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()
    steps = st["decode_steps"]
    log(f"[serve] {st['requests']} requests, {st['generated_tokens']} tokens "
        f"in {st['wall_s']:.2f}s: {st['tok_per_s']:.2f} tok/s, TTFT p50 "
        f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode {st['decode_ms_per_step']:.2f}"
        f" ms/step over {steps} steps, {st['prefill_chunks']} prefill chunks, "
        f"{st['preemptions']} preemptions, peak pages {st['peak_pages']}/"
        f"{st['n_blocks']}")
    log(f"[serve] launches: SC-GEMM {launches['sc_matmul_counts']} "
        f"(>= {steps} x {7 * N_LAYERS + 1}), paged attention "
        f"{launches['paged_attention']} (>= {steps} x {N_LAYERS}); "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    if launches["sc_matmul_counts"] < steps * (7 * N_LAYERS + 1):
        raise AssertionError(f"SC-GEMM kernel launched "
                             f"{launches['sc_matmul_counts']} times in "
                             f"{steps} decode steps")
    if launches["paged_attention"] < steps * N_LAYERS:
        raise AssertionError(f"paged kernel launched "
                             f"{launches['paged_attention']} times in "
                             f"{steps} decode steps")
    if steps < 1:
        raise AssertionError("the engine ran no decode step")
    # correctness: in-vocab streams of the requested lengths, identical to
    # the sequential B=1 baseline on the card (batch invariance)
    t1 = time.perf_counter()
    mismatched = []
    for req, res in zip(reqs, results):
        if res.n_generated != req.max_new_tokens:
            raise AssertionError(f"{req.uid}: {res.n_generated} tokens, "
                                 f"asked {req.max_new_tokens}")
        if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"{req.uid}: token out of vocabulary")
        ref = generate(cfg, params, req.prompt[None],
                       gen_tokens=req.max_new_tokens,
                       device="cuda")[0].cpu().numpy()
        if not np.array_equal(ref, res.tokens):
            first = int(np.argmax(ref != res.tokens))
            mismatched.append(f"{req.uid} first differs at {first}")
    log(f"[serve] sequential baseline ({time.perf_counter() - t1:.1f}s): "
        f"{len(reqs) - len(mismatched)}/{len(reqs)} streams identical")
    if mismatched:
        raise AssertionError("engine streams differ from the sequential "
                             "baseline: " + "; ".join(mismatched))
    return {"stats": {k: v for k, v in st.items() if k != "backpressure"},
            "launches": launches, "max_memory_allocated": peak,
            "first_stream": results[0].tokens[:16].tolist()}


def phase_profile() -> dict:
    """Where a decode step's time goes: ``torch.profiler`` over two decode
    steps of a full-width serve (4 requests in 4 slots): device time by
    kernel, host time by operator, and the device's busy share against
    the wall time of two unprofiled steps of the same engine."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    cfg = dataclasses.replace(ARCHS["smollm-360m"],
                              use_sc_gemm=True).validate()
    params = bind(cfg, "cuda").init_params(0)
    eng = Engine(cfg, params, device="cuda", capacity=4, max_seq=256,
                 block=64, chunk=16)
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
    steps0 = eng._step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
    steps = eng._step - steps0
    while eng.step():
        pass

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    kernels = [e for e in events if not e.key.startswith(("aten::", "cuda"))]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    by_kernel = sorted(((dev_us(e) / 1e3 / max(steps, 1), e.count // max(
        steps, 1), e.key[:90]) for e in kernels), reverse=True)
    ours = {"sc_counts_kernel": 0.0, "paged_decode_kernel": 0.0}
    for ms, _, name in by_kernel:
        for key in ours:
            if key in name:
                ours[key] += ms
    host = sorted(((e.self_cpu_time_total / 1e3 / max(steps, 1),
                    e.count // max(steps, 1), e.key[:60])
                   for e in prof.key_averages()
                   if e.key.startswith("aten::")), reverse=True)
    # no device time at all means the profiler did not trace the card
    busy = device_ms / steps / wall_ms if device_ms > 0 else None
    out = {"decode_steps": steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms / steps if busy else None,
           "device_busy_share": busy,
           "top_host_ops": [{"self_cpu_ms_per_step": ms, "calls_per_step": n,
                             "name": name} for ms, n, name in host[:10]],
           "kernel_launches_per_step": launches / max(steps, 1),
           "ours_ms_per_step": ours,
           "top_kernels": [{"ms_per_step": ms, "calls_per_step": n,
                            "name": name} for ms, n, name in by_kernel[:12]]}
    busy_txt = (f"{device_ms / steps:.2f} ms/step of kernels (device busy "
                f"{100 * busy:.1f}%)" if busy else
                "device time not measured (no CUDA events in the trace)")
    log(f"[profile] {steps} decode steps under torch.profiler; "
        f"{out['wall_ms_per_step']:.1f} ms/step wall unprofiled, {busy_txt}, "
        f"{out['kernel_launches_per_step']:.0f} kernel launches/step; "
        f"SC-GEMM {ours['sc_counts_kernel']:.2f} ms, paged "
        f"{ours['paged_decode_kernel']:.2f} ms per step")
    for row in out["top_kernels"][:8]:
        log(f"[profile]   device {row['ms_per_step']:8.3f} ms/step "
            f"{row['calls_per_step']:5d} calls  {row['name']}")
    for row in out["top_host_ops"][:8]:
        log(f"[profile]   host {row['self_cpu_ms_per_step']:8.3f} ms/step "
            f"{row['calls_per_step']:5d} calls  {row['name']}")
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
              ("paged", phase_paged), ("small_model", phase_small_model),
              ("serve", phase_serve), ("profile", phase_profile))
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
    paged_bf16 = next(r for r in report["paged"]["cases"]
                      if r["dtype"] == "bfloat16" and r["window"] is None)
    kernels = [
        {"name": "sc_matmul_counts", "route": "cuda",
         "source": f"{src}/sc_matmul.cu",
         "replaces": "src/repro/kernels/sc_matmul.py:89",
         "launches": report["serve"]["launches"]["sc_matmul_counts"],
         "max_abs_err": 0.0,
         "ms": step["ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "unit": "one smollm-360m decode step at M=4: 225 calls "
                 "(32 layers x 7 projections + the LM head)"},
        {"name": "paged_attention", "route": "cuda",
         "source": f"{src}/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:194",
         "launches": report["serve"]["launches"]["paged_attention"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in report["paged"]["cases"]),
         "ms": N_LAYERS * paged_bf16["ms"],
         "plain_ms": N_LAYERS * paged_bf16["plain_ms"],
         "bound_ms": N_LAYERS * paged_bf16["bound_ms"],
         "bound_by": paged_bf16["bound_by"], "library_ms": None,
         "unit": f"one smollm-360m decode step: 32 calls at C=4 KV=5 G=3 "
                 f"D=64 block=64 MB=4 bf16, positions "
                 f"{paged_bf16['positions']}"},
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
