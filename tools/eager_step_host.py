#!/usr/bin/env python3
"""The host time of an eager step on the card: smollm-360m at full width
under SC-GEMM at 8 bits (packed weights), one paged decode step of 4
slots (``launch.steps.paged_decode_step``, as an engine with
``graphs=False`` runs it), and a one-shot prefill of 2 x 128 tokens.

For each, ``host_ms`` is the host clock around enqueueing one step with
nothing else in flight (the card idles before each step, so the host
time is all that the step's issue costs), and ``wall_ms`` the host clock
around the step and a synchronize; the medians of ``--steps`` steps after
two untimed ones. The kernels' launches a step are counted by their
wrappers.

    python3 tools/eager_step_host.py [--src DIR] [--steps N]

``--src`` (default: this checkout's ``src``) is the source tree whose
``repro_torch`` is timed, so that one call can time two trees on one
card, in turns. Prints one JSON line, with the card's name and power
limit. Needs a CUDA card and nvcc, as the kernels do.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _timed(fn, steps: int) -> dict:
    import torch
    host, wall = [], []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 2:
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
    return {"host_ms": statistics.median(host),
            "wall_ms": statistics.median(wall),
            "host_ms_all": host}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.device import exact_float32
    from repro_torch.kernels.ops import launch_counters
    from repro_torch.launch import steps
    from repro_torch.models import bind, cache_ops, pack_sc_weights
    if not torch.cuda.is_available():
        raise SystemExit("eager_step_host: no CUDA device is visible")
    exact_float32()
    cfg = dataclasses.replace(ARCHS["smollm-360m"], use_sc_gemm=True,
                              sc_bits=8, sc_impl="pallas").validate()
    m = bind(cfg, "cuda")
    params = pack_sc_weights(m.init_params(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    pool = cache_ops.paged_init(m.init_cache, 4, 16, 64)
    for leaf in cache_ops.seq_leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda")
                   .to(leaf.dtype))
    pos = torch.tensor([40, 100, 180, 255], dtype=pool.pos.dtype,
                       device="cuda")
    tables = torch.arange(16, dtype=torch.int32, device="cuda").reshape(4, 4)
    toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                         device="cuda", dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                           device="cuda", dtype=torch.int32)
    counters = launch_counters()

    def decode():
        pool.pos.copy_(pos)
        steps.paged_decode_step(m, params, pool, tables, {"tokens": toks})

    def prefill():
        steps.prefill_step(m, params, {"tokens": prompt})

    out = {"card": _card(), "src": args.src}
    for name, fn in (("decode", decode), ("prefill", prefill)):
        before = {n: c.launches for n, c in counters.items()}
        fn()
        launches = {n: c.launches - before[n] for n, c in counters.items()
                    if c.launches != before[n]}
        out[name] = _timed(fn, args.steps) | {"launches": launches}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
