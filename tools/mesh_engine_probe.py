#!/usr/bin/env python3
"""The serving engine on a mesh (``serving.Engine(mesh=...)``) on one NCCL
rank of the card, in two parts.

``probe``: every mode of reduced smollm-360m (chunked with the prefix
cache, one-shot, speculative at ``k=2, draft_bits=4``, the contiguous
pool) and one reduced config of each other family (gemma2-9b,
qwen3-moe-235b-a22b, mamba2-130m, zamba2-7b, musicgen-large, qwen2-vl-2b;
chunked), bf16 under SC-GEMM at 8 bits, served on
``default_serving_mesh()`` and by the graphed plain engine on the same
requests; each cell prints whether the streams are equal, or the error
it raised, and goes on to the next.

``profile``: smollm-360m at full width (bf16, SC-GEMM at 8 bits, seed-0
weights) in ``Engine(capacity=2, max_seq=256, block=64, chunk=16)``: the
host clock around a mesh decode step and a synchronize (the mean of 5
after 2 untimed), the same step of an eager plain engine
(``graphs=False``), and a ``cProfile`` of 3 mesh steps: DTensor dispatches
a step and the functions with the most cumulative time.

    python3 tools/mesh_engine_probe.py [probe|profile|both]

Prints the card's name and power limit first, and one JSON line a part;
exits 1 when a probed cell raised or served other streams. Needs a CUDA
card and nvcc, as the kernels do.
"""
from __future__ import annotations

import cProfile
import dataclasses
import json
import pstats
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import bind  # noqa: E402
from repro_torch.serving import (Engine, Request,  # noqa: E402
                                 default_serving_mesh)

MODES = {"chunked": {}, "oneshot": dict(prefill_mode="oneshot"),
         "speculative": dict(speculate_k=2, draft_bits=4),
         "contiguous": dict(paged=False)}
FAMILIES = ("gemma2-9b", "qwen3-moe-235b-a22b", "mamba2-130m", "zamba2-7b",
            "musicgen-large", "qwen2-vl-2b")
PROBE_ENGINE = dict(capacity=2, max_seq=64, block=16, chunk=8)
PROFILE_ENGINE = dict(capacity=2, max_seq=256, block=64, chunk=16)


def _requests(cfg, length: int, gens, seed: int):
    """Two prompts of ``length`` tokens, then the first again."""
    rng = np.random.default_rng(seed)
    kb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = [rng.integers(0, cfg.vocab_size, (length, *kb))
               .astype(np.int32) for _ in range(2)]
    prompts.append(prompts[0])
    return [Request(uid=f"r{i}", prompt=p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, gens))]


def probe(mesh) -> list:
    cells = [("smollm-360m", m) for m in MODES]
    cells += [(arch, "chunked") for arch in FAMILIES]
    out = []
    for arch, mode in cells:
        cfg = ARCHS[arch].reduced(dtype="bfloat16", use_sc_gemm=True,
                                  sc_bits=8)
        params = bind(cfg, "cuda").init_params(0)
        cell = {"arch": arch, "mode": mode}
        try:
            want = Engine(cfg, params, **PROBE_ENGINE, **MODES[mode]).run(
                _requests(cfg, 32, (6, 9, 5), seed=4))
            engine = Engine(cfg, params, mesh=mesh, **PROBE_ENGINE,
                            **MODES[mode])
            got = engine.run(_requests(cfg, 32, (6, 9, 5), seed=4))
            cell["equal"] = all(np.array_equal(a.tokens, b.tokens)
                                for a, b in zip(got, want))
            cell["mesh_ms_per_step"] = engine.stats["decode_ms_per_step"]
        except Exception as e:          # report it, go on to the next cell
            cell["error"] = f"{type(e).__name__}: {e}"
            cell["where"] = traceback.format_exc().splitlines()[-6:]
        print(f"[probe] {cell}", flush=True)
        out.append(cell)
    return out


def _step_ms(step, n: int = 5) -> float:
    def once():
        step.replay()
        torch.cuda.synchronize()
    for _ in range(2):
        once()
    t = time.perf_counter()
    for _ in range(n):
        once()
    return (time.perf_counter() - t) / n * 1e3


def profile(mesh) -> dict:
    cfg = dataclasses.replace(ARCHS["smollm-360m"], use_sc_gemm=True,
                              sc_bits=8).validate()
    params = bind(cfg, "cuda").init_params(0)
    warm = _requests(cfg, 64, (4, 4, 4), seed=11)[:2]
    engine = Engine(cfg, params, mesh=mesh, **PROFILE_ENGINE)
    engine.run(warm)
    step = engine._decode
    step.tables.copy_(torch.arange(8, dtype=torch.int32,
                                   device="cuda").reshape(2, 4))
    mesh_ms = _step_ms(step)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(3):
        step.replay()
        torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    dispatches = sum(calls[1] for func, calls in stats.stats.items()
                     if func[0].endswith("distributed/tensor/_dispatch.py")
                     and func[2] == "wrap") / 3
    top = sorted(((v[3], f"{Path(k[0]).name}:{k[1]}({k[2]})")
                  for k, v in stats.stats.items()), reverse=True)[:12]
    total = stats.total_tt
    plain = Engine(cfg, params, graphs=False, **PROFILE_ENGINE)
    plain._decode.tables.copy_(step.tables)
    plain_ms = _step_ms(plain._decode)
    return {"mesh_step_ms": mesh_ms, "plain_eager_step_ms": plain_ms,
            "dtensor_dispatches_per_step": dispatches,
            "profiled_s_per_step": total / 3,
            "top_cumulative": [{"fn": name, "share": cum / total}
                               for cum, name in top]}


def main() -> int:
    part = sys.argv[1] if len(sys.argv) > 1 else "both"
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    bad = []
    try:
        mesh = default_serving_mesh()
        if part in ("probe", "both"):
            cells = probe(mesh)
            bad = [c for c in cells if not c.get("equal")]
            print(json.dumps({"probe": cells}), flush=True)
        if part in ("profile", "both"):
            print(json.dumps({"profile": profile(mesh)}), flush=True)
    finally:
        dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
