"""End to end: train a ~100M-class LM on the synthetic pipeline, with
checkpoint and restart demonstrated mid-run (port of the reference's
``examples/train_lm.py``).

By default it trains a width-reduced smollm variant ("smollm-mini");
``--full-360m`` trains smollm-360m as registered.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        [--batch 8 --seq 128] [--full-360m] [--device cpu]

Runs on the card unless ``--device cpu`` is given. Two calls of
``launch.train.train`` share one temporary checkpoint folder: the first
trains ``steps // 2`` steps and saves, the second restores that save and
trains on to ``steps``. ``main`` returns both calls' losses, their wall
seconds and, on the card, the peak device memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.device import resolve_device
from repro_torch.launch.train import train

__all__ = ["mini_config", "main"]


def mini_config():
    """The reference example's "smollm-mini": smollm-360m reduced to
    float32 at 4 layers, d_model 256, 4 heads of 64 (2 KV), d_ff 1024 and
    a 4,096-token vocabulary."""
    return dataclasses.replace(
        ARCHS["smollm-360m"].reduced(dtype="float32"),
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=1024, vocab_size=4096, name="smollm-mini")


def _timed(dev: torch.device, **kw) -> tuple[dict, float]:
    t0 = time.perf_counter()
    out = train(**kw, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-360m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ARCHS["smollm-360m"] if args.full_360m else mini_config()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    half = args.steps // 2
    kw = dict(cfg=cfg, batch=args.batch, seq=args.seq,
              ckpt_every=max(half // 2, 1))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print(f"[example] training {cfg.name} for {half} steps, then killing "
              f"and restarting from the checkpoint…")
        out1, s1 = _timed(dev, steps=half, ckpt_dir=ckpt_dir, **kw)
        # simulate failure + restart: train() restores from the latest commit
        out2, s2 = _timed(dev, steps=args.steps, ckpt_dir=ckpt_dir, **kw)
    first, mid, last = (out1["losses"][0], out1["losses"][-1],
                        out2["losses"][-1])
    print(f"[example] loss {first:.3f} -> {mid:.3f} -> {last:.3f} "
          f"(restart resumed training; loss kept falling: {last < mid})")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    print(f"[example] {half} steps in {s1:.1f}s, then "
          f"{args.steps - half} steps in {s2:.1f}s"
          + ("" if peak is None else f"; peak {peak / 2**30:.2f} GiB"))
    assert last < first, "training did not reduce loss"
    return {"device": str(dev), "arch": cfg.name, "first": first,
            "mid": mid, "last": last, "losses": [out1["losses"],
                                                 out2["losses"]],
            "steps": [half, args.steps - half], "seconds": [s1, s2],
            "peak_bytes": peak}


if __name__ == "__main__":
    main()
