"""Serving example: batched prefill and decode for three families — a
dense transformer, a pure SSM (O(1) decode state) and the zamba2 hybrid —
through the sequential ``launch.serve.generate`` (port of the reference's
``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Runs on the card unless ``--device cpu`` is given. Each model is the
reduced float32 config with parameters drawn on the CPU (seed 0) and
moved; the prompts (``(4, 32)``, a whole number of the reduced
``ssm_chunk``) come from a CPU generator seeded 1, and sampling at
temperature 0.8 from ``generate``'s own generator (seed 0). ``main``
returns each family's streams and seconds.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import bind
from repro_torch.models.transformer import params_to

__all__ = ["ARCH_NAMES", "BATCH", "PROMPT_LEN", "GEN_TOKENS", "TEMPERATURE",
           "setup", "serve", "main"]

ARCH_NAMES = ("smollm-360m", "mamba2-130m", "zamba2-7b")
BATCH, PROMPT_LEN, GEN_TOKENS, TEMPERATURE = 4, 32, 16, 0.8


def setup(arch: str, device: str | torch.device | None = None):
    """``(cfg, params, prompts)`` of one family on ``device``."""
    cfg = ARCHS[arch].reduced(dtype="float32")
    params = params_to(bind(cfg, "cpu").init_params(0),
                       resolve_device(device))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    return cfg, params, prompts


def serve(cfg, params, prompts, temperature: float = TEMPERATURE,
          device: str | torch.device | None = None) -> dict:
    """``generate`` over ``prompts``, sampling (at ``temperature`` > 0)
    from its generator of seed 0: the ``(B, GEN_TOKENS)`` streams on the
    host and the wall seconds, the streams' copy to the host included."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    tokens = generate(cfg, params, prompts, gen_tokens=GEN_TOKENS,
                      temperature=temperature, device=dev).cpu()
    return {"tokens": tokens, "seconds": time.perf_counter() - t0}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {}
    for arch in ARCH_NAMES:
        cfg, params, prompts = setup(arch, dev)
        run = serve(cfg, params, prompts, TEMPERATURE, dev)
        tokens = run["tokens"]
        assert tokens.shape[:2] == (BATCH, GEN_TOKENS)
        print(f"[serve] {arch:14s} ({cfg.family:7s}) generated "
              f"{BATCH}x{GEN_TOKENS} tokens in {run['seconds']:5.1f}s -> "
              f"sample: {tokens[0, :8].tolist()}")
        out[arch] = {"family": cfg.family, **run}
    return out


if __name__ == "__main__":
    main()
