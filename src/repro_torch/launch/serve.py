"""Serving entry point of the port: a CLI over the continuous-batching engine,
and the sequential per-request :func:`generate` baseline (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --sc-gemm [--attn-sc [--attn-sc-bits 8]] \\
        [--speculate-k 3 [--draft-bits 4]] \\
        [--no-prefix-cache] [--prefix-block-hash 0] \\
        [--requests 8 --prompt-len 64 --gen 64] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --sc-gemm [--prompt-len 128 --prefill-mode oneshot]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --sc-gemm --prompt-len 128 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \\
        --sc-gemm --prompt-len 64 [--speculate-k 1]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \\
        --sc-gemm --prompt-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-235b-a22b --sc-gemm --reduced [--speculate-k 1]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama4-maverick-400b-a17b --sc-gemm --reduced --device cpu

Runs on the card unless ``--device cpu`` is given. The ssm and hybrid
families (mamba2-130m, zamba2-7b) round ``--chunk`` up to a multiple of
``ssm_chunk``; their one-shot prefill takes prompts of a whole number of
``ssm_chunk`` tokens, as the reference's does. qwen2-vl-2b serves text
prompts (M-RoPE at the text positions); musicgen-large's prompts are
``(S, 4)`` codebook frames and its streams ``(n, 4)``. The moe family
(qwen3-moe-235b-a22b, llama4-maverick-400b-a17b) routes each step's tokens
as one router group, so a prompt of a one-shot prefill longer than the
group must be a whole number of groups, as the reference's; whole, neither
fits one card (``--reduced`` on the CPU). The synthetic workload
is the reference CLI's: every prompt opens with one shared preamble of
``prompt_len // 2`` tokens and then diverges, so the prefix cache (on by
default) has something to share. ``generate`` is the sequential baseline
for SC attention, speculative decoding and the prefix cache alike.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import sc_attention_bits_ok
from repro_torch.configs.registry import ARCHS
from repro_torch.errors import ConfigError
from repro_torch.launch import numeric_overrides
from repro_torch.launch.steps import decode_step, prefill_step
from repro_torch.models import bind, pack_sc_weights

__all__ = ["generate", "main"]


def generate(cfg, params, prompts, *, gen_tokens: int,
             temperature: float = 0.0, seed: int = 0,
             device: str | torch.device | None = None) -> torch.Tensor:
    """``prompts: (B, S)`` int token ids → ``(B, gen_tokens)`` sampled
    continuations, every sequence decoding ``gen_tokens`` steps in
    lockstep over a dense cache; with codebooks ``(B, S, K)`` →
    ``(B, gen_tokens, K)``, a token per codebook a step. With B=1 and
    greedy sampling this is the reference stream the serving engine
    reproduces token for token. With ``cfg.use_sc_gemm`` the weights are
    packed once, here, for the call. An ssm or hybrid prompt is a whole
    number of ``cfg.ssm_chunk`` tokens (:class:`ConfigError` otherwise,
    from the SSD scan)."""
    m = bind(cfg, device)
    params = pack_sc_weights(params, cfg)
    prompts = torch.as_tensor(np.asarray(prompts), device=m.device)
    b = prompts.shape[0]
    logits, cache = prefill_step(m, params, {"tokens": prompts},
                                 extra_slots=gen_tokens)
    # host-side draws from one seeded generator, as the engine samples a
    # request's stream — so a B=1 sampled stream matches the engine's too
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(gen_tokens):
        # (B, V), or (B, K, V) with codebooks
        step_logits = logits[:, -1].to(torch.float32)
        if temperature > 0:
            probs = torch.softmax(step_logits.cpu().double() / temperature,
                                  dim=-1)
            if cfg.n_codebooks:
                # a sequence's K draws in codebook order, as the engine's
                tok = torch.stack([torch.multinomial(p, 1, generator=gen)[:, 0]
                                   for p in probs])
            else:
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(step_logits, dim=-1)
        tok = tok.to(device=m.device, dtype=torch.int32)
        out.append(tok)
        logits, cache = decode_step(m, params, cache,
                                    {"tokens": tok.reshape(b, 1,
                                                           *tok.shape[1:])})
    return torch.stack(out, dim=1)


def main(argv=None) -> None:
    from repro_torch.core.sc_matmul import SC_IMPLS
    from repro_torch.serving import Engine, Request

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random parameters")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of requests in the synthetic workload")
    ap.add_argument("--capacity", type=int, default=4,
                    help="slot-pool capacity (decode batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32,
                    help="max new tokens per request; the synthetic workload "
                         "mixes lengths in [gen/4, gen]")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--no-continuous", action="store_true",
                    help="static batching A/B")
    ap.add_argument("--no-paged", action="store_true",
                    help="contiguous slot stripes instead of pages")
    ap.add_argument("--block", type=int, default=64,
                    help="paged cache page size in tokens")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged cache page budget (n_blocks); default "
                         "capacity * ceil(max_seq / block)")
    ap.add_argument("--sc-gemm", action="store_true",
                    help="serve through the SC-GEMM numeric")
    ap.add_argument("--sc-impl", choices=SC_IMPLS, default=None,
                    help="SC-GEMM implementation (overrides the config)")
    ap.add_argument("--attn-sc", action="store_true",
                    help="route attention's QK^T/PV contractions through the "
                         "SC popcount path at the config's sc_bits width")
    ap.add_argument("--attn-sc-bits", type=int, default=None,
                    help="operand bit width for --attn-sc (overrides the "
                         "config's sc_bits; 2..8)")
    ap.add_argument("--paged-attn", choices=("auto", "jnp", "pallas_tuned"),
                    default=None,
                    help="paged decode-attention dispatch: the CUDA kernel "
                         "('auto'/'pallas_tuned') or the gathered plain "
                         "version ('jnp')")
    ap.add_argument("--no-fused-paged", action="store_true",
                    help="paged decode through gather → decode → commit")
    ap.add_argument("--prefill-mode", choices=("chunked", "oneshot"),
                    default="chunked")
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk length in tokens")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prefill tokens per engine step (default: a chunk)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="share block-aligned prompt prefixes across "
                         "requests through the copy-on-write prefix cache "
                         "over the paged pool (active for paged + chunked + "
                         "dense; exact). --no-prefix-cache is the reuse A/B")
    ap.add_argument("--prefix-block-hash", type=int, default=0,
                    help="seed keying the radix tree's chained block hash; "
                         "streams do not depend on it (a match verifies the "
                         "raw tokens)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="self-speculative decoding: draft this many tokens "
                         "a round through the SC popcount path, verify them "
                         "with one exact (k+1)-row window; greedy acceptance "
                         "keeps streams equal to the baseline. 0 disables. "
                         "Needs the paged layout and temperature 0")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="SC operand width (2..8) of the speculative draft; "
                         "lower is cheaper but accepts less")
    ap.add_argument("--stream", action="store_true",
                    help="print an SSE-style event per token as it lands")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    over = numeric_overrides(sc_gemm=args.sc_gemm, sc_impl=args.sc_impl)
    if args.paged_attn is not None:
        over["paged_attn_kernel"] = args.paged_attn
    if args.attn_sc or args.attn_sc_bits is not None:
        over["attn_sc"] = True
        if args.attn_sc_bits is not None:
            if not sc_attention_bits_ok(args.attn_sc_bits):
                raise ConfigError(f"--attn-sc-bits takes 2..8, got "
                                  f"{args.attn_sc_bits}")
            over["sc_bits"] = args.attn_sc_bits
    if over:
        cfg = dataclasses.replace(cfg, **over).validate()
    m = bind(cfg, args.device)
    params = m.init_params(args.seed)

    rng = np.random.default_rng(1)

    def tokens(n):
        shape = (n, cfg.n_codebooks) if cfg.n_codebooks else (n,)
        return rng.integers(0, cfg.vocab_size, size=shape, dtype=np.int32)

    # real traffic shares long system or tool preambles: every prompt opens
    # with the same first half, then diverges (the reference CLI's draws)
    preamble = tokens(args.prompt_len // 2)
    gens = rng.integers(max(args.gen // 4, 1), args.gen + 1,
                        size=args.requests)
    requests = [
        Request(uid=f"req-{i}",
                prompt=np.concatenate(
                    [preamble, tokens(args.prompt_len - len(preamble))]),
                max_new_tokens=int(g), temperature=args.temperature, seed=i)
        for i, g in enumerate(gens)
    ]
    engine = Engine(cfg, params, device=m.device, capacity=args.capacity,
                    max_seq=args.prompt_len + args.gen,
                    continuous=not args.no_continuous,
                    paged=not args.no_paged, block=args.block,
                    n_blocks=args.pages, fused=not args.no_fused_paged,
                    prefill_mode=args.prefill_mode, chunk=args.chunk,
                    prefill_budget=args.prefill_budget,
                    prefix_cache=args.prefix_cache,
                    prefix_hash_seed=args.prefix_block_hash,
                    speculate_k=args.speculate_k,
                    draft_bits=args.draft_bits)
    t0 = time.time()
    if args.stream:
        def on_token(uid, index, tok, reason):
            tail = f" finish={reason}" if reason else ""
            print(f"data: {{uid: {uid}, index: {index}, "
                  f"token: {np.asarray(tok).tolist()}}}{tail}")
        for r in requests:
            engine.submit(r, on_token=on_token)
        results = engine.run()
        results.sort(key=lambda r: int(r.uid.rsplit("-", 1)[1]))
    else:
        results = engine.run(requests)
    dt = time.time() - t0
    st = engine.stats
    pages = (f", pages peak {st['peak_pages']}/{st['n_blocks']}"
             f" (block {st['block']}, {st['preemptions']} preemptions)"
             if st["layout"] == "paged" else "")
    if st["prefix_cache"]:
        pages += (f", prefix {st['prefix_hits']}/"
                  f"{st['prefix_hits'] + st['prefix_misses']} hits "
                  f"({st['prefill_tokens_saved']} prefill tokens saved, "
                  f"{st['cow_copies']} CoW)")
    if st["speculative"]:
        pages += (f", spec k={st['speculate_k']}@{st['draft_bits']}b: "
                  f"{st['spec_acceptance_rate']:.0%} accepted, "
                  f"{st['spec_tokens_per_round']:.2f} tok/round "
                  f"(draft {st['spec_draft_us']:.0f}us "
                  f"verify {st['spec_verify_us']:.0f}us)")
    print(f"[serve] {st['device']} {st['mode']}/{st['layout']}/"
          f"{st['prefill_mode']}: {st['requests']} requests, "
          f"{st['generated_tokens']} tokens in {dt:.1f}s "
          f"({st['tok_per_s']:.1f} tok/s), {st['decode_steps']} decode steps "
          f"({st['decode_ms_per_step']:.1f} ms/step), "
          f"p50 {st['p50_latency_s'] * 1e3:.0f}ms "
          f"p99 {st['p99_latency_s'] * 1e3:.0f}ms, "
          f"ttft p50 {st['ttft_p50_s'] * 1e3:.0f}ms "
          f"itl p50 {st['itl_p50_s'] * 1e3:.1f}ms "
          f"({st['prefill_chunks']} prefill chunks){pages}; attention "
          f"{'SC %d-bit' % st['attn_sc_bits'] if st['attn_sc_bits'] else 'float'}")
    print(f"[serve] first stream: {results[0].tokens[:16]}")


if __name__ == "__main__":
    main()
