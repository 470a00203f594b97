#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) starts on
the GPU: builds its CUDA kernels from this checkout's sources, holds each
kernel against its plain PyTorch version on the card, runs the paper's
multiplier over exhaustive operand grids and its Table II / Fig. 1(b)
rows, then serves requests through the port's engine at smollm-360m's
full width — float attention, then SC attention — and at qwen2-vl-2b's,
musicgen-large's, mamba2-130m's, zamba2-7b's, qwen3-moe-235b-a22b's and
llama4-maverick-400b-a17b's (the vlm, audio, ssm, hybrid and moe
families) and qwen2-7b's, qwen2.5-14b's and gemma2-9b's (the plain dense
LLMs), and checks the streams against the sequential baseline; then
it trains smollm-360m at full width, killed and resumed; last it runs the
distribution layer on one NCCL rank at the same width, and the port's
four examples.

    python3 chip_smoke.py            # one CUDA card; ~12-17 minutes
    python3 chip_smoke.py --only build,flash   # a subset, for debugging

Phases (each raises on failure, so any failure exits non-zero):

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. build the four kernels (one ``nvcc`` per source, started together;
   each library keyed by its source and the shared header);
3. tune: the autotuner (``kernels/autotune.py``) on a fresh cache file
   (``chiprun_out/autotune.json``, ``$REPRO_TORCH_AUTOTUNE_CACHE``) sweeps
   SC-GEMM over ``sc_gemm_problems`` of smollm-360m (a 4-slot decode step,
   a 16-row chunk) and zamba2-7b (a 4-slot decode step, a 128-row chunk;
   K up to 14,336, N up to 32,000), flash at the serve chunk and
   zamba2-7b's 128-row chunk (float and SC 8-bit), paged at the serve
   layout and the stream kernel at B = 12; per key the winner, its device
   ms, the default plan's and the grid's size; every candidate bit-equal
   to the default plan; a second lookup of every key sweeps nothing. The
   later phases run on the tuned plans (``"auto"`` on the card is
   tuned), and every graphed serve run must show no sweep in a warm-up
   or a capture;
4. SC-GEMM: the counts entry exactly equal to its plain version at the
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
   of each (likewise qwen2-vl-2b's and musicgen-large's), and gemma2-9b's
   tied head (K 3,584, N 256,000) at M = 1 and 4, timed at M = 4 against
   its bound; then the batched launch (one MoE projection of all experts)
   at qwen3-moe's (E = 128) and llama4's (E = 32) expert shapes, M = C =
   64 rows an expert, a NaN row and an expert of zero rows: bit-equal to
   its plain version and to E unbatched launches at the default and the
   tuned plan, its device ms against the planes' bytes at the HBM rate
   and against the E unbatched launches' sum;
5. paged decode-attention kernel vs its plain version at smollm's layout,
   f32 and bf16, float and SC at 4 and 8 bits, fragmented tables, windows,
   a single-KV-head layout (SC), zamba2-7b's layout (KV 32, G 1, D 112;
   float and SC), gemma2-9b's (KV 8, G 2, D 256, MB 68) with its logit
   softcap 50, windowed (4,096) and global, float and SC at 4 and 8 bits,
   and without the cap, qwen2-7b's (KV 4, G 7, D 128) and qwen2.5-14b's
   (KV 8, G 5, D 128); kernel ms, device ms, plain and bound ms
   of both paths at the serve shape (MB 4), a long context (MB 64, up
   to 4,096 keys) and each of the dense cells' bf16 layouts; then
   bitwise paging invariance (block 16, 32, 48, 64, 256 and the dense
   view) and batch invariance (a slot alone against four together),
   without and with a softcap, any difference failing the phase;
6. flash-attention kernel vs its plain version: f32 and bf16, float and SC
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
7. the bit-parallel stream kernel through ``ops.sc_stream_mul`` on every
   operand pair at B = 5, 6, 7, 8, 10 and 12 (16,777,216 pairs), counter
   set to 0 just before: counts exactly equal to the plain version and
   the closed form (and the bit-level oracle at B <= 8); seeded samples
   of 2^20 pairs at B = 9, 11 and 16, ragged sizes 1, 31 and 100,003, 3-D
   shapes, a view at storage offset 1, empty operands, block widths
   1/4/8; kernel (back to back and device), plain and bound ms at B = 8,
   10 and 12;
8. ``launch.paper``'s Table II and Fig. 1(b) rows on the card, each equal
   to the same row computed on the CPU;
9. a reduced smollm-360m (float32) cross-check: prefill logits on the
   card agree with the CPU's, and the engine's streams on both are
   compared;
10. a ``torch.profiler`` pass over two full-width decode steps, eager and
    then graphed, and over two chunks of a 240-token prompt's chunked
    prefill, eager and then graphed: device time by kernel, host time by
    operator, kernel launches, host API calls and synchronizations per
    step or chunk, the device's busy share, the graphed step's and
    chunk's wall split, and the kernel records of the graphed steps and
    chunks against the launches their capture recorded; then the same
    graphed-step profile of each family cell's model (15, 16; not 17 and
    18, whose steps are the same kernels at other widths). It runs
    before any cell serves: the profiler drops kernel records now and
    then, more often late in a long process (§7 of ``PERF.md``), so a
    graphed trace that lost records is taken again, up to three times
    (``_whole_trace``); ``--only`` with a family phase runs this phase
    too;
11. serve 8 requests at full width (smollm-360m, bf16, SC-GEMM on, random
   weights from seed 0) through ``Engine(capacity=4, max_seq=256, block=64,
   chunk=16)``, first with ``graphs=False`` (every step dispatched
   operator by operator), then graphed (the default on the card: each
   decode step one replay of the shape's captured CUDA graph, captured
   once when the engine is built, and each prefill chunk or one-shot
   prefill one replay of its shape's graph, captured at first use) twice
   on one engine, the first run capturing its prefill shape and the
   second none; for each run, the launch counters, set to 0 just before,
   must show the kernels on every decode step and prefill chunk (and a
   capture's tuning pass and warm-up runs), exactly one fused SC-GEMM
   launch per projection, one capture a prefill shape, one replay a
   prefill call and
   225 SC-GEMM and 32 flash launches a prefill replay; streams must equal
   the sequential ``generate`` baseline on the card; decode ms/step,
   tokens/s, TTFT p50 and peak memory side by side (eager against the
   graphed second run);
12. the same with SC attention at 8 bits, chunked and then one-shot
    prefill, each against the sequential baseline;
13. ``serve_spec``: the ``serve`` cell's model, requests and baseline
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
14. ``serve_prefix``: the reference's default serve, prefix cache on, over
    one shared 128-token preamble (cache off, eager, graphed cold and
    warm, speculative, a rebind), its stats held to the script's plan;
15. ``serve_ssm`` and ``serve_hybrid``: mamba2-130m as registered, whole,
    and zamba2-7b at full width and 9 of its 81 layers (3 shared-block
    sites; ``FAMILY_CUTS``), SC-GEMM at
    8 bits, float attention, random weights from seed 0: 8 requests of
    128- and 256-token prompts (whole ``ssm_chunk``s) and 16-64 new
    tokens through ``Engine(capacity=4, max_seq=384, block=64,
    chunk=128)``;
16. ``serve_vlm`` and ``serve_audio``: qwen2-vl-2b as registered, whole
    (28 layers), and musicgen-large at full width and 12 of its 48
    layers, likewise, with the ``serve`` cell's traffic and engine (8
    requests of 64-token prompts, ``(64, 4)`` codebook frames for
    musicgen-large, 16-64 new tokens);
    qwen2-vl-2b first holds a one-shot prefill of a 256-token prompt with
    64 patch embeddings at the (t, h, w) ids of an 8 x 8 grid against
    plain versions (``_vision_prefill``: float32 and bf16 with exact
    projections against plain attention, the cell's numeric against
    plain SC-GEMM);
17. ``serve_moe`` and ``serve_moe_llama4``: qwen3-moe-235b-a22b at full
    width and 2 of its 94 layers (all 128 experts, top-8, C = 64) and
    llama4-maverick-400b-a17b at its one whole period of 4 layers and 32
    of its 128 experts (top-1, a shared expert, windows on 3 of 4
    layers), ~22 and ~43 GB of weights and planes; the ``serve`` cell's
    traffic and engine with 4 requests (``MOE_REQUESTS``); first the
    static check that C covers every router group the cell forms (a
    decode step's 4 slots, a 16-row chunk, a 64-token one-shot prompt, a
    verify window of 4 x 2), so no token is dropped and routing is
    batch-invariant. qwen3-moe runs like 16 (eager and graphed twice, a
    speculative engine at (1, 4), the caller's weights on the host
    meanwhile); llama4 graphed only, chunked and one-shot;
18. ``serve_qwen2_7b``, ``serve_qwen2_5_14b`` and ``serve_gemma2_9b``: the
    registry's three plain dense LLMs at full width (``DENSE_CELLS``):
    qwen2-7b whole (28 layers), qwen2.5-14b at 2 of 48 layers and
    gemma2-9b at 2 of 42 (``FAMILY_CUTS``), the autotuner's SC-GEMM
    plans (``sc_impl="auto"``, as registered), graphed only,
    chunked and one-shot, no speculative engine: the qwen cells with the
    ``serve`` cell's traffic and engine (QKV bias; the paged kernel at G
    7 and 5, flash at D 128), gemma2-9b with it and one more request, a
    4,160-token prompt and 16 new tokens, through ``Engine(max_seq=4352,
    chunk=256)``, so that its 4,096-token window binds in prefill and
    decode (its softcapped layers
    prefill through the plain formulation, as in the reference, and
    decode through the paged kernel's softcap path, whose launches must
    equal the paged launches); each cell moves its float weights to the
    host while each engine's entry copies them in and packs them; the
    peak memory of each engine's build and each run, against the card's;
19. ``train``: smollm-360m at full width as registered (bf16, remat on)
    with SC-GEMM at 8 bits, the reference CLI's batch 8 x seq 128, lr
    3e-4, synthetic data of seed 0, cut to 8 steps: ``launch.train.train``
    for 4 steps with a checkpoint, then again on the same directory,
    resuming from its save to step 8 (counters set to 0 just before,
    read just after: 2 x 7 x 32 + 1 SC-GEMM and 2 x 32 flash launches a
    step, remat running each layer's forward twice; the loss falls; the
    reference's committed steps, 4 then 4 and 8); the restored weights
    equal the saved ones, and a step from them repeats the resumed
    run's first loss; the step's loss and gradients through the SC-GEMM
    kernel (plain attention) equal ``mxu_split``'s bit for bit, through
    the flash kernel (exact projections) lie within stated tolerances of
    plain attention's, and with all kernels within stated tolerances of
    all plain versions, beside the plain step against itself with
    attention's sums in another order; a full state saved on the writer
    thread and
    restored equals the state in memory, and a step from each is bit
    for bit the same; ms a step with the kernels and with exact
    projections, one profiled step, the peak memory; one step with
    compressed gradients;
20. ``dist``: the distribution layer on one NCCL rank (an in-process
    ``HashStore``, no fallback to gloo or the CPU) at the ``train``
    phase's model: the ``(1, 1)`` ``("data", "model")`` mesh from
    ``launch.mesh.make_mesh``; smollm-360m's bf16 weights (seed 0) placed
    by ``param_pspecs`` and ``named``, every local shard bit-equal to its
    source, and the per-rank parameter bytes the same rules give at
    16 x 16 and 2 x 16 x 16 (host arithmetic); ``pipeline_forward`` with
    one stage of the 32 layers (``block_forward`` with ``full_attend``:
    SC-GEMM at 8 bits and flash, default plans) over the embedded 8 x 128
    batch in 4 microbatches, bit-equal to the whole batch through the
    same layers, the launches counted (7 x 32 SC-GEMM and 32 flash a
    microbatch), ms of both; ``compressed_psum`` over every gradient leaf
    of one train step, bit-equal to ``dequantize8(quantize8(g))``, its ms
    against its bytes at the HBM rate; the flash kernel against
    ``flash_attention_ref`` (float32 2e-3, bf16 3e-2) and
    ``sc_flash_attention_ref`` (``8 / (2**bits - 1)``) at the prefill
    layout, the paged SC kernel against ``sc_decode_attention_ref`` at the
    serve layout with and without a window, and softcap decode (the
    gathered path) with a window, within ``2 / (2**bits - 1)``;
    ``sc_attention_divergence`` at 4, 6 and 8 bits on the card within
    1e-3 relative of the CPU's, falling from 4 bits; ``param_counts`` of
    every registered arch and ``model_flops`` over the ``train`` phase's
    ms a step and the ``serve`` cell's graphed decode ms/step, each
    against the bf16 dense peak;
21. ``dryrun``: the kernel operators' fake metas, the mesh-bound train
    and paged decode steps on one NCCL rank against the plain-tensor
    steps and the dry run's prediction, one production cell dry-run
    (``phase_dryrun``);
22. ``serve_mesh``: the engine on a mesh (``Engine(mesh=...)``) on one
    NCCL rank (an in-process ``HashStore``, as ``dist``): smollm-360m as
    registered (bf16, 32 layers, d 960), SC-GEMM at 8 bits, seed-0
    weights, on ``serving.default_serving_mesh()`` (1 x 1); three requests
    (two 64-token prompts, then the first again: a prefix hit whose
    resume page is copied on write; 8-16 new tokens) through
    ``Engine(capacity=2, max_seq=256, block=64, chunk=16)``, chunked and
    then one-shot: streams, prefix hits, tokens saved and CoW copies
    equal to the graphed plain engine's (``mesh=None``) on the same
    requests and weights; the counters, set to 0 just before each mesh
    run and read just after, must show SC-GEMM, paged and flash
    launches; ms a decode step, tokens/s and peak memory of both;
23. ``analysis``: the port's lint (``repro_torch.analysis``, R1-R5) over
    this checkout's ``src/repro_torch`` must find nothing; the four
    contract audits run on the card (``analysis.contracts``: the stream
    kernel integer-only and equal to its plain version, the paged plain
    version and the gathered dense path reducing alike and the paged
    kernel serving both bit-equal, one capture a shape through graphed
    engines, the prefix cache's copy-on-write ledger stepped by hand),
    then capture-counts and cow-protocol again at smollm-360m's full
    width (bf16, SC-GEMM at 8 bits, seed-0 weights) on their own short
    schedules; the launch counters, set to 0 just before each audit,
    must show the kernels of its path;
24. ``examples``: the port's four examples (``repro_torch.examples``),
    each ``main`` in this process on the card at the reference example's
    sizes (``train_lm`` at ``--steps 8 --batch 8 --seq 128``), within a
    45 s budget that it reports, the counters set to 0 just before each and read just after: quickstart's Table I,
    MAE and Table II equal to a CPU run's, the SC-GEMM kernel's counts on
    its operands equal to ``mxu_split``'s; sc_gemm_inference (reduced
    smollm-360m, float32, every SC projection one SC-GEMM launch) within
    stated tolerances of a CPU run on the same parameters and equal to
    ``mxu_split`` on the card; serve_lm's ``(4, 16)`` streams of three
    families, repeated by the same seed and at temperature 0 equal to the
    CPU's; train_lm restored from its checkpoint with a falling, finite
    loss.

Each family cell (15-18) asks for the prefix cache (the dense-only gate
turns it off, and the stats must say so; the dense cells ask for none,
as the ``serve`` cell) and serves chunked then
one-shot, each eager and then graphed twice on one engine; every run
against the sequential baseline, the counters showing one SC-GEMM launch
a projection (48 a step or chunk for mamba2-130m, 40 for zamba2-7b at
9 layers, 197 for qwen2-vl-2b, 85 for musicgen-large at 12 layers, 15
for qwen3-moe at 2 and 35 for llama4, an expert projection one launch for all
experts; 7 a layer and the head for the dense cells) and one paged
launch an attention site a step and one flash launch an unwindowed,
uncapped site a prefill call (llama4's windowed sites and all of
gemma2-9b's take the plain formulation, as in the reference); tokens/s, TTFT p50, decode
ms/step, a prefill chunk of the longest prompt (eager and graphed),
peak memory and launches. Last, a graphed speculative engine at (k,
draft_bits) = (1, 4) serves qwen2-vl-2b and qwen3-moe against the
baseline and must be refused for the ssm, hybrid and audio cells, as in
the reference.

The sequential baselines of phases 11-18 but the moe cells' (one B=1
``generate`` call a request, on the cell's weights from the same seed)
are computed on the card by one child process, started with the first
of those phases (phase 13, which runs before 11 and 12: its eager run
covers their baselines), in the order the phases read them, while this
process serves; a cell's runs wait for its baseline at their first
comparison; the child is stopped while a graphed run or replay is timed;
the moe cells wait for it to end, then compute their own. The script
stops the child when it ends or fails.

The line before the last is a JSON object with one entry per kernel,
its ``launches`` the sum over every serving run of phases 11-18, the
train phase's kill-and-resume (``train_launches`` apart), the dryrun
phase's steps, the serve_mesh phase's mesh runs, the analysis phase's
audits and the examples phase's runs (the stream kernel's: the
stream phase's and popcount-path's; the
attention kernels' float and SC entries split as their wrappers counted
them), its ``tuned`` the tune phase's keys of the kernel; the last line is ``{"ok": true, "device": {...}}``. Details go to
``build/chip_smoke.json`` (``$CHIP_SMOKE_OUT`` names another directory).
Nothing of JAX or of the JAX package is imported.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import signal
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
# qwen2-vl-2b: q, o (1536, 1536), k, v (1536, 256), w1, w3 (1536, 8960)
# and w2 (8960, 1536) in each of 28 layers, the tied head (1536, 151936)
# once. musicgen-large: q, k, v, o (2048, 2048), w1, w3 (2048, 8192) and
# w2 (8192, 2048) in each of 48 layers, the head of 4 codebooks x 2048
# (2048, 8192) once. gemma2-9b: its tied head (3584, 256000), the widest N
# the port serves, once (its other shapes are qwen2-7b's widths or
# smaller; the serve cells hold them through their streams).
FAMILY_SC_SHAPES = {
    "mamba2-130m": {(768, 3352): 24, (1536, 768): 24},
    "zamba2-7b": {(3584, 14576): 81, (7168, 3584): 81, (3584, 3584): 108,
                  (3584, 14336): 54, (14336, 3584): 27, (3584, 32000): 1},
    "qwen2-vl-2b": {(1536, 1536): 56, (1536, 256): 56, (1536, 8960): 56,
                    (8960, 1536): 28, (1536, 151936): 1},
    "musicgen-large": {(2048, 2048): 192, (2048, 8192): 97,
                       (8192, 2048): 48},
    "gemma2-9b": {(3584, 256000): 1}}
#: the row counts each family cell sends through those shapes (each held
#: bit-equal to the plain version) — the sequential baseline's steps and a
#: prefill's last row (1), a decode step (4), a prefill chunk (128 rows
#: for the ssm and hybrid cells, 16 for the multimodal ones), a one-shot
#: prefill (256; 64, and qwen2-vl-2b's 256-token vision prefill) — and the
#: two timed, a decode step's and a chunk's
FAMILY_SC_ROWS = {"mamba2-130m": (1, 4, 128, 256),
                  "zamba2-7b": (1, 4, 128, 256),
                  "qwen2-vl-2b": (1, 4, 16, 64, 256),
                  "musicgen-large": (1, 4, 16, 64),
                  "gemma2-9b": (1, 4)}
FAMILY_SC_TIMED = {"mamba2-130m": (4, 128), "zamba2-7b": (4, 128),
                   "qwen2-vl-2b": (4, 16), "musicgen-large": (4, 16),
                   "gemma2-9b": (4,)}


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
    """``launch.cost_analysis.sc_bound``: the one rule of an SC-GEMM
    launch's least time, which the dry run counts by too. Returns (ms,
    bound_by, bytes, ops)."""
    from repro_torch.launch.cost_analysis import sc_bound
    return sc_bound(m, k, n, esz)


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
    plain version, the bound, and the device time at the autotuner's plan
    for the key beside the default plan's; then a decode step's device
    time with the K split aimed at 1, 2 and 4 blocks per SM."""
    import dataclasses
    import torch
    from repro_torch.core.sc_numerics import quantize_sign_magnitude
    from repro_torch.core.tcu import stream_length
    from repro_torch.kernels import autotune
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

            def call(config=None):
                return sc_linear(x, pws[next(it) % len(pws)], config=config)
            row["ms"] = cuda_ms(call, iters=50)
            row["device_ms"] = device_ms(call, "sc_gemm_kernel")
            # the autotuner's plan for the key (M = 4 at its bucket's)
            tuned = autotune.get_or_tune(x, pws[0])
            row["tuned"] = dataclasses.asdict(tuned)
            row["tuned_device_ms"] = device_ms(lambda: call(tuned),
                                               "sc_gemm_kernel")
            row["chain_ms"] = cuda_ms(lambda: chain(
                x, ws[next(it) % len(ws)], 8), iters=10)
            row["plain_ms"] = cuda_ms(lambda: sc_linear_torch(x, pws[0]),
                                      iters=2, warmup=1)
            bound, by, nbytes, ops = _sc_bound(m, k, n, 2)
            row.update(bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            timing.append(row)
            log(f"[sc_gemm] M={m:2d} K={k:4d} N={n:5d} ({row['blocks']} "
                f"blocks, {splits} K splits): fused {row['ms']:.4f} ms a "
                f"call, device {_ms(row['device_ms'])} (tuned {row['tuned']}: "
                f"{_ms(row['tuned_device_ms'])}), old chain "
                f"{row['chain_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
                f"bound {bound:.4f} ms ({by})")

    def per_step(m, key):
        vals = [r[key] for r in timing if r["M"] == m]
        if None in vals:
            return None
        return sum(r["calls_per_decode_step"] * v for r, v in
                   zip((r for r in timing if r["M"] == m), vals))

    step = {key: per_step(4, key) for key in
            ("ms", "device_ms", "tuned_device_ms", "chain_ms", "plain_ms",
             "bound_ms")}
    log(f"[sc_gemm] one decode step (M=4, {sum(SC_SHAPES.values())} fused "
        f"calls): {step['ms']:.3f} ms of calls, device "
        f"{_ms(step['device_ms'])} (tuned plans "
        f"{_ms(step['tuned_device_ms'])}); old chain {step['chain_ms']:.3f} ms, "
        f"plain {step['plain_ms']:.1f} ms, bound {step['bound_ms']:.4f} ms")
    prefill = {}
    for m in (16, 64):
        prefill[m] = {key: per_step(m, key) for key in
                      ("ms", "device_ms", "tuned_device_ms", "chain_ms",
                       "bound_ms")}
        p = prefill[m]
        log(f"[sc_gemm] one prefill pass at M={m} (225 calls): "
            f"{p['ms']:.3f} ms of calls, device {_ms(p['device_ms'])} "
            f"(tuned plans {_ms(p['tuned_device_ms'])}); old "
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
    moe = _sc_gemm_moe(gen, dev)
    return {"cases": rows, "timing": timing, "decode_step": step,
            "prefill_pass": prefill, "blocks_per_sm_sweep": split_sweep,
            "sms": sms, "families": families, "moe": moe}


#: The moe cells' expert projections, each one batched launch: (arch, E,
#: rows an expert = C, (K, N) of w1/w3 and of w2, launches of each a step)
MOE_SC_SHAPES = (("qwen3-moe-235b-a22b", 128, 64, (4096, 1536), 8),
                 ("qwen3-moe-235b-a22b", 128, 64, (1536, 4096), 4),
                 ("llama4-maverick-400b-a17b", 32, 64, (5120, 8192), 4),
                 ("llama4-maverick-400b-a17b", 32, 64, (8192, 5120), 2))


def _sc_gemm_moe(gen, dev) -> dict:
    """The batched launch (one MoE projection of every expert) at the moe
    cells' expert shapes, bf16 rows with a NaN row in one expert and
    zero rows (empty capacity rows) in another: bit-equal to its plain
    version and to E unbatched launches of the same rows, at the default
    plan and at the autotuner's. Device ms of the batched launch (both
    plans) against the bound — the planes' bytes at the HBM rate — and
    against the E unbatched launches' sum, and the plain version's ms."""
    import dataclasses
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels.sc_matmul import (PackedWeight, pack_weight,
                                               sc_linear, sc_linear_torch)
    out = []
    for arch, e, m, (k, n), per_step in MOE_SC_SHAPES:
        w = (torch.randn((e, k, n), generator=gen, device=dev)
             * k ** -0.5).to(torch.bfloat16)
        pw = pack_weight(w, 8)
        del w
        x = torch.randn((e, m, k), generator=gen,
                        device=dev).to(torch.bfloat16)
        x[1, 3, 5] = math.nan
        x[2, m // 2:] = 0
        tuned = autotune.get_or_tune(x, pw)
        ones = [PackedWeight(pw.plane[i], pw.scale[i], 8, (k, n))
                for i in range(e)]
        t0 = time.perf_counter()
        want = sc_linear_torch(x, pw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for cfg in (None, tuned):
            got = sc_linear(x, pw, config=cfg)
            loop = torch.stack([sc_linear(x[i], ones[i], config=cfg)
                                for i in range(e)])
            torch.cuda.synchronize()
            for what, ref in (("plain version", want),
                              ("unbatched launches", loop)):
                if not (torch.equal(got.isnan(), ref.isnan()) and
                        torch.equal(got.nan_to_num(), ref.nan_to_num())):
                    bad = (got.nan_to_num() != ref.nan_to_num()).sum().item()
                    raise AssertionError(
                        f"batched SC-GEMM ({arch}, E={e} M={m} K={k} N={n}, "
                        f"plan {cfg}) differs from its {what}: {bad} entries")
            del got, loop
        del want
        it = iter(range(1 << 30))
        batched = device_ms(lambda: sc_linear(x, pw), "sc_gemm_kernel",
                            iters=5)
        batched_tuned = device_ms(lambda: sc_linear(x, pw, config=tuned),
                                  "sc_gemm_kernel", iters=5)
        def one():
            i = next(it) % e
            return sc_linear(x[i], ones[i])
        unbatched = device_ms(one, "sc_gemm_kernel", iters=2 * e,
                              one_launch=True)
        nbytes = e * k * (-(-n // 8) * 8) * 2
        bound = nbytes / HBM_BYTES_S * 1e3
        ops = 2 * e * m * n * k
        row = {"arch": arch, "E": e, "M": m, "K": k, "N": n,
               "launches_per_step": per_step, "bit_equal": True,
               "device_ms": batched, "tuned": dataclasses.asdict(tuned),
               "tuned_device_ms": batched_tuned,
               "unbatched_sum_device_ms": None if unbatched is None
               else e * unbatched,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_S
               >= ops / INT8_OPS_S else "operations",
               "plane_bytes": nbytes, "counts": e * m * n * k}
        rate = None if batched_tuned is None else \
            row["counts"] / (batched_tuned * 1e-3)
        row["tuned_counts_per_s"] = rate
        out.append(row)
        log(f"[sc_gemm] {arch} batched E={e} M={m} K={k:5d} N={n:5d}: "
            f"bit-equal to its plain version and to {e} unbatched launches "
            f"(default and tuned plans); device {_ms(batched)} (tuned "
            f"{row['tuned']}: {_ms(batched_tuned)}"
            + (f", {rate / 1e12:.3f} T counts/s" if rate else "")
            + f"), {e} unbatched launches {_ms(row['unbatched_sum_device_ms'])}"
            f", plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
            f"({row['bound_by']}: {nbytes / 1e9:.3f} GB of planes)")
        del x, pw, ones
        gc.collect()
        torch.cuda.empty_cache()
    return {"timing": out}


def _sc_gemm_families(gen, dev, sms) -> dict:
    """The fused projection at the family cells' shapes
    (``FAMILY_SC_SHAPES``), bf16 rows at every row count the cells run
    (``FAMILY_SC_ROWS``) bit-equal to its plain version (zamba2's w2 runs
    K = 14,336, four K blocks past ``K_BLOCK_MAX``; qwen2-vl-2b's head N =
    151,936); then at a decode step's M = 4 and a chunk's
    (``FAMILY_SC_TIMED``), per shape, the fused call's ms and device ms
    (at the default plan and at the autotuner's), the plain version's and
    the bound, weights cycled from HBM, summed to a decode step and a
    chunk of each model."""
    import dataclasses
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels.sc_matmul import (pack_weight, plan, sc_linear,
                                               sc_linear_torch)
    out = {}
    for arch, shapes in FAMILY_SC_SHAPES.items():
        rows, timed = [], FAMILY_SC_TIMED[arch]
        for m in FAMILY_SC_ROWS[arch]:
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
                if m not in timed:
                    log(f"[sc_gemm] {arch} M={m:3d} K={k:5d} N={n:5d}: "
                        f"bit-equal to the plain version")
                    continue
                pws += [pack_weight(w.clone(), 8) for _ in range(
                    max(0, math.ceil(128e6 / (k * n * 2)) - 1))]
                it = iter(range(1 << 30))
                mr, kc, splits = plan(m, n, k, sms)

                def call(config=None):
                    return sc_linear(x, pws[next(it) % len(pws)],
                                     config=config)
                tuned = autotune.get_or_tune(x, pws[0])
                row = {"M": m, "K": k, "N": n, "calls_per_step": calls,
                       "splits": splits, "ms": cuda_ms(call, iters=20),
                       "device_ms": device_ms(call, "sc_gemm_kernel",
                                              iters=10),
                       "tuned": dataclasses.asdict(tuned),
                       "tuned_device_ms": device_ms(
                           lambda: call(tuned), "sc_gemm_kernel", iters=10),
                       "plain_ms": cuda_ms(lambda: sc_linear_torch(
                           x, pws[0]), iters=1, warmup=0)}
                bound, by, nbytes, ops = _sc_bound(m, k, n, 2)
                row.update(bound_ms=bound, bound_by=by)
                rows.append(row)
                del pws
                log(f"[sc_gemm] {arch} M={m:3d} K={k:5d} N={n:5d} ({splits} "
                    f"K splits): bit-equal to the plain version; fused "
                    f"{row['ms']:.4f} ms a call, device "
                    f"{_ms(row['device_ms'])} (tuned {row['tuned']}: "
                    f"{_ms(row['tuned_device_ms'])}), plain "
                    f"{row['plain_ms']:.3f} "
                    f"ms, bound {bound:.4f} ms ({by})")
        sums = {}
        for m, what in zip(timed, ("decode_step", "prefill_chunk")):
            sel = [r for r in rows if r["M"] == m]
            sums[what] = {key: (None if any(r[key] is None for r in sel) else
                                sum(r["calls_per_step"] * r[key]
                                    for r in sel))
                          for key in ("ms", "device_ms", "tuned_device_ms",
                                      "plain_ms", "bound_ms")}
            t = sums[what]
            log(f"[sc_gemm] {arch} one {what.replace('_', ' ')} (M={m}, "
                f"{sum(shapes.values())} fused calls): {t['ms']:.3f} ms of "
                f"calls, device {_ms(t['device_ms'])} (tuned plans "
                f"{_ms(t['tuned_device_ms'])}), plain "
                f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms")
        out[arch] = {"timing": rows, **sums}
    return out


#: The autotuner's cache of a run: a fresh file, so every run sweeps from
#: scratch and no earlier tree's winners serve this one.
TUNE_CACHE = ROOT / "chiprun_out" / "autotune.json"
#: The baselines' child process's own cache: ``_Baselines.paused`` stops
#: the child with SIGSTOP, and a child stopped inside a cache write holds
#: the cache's lock, which the serving process would then wait on for
#: good. Every plan gives the same bits, so the baselines do not change.
BASELINE_TUNE_CACHE = TUNE_CACHE.with_name("autotune_baselines.json")
#: The tune phase's SC-GEMM problems: (arch, rows, kind) as
#: ``configs.shapes.Shape``s give them to ``sc_gemm_problems`` — a decode
#: step of 4 slots, a 16-row chunk (smollm-360m's serve cells) and a
#: 128-row chunk (zamba2-7b's).
TUNE_GEMM = (("smollm-360m", 1, 4, "decode"), ("smollm-360m", 16, 1, "prefill"),
             ("zamba2-7b", 1, 4, "decode"), ("zamba2-7b", 128, 1, "prefill"))
#: The tune phase's flash problems (name, H, KV, D, chunk rows, bucket
#: extent = the SC group, as the chunk step passes it): the serve cells'
#: 16-row chunk of a 64-token bucket, zamba2-7b's 128-row chunk of its
#: 256-token bucket; the offset held on the card, float and SC 8-bit.
TUNE_FLASH = (("serve_chunk", 15, 5, 64, 16, 64),
              ("zamba2_chunk", 32, 32, 112, 128, 256))


def _tune_log(tag: str, cache, key: str, n_cands: int) -> dict:
    """Log a swept key: its winner, the winner's and the default plan's ms
    and the grid's size, each candidate having been held bit-equal to the
    default plan."""
    ent = cache.entry(key)
    fields = {k: v for k, v in ent.items()
              if k not in ("tuned_at", "us_per_call", "default_us",
                           "candidates")}
    row = {"key": key, "winner": fields, "ms": ent["us_per_call"] / 1e3,
           "default_ms": ent["default_us"] / 1e3, "candidates": n_cands}
    log(f"[tune] {tag}: winner {fields} {row['ms']:.4f} ms, default "
        f"{row['default_ms']:.4f} ms, {n_cands} candidates, all "
        f"bit-equal to the default plan")
    if ent["candidates"] != n_cands:
        raise AssertionError(f"[tune] {key}: swept {ent['candidates']} "
                             f"candidates, the grid has {n_cands}")
    return row


def phase_tune() -> dict:
    """The autotuner on the card, on the run's fresh cache: sweep the
    SC-GEMM problems of ``TUNE_GEMM`` (``configs.shapes.sc_gemm_problems``;
    zamba2-7b at full width, K up to 14,336, N up to 32,000), the flash
    problems of ``TUNE_FLASH`` (float and SC 8-bit), the paged kernel at
    the serve layout (float and SC) and the stream kernel at B = 12; log
    each key's winner, its device ms (CUDA events), the default plan's
    and the grid's size. Every candidate's output must equal the default
    plan's bit for bit (on seeded operands of the key's shape), and a
    second lookup of every key must sweep nothing. The serve phases then
    run on these plans."""
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import Shape, sc_gemm_problems
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     m_tile_count)
    from repro_torch.kernels.sc_bitops import sc_stream_mul_cuda
    from repro_torch.kernels.sc_matmul import (PackedWeight, pack_weight,
                                               sc_linear)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cache = autotune._default_cache()
    if cache.path != TUNE_CACHE or len(cache):
        raise AssertionError(f"[tune] the cache is {cache.path} with "
                             f"{len(cache)} entries, not a fresh "
                             f"{TUNE_CACHE}")
    t0 = time.perf_counter()
    sweeps0 = autotune.sweeps
    lookups = []            # (what, lookup) to repeat after the sweeps
    out = {"sc_gemm": [], "flash": [], "paged": [], "stream": []}

    for arch, rows, batch, kind in TUNE_GEMM:
        cfg = ARCHS[arch]
        dt = getattr(torch, cfg.dtype)
        for m, k, n in sc_gemm_problems(cfg, Shape("tune", rows, batch,
                                                   kind)):
            key = cache.key(m, k, n, 8, dtype=dt, device=dev)
            if key in cache.keys():     # a head's row shares a decode key
                continue
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            stub = PackedWeight(torch.empty(0, device=dev),
                                torch.ones((), device=dev), 8, (k, n))

            def lookup(x=x, stub=stub):
                return autotune.get_or_tune(x, stub)
            win = lookup()
            lookups.append((f"sc_gemm {arch} ({m},{k},{n})", lookup))
            cands = autotune.candidate_configs(autotune.bucket_m(m), k, n,
                                               sms=sms)
            if win not in cands:
                raise AssertionError(f"[tune] {key}: winner {win} is not "
                                     f"in the grid")
            pw = pack_weight(torch.randn((k, n), generator=gen, device=dev),
                             8)
            want = sc_linear(x, pw)
            for c in cands:
                if not torch.equal(sc_linear(x, pw, config=c), want):
                    raise AssertionError(f"[tune] {key}: candidate {c} "
                                         f"differs from the default plan")
            row = _tune_log(f"sc_gemm {arch} M={m} K={k} N={n}", cache, key,
                            len(cands))
            out["sc_gemm"].append(row | {"arch": arch, "M": m, "K": k,
                                         "N": n})
            del pw, want
    torch.cuda.empty_cache()

    for name, h, kv, d, sq, skv in TUNE_FLASH:
        for bits in (None, 8):
            q = torch.randn((1, h, sq, d), generator=gen,
                            device=dev).to(torch.bfloat16)
            kk, vv = (torch.randn((1, kv, skv, d), generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(2))
            off = torch.tensor(skv - sq, dtype=torch.int32, device=dev)

            def lookup(q=q, kk=kk, vv=vv, off=off, skv=skv, bits=bits):
                return autotune.get_or_tune_flash(q, kk, vv, q_offset=off,
                                                  group=skv, sc_bits=bits)
            win = lookup()
            lookups.append((f"flash {name} sc{bits or 0}", lookup))
            cands = autotune.candidate_flash_configs(
                1, h, kv, sq, d, group=skv, q_offset=off, sc_bits=bits,
                esz=2, sms=sms)
            key = cache.flash_key(1, h, kv, sq, m_tile_count(sq, off), skv,
                                  d, True, group=skv, dtype=torch.bfloat16,
                                  sc_bits=bits, device=dev)
            want = flash_attention(q, kk, vv, q_offset=off, group=skv,
                                   sc_bits=bits)
            for c in cands:
                got = flash_attention(q, kk, vv, q_offset=off, group=skv,
                                      sc_bits=bits, config=c)
                if not torch.equal(got, want):
                    raise AssertionError(f"[tune] {key}: candidate {c} "
                                         f"differs from the default plan")
            if win not in cands:
                raise AssertionError(f"[tune] {key}: winner {win} is not "
                                     f"in the grid")
            out["flash"].append(_tune_log(
                f"flash {name} sc{bits or 0}", cache, key, len(cands))
                | {"shape": name, "sc_bits": bits})

    # the serve cells' paged layout: 4 slots of 5 KV heads x 3 x 64, pages
    # of 64 keys, 4 a table row (max_seq 256)
    c, kv, g, d, block, mb = 4, 5, 3, 64, 64, 4
    for bits in (None, 8):
        q = torch.randn((c, kv, g, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        pages = c * mb + 1
        kp, vp = (torch.randn((pages, block, kv, d), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        tables = torch.arange(c * mb, dtype=torch.int32,
                              device=dev).reshape(c, mb)
        pos = torch.tensor([5, 77, 150, 255], dtype=torch.int32, device=dev)

        def lookup(q=q, kp=kp, vp=vp, tables=tables, pos=pos, bits=bits):
            return autotune.get_or_tune_paged(q, kp, vp, tables, pos,
                                              sc_bits=bits)
        lookup()
        lookups.append((f"paged serve sc{bits or 0}", lookup))
        # a one-point grid: its candidate is the default plan
        key = cache.paged_key(c, kv, g, d, block, mb, None,
                              dtype=torch.bfloat16, sc_bits=bits, device=dev)
        out["paged"].append(_tune_log(f"paged serve sc{bits or 0}", cache,
                                      key, 1) | {"sc_bits": bits})

    size, bits = 1 << 24, 12
    x = torch.randint(0, 1 << bits, (size,), generator=gen, device=dev,
                      dtype=torch.int32)
    y = torch.randint(0, 1 << bits, (size,), generator=gen, device=dev,
                      dtype=torch.int32)

    def lookup(x=x, y=y):
        return autotune.get_or_tune_stream(x, y, bits=bits)
    lookup()
    lookups.append(("stream B=12", lookup))
    cands = autotune.candidate_stream_configs(size)
    want = sc_stream_mul_cuda(x, y, bits=bits)
    for cf in cands:
        if not torch.equal(sc_stream_mul_cuda(x, y, bits=bits,
                                              block_rows=cf.block_rows),
                           want):
            raise AssertionError(f"[tune] stream: block_rows "
                                 f"{cf.block_rows} differs from 8")
    out["stream"].append(_tune_log(
        "stream B=12", cache, cache.stream_key(size, bits, device=dev),
        len(cands)) | {"size": size, "bits": bits})
    del want

    # a decode step's and a chunk's SC-GEMM at the tuned plans and at the
    # default ones: each key's ms times its calls a pass
    calls = {"smollm-360m": SC_SHAPES, **FAMILY_SC_SHAPES}
    out["passes"] = []
    for arch, rows, batch, kind in TUNE_GEMM:
        dt = getattr(torch, ARCHS[arch].dtype)
        probs = {(k, n): m for m, k, n in sc_gemm_problems(
            ARCHS[arch], Shape("tune", rows, batch, kind))}
        ents = {kn: cache.entry(cache.key(probs[kn], *kn, 8, dtype=dt,
                                          device=dev))
                for kn in calls[arch]}
        row = {"arch": arch, "pass": "decode step" if kind == "decode"
               else f"{rows}-row chunk",
               "calls": sum(calls[arch].values()),
               "tuned_ms": sum(c * ents[kn]["us_per_call"] / 1e3
                               for kn, c in calls[arch].items()),
               "default_ms": sum(c * ents[kn]["default_us"] / 1e3
                                 for kn, c in calls[arch].items())}
        out["passes"].append(row)
        log(f"[tune] {arch} {row['pass']}: {row['calls']} SC-GEMM calls, "
            f"{row['tuned_ms']:.3f} ms at the tuned plans against "
            f"{row['default_ms']:.3f} ms at the default ones (the sweeps' "
            f"times, L2 flushed before each call)")

    swept = autotune.sweeps - sweeps0
    if swept != len(lookups) or len(cache) != len(lookups):
        raise AssertionError(f"[tune] {swept} sweeps and {len(cache)} keys "
                             f"for {len(lookups)} problems")
    with autotune.lookup_only():
        for what, lookup in lookups:
            lookup()
    if autotune.sweeps - sweeps0 != swept:
        raise AssertionError("[tune] a second lookup swept")
    out["keys"], out["sweeps"] = len(cache), swept
    out["seconds"] = time.perf_counter() - t0
    out["cache"] = str(cache.path)
    log(f"[tune] {swept} keys swept in {out['seconds']:.1f}s (the bit "
        f"checks included); a second lookup of each swept nothing")
    return out


def _paged_case(dtype, window, positions, gen, dev, c=4, kv=5, g=3, d=64,
                block=64, mb=4, q_scale=1.0):
    """smollm's decode layout with fragmented tables: pages of each slot
    scattered over the pool, -1 past each slot's last page; queries
    scaled by ``q_scale``."""
    import torch
    n_pages = c * mb + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    tables = torch.full((c, mb), -1, dtype=torch.int32, device=dev)
    used = 0
    for i, p in enumerate(positions):
        need = p // block + 1
        tables[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    q = (q_scale * torch.randn((c, kv, g, d), generator=gen,
                               device=dev)).to(dtype)
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
    layout, without and with a logit softcap: the same slots' rows at
    block 16, 32, 48, 64 and 256 and as the dense view, and each slot
    alone against all four together, must give identical outputs.
    Returns what differed."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((4, 5, 3, 64), generator=gen, device=dev).to(dtype)
        k_rows, v_rows = (torch.randn((4, 700, 5, 64), generator=gen,
                                      device=dev).to(dtype) for _ in range(2))
        pos = torch.tensor([650, 255, 37, 699], dtype=torch.int32,
                           device=dev)
        for bits, window, cap in [(b, w, None) for b in (None, 4, 8)
                                  for w in (None, 300)] + [
                (b, 300, 3.0) for b in (None, 8)]:
            outs = {block: paged_attention(
                q, *_paginate(k_rows, v_rows, block, gen), pos,
                window=window, logit_softcap=cap, sc_bits=bits)
                for block in (None, 16, 32, 48, 64, 256)}
            what = (f"{str(dtype)[6:]} sc_bits={bits} window={window}"
                    + (f" softcap={cap}" if cap else ""))
            differ = [b for b, o in outs.items()
                      if not torch.equal(o, outs[None])]
            if differ:
                bad.append(f"paging: {what}, blocks {differ} differ "
                           f"from the dense view")
            kp, vp, tables = _paginate(k_rows, v_rows, 64, gen)
            alone = [i for i in range(4) if not torch.equal(
                paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                pos[i:i + 1], window=window,
                                logit_softcap=cap, sc_bits=bits),
                outs[64][i:i + 1])]
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
    MB 4), at a long context (MB 64, positions up to 4095) and at the
    dense cells' layouts (gemma2-9b's with its logit softcap, windowed and
    global, and without it; qwen2-7b's group 7 and qwen2.5-14b's group 5);
    then bitwise paging and batch invariance, which fail the phase on any
    difference (checked last, so the times are printed either way)."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # f32: the kernel reassociates the softmax sums over 32-token tiles
    # (online rescaling) against the plain version's one exact softmax, a
    # few float32 ulps; bf16: both cast the float32 result to bf16 once,
    # so they may land one bf16 ulp (2**-8 relative) apart. SC: the same,
    # plus one quantization step at most (check_close). With the logit
    # softcap the same: its division and tanh on the card and in PyTorch
    # (which multiplies by the cap's reciprocal) part by an ulp or two of
    # a score, well inside them.
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
    # qwen2-vl-2b's (2 KV heads, group 6, D 128; its speculative draft on
    # the SC path at 4 bits) and musicgen-large's (32 KV heads, group 1,
    # D 64) at the serve cells' block 64 and max_seq 256 (MB 4)
    vlm, audio = dict(kv=2, g=6, d=128), dict(kv=32, g=1, d=64)
    for bits in (None, 4, 8):
        cases += [(f32, None, main, bits, vlm, None),
                  (bf16, None, main, bits, vlm,
                   "vlm" if bits in (None, 4) else None),
                  (f32, None, [0, 63, 127, 191], bits, audio, None),
                  (bf16, None, main, bits, audio,
                   "audio" if bits is None else None)]
    # gemma2-9b's decode layout (8 KV heads, group 2, D 256) at its cell's
    # block 64 and max_seq 4,352 (MB 68), with its logit softcap 50 and
    # queries scaled by 8 so that the cap bends the scores: windowed (its
    # local layers, 4,096) and global, float and SC at 4 and 8 bits; bf16
    # timed, f32 checked; then the same bf16 calls without the cap, timed
    # beside them (the cap's cost)
    gemma, gpos = dict(kv=8, g=2, d=256, mb=68, q_scale=8.0), \
        [4175, 2900, 1500, 64]
    for bits in (None, 4, 8):
        for window, tag in ((4096, "gemma2_local"), (None, "gemma2_global")):
            cases += [(f32, window, gpos, bits, {**gemma, "cap": 50.0}, None),
                      (bf16, window, gpos, bits, {**gemma, "cap": 50.0}, tag)]
    for bits in (None, 8):
        cases.append((bf16, 4096, gpos, bits, gemma, "gemma2_nocap"))
    # qwen2-7b's (4 KV heads, group 7) and qwen2.5-14b's (8 KV heads, group
    # 5) at D 128, the serve cells' block 64 and max_seq 256 (MB 4)
    for tag, geom in (("qwen2_7b", dict(kv=4, g=7, d=128)),
                      ("qwen2_5_14b", dict(kv=8, g=5, d=128))):
        for bits in (None, 8):
            cases += [(f32, None, main, bits, geom, None),
                      (bf16, None, main, bits, geom, tag)]
    rows = []
    for dtype, window, positions, bits, geom, shape in cases:
        geom = dict(geom)
        cap = geom.pop("cap", None)
        q, k, v, tables, qpos = _paged_case(dtype, window, positions, gen,
                                            dev, **geom)
        got = paged_attention(q, k, v, tables, qpos, window=window,
                              logit_softcap=cap, sc_bits=bits)
        want = paged_attention_torch(q, k, v, tables, qpos, window=window,
                                     logit_softcap=cap, sc_bits=bits)
        torch.cuda.synchronize()
        rtol, atol = tol[dtype]
        err = check_close(got, want, rtol=rtol, atol=atol, v=v, bits=bits,
                          what=f"paged ({dtype}, window {window}, sc_bits "
                               f"{bits}, softcap {cap}, positions "
                               f"{positions}, {geom})")
        c, kv, g, d = q.shape
        row = {"dtype": str(dtype).replace("torch.", ""), "window": window,
               "positions": positions, "sc_bits": bits, "softcap": cap,
               "layout": {"C": c, "KV": kv, "G": g, "D": d,
                          "block": k.shape[1], "MB": tables.shape[1]},
               "max_abs_err": err, "shape": shape}
        if shape:
            def call():
                return paged_attention(q, k, v, tables, qpos, window=window,
                                       logit_softcap=cap, sc_bits=bits)
            ms = cuda_ms(call, iters=200)
            dev_ms = device_ms(call, "paged_decode")
            plain_ms = cuda_ms(lambda: paged_attention_torch(
                q, k, v, tables, qpos, window=window, logit_softcap=cap,
                sc_bits=bits), iters=20)
            esz = q.element_size()
            rows_read = sum(min(p + 1, window or p + 1) for p in positions)
            nbytes = (2 * rows_read * kv * d * esz + 2 * q.numel() * esz
                      + tables.numel() * 4 + qpos.numel() * 4)
            # QK and PV, two operations a term each; the cap a division,
            # a tanh and a product a score
            ops = 4 * rows_read * kv * g * d + (3 * rows_read * kv * g
                                                if cap else 0)
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
            f"{f'softcap={cap} ' if cap else ''}pos={positions} "
            f"{geom or ''}: max abs err {err:.2e}{timing}")
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
    """``launch.cost_analysis.flash_bound``: the one rule of a flash
    call's least time, which the dry run counts by too. Returns (ms,
    bound_by, bytes, ops)."""
    from repro_torch.launch.cost_analysis import flash_bound
    return flash_bound(q, k, q_offset, bits)


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
    positions; and qwen2-vl-2b's (H 12, KV 2, D 128) and
    musicgen-large's (H = KV = 32, D 64) 16-row chunks of a 64-token
    prompt. Returns what differed."""
    import torch
    bad = []
    for geom in ((15, 5, 64, 64, 16, (64, 128, 256)),
                 (32, 32, 112, 256, 128, (256, 384)),
                 (12, 2, 128, 64, 16, (64, 256)),
                 (32, 32, 64, 64, 16, (64, 256))):
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
             (1, 32, 32, 128, 384, 112, 256, 384, True, True),
             # qwen2-vl-2b: H 12, KV 2, D 128; the serve cell's one-shot
             # 64-token prefill, a 16-row chunk at 48 over its 64-token
             # bucket, the 256-token vision prefill
             (1, 12, 2, 64, 64, 128, 0, 64, True, True),
             (1, 12, 2, 16, 64, 128, 48, 64, True, True),
             (1, 12, 2, 256, 256, 128, 0, 256, True, True),
             # musicgen-large: H = KV = 32, D 64; one-shot and a chunk
             (1, 32, 32, 64, 64, 64, 0, 64, True, True),
             (1, 32, 32, 16, 64, 64, 48, 64, True, True)]
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

    # the multimodal cells' calls (float: they serve float attention):
    # qwen2-vl-2b's 256-token vision prefill (H 12, KV 2, D 128) and a
    # musicgen-large 16-row chunk at 48 over its 64-token bucket (H = KV =
    # 32, D 64), the offset on the card
    for name, hh, kvh, sq, skv, dd, off in (
            ("vlm_prefill", 12, 2, 256, 256, 128, 0),
            ("audio_chunk", 32, 32, 16, 64, 64, 48)):
        q, k, v = _flash_inputs(torch.bfloat16, 1, hh, kvh, sq, skv, dd,
                                gen, dev, True)
        row = timed(q, k, v, off, skv, None, iters=50, plain_iters=5,
                    on_card=sq < skv)
        timing["float"][name] = row
        show(f"bf16 {name} Sq={sq} Skv={skv} offset={off} H={hh} KV={kvh} "
             f"D={dd}", row)

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
    """``n`` requests of ``prompt_len`` random tokens (``(prompt_len, K)``
    frames with codebooks) and ``gen_lo``-``gen_hi`` new ones."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    shape = ((prompt_len, cfg.n_codebooks) if cfg.n_codebooks
             else (prompt_len,))
    return [Request(uid=f"req-{i}",
                    prompt=rng.integers(0, cfg.vocab_size, size=shape,
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


def _first_difference(ref, got) -> int:
    """The first step at which two ``(n,)`` or ``(n, K)`` streams differ."""
    import numpy as np
    return int(np.argmax((ref != got).reshape(len(ref), -1).any(-1)))


def _serve_launch_counters():
    """The serving path's launch counters: every wrapper's but the stream
    multiplier's, the attention wrappers' SC paths (``*_sc``) apart."""
    from repro_torch.launch.steps import launch_counters
    return {name: c for name, c in launch_counters().items()
            if name != "sc_stream_mul"}


def _serve_engine(cfg, params, mode, graphs, max_seq=256, chunk=16,
                  prefix_cache=False):
    from repro_torch.serving import Engine
    return Engine(cfg, params, device="cuda", capacity=4, max_seq=max_seq,
                  block=64, chunk=chunk, prefill_mode=mode,
                  prefix_cache=prefix_cache, speculate_k=0, graphs=graphs)


def _path_counts(cfg) -> tuple[int, int]:
    """(SC-GEMM projections, attention sites) of one decode step or
    prefill call of ``cfg``'s family: dense, 7 a layer and the LM head;
    ssm, ``in_proj`` and ``out_proj`` a Mamba layer (the tied head is a
    float product); hybrid, those, 7 at each shared-block site and the
    head; moe, 4 attention projections a layer, 3 in a dense layer's MLP,
    3 in a MoE layer (each one launch for all experts) and 3 more for a
    shared expert, and the head."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers, 0
    if cfg.family == "hybrid":
        sites = cfg.n_layers // cfg.shared_attn_every
        return 2 * cfg.n_layers + 7 * sites + 1, sites
    moe = sum(cfg.moe_at(i) for i in range(cfg.n_layers))
    shared = 3 * moe if cfg.shared_expert_d_ff else 0
    return 7 * cfg.n_layers + shared + 1, cfg.n_layers


def _flash_sites(cfg) -> int:
    """The attention sites at which a prefill call launches the flash
    kernel: every one without a sliding window or a logit softcap, at a
    head dim the kernel takes. A windowed site (llama4's 3 of 4 layers)
    or a softcapped one (all of gemma2-9b's, whose head dim 256 is past
    the kernel's 128 too) takes the plain formulation, as in the
    reference, whose TPU kernel's gate refuses them too; its decode runs
    the paged kernel, which takes windows and the softcap."""
    from repro_torch.kernels.flash_attention import MAX_D
    if cfg.family in ("ssm", "hybrid"):
        return _path_counts(cfg)[1]
    if cfg.attn_softcap is not None or cfg.head_dim > MAX_D:
        return 0
    return sum(cfg.window_at(i % cfg.group_size) is None
               for i in range(cfg.n_layers))


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
    (``_path_counts``: 225 and 32 at smollm-360m). The autotuner's sweeps
    in the run are counted; graphed, every capture must have swept in
    its tuning pass only, none in its warm-up or capture."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import steps as step_cache
    from repro_torch.kernels import autotune
    from repro_torch.launch.steps import EAGER_RUNS, bucket_for
    graphs = eng.graphs
    n_proj, sites = _path_counts(cfg)
    flash_sites = _flash_sites(cfg)
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
    sweeps0 = autotune.sweeps
    with _BASELINES.paused(graphs):
        results = eng.run(reqs)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    sweeps = autotune.sweeps - sweeps0
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
        if sites and cfg.attn_softcap:
            want["paged_attention_softcap"] = sites
        if sc_attn and cfg.attn_softcap:
            want["paged_attention_sc_softcap"] = sc_attn
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
        if flash_sites:
            want_p["flash_attention"] = flash_sites
        if sc_attn:
            want_p["flash_attention_sc"] = flash_sites
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
        # the tuner swept only in the captures' tuning passes, never in a
        # warm-up or a capture (lookup-only there)
        prefill_graph["capture_sweeps"] = [s.capture_sweeps
                                           for s in entries.values()]
        prefill_graph["tuning_sweeps"] = [s.tuning_sweeps
                                          for s in entries.values()]
        if step.capture_sweeps or any(prefill_graph["capture_sweeps"]):
            raise AssertionError(f"{tag} the tuner swept during a warm-up or "
                                 f"a capture: decode "
                                 f"{step.capture_sweeps}, prefill "
                                 f"{prefill_graph['capture_sweeps']}")
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
    log(f"{tag} autotuner: {sweeps} sweeps in this run"
        + (f" (captures' tuning passes: decode {step.tuning_sweeps}, prefill "
           f"{prefill_graph['tuning_sweeps']}; warm-ups and captures: 0)"
           if graphs else ""))
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
        f" x {flash_sites} unwindowed sites, and {flash_sites} a warm-up "
        f"run of a capture in this run)"
        + (f", paged with the logit softcap "
           f"{launches['paged_attention_softcap']} (= paged)"
           if cfg.attn_softcap else "")
        + f"; max_memory_allocated {peak / 2**30:.3f} GiB, "
        f"memory_reserved {reserved / 2**30:.3f} GiB")
    if steps < 1:
        raise AssertionError("the engine ran no decode step")
    # one fused launch per projection (``_path_counts``), on every
    # decode step and every prefill call; no weight is quantized on
    # the way (the counts entry, which takes planes quantized per call, is
    # never reached). A prefill capture in this run adds its tuning pass
    # and warm-up (launch.steps.EAGER_RUNS eager runs), which launch the
    # kernels too; the tuner's sweeps put the counters back.
    warm = EAGER_RUNS * st.get("prefill_captures", 0) if graphs else 0
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
            (prefill_calls + warm) * flash_sites:
        raise AssertionError(f"flash kernel launched "
                             f"{launches['flash_attention']} times for "
                             f"{prefill_calls} prefill calls")
    # every paged launch of a softcapped model applied the cap, and no
    # other model's did
    capped = launches["paged_attention"] if cfg.attn_softcap else 0
    if launches["paged_attention_softcap"] != capped or \
            (cfg.attn_softcap and not capped):
        raise AssertionError(f"{tag} {launches['paged_attention_softcap']} "
                             f"paged launches with the softcap, want "
                             f"{capped} (> 0 with a softcap)")
    # every attention launch took the cell's path: SC, or float
    for name, sc in (("paged_attention", "paged_attention_sc"),
                     ("flash_attention", "flash_attention_sc"),
                     ("paged_attention_softcap",
                      "paged_attention_sc_softcap")):
        if launches[sc] != (launches[name] if sc_attn else 0):
            raise AssertionError(f"{tag} {launches[sc]} of "
                                 f"{launches[name]} {name} launches on the "
                                 f"SC path")
    mismatched = []
    for req, res, ref in zip(reqs, results, baseline):
        if res.n_generated != req.max_new_tokens:
            raise AssertionError(f"{req.uid}: {res.n_generated} tokens, "
                                 f"asked {req.max_new_tokens}")
        if not ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"{req.uid}: token out of vocabulary")
        if res.tokens.shape[1:] != req.prompt.shape[1:]:
            raise AssertionError(f"{req.uid}: tokens {res.tokens.shape} for "
                                 f"a prompt of {req.prompt.shape}")
        if not np.array_equal(ref, res.tokens):
            mismatched.append(f"{req.uid} first differs at "
                              f"{_first_difference(ref, res.tokens)}")
    log(f"{tag} {len(reqs) - len(mismatched)}/{len(reqs)} streams identical "
        f"to the sequential baseline")
    if mismatched:
        raise AssertionError(f"{tag} engine streams differ from the "
                             f"sequential baseline: " + "; ".join(mismatched))
    return {"stats": {k: v for k, v in st.items() if k != "backpressure"},
            "launches": launches, "sweeps": sweeps,
            "max_memory_allocated": peak, "memory_reserved": reserved,
            "decode_graph": {"captures": step.captures,
                             "replays": step.replays,
                             "launch_counts": step.launch_counts,
                             "tuning_sweeps": step.tuning_sweeps,
                             "capture_sweeps": step.capture_sweeps}
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
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    tag = "[serve_sc]" if attn_sc else "[serve]"
    cfg, reqs = _baseline_cell(tag[1:-1])
    baseline = _BASELINES.pending(tag[1:-1], tag)
    t0 = time.perf_counter()
    params = bind(cfg, "cuda").init_params(0)
    torch.cuda.synchronize()
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


def _family_workload(cfg, seed=7):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    lens = [FAMILY_PROMPTS[i % 2] for i in range(8)]
    return [Request(uid=f"req-{i}",
                    prompt=rng.integers(0, cfg.vocab_size, size=(n,),
                                        dtype=np.int32),
                    max_new_tokens=int(rng.integers(16, 65)))
            for i, n in enumerate(lens)]


#: The cuts of the family cells, every width kept. The moe configs do not
#: fit the card whole: qwen3-moe-235b-a22b at 2 of its 94 layers (all 128
#: experts, C = 64; every layer MoE); llama4-maverick-400b-a17b at its one
#: whole period of 4 layers (windowed dense, windowed MoE, windowed dense,
#: global MoE) and 32 of its 128 experts (C = 64 at capacity factor 4).
#: zamba2-7b at 9 of its 81 layers (3 of 27 shared-block sites, the
#: pattern kept) and musicgen-large at 12 of its 48. The script has 1,200
#: s and on a slow host (an eager smollm-360m step ~160 ms) ran 1,257 s
#: with these three cells at 4, 27 and 24 layers; the depth comes out of
#: the cells that were cut already, whose checks are exact (streams
#: bitwise, launches by formula), while mamba2-130m and qwen2-vl-2b
#: (whose vision prefill is held within shares of its largest logit) run
#: whole. The dense cells, for the script's time too: qwen2.5-14b at 2 of
#: its 48 layers and gemma2-9b at 2 of its 42 (one local/global period);
#: qwen2-7b runs whole. Whole (the kernel's default SC-GEMM plans, on an
#: H100 80GB HBM3 at 700 W) both fit and serve every stream equal to the
#: baseline, but take 103.9 s (peak 54.5 GiB) and 797.1 s (58.3 GiB; ~19
#: s a layer, most of it the 4,160-token prompt's SC-GEMM at 4,160 rows
#: and plain flash formulation, seven one-shot passes and two chunked);
#: qwen2-7b alone takes 65.8 s, and the script's estimate on a slow host
#: was already ~980 s of its 1,200. To serve one whole, drop its entry
#: here in a copy of the script and run that cell alone (``--only``).
FAMILY_CUTS = {"qwen3-moe-235b-a22b": {"n_layers": 2},
               "llama4-maverick-400b-a17b": {"n_layers": 4, "n_experts": 32},
               "zamba2-7b": {"n_layers": 9},
               "musicgen-large": {"n_layers": 12},
               "qwen2.5-14b": {"n_layers": 2},
               "gemma2-9b": {"n_layers": 2}}



def _family_cfg(arch: str):
    """A family cell's config: ``arch`` as registered (whole, or cut as
    ``FAMILY_CUTS`` says), SC-GEMM at 8 bits, float attention."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(ARCHS[arch], use_sc_gemm=True, sc_bits=8,
                               **FAMILY_CUTS.get(arch, {})).validate()


#: phase -> arch of the family cells. ``phase_profile`` profiles each
#: one's graphed decode step before any cell serves: traces taken after
#: serving runs lost kernel records (one of 96 at mamba2-130m after the vlm
#: and audio cells, three of 394 at qwen2-vl-2b after zamba2-7b's, 37 of
#: 704 at zamba2-7b after the smollm cells; PERF.md §7)
PROFILED_CELLS = {"serve_ssm": "mamba2-130m", "serve_hybrid": "zamba2-7b",
                  "serve_vlm": "qwen2-vl-2b",
                  "serve_audio": "musicgen-large"}
#: the moe cells (not profiled: a graphed step there is ~0.2 s, almost all
#: of it the batched expert projections, which ``sc_gemm`` times)
MOE_CELLS = {"serve_moe": "qwen3-moe-235b-a22b",
             "serve_moe_llama4": "llama4-maverick-400b-a17b"}
#: the plain dense LLMs of the registry at their full widths: QKV bias and
#: the paged kernel at groups 7 and 5 (the qwen cells); alternating 4,096-
#: token windows, attention softcap 50 on every layer (the paged kernel's
#: softcap path), final softcap 30, head dim 256 and a scaled, tied
#: 256,000-row embedding (gemma2-9b). Not profiled: their steps are the
#: same kernels at other widths
DENSE_CELLS = {"serve_qwen2_7b": "qwen2-7b",
               "serve_qwen2_5_14b": "qwen2.5-14b",
               "serve_gemma2_9b": "gemma2-9b"}
FAMILY_CELLS = {**PROFILED_CELLS, **MOE_CELLS, **DENSE_CELLS}
#: cells served graphed only (no eager run, no speculative engine;
#: speculation over gemma2's arch is held on the CPU)
GRAPHED_ONLY = {"serve_moe_llama4", *DENSE_CELLS}
#: a family cell's traffic: (its requests from the config, the engine's
#: max_seq and chunk). The ssm and hybrid cells take ``FAMILY_*``'s; the
#: vlm and audio cells the ``serve`` cell's (8 requests of 64-token
#: prompts, ``(64, K)`` frames with codebooks, 16-64 new tokens)
FAMILY_TRAFFIC = (_family_workload,
                  dict(max_seq=FAMILY_MAX_SEQ, chunk=FAMILY_CHUNK))
SERVE_TRAFFIC = (lambda cfg: _workload(cfg, 8, 64, 16, 64, seed=5),
                 dict(max_seq=256, chunk=16))
#: the moe cells' requests: the ``serve`` cell's traffic with 4 requests
#: instead of 8 (a step of either cut model is ~0.2-0.3 s whatever its
#: tokens: every expert computes its C = 64 capacity rows), so that the
#: script stays within its time limit
MOE_REQUESTS = 4
MOE_TRAFFIC = (lambda cfg: _workload(cfg, MOE_REQUESTS, 64, 16, 64, seed=5),
               dict(max_seq=256, chunk=16))
#: gemma2-9b's traffic: the ``serve`` cell's 8 requests and one of a
#: 4,160-token prompt and 16 new tokens, last, through ``max_seq`` 4,352
#: and 256-row chunks, so that the 4,096-token window binds in its
#: prefill (rows past 4,095, chunked and one-shot) and in its decode
GEMMA_LONG_PROMPT, GEMMA_LONG_NEW = 4160, 16


def _gemma_workload(cfg):
    import dataclasses
    return (_workload(cfg, 8, 64, 16, 64, seed=5)
            + [dataclasses.replace(
                _workload(cfg, 1, GEMMA_LONG_PROMPT, GEMMA_LONG_NEW,
                          GEMMA_LONG_NEW, seed=13)[0], uid="req-long")])


GEMMA_TRAFFIC = (_gemma_workload, dict(max_seq=4352, chunk=256))
#: a family cell's speculative engine: (k, draft_bits)
FAMILY_SPEC = (1, 4)
#: each family cell's traffic
CELL_TRAFFIC = {"serve_ssm": FAMILY_TRAFFIC, "serve_hybrid": FAMILY_TRAFFIC,
                "serve_vlm": SERVE_TRAFFIC, "serve_audio": SERVE_TRAFFIC,
                "serve_moe": MOE_TRAFFIC, "serve_moe_llama4": MOE_TRAFFIC,
                "serve_qwen2_7b": SERVE_TRAFFIC,
                "serve_qwen2_5_14b": SERVE_TRAFFIC,
                "serve_gemma2_9b": GEMMA_TRAFFIC}
#: phase -> the cells whose sequential baselines it reads from the child
#: process (``_Baselines``). Not the moe cells': a B=1 step there is ~0.2 s
#: of batched expert projections on the card, whose kernels would share
#: it with every run of the main process (on an H100 80GB HBM3 at 700 W
#: the serve cell's graphed step took 19.49 ms beside llama4's baseline,
#: 9.98 alone), so those cells compute theirs in line, after the child
#: has ended. The dense cells' come last: the child computes them (28.6
#: GiB at most, qwen2-7b's) beside the vlm and audio cells (under 13 GiB)
#: and has ended before the moe cells start; in line they took ~40 s of
#: the script (H100 80GB HBM3, 700 W).
BASELINE_KEYS = {"serve": ("serve",), "serve_sc": ("serve_sc",),
                 "serve_spec": ("serve", "serve_sc"),
                 "serve_prefix": ("serve_prefix",),
                 **{name: (name,) for name in PROFILED_CELLS},
                 **{name: (name,) for name in DENSE_CELLS}}


def _baseline_cell(key: str):
    """(config, requests) of the serving cell whose baseline ``key``
    names: the cell's own, built as its phase builds them."""
    if key in ("serve", "serve_sc"):
        cfg = _spec_cfg(key == "serve_sc")
        return cfg, _workload(cfg, 8, 64, 16, 64, seed=5)
    if key == "serve_prefix":
        cfg = _spec_cfg(False)
        return cfg, _prefix_workload(cfg)
    cfg = _family_cfg(FAMILY_CELLS[key])
    return cfg, CELL_TRAFFIC[key][0](cfg)


def _generate_streams(cfg, params, reqs) -> list:
    """The sequential baseline: each request alone through B=1
    ``generate`` on the card, its stream as a numpy array."""
    from repro_torch.launch.serve import generate
    return [generate(cfg, params, r.prompt[None],
                     gen_tokens=r.max_new_tokens,
                     device="cuda")[0].cpu().numpy() for r in reqs]


def _baseline_worker(keys, queue) -> None:
    """A child process's body: each cell's sequential B=1 ``generate``
    baseline on the card, on the cell's weights (``init_params(0)``, the
    phases' seed), in ``keys``' order; each put on ``queue`` as ``(key,
    streams, seconds, peak allocated bytes)``, or ``(key, None,
    traceback, None)`` and an end at the first failure."""
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(BASELINE_TUNE_CACHE)
    import torch
    from repro_torch.device import exact_float32
    from repro_torch.models import bind
    exact_float32()
    torch.set_num_threads(2)     # the serving process has the other cores
    for key in keys:
        try:
            cfg, reqs = _baseline_cell(key)
            params = bind(cfg, "cuda").init_params(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            streams = _generate_streams(cfg, params, reqs)
            torch.cuda.synchronize()
            queue.put((key, streams, time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated()))
        except BaseException:
            queue.put((key, None, traceback.format_exc(), None))
            return
        finally:
            params = None
            gc.collect()
            torch.cuda.empty_cache()


class _Baselines:
    """The serving cells' sequential baselines (``BASELINE_KEYS``),
    computed by one child process (``_baseline_worker``) while the main
    process serves: a baseline is host-bound (one B=1 eager step at a
    time, the card ~7% busy), and computed in line the seven took 236 s
    of a 1,257 s run (H100 80GB HBM3, 700 W). A cell's runs read it through ``pending``,
    which waits for it at the first comparison. The child is stopped
    (``paused``) while a graphed run or replay is timed, so that no
    kernel of its shares the card with them; the moe cells' phases first
    ``finish`` it."""

    def __init__(self):
        self.proc = self.queue = None
        self.keys: tuple = ()
        self.got: dict = {}

    def start(self, keys) -> None:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.keys = tuple(keys)
        self.queue = ctx.Queue()
        self.proc = ctx.Process(target=_baseline_worker, daemon=True,
                                args=(self.keys, self.queue),
                                name="chip_smoke baselines")
        self.proc.start()
        log(f"[baselines] a child process computes {list(self.keys)}")

    def get(self, key: str) -> dict:
        """``{"streams", "seconds", "peak", "waited"}`` of ``key``'s cell,
        waiting for the child when it has not sent it yet."""
        import queue as q
        if key not in self.got and key not in self.keys:
            raise AssertionError(f"[baselines] {key} was not asked of the "
                                 f"child process")
        t0 = time.perf_counter()
        while key not in self.got:
            try:
                k, streams, secs, peak = self.queue.get(timeout=5)
            except q.Empty:
                if not self.proc.is_alive():
                    raise AssertionError(
                        f"[baselines] the child process exited with "
                        f"{self.proc.exitcode} before sending {key}")
                continue
            if streams is None:
                raise AssertionError(f"[baselines] {k} failed in the child "
                                     f"process:\n{secs}")
            self.got[k] = {"streams": streams, "seconds": secs,
                           "peak": peak, "waited": 0.0}
        self.got[key]["waited"] += time.perf_counter() - t0
        return self.got[key]

    def pending(self, key: str, tag: str) -> "_PendingBaseline":
        return _PendingBaseline(self, key, tag)

    @contextlib.contextmanager
    def paused(self, on: bool = True):
        """The child stopped (``SIGSTOP``) for the block when ``on``; the
        kernels it has queued drain in a few ms."""
        proc = self.proc if on else None
        try:
            if proc is not None:
                os.kill(proc.pid, signal.SIGSTOP)
        except ProcessLookupError:     # it has ended
            proc = None
        try:
            yield
        finally:
            if proc is not None:
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass

    def finish(self) -> None:
        """Every baseline received and the child gone (its memory too)."""
        for key in self.keys:
            self.get(key)
        self.stop()

    def stop(self) -> None:
        if self.proc is None:
            return
        # the child ends by itself once it has sent every baseline
        self.proc.join(timeout=30 if set(self.keys) <= set(self.got) else 0)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        self.proc = None


class _PendingBaseline:
    """A cell's baseline streams as an iterable read at first use: the
    cell's first run serves while the child still computes them."""

    def __init__(self, baselines: _Baselines, key: str, tag: str):
        self.baselines, self.key, self.tag = baselines, key, tag
        self.streams = None

    def __iter__(self):
        if self.streams is None:
            b = self.baselines.get(self.key)
            self.streams = b["streams"]
            log(f"{self.tag} sequential baseline (in a child process): "
                f"{len(self.streams)} requests in {b['seconds']:.1f}s, peak "
                f"allocated {b['peak'] / 2**30:.3f} GiB there; waited "
                f"{b['waited']:.1f}s for it")
        return iter(self.streams)


_BASELINES = _Baselines()


def _family_line(cfg, n_params: int) -> str:
    """The model as its phase's first line describes it."""
    n_proj, sites = _path_counts(cfg)
    if cfg.family in ("ssm", "hybrid"):
        body = (f"{cfg.n_layers} Mamba-2 layers (d_model {cfg.d_model}, "
                f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads x "
                f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv "
                f"{cfg.ssm_conv}), {sites} shared-block attention sites"
                + (f" ({cfg.n_heads}/{cfg.n_kv_heads} heads x "
                   f"{cfg.head_dim}, d_ff {cfg.d_ff})" if sites else "")
                + f", vocab {cfg.vocab_size}")
    elif cfg.family == "moe":
        from repro_torch.models.moe import moe_capacity
        moe = sum(cfg.moe_at(i) for i in range(cfg.n_layers))
        body = (f"{cfg.n_layers} layers ({moe} MoE: {cfg.n_experts} experts, "
                f"top-{cfg.top_k}, expert d_ff {cfg.moe_d_ff}, capacity C = "
                f"{moe_capacity(cfg)} a router group of "
                f"{cfg.router_group_size}"
                + (f", a shared expert of d_ff {cfg.shared_expert_d_ff}"
                   if cfg.shared_expert_d_ff else "")
                + (f"; {cfg.n_layers - moe} dense of d_ff {cfg.d_ff}"
                   if moe < cfg.n_layers else "")
                + f"), d_model {cfg.d_model}, {cfg.n_heads}/"
                f"{cfg.n_kv_heads} heads x {cfg.head_dim}, windows "
                f"{cfg.windows}, vocab {cfg.vocab_size}")
    else:
        body = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
                f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
                f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
                + (f" x {cfg.n_codebooks} codebooks" if cfg.n_codebooks
                   else "")
                + (f", M-RoPE sections {cfg.mrope_sections}"
                   if cfg.mrope_sections else "")
                + (", QKV bias" if cfg.qkv_bias else "")
                + (f", windows {cfg.windows}" if any(cfg.windows) else "")
                + (f", softcap {cfg.attn_softcap} (attention) / "
                   f"{cfg.final_softcap} (final)" if cfg.attn_softcap
                   else "")
                + (", tied scaled embedding" if cfg.tie_embeddings
                   and cfg.emb_scale else "") + f", {cfg.act}")
    cut = FAMILY_CUTS.get(cfg.name)
    body += (f"; cut {cut} of the registered config, every width kept"
             if cut else "; whole")
    return (f"{cfg.name} ({cfg.family}): {body}, {cfg.dtype}, "
            f"{n_params / 1e9:.3f} B parameters; SC-GEMM {cfg.sc_bits}-bit "
            f"({n_proj} projections a step), attention float")


def _family_chunk_ms(eng, cfg, tag: str, length: int, n: int = 2) -> dict:
    """A prefill chunk as the engine drives it (the inputs copied in, the
    bucket's step run or replayed), on a prompt of ``length`` tokens (the
    cell's longest): wall ms a chunk over ``n`` passes of its chunks, each
    ending in a synchronize; graphed, the replay's device ms back to back
    too (CUDA events, the staging position put back before each)."""
    import torch
    req = _workload(cfg, 1, length, 1, 1, seed=17)[0]
    st = eng._start_prefill(req)
    step, walls = st.step, []
    for _ in range(n):
        step.start()
        st.entry.prefill_offset = 0
        for _ in range(length // eng.chunk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._prefill_chunk_once(st)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    out = {"wall_ms": sum(walls) / len(walls), "replay_ms": None}
    if eng.graphs:
        # the last chunk again: its offset put back before each replay
        saved = step.cache.pos - eng.chunk

        def replay():
            step.cache.pos.copy_(saved)
            step.replay()
        out["replay_ms"] = cuda_ms(replay, 4, warmup=0)
    log(f"{tag} prefill chunk ({eng.chunk} rows of a {length}-token "
        f"prompt): {out['wall_ms']:.3f} ms a chunk"
        + (f", replay {out['replay_ms']:.3f} ms on the device back to back"
           if out["replay_ms"] is not None else ""))
    return out


#: qwen2-vl-2b's vision prefill: a 256-token prompt whose first 64 rows are
#: patch embeddings at the (t, h, w) ids (0, row, column) of an 8 x 8 grid
#: — the reference's ``input_specs`` form, P = S // 4 — and whose text ids
#: continue from 8 in all three streams.
VISION_PROMPT, VISION_GRID = 256, 8
#: the vision prefill's cases: (tag, dtype, SC-GEMM, the plain versions
#: its logits are held against, tolerance as a share of the largest logit)
VISION_CASES = (("f32_exact", "float32", False, {"attn_kernel": "jnp"}, 1e-3),
                ("bf16_exact", "bfloat16", False, {"attn_kernel": "jnp"},
                 1e-1),
                ("cell", "bfloat16", True, {"sc_impl": "ref"}, 0.0))


def _vision_batch(cfg, gen) -> dict:
    import torch
    from repro_torch.models.transformer import model_dtype
    dev = torch.device("cuda")
    s, g = VISION_PROMPT, VISION_GRID
    p = g * g
    ids = torch.arange(p, dtype=torch.int32, device=dev)
    pos = torch.zeros((3, 1, s), dtype=torch.int32, device=dev)
    pos[1, 0, :p] = ids // g
    pos[2, 0, :p] = ids % g
    pos[:, 0, p:] = g + torch.arange(s - p, dtype=torch.int32, device=dev)
    return {"tokens": torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                                    device=dev, dtype=torch.int32),
            "visual_embeds": torch.randn((1, p, cfg.d_model), generator=gen,
                                         device=dev).to(model_dtype(cfg)),
            "mrope_positions": pos}


def _vision_prefill(cfg, params, name: str) -> dict:
    """One-shot ``prefill_step`` of the vision batch (distinct M-RoPE
    streams through the flash kernel) on the card, its logits held against
    the same call through plain versions, case by case (``VISION_CASES``):

    * float32, exact projections, against the port's plain attention
      (``attn_kernel="jnp"``): float32 on CUDA cores against one exact
      softmax, sums in other orders, within 1e-3 of the largest logit; and
      the grid's positions must move the logits (against the default
      positions) by more than that;
    * bf16, exact projections, against the plain attention: outputs an
      ulp apart here and there carried through 28 layers, within 0.1 of
      the largest logit;
    * the cell's numeric (bf16, SC-GEMM at 8 bits) against the SC-GEMM's
      plain closed form per call (``sc_impl="ref"``), the flash kernel
      kept: integer-exact counts, so the logits must be bit-equal.

    Reported beside each, not held: the logits against both plain versions
    at once, and how far the all-plain model's logits move when one patch
    embedding's first element moves by one ulp of its dtype."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import prefill_step
    from repro_torch.models import bind, pack_sc_weights
    from repro_torch.models.transformer import params_to
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for tag, dtype, sc, plain, rel in VISION_CASES:
        c = dataclasses.replace(cfg, dtype=dtype, use_sc_gemm=sc)
        w = params if dtype == cfg.dtype else params_to(params, torch.float32)
        batch = _vision_batch(c, gen)
        model = bind(c, "cuda")
        got, _ = prefill_step(model, pack_sc_weights(w, c), batch)
        want, _ = prefill_step(bind(dataclasses.replace(c, **plain), "cuda"),
                               w, batch)
        all_plain = bind(dataclasses.replace(c, sc_impl="ref",
                                             attn_kernel="jnp"), "cuda")
        both, _ = prefill_step(all_plain, w, batch)
        emb = batch["visual_embeds"].clone()   # one ulp off in its bits
        emb.view({torch.float32: torch.int32,
                  torch.bfloat16: torch.int16}[emb.dtype])[0, 0, 0] += 1
        nudged, _ = prefill_step(all_plain, w, {**batch,
                                                "visual_embeds": emb})
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        row = {"dtype": dtype, "sc_gemm": sc, "plain": plain,
               "max_abs_err": err, "max_abs_logit": scale,
               "tolerance": rel * scale,
               "argmax_equal": bool(torch.equal(got.argmax(-1),
                                                want.argmax(-1))),
               "finite": bool(torch.isfinite(got).all()),
               "both_plain_max_abs_err": (got - both).abs().max().item(),
               "one_ulp_nudge_max_abs": (nudged - both).abs().max().item()}
        ok = torch.equal(got, want) if rel == 0 else err <= row["tolerance"]
        if tag == "f32_exact":
            text, _ = prefill_step(model, w, {
                "tokens": batch["tokens"],
                "visual_embeds": batch["visual_embeds"]})
            row["grid_vs_default_positions"] = (
                (got - text).abs().max().item())
            ok = ok and row["tolerance"] < row["grid_vs_default_positions"]
        log(f"[{name}] vision prefill ({VISION_PROMPT} tokens, "
            f"{VISION_GRID ** 2} patch embeddings on a {VISION_GRID} x "
            f"{VISION_GRID} grid, {dtype}"
            f"{', SC-GEMM %d-bit' % c.sc_bits if sc else ', exact'}) "
            f"against {plain}: max abs err {err:.4e} (tolerance "
            f"{row['tolerance']:.4e}; largest logit {scale:.3f}), argmax "
            f"{'equal' if row['argmax_equal'] else 'differs'}"
            + (f"; the grid's positions move the logits by "
               f"{row['grid_vs_default_positions']:.4f} against the default "
               f"ones" if tag == "f32_exact" else "")
            + f"; not held: against both plain versions "
            f"{row['both_plain_max_abs_err']:.4e}, the all-plain model "
            f"under a one-ulp nudge of one input {row['one_ulp_nudge_max_abs']:.4e}")
        if not (row["finite"] and ok):
            raise AssertionError(f"[{name}] vision prefill {tag}: {row}")
        out[tag] = row
        del w, got, want, both, nudged
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _family_speculate(cfg, params, reqs, baseline, shape, name: str):
    """A graphed speculative engine at ``FAMILY_SPEC``: where the family
    speculates (attention without codebooks, as in the reference) its two
    runs against the baseline, the second the cell; else it must be
    refused, and the refusal is returned."""
    from repro_torch.errors import ConfigError
    from repro_torch.serving import Engine
    k, bits = FAMILY_SPEC
    speculates = cfg.family not in ("ssm", "hybrid") and not cfg.n_codebooks
    try:
        eng = Engine(cfg, params, device="cuda", capacity=4, block=64,
                     prefix_cache=False, graphs=True, speculate_k=k,
                     draft_bits=bits, **shape)
    except ConfigError as e:
        if speculates:
            raise
        log(f"[{name}] a speculative engine is refused: {e}")
        return f"refused: {e}"
    if not speculates:
        raise AssertionError(f"[{name}] the {cfg.family} family speculated")
    first = _serve_spec_run(cfg, eng, reqs, baseline, name=name)
    cell = _serve_spec_run(cfg, eng, reqs, baseline, run=2, name=name)
    cell["first_run"] = first
    return cell


def _family_phase(name: str) -> dict:
    """Serve the cell's ``CELL_TRAFFIC`` at the cell's arch as registered,
    whole (SC-GEMM at 8 bits, float attention, random weights from seed
    0), with the prefix cache asked for (its dense-only gate turns it off,
    and the stats must say so; a dense cell asks for none, as the
    ``serve`` cell): chunked and
    one-shot, each eager and then graphed twice on one engine (the second
    run the cell; ``GRAPHED_ONLY`` cells graphed only), every run against
    the sequential B=1 ``generate`` baseline (a moe cell computes it here,
    once the child process has ended), a prefill chunk timed on the
    chunked engines. An M-RoPE model first holds its vision
    prefill (``_vision_prefill``); last, a speculative engine serves or is
    refused (``_family_speculate``). A dense cell's float weights wait on
    the host while its engines run: each graphed entry copies them in
    and packs its own. The graphed step's profile is ``phase_profile``'s."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.models.transformer import params_to
    shape = CELL_TRAFFIC[name][1]
    cfg, reqs = _baseline_cell(name)
    total = torch.cuda.get_device_properties(0).total_memory
    if cfg.family == "moe":
        _no_drops(cfg, name, shape)
        # the cell's engines need most of the card: the child process that
        # computes the other cells' baselines goes first
        _BASELINES.finish()
    else:
        baseline = _BASELINES.pending(name, f"[{name}]")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = bind(cfg, "cuda").init_params(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in steps._tensors(params))
    log(f"[{name}] {_family_line(cfg, n_params)}; init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    out = {"n_layers": cfg.n_layers, "parameters": n_params}
    peaks = {}
    if cfg.mrope_sections:
        out["vision_prefill"] = _vision_prefill(cfg, params, name)
    longest = max(r.prompt_len for r in reqs)
    what = (f"{len(reqs)} requests ({sum(r.prompt_len for r in reqs)} "
            f"prompt tokens"
            + (f" of {cfg.n_codebooks} codebooks" if cfg.n_codebooks else "")
            + f", {sum(r.max_new_tokens for r in reqs)} new)")
    windows = [w for w in cfg.windows if w]
    if windows:
        what += (f"; the longest prompt {longest} tokens "
                 f"({'crosses' if longest > min(windows) else 'within'} "
                 f"the {min(windows)}-token window)")
        if name in DENSE_CELLS and not longest > min(windows):
            raise AssertionError(f"[{name}] no request crosses the "
                                 f"{min(windows)}-token window")
    if cfg.family == "moe":
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        baseline = _generate_streams(cfg, params, reqs)
        torch.cuda.synchronize()
        peaks["baseline"] = torch.cuda.max_memory_allocated()
        log(f"[{name}] sequential baseline: {what} in "
            f"{time.perf_counter() - t1:.1f}s, peak allocated "
            f"{peaks['baseline'] / 2**30:.3f} GiB")
    else:
        log(f"[{name}] {what}")
    if name in DENSE_CELLS:
        # an entry holds its own float copy and the packed one: the
        # caller's copy waits on the host, so no second device copy exists
        params = params_to(params, "cpu")
        gc.collect()
        torch.cuda.empty_cache()
    modes = (True,) if name in GRAPHED_ONLY else (False, True)
    for mode in ("chunked", "oneshot"):
        steps.clear_decode_steps()
        gc.collect()
        runs = {}
        for graphs in modes:
            n0 = len(steps.decode_steps())
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            eng = _serve_engine(cfg, params, mode, graphs, **shape,
                                prefix_cache=name not in DENSE_CELLS)
            torch.cuda.synchronize()
            kind = "graphed" if graphs else "eager"
            peaks[f"{mode}:{kind}:build"] = torch.cuda.max_memory_allocated()
            log(f"[{name}:{mode}:{kind}] engine built in "
                f"{time.perf_counter() - t1:.1f}s (its decode graph "
                f"captured), peak allocated "
                f"{peaks[f'{mode}:{kind}:build'] / 2**30:.3f} GiB")
            runs[kind] = _serve_run(cfg, eng, reqs, mode, baseline,
                                    name=name, captured=len(
                                        steps.decode_steps()) - n0)
            if graphs:
                runs["first"] = runs[kind]
                runs[kind] = _serve_run(cfg, eng, reqs, mode, baseline,
                                        run=2, name=name)
            if mode == "chunked":
                # the cell's longest prompt, or for a dense cell the
                # serve prompts' 64 tokens in whole chunks
                length = longest if name not in DENSE_CELLS else \
                    eng.chunk * max(1, 64 // eng.chunk)
                with _BASELINES.paused(graphs):
                    runs[kind]["prefill_chunk"] = _family_chunk_ms(
                        eng, cfg, f"[{name}:{mode}:{kind}]", length)
            del eng
            gc.collect()
            # a moe cell's next entry needs ~40 GiB more in one piece
            torch.cuda.empty_cache()
        eager, first, graphed = (runs.get("eager"), runs["first"],
                                 runs["graphed"])
        for run in (eager, first, graphed):
            if run is not None and run["stats"]["prefix_cache"]:
                raise AssertionError(f"[{name}] the prefix cache is on for "
                                     f"the {cfg.family} family")
        graphed["first_run"] = first
        if eager is not None:
            graphed["eager"] = eager
            graphed["eager_vs_graphed"] = _side_by_side(f"[{name}:{mode}]",
                                                        eager, graphed)
        fs = first["stats"]
        log(f"[{name}:{mode}] graphed first run (its captures included): "
            f"tokens/s {fs['tok_per_s']:.2f}, TTFT p50 "
            f"{fs['ttft_p50_s'] * 1e3:.2f} ms, peak allocated "
            f"{first['max_memory_allocated'] / 2**30:.3f} GiB; prefix cache "
            + ("off, as in the serve cell" if name in DENSE_CELLS else
               f"asked for, off for the {cfg.family} family"))
        out[mode] = graphed
    steps.clear_decode_steps()
    gc.collect()
    if name in GRAPHED_ONLY:
        out["speculative"] = "not run: a graphed-only cell"
    else:
        if cfg.family == "moe":
            # the draft's planes are a fourth copy of the weights' size:
            # the caller's float copy waits on the host, and the engine
            # brings it over only while its entry copies it in
            params = params_to(params, "cpu")
            gc.collect()
            torch.cuda.empty_cache()
        out["speculative"] = _family_speculate(cfg, params, reqs, baseline,
                                               shape, name)
    steps.clear_decode_steps()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for m in ("chunked", "oneshot", "speculative"):
        if isinstance(out[m], dict):
            for tag, r in (("", out[m]), (":first", out[m].get("first_run")),
                           (":eager", out[m].get("eager"))):
                if isinstance(r, dict):
                    peaks[f"{m}{tag}"] = r["max_memory_allocated"]
    out["peak_gib"] = {k: v / 2**30 for k, v in peaks.items()}
    out["peak_gib_max"] = max(peaks.values()) / 2**30
    log(f"[{name}] peak allocated over the cell (each engine's build and "
        f"its serving runs{', and its baseline' if 'baseline' in peaks else ''}) {out['peak_gib_max']:.3f} "
        f"GiB of the card's {total / 2**30:.3f}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["peak_gib"].items()))
    return out


def _no_drops(cfg, name: str, shape: dict) -> None:
    """A moe cell's streams can equal the B=1 baseline only if no token is
    dropped: every router group the cell forms — a decode step's slots,
    a prefill chunk, a one-shot prompt, a verify window's slots x (k + 1)
    — must fit the capacity C (a group of g tokens puts at most g on one
    expert), and a one-shot prompt must be one group."""
    from repro_torch.models.moe import moe_capacity
    c = moe_capacity(cfg)
    k = FAMILY_SPEC[0]
    groups = {"decode": 4, "chunk": shape["chunk"], "one-shot prompt": 64,
              "verify window": 4 * (k + 1)}
    log(f"[{name}] capacity C = {c} >= every router group the cell forms "
        f"({groups}): no token can be dropped")
    if any(g > c or g > cfg.router_group_size for g in groups.values()):
        raise AssertionError(f"[{name}] a router group of {groups} exceeds "
                             f"C = {c}: tokens could be dropped and streams "
                             f"part from the baseline")


def phase_serve_ssm() -> dict:
    return _family_phase("serve_ssm")


def phase_serve_hybrid() -> dict:
    return _family_phase("serve_hybrid")


def phase_serve_vlm() -> dict:
    return _family_phase("serve_vlm")


def phase_serve_audio() -> dict:
    return _family_phase("serve_audio")


def phase_serve_moe() -> dict:
    return _family_phase("serve_moe")


def phase_serve_moe_llama4() -> dict:
    return _family_phase("serve_moe_llama4")


def phase_serve_qwen2_7b() -> dict:
    return _family_phase("serve_qwen2_7b")


def phase_serve_qwen2_5_14b() -> dict:
    return _family_phase("serve_qwen2_5_14b")


def phase_serve_gemma2_9b() -> dict:
    return _family_phase("serve_gemma2_9b")


#: The train phase: smollm-360m at full width as registered (32 layers,
#: bf16, remat on) with SC-GEMM at 8 bits and float attention, at the
#: reference CLI's batch 8 and sequence 128, learning rate 3e-4 and the
#: synthetic pipeline of seed 0. Its cut: 8 steps (the CLI's default is
#: 100), a first ``train`` call of 4 steps that saves and is dropped, then
#: a second on the same directory that resumes and runs to 8.
TRAIN_ARCH = "smollm-360m"
TRAIN_RUN = dict(batch=8, seq=128, lr=3e-4, seed=0)
TRAIN_KILL, TRAIN_STEPS = 4, 8
#: Steps timed a configuration (after one untimed step), each between
#: CUDA events as well as on the host's clock.
TRAIN_TIMED = 4
#: The kernels' steps are held against the plain versions' by a floor
#: taken from the plain path's own rounding at the same numeric: the plain
#: step against itself with each attention output's bf16 rounding moved
#: one ulp, up or down, in the share of elements where the kernel's
#: outputs and the plain version's differ in this run (a hash of each
#: element's index and bits, salted, picks them, so remat's recompute
#: moves the same ones). Once for each salt, under SC-GEMM at 8 bits (all
#: kernels) and at exact projections (the flash kernel alone). The
#: kernels' loss error, gradient tree L2 distance, and each leaf's max
#: error and L2 distance must each be no larger than the largest floor
#: reading of the same numeric. On an H100 80GB HBM3 at 700 W (four
#: salts) every reading but one sat below the smallest floor:
#: under SC-GEMM 0.10 against 0.14 in L2 and 0.71 against 0.99 for a
#: leaf, the loss 7.3e-4 within 5.9e-5–5.6e-3; at exact projections
#: 6.3e-3 against 6.6e-3 and 1.6e-2 against 2.0e-2.
TRAIN_FLOOR_SALTS = (1, 2, 3)
#: the metrics that the floor bounds (``_step_errors``)
TRAIN_HELD = ("loss_rel", "norm_rel", "max_rel", "leaf_l2_rel")


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


class _FlashRecorder:
    """While entered, keeps the first ``limit`` flash kernel launches'
    operands and output (the kernel's layout, ``ops.flash_attention_tuned``)
    for an element-by-element comparison with the plain version; the
    launches and their counts are the kernel's own."""

    def __init__(self, limit: int):
        self.limit, self.calls = limit, []

    def __enter__(self):
        from repro_torch.kernels import ops
        self._real = real = ops.flash_attention_tuned

        def rec(q, k, v, **kw):
            out = real(q, k, v, **kw)
            if len(self.calls) < self.limit:
                self.calls.append((q.detach(), k.detach(), v.detach(), kw,
                                   out.detach()))
            return out
        ops.flash_attention_tuned = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention_tuned = self._real


def _ordered(x):
    """A float tensor's bits as integers in the floats' order (adjacent
    floats one apart), int64."""
    import torch
    itype, mag = {torch.bfloat16: (torch.int16, 0x7FFF),
                  torch.float32: (torch.int32, 0x7FFFFFFF)}[x.dtype]
    bits = x.contiguous().view(itype).to(torch.int64)
    return torch.where(bits < 0, -(bits & mag), bits)


def _ulp_stats(got, want) -> dict:
    """The share of elements that differ, the largest distance in ulps of
    the dtype (large only near zero, where ulps are small) and the largest
    difference over the largest magnitude of ``want``."""
    d = (_ordered(got) - _ordered(want)).abs()
    return {"share": (d > 0).float().mean().item(),
            "max_ulps": int(d.max().item()),
            "max_rel": ((got.float() - want.float()).abs().max()
                        / want.float().abs().max().clamp(min=1e-30)).item()}


def _flash_op_stats(calls) -> dict:
    """The recorded kernel outputs against the plain version on the same
    operands, and the plain version against itself over key blocks of half
    the kernel's group (its online softmax merging two blocks where the
    kernel's group is one), over every recorded call together."""
    from repro_torch.kernels.flash_attention import flash_attention_torch
    rows = {"kernel_vs_plain": [], "plain_half_blocks": []}
    for q, k, v, kw, out in calls:
        plain = flash_attention_torch(q, k, v, **kw)
        rows["kernel_vs_plain"].append(_ulp_stats(out, plain))
        half = flash_attention_torch(q, k, v, **{**kw,
                                                 "group": kw["group"] // 2})
        rows["plain_half_blocks"].append(_ulp_stats(half, plain))
    return {key: {"share": sum(r["share"] for r in rs) / max(len(rs), 1),
                  "max_ulps": max((r["max_ulps"] for r in rs), default=0),
                  "max_rel": max((r["max_rel"] for r in rs), default=0.0),
                  "calls": len(rs)}
            for key, rs in rows.items()}


class _NudgedPlainAttention:
    """While entered, the plain flash formulation (``layers._flash_plain``)
    returns its output with one ulp of its dtype added or taken away in a
    ``share`` of the elements: those whose index and bits hash (with
    ``salt``) below the share, so a rematerialised forward moves the same
    elements. The gradient is the plain formulation's own. ``moved`` and
    ``seen`` count the elements over the calls."""

    def __init__(self, share: float, salt: int):
        self.share, self.salt = share, salt
        self.moved = self.seen = 0

    def __enter__(self):
        import torch
        from repro_torch.models import layers
        self._real = real = layers._flash_plain
        self._counts = []

        def nudged(*args, **kw):
            out = real(*args, **kw)
            with torch.no_grad():
                bits = _ordered(out)
                idx = torch.arange(bits.numel(), device=bits.device
                                   ).reshape(bits.shape)
                h = (idx * 0x9E3779B1 + (bits & 0xFFFF) * 0x7FEB352D
                     + self.salt * 0x68E31DA4) & 0xFFFFFFFF
                for _ in range(3):   # a 32-bit integer mix
                    h = ((h >> 16) ^ h) * 0x45D9F3B & 0xFFFFFFFF
                pick = (h >> 8).to(torch.float64) < self.share * 2.0 ** 24
                step = torch.where((h & 1).bool() & (bits != 0), -1, 1)
                moved = bits + torch.where(pick, step, 0)
                itype, mag = {torch.bfloat16: (torch.int16, 0x7FFF),
                              torch.float32: (torch.int32, 0x7FFFFFFF)}[
                                  out.dtype]
                raw = torch.where(moved < 0, (-moved) | (mag + 1), moved)
                raw = torch.where(raw > mag, raw - 2 * (mag + 1), raw)
                delta = raw.to(itype).view(out.dtype) - out
                self._counts.append((pick.sum(), pick.numel()))
            return out + delta
        layers._flash_plain = nudged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers._flash_plain = self._real
        self.moved = sum(int(n) for n, _ in self._counts)
        self.seen = sum(t for _, t in self._counts)


def _differing(a, b) -> list[str]:
    """The paths of the leaves of two trees of one structure that are not
    equal bit for bit."""
    import torch
    from repro_torch import tree as tr
    return [name for name, x, y in zip(tr.paths(a), tr.leaves(a),
                                       tr.leaves(b))
            if not torch.equal(x, y)]


def _train_cell(cfg, dev, root: Path, run: dict, kill: int, steps: int,
                timed: int) -> dict:
    """The train phase on ``dev`` (the card; a reduced config on the CPU
    rehearses it): a kill-and-resume through ``launch.train.train`` with
    the launch counters set to 0 just before and read just after; the
    restored weights against the saved ones; the resumed step repeated
    from the restored state; the kernels' step against the plain
    versions'; a full state saved asynchronously, restored, and a step
    from it against the step from the state in memory; ms a step with the
    kernels and with exact projections, a profiled step, the peak memory;
    one step with compressed gradients."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as tt
    from repro_torch.models import bind
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as opt_init
    t_start = time.perf_counter()

    def at() -> str:
        return f"{time.perf_counter() - t_start:.1f}s"

    shutil.rmtree(root, ignore_errors=True)
    ckpt_dir = root / "run"
    args = dict(batch=run["batch"], seq=run["seq"], lr=run["lr"],
                seed=run["seed"], device=dev, log_every=1)

    # -- the main path: train, killed after `kill` steps, then resumed
    counters = _serve_launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out1 = tt.train(cfg, steps=kill, ckpt_dir=str(ckpt_dir), **args)
    after1 = Checkpointer(ckpt_dir).all_steps()
    out2 = tt.train(cfg, steps=steps, ckpt_dir=str(ckpt_dir), **args)
    after2 = Checkpointer(ckpt_dir).all_steps()
    _sync(dev)
    train_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    losses = out1["losses"] + out2["losses"]
    log(f"[train] {at()} {cfg.name}: train(steps={kill}) then "
        f"train(steps={steps}) on one directory in {train_s:.1f}s; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; committed after each call {after1} {after2}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise AssertionError(f"[train] losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    if after1 != [kill] or after2 != [kill, steps]:
        raise AssertionError(f"[train] committed steps {after1}, {after2}: "
                             f"the reference commits only each call's end")
    # a step's launches: one SC-GEMM a projection and one flash call an
    # attention site in each forward; under remat every layer group runs
    # its forward twice, the LM head once a loss chunk
    fwd = 2 if cfg.remat else 1
    chunks = -(-run["seq"] // min(cfg.loss_chunk, run["seq"]))
    want = {"sc_linear": steps * (fwd * 7 * cfg.n_layers + chunks),
            "flash_attention": steps * fwd * cfg.n_layers}
    want = {name: (want.get(name, 0) if dev.type == "cuda" else 0)
            for name in launches}
    log(f"[train] launches in the {steps} steps: {launches} "
        f"(want {want})")
    if launches != want:
        raise AssertionError(f"[train] launches {launches}, want {want}")
    del out2

    # -- the saved weights restored, and the resumed step repeated
    m = bind(cfg, dev)
    optc = AdamWConfig(quantize_moments=cfg.n_experts >= 64)
    like = m.init_params(run["seed"])
    state = Checkpointer(ckpt_dir).restore(
        kill, {"params": like, "opt": opt_init(like, optc)})
    del like
    off = _differing(state["params"], out1["params"])
    if off or int(state["opt"]["step"]) != kill:
        raise AssertionError(f"[train] restored leaves differ from the "
                             f"saved ones: {off[:4]}")
    del out1
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq"],
        global_batch=run["batch"], n_codebooks=cfg.n_codebooks,
        seed=run["seed"]))

    def batch_at(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in pipe.get_batch(step).items()}

    def step_of(model, s, i):
        return tt.train_step(model, s["params"], s["opt"], batch_at(i),
                             lr_peak=run["lr"], steps=steps, optc=optc)

    with _FlashRecorder(cfg.n_layers) as rec_sc:
        p1, o1, loss_k, grads_k = step_of(m, state, kill)
    if float(loss_k) != losses[kill]:
        raise AssertionError(f"[train] a step from the restored state gives "
                             f"loss {float(loss_k)!r}, the resumed train "
                             f"gave {losses[kill]!r}")
    # the state after it, saved on the writer thread meanwhile
    s5 = {"params": p1, "opt": o1}
    ck = Checkpointer(root / "state")
    ck.save(kill + 1, s5)

    # -- the kernels' step against the plain versions': SC-GEMM alone
    # (attention plain on both sides) bit for bit; the flash kernel alone
    # (exact projections) and all kernels together (SC-GEMM at 8 bits) no
    # further than their floors: the plain step against itself with the
    # kernel's share of its attention outputs moved one ulp
    # (TRAIN_FLOOR_SALTS)
    def grads_of(nudge=None, **kw):
        model = bind(dataclasses.replace(cfg, **kw), dev)
        if nudge is None:
            loss, grads = tt.value_and_grad(model, state["params"],
                                            batch_at(kill))
            return float(loss), grads
        with _NudgedPlainAttention(*nudge) as moved:
            loss, grads = tt.value_and_grad(model, state["params"],
                                            batch_at(kill))
        nudges.append((moved.moved, moved.seen))
        return float(loss), grads

    nudges = []

    sc_kernel = grads_of(attn_kernel="jnp")
    plain = grads_of(sc_impl="mxu_split", attn_kernel="jnp")
    sc_off = _differing(sc_kernel[1], plain[1])
    sc_equal = sc_kernel[0] == plain[0] and not sc_off
    log(f"[train] {at()} SC-GEMM kernel's step (attention plain) = "
        f"mxu_split's bit for bit: {sc_equal} ({len(sc_off)} leaves "
        f"differ)")
    if not sc_equal:
        raise AssertionError(f"[train] the SC-GEMM kernel's step differs "
                             f"from its plain version's: {sc_off[:4]}")
    all_vs = _step_errors((float(loss_k), grads_k), plain)
    del grads_k, plain
    ops_sc = _flash_op_stats(rec_sc.calls)
    del rec_sc
    # SC-GEMM through the kernel, which gives mxu_split's bits (above)
    floors_sc = [_step_errors(grads_of((ops_sc["kernel_vs_plain"]["share"],
                                        salt), attn_kernel="jnp"),
                              sc_kernel)
                 for salt in TRAIN_FLOOR_SALTS]
    del sc_kernel
    with _FlashRecorder(cfg.n_layers) as rec_x:
        flash_k = grads_of(use_sc_gemm=False)
    exact_plain = grads_of(use_sc_gemm=False, attn_kernel="jnp")
    flash = _step_errors(flash_k, exact_plain)
    del flash_k
    ops_x = _flash_op_stats(rec_x.calls)
    del rec_x
    floors_x = [_step_errors(grads_of((ops_x["kernel_vs_plain"]["share"],
                                       salt), use_sc_gemm=False,
                                      attn_kernel="jnp"), exact_plain)
                for salt in TRAIN_FLOOR_SALTS]
    del exact_plain
    for tag, ops in (("SC-GEMM 8 bits", ops_sc), ("exact", ops_x)):
        kv, ro = ops["kernel_vs_plain"], ops["plain_half_blocks"]
        log(f"[train] flash outputs ({tag}, the first forward's "
            f"{kv['calls']} calls, {cfg.dtype}): the kernel's differ from "
            f"plain attention's in {100 * kv['share']:.4f}% of elements (at "
            f"most {kv['max_ulps']} ulps, {kv['max_rel']:.2e} of a call's "
            f"largest); plain attention over key blocks of half the "
            f"kernel's group against its whole group in "
            f"{100 * ro['share']:.4f}% ({ro['max_ulps']} ulps, "
            f"{ro['max_rel']:.2e})")
    log(f"[train] the floors moved "
        + ", ".join(f"{n} of {t} outputs" for n, t in nudges)
        + " (each floor's every attention call, remat's recompute too)")
    log(f"[train] {at()} all kernels vs plain versions (SC-GEMM 8 bits): "
        f"{_fmt_errors(all_vs)}; floors (each metric held to the "
        f"largest), the plain step with that share of its attention "
        f"outputs an ulp off: "
        + "; ".join(_fmt_errors(f) for f in floors_sc))
    log(f"[train] {at()} flash alone vs plain attention (exact "
        f"projections): {_fmt_errors(flash)}; floors: "
        + "; ".join(_fmt_errors(f) for f in floors_x))
    held = (("SC-GEMM 8 bits", ops_sc, all_vs, floors_sc),
            ("exact", ops_x, flash, floors_x))
    moved = iter(nudges)
    for what, ops, got, floors in held:
        share = ops["kernel_vs_plain"]["share"]
        for n, t in (next(moved) for _ in floors):
            if not 0.8 * share <= n / t <= 1.25 * share:
                raise AssertionError(f"[train] a floor ({what}) moved {n} "
                                     f"of {t} outputs, not the kernel's "
                                     f"share {share}")
        over = {k: (got[k], max(f[k] for f in floors)) for k in TRAIN_HELD
                if got[k] > max(f[k] for f in floors)}
        if over:
            raise AssertionError(f"[train] the kernels' step ({what}) parts "
                                 f"from the plain versions' further than the "
                                 f"plain step's own one-ulp roundings: "
                                 f"{over}")

    # -- the full state back from disk, and a step from it
    ck.wait()
    back = ck.restore(kill + 1, s5)
    off = _differing(back, s5)
    mem = step_of(m, s5, kill + 1)
    res = step_of(m, back, kill + 1)
    step_off = _differing((mem[0], mem[1]), (res[0], res[1]))
    log(f"[train] {at()} full state restored bit for bit: {not off}; a step "
        f"from it = the step from memory bit for bit: "
        f"{not step_off and float(mem[2]) == float(res[2])}")
    if off or step_off or float(mem[2]) != float(res[2]):
        raise AssertionError(f"[train] restored {off[:4]}, stepped "
                             f"{step_off[:4]}")
    del back, res, state

    # -- time a step with the kernels and with exact projections
    s = {"params": mem[0], "opt": mem[1]}
    del mem, s5, p1, o1
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ms = {}
    for tag, vcfg in (("sc_gemm", cfg),
                      ("exact", dataclasses.replace(cfg, use_sc_gemm=False))):
        vm = bind(vcfg, dev)
        p, o, _, _ = step_of(vm, s, kill + 2)
        _sync(dev)
        marks = []
        t0 = time.perf_counter()
        for i in range(timed):
            if dev.type == "cuda":
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            p, o, loss, _ = tt.train_step(
                vm, p, o, batch_at(kill + 3 + i), lr_peak=run["lr"],
                steps=steps, optc=optc)
        if dev.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        _sync(dev)
        ms[tag] = (time.perf_counter() - t0) / timed * 1e3
        ms[tag + "_events"] = [a.elapsed_time(b)
                               for a, b in zip(marks, marks[1:])]
        del p, o
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else None)
    trace = _train_trace(m, s, batch_at(kill + 2), run, steps, optc, dev,
                         ms["sc_gemm"])
    log(f"[train] {at()} ms a step (batch {run['batch']} x seq "
        f"{run['seq']}, {timed} steps, host clock; CUDA events a step): "
        f"SC-GEMM kernels {ms['sc_gemm']:.1f} ("
        + " ".join(f"{x:.1f}" for x in ms["sc_gemm_events"])
        + f"), exact projections {ms['exact']:.1f} ("
        + " ".join(f"{x:.1f}" for x in ms["exact_events"]) + "); peak "
        + ("not measured" if peak is None else f"{peak:.2f} GiB"))
    if trace is not None:
        log(f"[train] a profiled kernel step: {trace['device_ms']:.1f} ms of "
            f"kernels ({trace['kernel_launches']} launches, busy "
            f"{100 * trace['busy_share']:.1f}% of the unprofiled wall), "
            f"SC-GEMM {trace['sc_gemm_ms']:.1f} ms "
            f"({100 * trace['sc_gemm_share']:.1f}%), flash "
            f"{trace['flash_ms']:.2f} ms ({100 * trace['flash_share']:.2f}%)")
        for row in trace["top_kernels"]:
            log(f"[train]   device {row['ms']:8.3f} ms {row['calls']:5d} "
                f"calls  {row['name']}")
    del s

    # -- one step with compressed gradients (EF-int8)
    out_c = tt.train(cfg, steps=1, ckpt_dir=None, compress_grads=True,
                     **args)
    if not math.isfinite(out_c["losses"][0]):
        raise AssertionError(f"[train] compressed step: {out_c['losses']}")
    del out_c
    shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_start
    log(f"[train] phase {seconds:.1f}s")
    return {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                       "dtype": cfg.dtype, "sc_bits": cfg.sc_bits,
                       "remat": cfg.remat, **run, "steps": steps,
                       "killed_at": kill},
            "losses": losses, "committed": [after1, after2],
            "train_s": train_s, "launches": launches,
            "sc_kernel_step_equals_plain": sc_equal,
            "kernels_vs_plain": all_vs, "kernels_floors": floors_sc,
            "flash_vs_plain_exact": flash, "flash_floors": floors_x,
            "flash_outputs": {"sc_gemm": ops_sc, "exact": ops_x},
            "floor_nudges": nudges,
            "ms_per_step": ms,
            "peak_gib": peak, "trace": trace, "seconds": seconds}


def _step_errors(got, want) -> dict:
    """A step's (loss, gradients) against another's: the loss's relative
    error; each leaf's max |got - want| over the leaf's max |want| and its
    relative L2 distance (the largest of each, and where); the whole
    tree's relative L2 distance."""
    from repro_torch import tree as tr
    per, per_l2, num, den = {}, {}, 0.0, 0.0
    for name, g, w in zip(tr.paths(want[1]), tr.leaves(got[1]),
                          tr.leaves(want[1])):
        g, w = g.float(), w.float()
        per[name] = (g - w).abs().max().item() / max(
            w.abs().max().item(), 1e-30)
        d2, w2 = (g - w).square().sum().item(), w.square().sum().item()
        per_l2[name] = math.sqrt(d2 / max(w2, 1e-30))
        num += d2
        den += w2
    worst = max(per, key=per.get)
    worst_l2 = max(per_l2, key=per_l2.get)
    return {"loss": got[0], "loss_rel": abs(got[0] - want[0]) / abs(want[0]),
            "max_rel": per[worst], "worst_leaf": worst,
            "leaf_l2_rel": per_l2[worst_l2], "worst_l2_leaf": worst_l2,
            "norm_rel": math.sqrt(num / max(den, 1e-30))}


def _fmt_errors(e: dict) -> str:
    return (f"loss rel {e['loss_rel']:.3e}, gradients' L2 rel "
            f"{e['norm_rel']:.3e}, leaf max rel {e['max_rel']:.3e} at "
            f"{e['worst_leaf']}, leaf L2 rel {e['leaf_l2_rel']:.3e} at "
            f"{e['worst_l2_leaf']}")


def _train_trace(m, s, batch, run, steps, optc, dev, wall_ms):
    """One kernel step under ``torch.profiler``, the card's activity only
    (a step launches ~35,000 kernels; the host's side would take longer
    to trace than the step): its kernels' device time, the SC-GEMM and
    flash kernels' shares of it, the busy share against ``wall_ms`` and
    the top kernels; None off the card or when the trace holds no device
    time."""
    if dev.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as tt
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tt.train_step(m, s["params"], s["opt"], batch, lr_peak=run["lr"],
                      steps=steps, optc=optc)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    total = sum(_dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        return None
    ours = {key: sum(_dev_us(e) for e in kernels if key in e.key) / 1e3
            for key in ("sc_gemm_kernel", "flash_fwd_")}
    top = sorted(((_dev_us(e) / 1e3, e.count, e.key[:90]) for e in kernels),
                 reverse=True)[:8]
    return {"device_ms": total, "busy_share": total / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "sc_gemm_ms": ours["sc_gemm_kernel"],
            "sc_gemm_share": ours["sc_gemm_kernel"] / total,
            "flash_ms": ours["flash_fwd_"],
            "flash_share": ours["flash_fwd_"] / total,
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in top]}


def phase_train() -> dict:
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], use_sc_gemm=True).validate()
    return _train_cell(cfg, torch.device("cuda"), OUT_DIR / "train_ckpt",
                       TRAIN_RUN, TRAIN_KILL, TRAIN_STEPS, TRAIN_TIMED)


#: The dist phase: the ``train`` phase's model (smollm-360m at full width,
#: bf16, SC-GEMM at 8 bits, weights of seed 0) on one NCCL rank, its
#: ``(1, 1)`` ``("data", "model")`` mesh and a ``("stage",)`` mesh of one.
#: The pipeline runs the embedded batch of ``DIST_BATCH x DIST_SEQ`` tokens
#: in ``DIST_MICRO`` microbatches through one stage of all the layers, at
#: the kernel's default plans (``sc_impl="pallas"``: no sweep in the phase).
DIST_BATCH, DIST_SEQ, DIST_MICRO = 8, 128, 4
#: ``sc_attention_divergence`` on the card against the CPU, relative: the
#: oracles' float32 sums run in other orders there, and one probability
#: magnitude moved a step moves a MAD near 0.09 by ~1e-4 of itself.
DIST_DIVERGENCE_REL = 1e-3
#: the paged SC kernel's serve layout for the decode oracle: slots, KV
#: heads, group, head dim, page, pages a slot; the slots' positions and
#: the sliding window; the softcap (gemma2-9b's) the gathered path takes
DIST_PAGED = dict(c=4, kv=5, g=3, d=64, block=64, mb=4)
DIST_PAGED_POS, DIST_PAGED_WINDOW, DIST_SOFTCAP = (40, 100, 180, 255), 96, 50.0


def _spec_bytes(specs, params, mesh) -> int:
    """The bytes of ``params`` one rank of ``mesh`` holds under ``specs``
    (host arithmetic over shapes)."""
    from repro_torch import tree as tr
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.parallel.sharding import is_spec
    sizes = mesh_axes(mesh)
    total = 0
    for spec, t in zip(tr.leaves(specs, is_leaf=is_spec), tr.leaves(params)):
        div = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                div *= 1 if a is None else sizes[a]
        total += t.numel() * t.element_size() // div
    return total


def _dist_oracles(cfg, dev) -> dict:
    """The flash kernel against ``flash_attention_ref`` (float32 within
    2e-3, ``tests/test_kernels.py:177``; bf16 within 3e-2, ``:192``) and
    ``sc_flash_attention_ref`` (within ``8 / (2**bits - 1)``,
    ``tests/test_sc_attention.py:130``) at smollm-360m's prefill layout,
    the quantization group the whole 128-key row, as the model's
    ``kv_block`` makes it; the paged kernel's SC path against
    ``sc_decode_attention_ref`` at the serve layout, shuffled pages, with
    and without a window, and the gathered path (which serves softcap
    layers on the card) with a window and a softcap, within
    ``2 / (2**bits - 1)`` (``tests/test_sc_attention.py:193``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.layers import decode_attention
    gen = torch.Generator().manual_seed(1)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    out = {}
    h, kv, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, DIST_SEQ
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        q, k, v = (rnd(sh, dtype) for sh in ((2, h, s, d), (2, kv, s, d),
                                             (2, kv, s, d)))
        got = flash_attention(q, k, v, causal=True, group=s).float()
        want = ref.flash_attention_ref(q, k, v, causal=True).float()
        err = (got - want).abs().max().item()
        ok = bool(torch.isclose(got, want, rtol=tol, atol=tol).all())
        out[f"flash_{str(dtype)[6:]}"] = {"max_abs_err": err, "tol": tol}
        if not ok:
            raise AssertionError(f"[dist] flash kernel ({dtype}) against "
                                 f"flash_attention_ref: {err} over {tol}")
    q, k, v = (rnd(sh) for sh in ((2, h, s, d), (2, kv, s, d),
                                  (2, kv, s, d)))
    for bits in (4, 8):
        got = flash_attention(q, k, v, causal=True, group=s, sc_bits=bits)
        want = ref.sc_flash_attention_ref(q, k, v, bits=bits, causal=True)
        err, tol = (got - want).abs().max().item(), 8.0 / (2 ** bits - 1)
        out[f"flash_sc{bits}"] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"[dist] SC flash kernel ({bits} bits) "
                                 f"against sc_flash_attention_ref: {err}")
    p = DIST_PAGED
    c, hp = p["c"], p["kv"] * p["g"]
    s_len = p["block"] * p["mb"]
    q = rnd((c, 1, hp, p["d"]))
    kc, vc = rnd((c, s_len, p["kv"], p["d"])), rnd((c, s_len, p["kv"],
                                                    p["d"]))
    pos = torch.tensor(DIST_PAGED_POS, dtype=torch.int32, device=dev)
    n = c * p["mb"]
    perm = torch.randperm(n, generator=gen)
    pages = [torch.cat([t.reshape(n, p["block"], p["kv"], p["d"])[
        perm.argsort().to(dev)], torch.zeros_like(t[:1, :p["block"]])])
        for t in (kc, vc)]
    tables = perm.reshape(c, p["mb"]).to(dev, torch.int32)
    for bits in (4, 8):
        tol = 2.0 / (2 ** bits - 1)
        for window in (None, DIST_PAGED_WINDOW):
            got = paged_attention(q.reshape(c, p["kv"], p["g"], p["d"]),
                                  *pages, tables, pos, window=window,
                                  sc_bits=bits).reshape(c, 1, hp, p["d"])
            want = ref.sc_decode_attention_ref(q, kc, vc, q_position=pos,
                                               bits=bits, window=window)
            err = (got - want).abs().max().item()
            out[f"paged_sc{bits}_window_{window}"] = {"max_abs_err": err,
                                                      "tol": tol}
            if not err <= tol:
                raise AssertionError(f"[dist] paged SC kernel ({bits} bits, "
                                     f"window {window}) against "
                                     f"sc_decode_attention_ref: {err}")
        got = decode_attention(q, kc, vc, q_position=pos,
                               window=DIST_PAGED_WINDOW,
                               logit_softcap=DIST_SOFTCAP, sc_bits=bits)
        want = ref.sc_decode_attention_ref(
            q, kc, vc, q_position=pos, bits=bits, window=DIST_PAGED_WINDOW,
            logit_softcap=DIST_SOFTCAP)
        err = (got - want).abs().max().item()
        out[f"gathered_sc{bits}_softcap"] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"[dist] softcap decode ({bits} bits) "
                                 f"against sc_decode_attention_ref: {err}")
    for key, r in out.items():
        log(f"[dist] oracle {key}: max abs err {r['max_abs_err']:.3e} "
            f"(tolerance {r['tol']:.3e})")
    return out


def _dist_cell(cfg, dev, report: dict) -> dict:
    """The dist phase on ``dev`` (the card over NCCL; a reduced config on
    the CPU over gloo rehearses it): the process group and meshes, the
    parameters placed by ``param_pspecs``, the pipelined forward against
    the whole batch, ``compressed_psum`` over a step's gradients, the
    kernels against the oracles, ``sc_attention_divergence`` on the card
    against the CPU, ``param_counts`` and ``model_flops`` over measured
    times."""
    import dataclasses
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    from repro_torch import tree as tr
    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import Shape
    from repro_torch.core.error_analysis import sc_attention_divergence
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as tt
    from repro_torch.launch.mesh import make_mesh, production_mesh
    from repro_torch.launch.modelmeta import model_flops, param_counts
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models import bind
    from repro_torch.models.transformer import (_embed, block_forward,
                                                full_attend)
    from repro_torch.optim.adamw import dequantize8, quantize8
    from repro_torch.optim.grad_compression import compressed_psum
    from repro_torch.parallel import named, param_pspecs
    from repro_torch.parallel.pipeline_parallel import pipeline_forward
    from repro_torch.parallel.sharding import distribute
    t_start = time.perf_counter()
    out: dict = {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        # -- the process group and the meshes
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        stages = make_mesh((1,), ("stage",), device_type=dev.type)
        out["backend"] = dist.get_backend()
        if out["backend"] != backend or mesh.device_type != dev.type:
            raise AssertionError(f"[dist] a {out['backend']} group, a "
                                 f"{mesh.device_type} mesh; want {backend} "
                                 f"on {dev.type}")
        log(f"[dist] one {out['backend']} rank; meshes {mesh} and {stages}")

        # -- the parameters placed by the rules
        params = bind(cfg, dev).init_params(0)
        _sync(dev)
        specs = param_pspecs(cfg, params, mesh)
        placed = distribute(params, named(mesh, specs))
        off = [name for name, src, d in zip(tr.paths(params),
                                             tr.leaves(params),
                                             tr.leaves(placed))
               if d.to_local().dtype != src.dtype
               or not torch.equal(d.to_local(), src)]
        n_leaves = len(tr.leaves(params))
        del placed
        log(f"[dist] {n_leaves} parameter leaves placed by param_pspecs on "
            f"the (1, 1) mesh: every local shard bit-equal to its source: "
            f"{not off}")
        if off:
            raise AssertionError(f"[dist] placed leaves differ: {off[:4]}")
        meta = abstract_params(cfg)
        whole = _spec_bytes(param_pspecs(cfg, meta, mesh), meta, mesh)
        per_rank = {}
        for name, pm in (("16x16", production_mesh()),
                         ("2x16x16", production_mesh(multi_pod=True))):
            for strategy in ("tp_sp", "dp"):
                c = dataclasses.replace(cfg, sharding_strategy=strategy)
                per_rank[f"{name}_{strategy}"] = _spec_bytes(
                    param_pspecs(c, meta, pm), meta, pm)
        out["param_bytes"] = {"one_rank": whole, **per_rank}
        log(f"[dist] parameter bytes a rank ({cfg.dtype}): one rank "
            f"{whole:,}; " + ", ".join(f"{k} {v:,}"
                                       for k, v in per_rank.items()))

        # -- the pipelined forward against the whole batch
        pcfg = dataclasses.replace(cfg, sc_impl="pallas")
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (DIST_BATCH, DIST_SEQ),
                               generator=gen).to(dev)

        def stage_fn(layers, h):
            b, s = h.shape[:2]
            pos = torch.arange(s, dtype=torch.int32,
                               device=h.device).expand(b, s)
            for i, layer in enumerate(layers):
                h = block_forward(layer, h, pcfg, full_attend(
                    pcfg, pos, pcfg.window_at(i % pcfg.group_size)))
            return h

        counters = _serve_launch_counters()
        ms = {}
        with torch.no_grad():
            x = _embed(params, pcfg, {"tokens": tokens})
            stage = tr.tree_map(lambda w: w[None], params["layers"])

            def whole_run():
                return stage_fn(params["layers"], x)

            def piped_run():
                return pipeline_forward(stage_fn, stage, x, mesh=stages,
                                        axis="stage",
                                        n_microbatches=DIST_MICRO)

            for tag, run in (("whole", whole_run), ("pipelined", piped_run)):
                run()                     # first calls: the flash tuner
                _sync(dev)
                if tag == "pipelined":
                    for c in counters.values():
                        c.launches = 0
                t0 = time.perf_counter()
                got = run()
                _sync(dev)
                ms[tag] = (time.perf_counter() - t0) * 1e3
                if tag == "pipelined":
                    launches = {k: c.launches for k, c in counters.items()}
                    piped = got
                else:
                    ref_out = got
        equal = bool(torch.equal(piped, ref_out))
        want = {"sc_linear": DIST_MICRO * 7 * cfg.n_layers,
                "flash_attention": DIST_MICRO * cfg.n_layers}
        want = {k: (want.get(k, 0) if dev.type == "cuda" else 0)
                for k in launches}
        out["pipeline"] = {"bit_equal": equal, "ms": ms,
                           "launches": launches,
                           "finite": bool(torch.isfinite(piped).all())}
        log(f"[dist] pipeline_forward, one stage of {cfg.n_layers} layers, "
            f"{DIST_BATCH} x {DIST_SEQ} tokens in {DIST_MICRO} microbatches: "
            f"bit-equal to the whole batch: {equal}; ms (host clock, "
            f"synchronized) pipelined {ms['pipelined']:.2f}, whole "
            f"{ms['whole']:.2f}; launches {launches} (want {want})")
        if not equal or not out["pipeline"]["finite"]:
            raise AssertionError("[dist] the pipelined forward differs from "
                                 "the whole batch's")
        if launches != want:
            raise AssertionError(f"[dist] pipeline launches {launches}, "
                                 f"want {want}")
        del x, stage, piped, ref_out

        # -- compressed_psum over a train step's gradients
        pipe = TokenPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=DIST_SEQ,
            global_batch=DIST_BATCH, n_codebooks=cfg.n_codebooks, seed=0))
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.get_batch(0).items()}
        _, grads = tt.value_and_grad(bind(pcfg, dev), params, batch)
        flat = tr.leaves(grads)
        del grads
        n_values = sum(g.numel() for g in flat)
        compressed_psum(flat[0])          # the communicator's first use
        _sync(dev)
        t0 = time.perf_counter()
        means = [compressed_psum(g) for g in flat]
        _sync(dev)
        psum_ms = (time.perf_counter() - t0) * 1e3
        off = [i for i, (g, m) in enumerate(zip(flat, means))
               if m.dtype != g.dtype or not torch.equal(
                   m, dequantize8(quantize8(g), g.shape, g.dtype))]
        nbytes = sum(2 * g.numel() * g.element_size() for g in flat)
        out["compressed_psum"] = {
            "values": n_values, "leaves": len(flat), "ms": psum_ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_S * 1e3,
            "bit_equal": not off, "dtype": str(flat[0].dtype)}
        log(f"[dist] compressed_psum over {len(flat)} gradient leaves "
            f"({n_values:,} values, {flat[0].dtype}): {psum_ms:.2f} ms (host "
            f"clock, synchronized) against {nbytes:,} bytes read and written "
            f"once, {out['compressed_psum']['bound_ms']:.3f} ms at the HBM "
            f"rate; bit-equal to dequantize8(quantize8(g)): {not off}")
        if off:
            raise AssertionError(f"[dist] compressed_psum differs from the "
                                 f"round trip at leaves {off[:4]}")
        del flat, means, params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # -- the kernels against the oracles; the divergence on the card
    out["oracles"] = _dist_oracles(cfg, dev)
    div = {}
    for bits in (4, 6, 8):
        here = sc_attention_divergence(bits, device=dev)
        cpu = sc_attention_divergence(bits, device="cpu")
        div[bits] = {"device": here, "cpu": cpu}
        for key in ("output_mad", "score_mad"):
            if abs(here[key] - cpu[key]) > DIST_DIVERGENCE_REL * cpu[key]:
                raise AssertionError(f"[dist] sc_attention_divergence "
                                     f"({bits} bits) {key} {here[key]} on "
                                     f"{dev.type}, {cpu[key]} on the CPU")
        log(f"[dist] sc_attention_divergence {bits} bits on {dev.type}: "
            f"output MAD {here['output_mad']:.6f} (CPU "
            f"{cpu['output_mad']:.6f}), score MAD {here['score_mad']:.6f} "
            f"(CPU {cpu['score_mad']:.6f})")
    mads = {b: div[b]["device"]["output_mad"] for b in div}
    if not mads[4] > max(mads[6], mads[8]):
        raise AssertionError(f"[dist] the divergence does not fall from 4 "
                             f"bits: {mads}")
    out["divergence"] = div

    # -- useful work: param_counts of every arch, model_flops over the
    # measured train and graphed decode steps
    counts = {arch: param_counts(c) for arch, c in ARCHS.items()}
    for arch, c in counts.items():
        log(f"[dist] param_counts {arch}: total {c['total']:,}, active "
            f"{c['active']:,.0f}, embedding {c['embedding']:,}")
    train_ms = report.get("train", {}).get("ms_per_step", {}).get("sc_gemm")
    decode_ms = report.get("serve", {}).get("stats", {}).get(
        "decode_ms_per_step")
    work = {}
    for tag, shape, step_ms in (
            ("train_step", Shape("train", DIST_SEQ, DIST_BATCH, "train"),
             train_ms),
            ("decode_step", Shape("decode", 256, 4, "decode"), decode_ms)):
        flops = model_flops(cfg, shape)
        share = (None if step_ms is None
                 else flops / (step_ms / 1e3) / BF16_OPS_S)
        work[tag] = {"model_flops": flops, "ms": step_ms,
                     "peak_flop_s": BF16_OPS_S, "peak": "bf16 dense",
                     "share_of_peak": share}
        log(f"[dist] model_flops of the {tag} ({shape.global_batch} x "
            f"{shape.seq_len if shape.kind == 'train' else 1} tokens): "
            f"{flops:.4e} over "
            + ("not measured" if step_ms is None else f"{step_ms:.2f} ms")
            + " = " + ("not measured" if share is None else
                       f"{share * 100:.4f}% of the bf16 dense peak "
                       f"({BF16_OPS_S:.3e} FLOP/s)"))
    out["useful_work"] = work
    out["param_counts"] = counts
    out["seconds"] = time.perf_counter() - t_start
    log(f"[dist] phase {out['seconds']:.1f}s")
    return out


def phase_dist(report: dict) -> dict:
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], use_sc_gemm=True).validate()
    return _dist_cell(cfg, torch.device("cuda"), report)


#: the dryrun phase: the train step's batch (smollm-360m at full width,
#: SC-GEMM at 8 bits), the paged decode pool (slots, pages a slot, page
#: size) with its slots' positions, the timed decode steps (the train
#: step is timed once, in its bit-equality run), and the production cell
#: dry-run in a subprocess with its deadline
DRYRUN_TRAIN = dict(batch=2, seq=128, steps=20)
DRYRUN_POOL = dict(capacity=4, per_slot=4, block=64)
DRYRUN_POS = (40, 100, 180, 255)
DRYRUN_ITERS = 3
DRYRUN_CELL = ("smollm-360m", "decode_32k", 150)


def _op_metas(dev) -> list:
    """Each kernel operator's fake output against its real output (shape,
    dtype, strides) at smollm-360m's shapes and qwen3-moe's batched
    expert shape."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    # the wrappers' modules register the operators
    import repro_torch.kernels.flash_attention  # noqa: F401
    import repro_torch.kernels.paged_attention  # noqa: F401
    from repro_torch.kernels.sc_matmul import pack_weight
    gen = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    ops = torch.ops.repro_torch
    pw = pack_weight(rand(960, 2560), 8)
    # the batched expert launch: 128 experts, 64 capacity rows, K 4096,
    # N 1536 (qwen3-moe-235b-a22b's w1/w3)
    pe = pack_weight(rand(128, 4096, 1536), 8)
    pool = rand(17, 64, 5, 64)
    tables = torch.arange(16, dtype=torch.int32, device=dev).reshape(4, 4)
    pos = torch.tensor(DRYRUN_POS, dtype=torch.int32, device=dev)
    q_rows = rand(1, 64, 15, 64).transpose(1, 2)
    kv_rows = rand(1, 64, 5, 64).transpose(1, 2)
    calls = {
        "sc_linear": (ops.sc_linear, (rand(4, 960), pw.plane, pw.scale, 8,
                                      0, 0, 0)),
        "sc_linear_batched": (ops.sc_linear, (rand(128, 64, 4096), pe.plane,
                                              pe.scale, 8, 0, 0, 0)),
        "paged_attention": (ops.paged_attention,
                            (rand(4, 5, 3, 64), pool, pool.clone(), tables,
                             pos, 0, 0, 0.0)),
        "paged_attention_sc": (ops.paged_attention,
                               (rand(4, 5, 3, 64), pool, pool.clone(),
                                tables, pos, 0, 8, 0.0)),
        "flash_attention": (ops.flash_attention,
                            (q_rows, kv_rows, kv_rows, None, 0, True, 64, 0,
                             0, 0)),
        "flash_attention_sc": (ops.flash_attention,
                               (q_rows, kv_rows, kv_rows, None, 0, True, 64,
                                8, 0, 0)),
    }
    rows = []
    for name, (op, args) in calls.items():
        real = op(*args)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                        else a for a in args))
        row = {"op": name, "shape": list(real.shape),
               "dtype": str(real.dtype), "stride": list(real.stride()),
               "fake": [list(fake.shape), str(fake.dtype),
                        list(fake.stride())]}
        if row["fake"] != [row["shape"], row["dtype"], row["stride"]]:
            raise AssertionError(f"[dryrun] fake meta of {name} differs: "
                                 f"{row}")
        rows.append(row)
        log(f"[dryrun] fake meta = real: {name} {tuple(real.shape)} "
            f"{real.dtype} stride {tuple(real.stride())}")
    del pw, pe, pool
    return rows


def _placed_bytes(tree) -> int:
    from repro_torch import tree as tr
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in tr.leaves(tree))


def _predicted(step, placed_args, dev) -> dict:
    """The dry run's prediction of ``step`` on the same mesh: each placed
    argument's shape and placements over a fake shard, counted (rank 0's
    program), and the roofline of the counts."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import tree as tr
    from repro_torch.launch.cost_analysis import (count_step, fake_mode,
                                                  roofline_terms)

    def fake_like(t):
        local = t.to_local()
        return DTensor.from_local(
            torch.empty(local.shape, dtype=local.dtype, device=dev.type),
            t.device_mesh, t.placements, shape=t.shape, stride=t.stride())

    mode = fake_mode()
    with mode:
        args = [tr.tree_map(fake_like, a) for a in placed_args]
    _, counted = count_step(step, *args, mode=mode)
    rl = roofline_terms(counted.stats, n_chips=1, model_flops=0.0,
                        mesh_shape=(1, 1))
    return {"memory": counted.memory(), "roofline": rl.to_dict(),
            "collectives_by_kind": dict(counted.stats.by_kind),
            "ops": counted.ops}


def _paged_pool(m, cfg, dev, gen):
    """A paged pool of ``DRYRUN_POOL`` with every K/V page random and the
    slots at ``DRYRUN_POS``, and its full block tables."""
    import torch
    from repro_torch.models import cache_ops
    c, per, block = (DRYRUN_POOL[k] for k in ("capacity", "per_slot",
                                               "block"))
    pool = cache_ops.paged_init(m.init_cache, c, c * per, block)
    for leaf in cache_ops.seq_leaves(pool):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev)
                   .to(leaf.dtype))
    pool.pos.copy_(torch.tensor(DRYRUN_POS, dtype=pool.pos.dtype,
                                device=dev))
    tables = torch.arange(c * per, dtype=torch.int32,
                          device=dev).reshape(c, per)
    return pool, tables


def _dryrun_cell(cfg, dev) -> dict:
    """(b) and (c) of the dryrun phase on one rank (module docstring)."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch import tree as tr
    from repro_torch.launch import mesh_steps as ms
    from repro_torch.launch import steps as eager
    from repro_torch.launch import train as tt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import bind, pack_sc_weights
    from repro_torch.optim import init as opt_init
    from repro_torch.parallel.sharding import distribute
    out: dict = {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        m = bind(cfg, dev)
        params = m.init_params(0)
        gen = torch.Generator(device=dev).manual_seed(5)
        run = DRYRUN_TRAIN
        toks = torch.randint(0, cfg.vocab_size, (run["batch"], run["seq"]),
                             generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}
        counters = _serve_launch_counters()

        # -- (b) train: the mesh-bound step against launch.train's
        step, sh, _, optc = ms.build_train_step(
            cfg, mesh, warmup=max(run["steps"] // 20, 1),
            total_steps=run["steps"])
        opt = opt_init(params, optc)
        want_p, _, want_loss, _ = tt.train_step(
            m, params, opt, batch, lr_peak=3e-4, steps=run["steps"],
            optc=optc)
        args = (distribute(params, sh["params"]), distribute(opt, sh["opt"]),
                distribute(batch, sh["batch_fn"](batch)))
        for c in counters.values():
            c.launches = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        got_p, _, metrics = step(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # the one run, host clock to a synchronize (a second would cost the
        # phase its time: the step is DTensor's host work)
        ms_train = ((time.perf_counter() - t_run) * 1e3
                    if dev.type == "cuda" else None)
        peak = (torch.cuda.max_memory_allocated() - base
                if dev.type == "cuda" else None)
        launches = {n: c.launches for n, c in counters.items()}
        same = all(torch.equal(a.full_tensor(), b) for a, b in
                   zip(tr.leaves(got_p), tr.leaves(want_p)))
        loss_same = torch.equal(metrics["loss"].full_tensor(), want_loss)
        if not (same and loss_same):
            raise AssertionError("[dryrun] the mesh-bound train step is not "
                                 "bit-equal to launch.train.train_step")
        t_pred = time.perf_counter()
        pred = _predicted(step, args, dev)
        log(f"[dryrun] train: the step {ms_train} ms, its count "
            f"{time.perf_counter() - t_pred:.1f}s")
        out["train"] = {"bit_equal": True, "launches": launches,
                        "argument_bytes": _placed_bytes(args),
                        "peak_bytes": peak, "ms": ms_train, "prediction": pred}
        del got_p, want_p, metrics, opt, args

        # -- (b) paged decode: the mesh-bound step against the eager one
        pool, tables = _paged_pool(m, cfg, dev, gen)
        step_toks = {"tokens": torch.randint(
            0, cfg.vocab_size, (DRYRUN_POOL["capacity"], 1), generator=gen,
            device=dev, dtype=torch.int32)}
        packed = pack_sc_weights(params, cfg)
        want_logits, want_pool = eager.paged_decode_step(
            m, packed, tr.tree_map(lambda t: t.clone(), pool), tables,
            step_toks)
        del packed
        step, sh, _ = ms.build_paged_decode_step(
            cfg, mesh, capacity=DRYRUN_POOL["capacity"],
            block=DRYRUN_POOL["block"],
            n_blocks=DRYRUN_POOL["capacity"] * DRYRUN_POOL["per_slot"],
            max_blocks=DRYRUN_POOL["per_slot"])
        args = (distribute(params, sh["params"]),
                distribute(tr.tree_map(lambda t: t.clone(), pool),
                           sh["cache"]),
                distribute(tables, sh["tables"]),
                distribute(step_toks, sh["batch_fn"](step_toks)))
        for c in counters.values():
            c.launches = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        logits, got_pool = step(*args)
        peak = (torch.cuda.max_memory_allocated() - base
                if dev.type == "cuda" else None)
        dec_launches = {n: c.launches for n, c in counters.items()}
        same = torch.equal(logits.full_tensor(), want_logits) and all(
            torch.equal(a.full_tensor(), b) for a, b in
            zip(tr.leaves(got_pool), tr.leaves(want_pool)))
        if not same:
            raise AssertionError("[dryrun] the mesh-bound paged decode step "
                                 "is not bit-equal to the eager step")
        pos0 = args[1].pos.clone()

        def again():
            args[1].pos.copy_(pos0)
            step(*args)
        ms_decode = (cuda_ms(again, DRYRUN_ITERS, warmup=0)
                     if dev.type == "cuda" else None)
        args[1].pos.copy_(pos0)
        pred = _predicted(step, args, dev)
        out["paged_decode"] = {"bit_equal": True, "launches": dec_launches,
                               "argument_bytes": _placed_bytes(args),
                               "peak_bytes": peak, "ms": ms_decode,
                               "prediction": pred}
        out["launches"] = {n: launches[n] + dec_launches[n]
                           for n in launches}
    finally:
        dist.destroy_process_group()
    for tag in ("train", "paged_decode"):
        r = out[tag]
        p = r["prediction"]
        if p["memory"]["argument_size_in_bytes"] != r["argument_bytes"]:
            raise AssertionError(f"[dryrun] {tag}: predicted argument bytes "
                                 f"{p['memory']['argument_size_in_bytes']} "
                                 f"!= placed {r['argument_bytes']}")
        pred_peak = (p["memory"]["temp_size_in_bytes"]
                     + p["memory"]["output_size_in_bytes"])
        step_s = p["roofline"]["compute_s"], p["roofline"]["memory_s"]
        log(f"[dryrun] {tag}: bit-equal; launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }; argument "
            f"bytes {r['argument_bytes']} = predicted; peak above the "
            f"arguments {r['peak_bytes']} B measured, {pred_peak} B "
            f"predicted (temp + output); measured {_ms(r['ms'])}, roofline "
            f"{max(step_s) * 1e3:.4f} ms (compute {step_s[0] * 1e3:.4f}, "
            f"memory {step_s[1] * 1e3:.4f}); {p['ops']} ops counted")
    return out


def _dryrun_production_cell():
    """(d): one production cell through the CLI in a subprocess, started
    at once and run beside (a)-(c) (each is host work on its own core);
    the returned function waits for it to a deadline and returns its
    record."""
    arch, shape, deadline = DRYRUN_CELL
    out_dir = ROOT / "chiprun_out" / "dryrun_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # its output to a file: a pipe nobody reads could fill and stall it
    log_path = out_dir / f"{arch}__{shape}__single.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out",
             str(out_dir)], env=env, cwd=str(ROOT), stdout=sink,
            stderr=subprocess.STDOUT)

    def finish() -> dict:
        try:
            proc.wait(timeout=max(1.0, deadline - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"[dryrun] the {arch} {shape} cell ran past "
                                 f"its {deadline} s deadline")
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[dryrun] the {arch} {shape} cell failed:"
                                 f"\n{log_path.read_text()[-3000:]}")
        rec = json.loads((out_dir / f"{arch}__{shape}__single.json")
                         .read_text())
        if rec["status"] != "ok" or rec["n_chips"] != 256:
            raise AssertionError(f"[dryrun] {arch} {shape}: {rec}")
        r = rec["roofline"]
        log(f"[dryrun] {arch} {shape} on the 16x16 mesh (fake, rank 0, "
            f"{rec['device']}): {seconds:.1f}s from its start, trace "
            f"{rec['trace_s']}s, dominant {r['dominant']}, compute "
            f"{r['compute_s']:.4e}s memory {r['memory_s']:.4e}s collective "
            f"{r['collective_s']:.4e}s, memory {rec['memory']}")
        return {"record": rec, "seconds": seconds}

    return finish


def phase_dryrun() -> dict:
    """(a) each kernel operator's fake output meta against its real
    output; (b) on one NCCL rank (a 1x1 mesh) smollm-360m at full width
    under SC-GEMM at 8 bits: the mesh-bound train and paged decode steps
    through the kernel operators, bit-equal to ``launch.train.train_step``
    and the eager paged decode step, launches counted; (c) the dry run's
    prediction of the same two steps on that mesh against the card; (d)
    one production cell dry-run in a subprocess."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import ARCHS
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    production_cell = _dryrun_production_cell()
    out = {"metas": _op_metas(dev)}
    torch.cuda.empty_cache()
    t_cell = time.perf_counter()
    log(f"[dryrun] metas {t_cell - t0:.1f}s")
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], use_sc_gemm=True,
                              sc_bits=8).validate()
    out.update(_dryrun_cell(cfg, dev))
    log(f"[dryrun] one-rank steps {time.perf_counter() - t_cell:.1f}s")
    out["production_cell"] = production_cell()
    out["seconds"] = time.perf_counter() - t0
    log(f"[dryrun] phase {out['seconds']:.1f}s")
    return out


#: the serve_mesh phase's engine and its requests' new tokens (two
#: 64-token prompts, then the first again)
MESH_ENGINE = dict(capacity=2, max_seq=256, block=64, chunk=16)
MESH_GENS = (12, 16, 8)


def phase_serve_mesh() -> dict:
    """The engine on a mesh at smollm-360m's full width on one NCCL rank,
    chunked and one-shot, against the graphed plain engine (module
    docstring, 21)."""
    import dataclasses
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import bind
    from repro_torch.serving import Engine, Request, default_serving_mesh
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], use_sc_gemm=True,
                              sc_bits=8).validate()
    params = bind(cfg, dev).init_params(0)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=(64,), dtype=np.int32)
               for _ in range(2)]
    prompts.append(prompts[0])

    def requests(tag):
        return [Request(uid=f"{tag}-{i}", prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(zip(prompts, MESH_GENS))]

    counters = _serve_launch_counters()
    keys = ("prefix_hits", "prefill_tokens_saved", "cow_copies",
            "preemptions")
    timed = ("decode_ms_per_step", "tok_per_s", "ttft_p50_s",
             "decode_steps", "prefill_chunks", "prefills")
    out: dict = {"launches": {n: 0 for n in counters}}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = default_serving_mesh()
        got_mesh = (mesh.device_type, tuple(mesh.shape),
                    tuple(mesh.mesh_dim_names))
        if got_mesh != ("cuda", (1, 1), ("data", "model")):
            raise AssertionError(f"[serve_mesh] default_serving_mesh() "
                                 f"gave {got_mesh}")
        for mode in ("chunked", "oneshot"):
            plain = Engine(cfg, params, prefill_mode=mode, **MESH_ENGINE)
            want = plain.run(requests(f"{mode}-plain"))
            plain_stats = dict(plain.stats)
            del plain
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t_build = time.perf_counter()
            engine = Engine(cfg, params, mesh=mesh, prefill_mode=mode,
                            **MESH_ENGINE)
            build_s = time.perf_counter() - t_build
            for c in counters.values():
                c.launches = 0
            got = engine.run(requests(f"{mode}-mesh"))
            torch.cuda.synchronize()
            launches = {n: c.launches for n, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() - base
            st = dict(engine.stats)
            del engine
            gc.collect()
            if not plain_stats["decode_graphs"] or st["decode_graphs"]:
                raise AssertionError("[serve_mesh] the plain engine must "
                                     "replay graphs, the mesh engine not")
            if st["mesh"] != {"data": 1, "model": 1}:
                raise AssertionError(f"[serve_mesh] stats mesh {st['mesh']}")
            diff = [r.uid for r, w in zip(got, want)
                    if not np.array_equal(r.tokens, w.tokens)]
            if diff:
                raise AssertionError(f"[serve_mesh] {mode}: streams of "
                                     f"{diff} differ from the graphed "
                                     f"plain engine's")
            mine = {k: st.get(k) for k in keys}
            theirs = {k: plain_stats.get(k) for k in keys}
            if mine != theirs:
                raise AssertionError(f"[serve_mesh] {mode}: stats {mine} "
                                     f"!= the plain engine's {theirs}")
            if mode == "chunked" and (mine["prefix_hits"] != 1
                                      or mine["cow_copies"] != 1):
                raise AssertionError(f"[serve_mesh] chunked: want one "
                                     f"prefix hit and one CoW copy, got "
                                     f"{mine}")
            idle = [n for n in ("sc_linear", "paged_attention",
                                "flash_attention") if not launches[n]]
            if idle:
                raise AssertionError(f"[serve_mesh] {mode}: {idle} never "
                                     f"launched on the mesh path")
            for n, v in launches.items():
                out["launches"][n] += v
            out[mode] = {"stats": mine, "launches": launches,
                         "peak_bytes": peak, "build_s": build_s,
                         "mesh": {k: st[k] for k in timed},
                         "graphed": {k: plain_stats[k] for k in timed}}
            log(f"[serve_mesh] {mode}: streams, {mine} equal to the graphed "
                f"engine's; mesh decode {st['decode_ms_per_step']:.2f} "
                f"ms/step, {st['tok_per_s']:.2f} tokens/s, TTFT p50 "
                f"{st['ttft_p50_s'] * 1e3:.1f} ms, {st['decode_steps']} "
                f"steps, peak {peak / 2**30:.3f} GiB above the weights, "
                f"built in {build_s:.2f}s; graphed "
                f"{plain_stats['decode_ms_per_step']:.2f} ms/step, "
                f"{plain_stats['tok_per_s']:.2f} tokens/s; launches "
                f"{ {k: v for k, v in launches.items() if v} }")
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"[serve_mesh] phase {out['seconds']:.1f}s on {_card_line()}")
    return out


#: the analysis phase's full-width model: the audits' own schedules at
#: smollm-360m's width (bf16 as registered, SC-GEMM at 8 bits, seed 0)
ANALYSIS_ARCH = "smollm-360m"
#: the audits run again at that width: the two that serve through graphs
ANALYSIS_FULL_WIDTH = ("capture-counts", "cow-protocol")
#: the kernels (launch counter names) each audit must launch on the card
ANALYSIS_KERNELS = {
    "popcount-path": ("sc_stream_mul",),
    "reduction-parity": ("paged_attention",),
    "capture-counts": ("sc_linear", "paged_attention", "flash_attention"),
    "cow-protocol": ("sc_linear", "paged_attention", "flash_attention")}


def _audit_run(tag: str, name: str, audit, dev, **kwargs) -> dict:
    """One contract audit on the card, the launch counters set to 0 just
    before and read just after; any problem, or a kernel of its path that
    did not launch, fails the phase."""
    import torch
    from repro_torch.launch.steps import launch_counters
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    problems = audit(dev, **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {n: c.launches for n, c in counters.items()}
    if problems:
        raise AssertionError(f"[analysis] {tag}: " + "; ".join(problems))
    idle = [k for k in ANALYSIS_KERNELS[name] if not launches[k]]
    if idle:
        raise AssertionError(f"[analysis] {tag}: {idle} never launched")
    log(f"[analysis] {tag}: pass in {seconds:.2f}s, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    return {"seconds": seconds, "launches": launches}


def phase_analysis() -> dict:
    """The port's lint over this checkout's ``src/repro_torch`` (no
    finding), the four contract audits on the card (graphed engines),
    then capture-counts and cow-protocol again at smollm-360m's full
    width, each with the launch counters set to 0 just before it."""
    import dataclasses
    import torch
    from repro_torch.analysis import DEFAULT_RULES, contracts, run_lint
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import bind
    t0 = time.perf_counter()
    lint = run_lint([ROOT / "src" / "repro_torch"], list(DEFAULT_RULES))
    if lint.findings or lint.errors:
        raise AssertionError("[analysis] lint: " + "; ".join(
            [f.render() for f in lint.findings] + lint.errors))
    out = {"lint": {"files": lint.files_checked, "findings": 0,
                    "seconds": time.perf_counter() - t0}}
    log(f"[analysis] lint: {lint.files_checked} files, 0 findings in "
        f"{out['lint']['seconds']:.2f}s")
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    audits = dict(contracts.AUDITS)
    out["audits"] = {name: _audit_run(name, name, audit, dev)
                     for name, audit in contracts.AUDITS}
    cfg = dataclasses.replace(ARCHS[ANALYSIS_ARCH], use_sc_gemm=True,
                              sc_bits=8).validate()
    params = bind(cfg, dev).init_params(0)
    out["full_width"] = {
        name: _audit_run(f"{name} at {ANALYSIS_ARCH}", name, audits[name],
                         dev, cfg=cfg, params=params)
        for name in ANALYSIS_FULL_WIDTH}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    runs = [*out["audits"].values(), *out["full_width"].values()]
    out["launches"] = {n: sum(r["launches"][n] for r in runs)
                       for n in runs[0]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    log(f"[analysis] phase {out['seconds']:.1f}s")
    return out


#: the examples phase's budget in seconds (an overrun is logged)
EXAMPLES_BUDGET_S = 45.0
EXAMPLES_TRAIN = ["--steps", "8", "--batch", "8", "--seq", "128"]


def _top2_margins(cfg, params, prompts, tokens) -> list:
    """The CPU's greedy decode of ``prompts`` fed ``tokens (B, n)``: each
    step's gap between the two largest logits of every row, as
    ``generate`` computes the logits."""
    import torch
    from repro_torch.launch.steps import decode_step, prefill_step
    from repro_torch.models import bind, pack_sc_weights
    m = bind(cfg, "cpu")
    params = pack_sc_weights(params, cfg)
    logits, cache = prefill_step(m, params, {"tokens": prompts},
                                 extra_slots=tokens.shape[1])
    margins = []
    for i in range(tokens.shape[1]):
        top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).tolist())
        logits, cache = decode_step(m, params, cache,
                                    {"tokens": tokens[:, i:i + 1]})
    return margins


def phase_examples() -> dict:
    """The port's four examples (``repro_torch.examples``), each ``main``
    called in this process on the card at the reference's own sizes (the
    training run at ``EXAMPLES_TRAIN``), its launch counters set to 0 just
    before and read just after, and checked: quickstart's Table I, MAE and
    Table II equal a CPU run's value for value, and on its SC-GEMM
    operands the kernel (``impl="pallas"``) gives the counts of
    ``mxu_split``; sc_gemm_inference within the example's own
    ``CARD_*`` tolerances of a CPU run on the same parameters, its SC run through the SC-GEMM kernel (launches
    counted) equal to ``mxu_split`` on the card; serve_lm's three families
    ``(4, 16)`` streams, the same again from the same seed, and at
    temperature 0 the CPU's streams (else the first differing step and
    its top-two logit margin); train_lm restored, its loss falling and
    finite. Every problem is collected, then the phase fails on any."""
    import math
    import contextlib
    import dataclasses
    import io
    import torch
    from repro_torch.core import sc_matmul
    from repro_torch.core.sc_numerics import recover_counts
    from repro_torch.examples import (quickstart, sc_gemm_inference,
                                      serve_lm, train_lm)
    from repro_torch.launch.steps import launch_counters
    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    card, cpu = ["--device", "cuda:0"], ["--device", "cpu"]
    counters = launch_counters()
    problems: list[str] = []
    out: dict = {}

    def counted(name, fn):
        gc.collect()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t,
                     "launches": {n: c.launches
                                  for n, c in counters.items()}}
        return res

    def quiet(fn):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    # quickstart
    got = counted("quickstart", lambda: quickstart.main(card))
    want = quiet(lambda: quickstart.main(cpu))
    for key in ("table1", "mae", "table2"):
        if got[key] != want[key]:
            problems.append(f"quickstart {key}: card {got[key]} != CPU "
                            f"{want[key]}")
    a, b = quickstart.sc_gemm_operands(dev)
    counts = {impl: recover_counts(sc_matmul(a, b, bits=8, impl=impl),
                                   a.cpu(), b.cpu())
              for impl in ("pallas", "mxu_split")}
    cpu_counts = recover_counts(sc_matmul(a.cpu(), b.cpu(), bits=8,
                                          impl="mxu_split"), a.cpu(), b.cpu())
    same = {"kernel_eq_mxu_split": bool((counts["pallas"]
                                         == counts["mxu_split"]).all()),
            "kernel_eq_cpu": bool((counts["pallas"] == cpu_counts).all())}
    if not all(same.values()):
        problems.append(f"quickstart SC-GEMM counts: {same}")
    out["quickstart"].update(same, cosine=got["cosine"],
                             cpu_cosine=want["cosine"], mae=got["mae"])
    log(f"[examples] quickstart: Table I, MAE {got['mae']!r} and Table II "
        f"= the CPU's: {not problems}; kernel counts = mxu_split's and the "
        f"CPU's: {same}; cosine {got['cosine']:.6f} (CPU "
        f"{want['cosine']:.6f})")

    # sc_gemm_inference
    got = counted("sc_gemm_inference", lambda: sc_gemm_inference.main(card))
    want = quiet(lambda: sc_gemm_inference.main(cpu))
    cfg_exact, cfg_sc, params, tokens = sc_gemm_inference.inputs(dev)
    plain = sc_gemm_inference.compare(
        cfg_exact, dataclasses.replace(cfg_sc, sc_impl="mxu_split"), params,
        tokens, dev)
    errs = {k: abs(got[k] - want[k]) for k in
            ("rel_err", "cosine", "loss_exact", "loss_sc")}
    problems += [f"sc_gemm_inference {p}"
                 for p in sc_gemm_inference.card_mismatches(got, want)]
    kernel_eq_plain = all(got[k] == plain[k] for k in plain)
    if not kernel_eq_plain:
        problems.append(f"sc_gemm_inference: the kernel's {got} != "
                        f"mxu_split's {plain} on the card")
    launches = out["sc_gemm_inference"]["launches"]
    sc_calls = sc_gemm_inference.sc_launches(cfg_sc)
    if launches["sc_linear"] != sc_calls:
        problems.append(f"sc_gemm_inference: {launches['sc_linear']} "
                        f"SC-GEMM launches, expected {sc_calls}")
    out["sc_gemm_inference"].update(card=got, cpu=want, errors=errs,
                                    kernel_eq_mxu_split=kernel_eq_plain)
    log(f"[examples] sc_gemm_inference: card - CPU "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }; kernel = "
        f"mxu_split on the card: {kernel_eq_plain}; SC-GEMM launches "
        f"{launches['sc_linear']} (expected {sc_calls}), flash "
        f"{launches['flash_attention']}")

    # serve_lm
    got = counted("serve_lm", lambda: serve_lm.main(card))
    serve = {}
    for arch in serve_lm.ARCH_NAMES:
        cfg, params, prompts = serve_lm.setup(arch, dev)
        tokens = got[arch]["tokens"]
        again = serve_lm.serve(cfg, params, prompts, serve_lm.TEMPERATURE,
                               dev)["tokens"]
        greedy = serve_lm.serve(cfg, params, prompts, 0.0, dev)["tokens"]
        _, cpu_params, _ = serve_lm.setup(arch, "cpu")
        cpu_greedy = serve_lm.serve(cfg, cpu_params, prompts, 0.0,
                                    "cpu")["tokens"]
        row = {"shape": tuple(tokens.shape),
               "same_seed_equal": torch.equal(again, tokens),
               "greedy_eq_cpu": torch.equal(greedy, cpu_greedy)}
        if row["shape"] != (serve_lm.BATCH, serve_lm.GEN_TOKENS):
            problems.append(f"serve_lm {arch}: streams {row['shape']}")
        if not row["same_seed_equal"]:
            problems.append(f"serve_lm {arch}: a second call with the same "
                            f"seed gave other streams")
        if not row["greedy_eq_cpu"]:
            step = int((greedy != cpu_greedy).any(0).nonzero()[0])
            rows = (greedy[:, step] != cpu_greedy[:, step]).nonzero()
            margins = _top2_margins(cfg, cpu_params, prompts, cpu_greedy)
            row["first_difference"] = {
                "step": step, "rows": rows[:, 0].tolist(),
                "top2_margin": [margins[step][r] for r in rows[:, 0]]}
            problems.append(f"serve_lm {arch}: greedy card streams differ "
                            f"from the CPU's: {row['first_difference']}")
        serve[arch] = row
    out["serve_lm"].update(families=serve, seconds_by_arch={
        arch: got[arch]["seconds"] for arch in serve_lm.ARCH_NAMES})
    log(f"[examples] serve_lm: {serve}; launches "
        f"{ {k: n for k, n in out['serve_lm']['launches'].items() if n} }")

    # train_lm
    args = EXAMPLES_TRAIN
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = counted("train_lm", lambda: train_lm.main(card + args))
    log(printed.getvalue().rstrip("\n"))
    half = int(args[1]) // 2
    losses = got["losses"][0] + got["losses"][1]
    checks = {"restored": f"[train] restored step {half} from"
              in printed.getvalue(),
              "loss_falls": got["last"] < got["first"],
              "finite": all(math.isfinite(x) for x in losses),
              "steps": [len(x) for x in got["losses"]] == [half, half]}
    if not all(checks.values()):
        problems.append(f"train_lm: {checks}")
    out["train_lm"].update(args=args, checks=checks, losses=got["losses"],
                           call_seconds=got["seconds"],
                           peak_bytes=got["peak_bytes"])
    log(f"[examples] train_lm {' '.join(args)}: {checks}; losses "
        f"{[round(x, 4) for x in losses]}; launches "
        f"{ {k: n for k, n in out['train_lm']['launches'].items() if n} }")

    names = ("quickstart", "sc_gemm_inference", "serve_lm", "train_lm")
    runs = [out[name] for name in names]
    out["launches"] = {n: sum(r["launches"][n] for r in runs)
                       for n in counters}
    out["seconds"] = time.perf_counter() - t0
    log(f"[examples] phase {out['seconds']:.1f}s (budget "
        f"{EXAMPLES_BUDGET_S:.0f}s; the examples' own "
        f"{ {r: round(out[r]['seconds'], 2) for r in names} }) on "
        f"{_card_line()}; launches "
        f"{ {k: n for k, n in out['launches'].items() if n} }")
    if out["seconds"] > EXAMPLES_BUDGET_S:
        log(f"[examples] over its budget by "
            f"{out['seconds'] - EXAMPLES_BUDGET_S:.1f}s")
    if problems:
        raise AssertionError("[examples] " + "; ".join(problems))
    return out


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


def _serve_spec_run(cfg, eng, reqs, baseline, *, run: int = 1,
                    name: str = "serve_spec") -> dict:
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
    from repro_torch.kernels import autotune
    from repro_torch.launch.steps import EAGER_RUNS
    k, bits, graphs = eng.speculate_k, eng.draft_bits, eng.graphs
    exact_draft = cfg.attn_sc and bits == cfg.sc_bits
    per_step, layers = _path_counts(cfg)
    tag = (f"[{name}:k{k}@{bits}b{':sc' if cfg.attn_sc else ''}:"
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
    sweeps0 = autotune.sweeps
    with _BASELINES.paused(graphs):
        results = eng.run(reqs)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    sweeps = autotune.sweeps - sweeps0
    if grids is not None:
        del eng._speculate_once
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()
    rounds = st["spec_rounds"]
    prefill_calls = st["prefill_chunks"]
    warm = EAGER_RUNS * st["prefill_captures"] if graphs else 0
    sc_verify = layers if cfg.attn_sc else 0
    flash = _flash_sites(cfg) * (prefill_calls + warm)
    want = {"sc_linear": per_step * ((k + 1) * rounds + prefill_calls
                                     + warm),
            "sc_matmul_counts": 0,
            "paged_attention": layers * (k + 1) * rounds,
            "paged_attention_sc": (layers * k + sc_verify) * rounds,
            "paged_attention_softcap": (layers * (k + 1) * rounds
                                        if cfg.attn_softcap else 0),
            "paged_attention_sc_softcap": ((layers * k + sc_verify) * rounds
                                           if cfg.attn_softcap else 0),
            "flash_attention": flash,
            "flash_attention_sc": flash if cfg.attn_sc else 0}
    steps_seen = {name: {"captures": s.captures,
                         "replays": s.replays - replays0[name],
                         "launch_counts": s.launch_counts}
                  for name, s in spec.items()}
    capture_sweeps = {name: s.capture_sweeps for name, s in
                      (*spec.items(), *eng.prefill_steps().items())}
    log(f"{tag} autotuner: {sweeps} sweeps in this run, none in a warm-up "
        f"or a capture ({capture_sweeps})")
    if any(capture_sweeps.values()):
        raise AssertionError(f"{tag} the tuner swept during a warm-up or a "
                             f"capture: {capture_sweeps}")
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
        f"{layers * (k + 1)} paged = {layers} x {k} SC + {layers} "
        f"{'SC' if cfg.attn_sc else 'float'})")
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    if graphs:
        log(f"{tag} step graphs: " + ", ".join(
            f"{name} captured {v['captures']}, replayed {v['replays']} "
            f"(a replay counts {v['launch_counts']})"
            for name, v in steps_seen.items()))
        verify = {"sc_linear": per_step, "paged_attention": layers}
        if sc_verify:
            verify["paged_attention_sc"] = sc_verify
        want_counts = {"draft": {"sc_linear": k * per_step,
                                 "paged_attention": k * layers,
                                 "paged_attention_sc": k * layers},
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
            mismatched.append(f"{req.uid} first differs at "
                              f"{_first_difference(ref, res.tokens)}")
    log(f"{tag} {len(reqs) - len(mismatched)}/{len(reqs)} streams identical "
        f"to the sequential baseline")
    if mismatched:
        raise AssertionError(f"{tag} speculative streams differ from the "
                             f"sequential baseline: " + "; ".join(mismatched))
    return {"stats": {k2: v for k2, v in st.items() if k2 != "backpressure"},
            "launches": launches, "sweeps": sweeps,
            "max_memory_allocated": peak,
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
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    out = {}
    for attn_sc in (False, True):
        # one cell's weights alive at a time, so each run's peak is its own
        name = "serve_sc" if attn_sc else "serve"
        cfg, reqs = _baseline_cell(name)
        params = bind(cfg, "cuda").init_params(0)
        baseline = _BASELINES.pending(name, f"[serve_spec] the {name} "
                                            f"cell's")
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
    return out


def _spec_beside(report: dict) -> None:
    """``serve_spec``'s cells' tokens/s beside the non-speculative graphed
    cells' (``serve`` and ``serve_sc`` chunked), which run after it."""
    spec = report["serve_spec"]
    tps = {"serve": report.get("serve", {}).get("stats", {}).get(
               "tok_per_s"),
           "serve_sc": report.get("serve_sc", {}).get("chunked", {}).get(
               "stats", {}).get("tok_per_s")}
    log("[serve_spec] tokens/s beside the non-speculative graphed cells' "
        "(" + ", ".join(f"{name} {v:.2f}" if v else f"{name} not run"
                        for name, v in tps.items()) + "): " + ", ".join(
            f"{name} {r['stats']['tok_per_s']:.2f} (acceptance "
            f"{r['stats']['spec_acceptance_rate']:.3f}, "
            f"{r['stats']['spec_tokens_per_round']:.2f} tokens a round, "
            f"{r['stats']['decode_ms_per_step']:.2f} ms a round)"
            for name, r in spec.items()))
    spec["serve_graphed_tok_per_s"] = tps["serve"]
    spec["serve_sc_graphed_tok_per_s"] = tps["serve_sc"]


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
    from repro_torch.models import bind
    from repro_torch.serving import Engine
    cfg, reqs = _baseline_cell("serve_prefix")
    params = bind(cfg, "cuda").init_params(0)
    baseline = _BASELINES.pending("serve_prefix", "[serve_prefix]")
    log(f"[serve_prefix] {len(reqs)} requests (prompts "
        f"{[r.prompt_len for r in reqs]}, new tokens "
        f"{[r.max_new_tokens for r in reqs]})")
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


#: traces of a graphed run taken, at most, to find one that holds every
#: kernel record of its replays
TRACE_TRIES = 3


def _whole_trace(tag: str, trace, counts: dict) -> dict:
    """``trace()`` (a ``_traced`` summary of graph replays) whose kernel
    records a replay equal ``counts``, the launches the capture recorded.
    A graph replays the same kernels every time, and the profiler now and
    then drops a kernel record but never adds one (PERF.md §7): a trace
    that holds fewer records than the capture launched is taken again, up
    to ``TRACE_TRIES`` traces, and the check holds the last one. More
    records than launches, or fewer in every trace, fail. Every trace's
    records stand under ``record_tries``."""
    tries = []
    while True:
        summary = trace()
        per = summary["kernel_records_per_step"]
        tries.append(per)
        lost = any(per[rec] < counts.get(name, 0)
                   for rec, name in RECORDS.items())
        if (not summary["device_busy_share"] or not lost
                or len(tries) == TRACE_TRIES):
            break
        log(f"{tag} trace {len(tries)} lost kernel records: {per} against "
            f"the capture's {counts}; tracing again")
    if summary["device_busy_share"]:
        _check_records(tag, per, counts)
    summary["record_tries"] = tries
    return summary


def _profile_engine(cfg, params, graphs: bool, tag: str = "profile") -> dict:
    """``torch.profiler`` over two decode steps of one engine (4 requests
    in 4 slots), against the wall time of two unprofiled steps. Graphed,
    the trace's kernel records a step must equal the launches the capture
    recorded (``_whole_trace``)."""
    import torch
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, device="cuda", capacity=4, max_seq=256,
                 block=64, chunk=16, prefix_cache=False, graphs=graphs)
    for r in _workload(cfg, 4, 16, 16, 16, seed=7):
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

    def trace():
        return _traced(two_steps, wall_ms)
    summary = (_whole_trace(tag, trace, eng._decode.launch_counts) if graphs
               else trace())
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
            f"{counts.get('paged_attention', 0)}); traces taken "
            f"{len(out['record_tries'])}")
    return out


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _is_kernel(e) -> bool:
    """A trace's device event (a kernel, a copy, a fill). A host range
    holds its kernels' device time too (an operator's ``aten::``, a CUDA
    call's, an autograd Function's such as ``ScDense``), and is not
    one."""
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA


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
    kernels = [e for e in events if _is_kernel(e)]
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
    SC-GEMM and 32 flash kernel records a chunk (``_whole_trace``) and no
    kernel launch from the host."""
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

    def trace():
        return _traced(two_chunks, wall_ms)
    summary = (_whole_trace(tag, trace, step.launch_counts) if graphs
               else trace())
    first = 16 * (n + 1 + 2 * (len(summary.get("record_tries", [0])) - 1))
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
            f"{per['flash_fwd_']:g} (captured {counts}); traces taken "
            f"{len(out['record_tries'])}")
        if out["kernel_launches_per_step"]:
            raise AssertionError(f"{tag} a graphed chunk launched "
                                 f"{out['kernel_launches_per_step']} kernels "
                                 f"from the host")
    return out


def phase_profile() -> dict:
    """Where a decode step's and a prefill chunk's time goes, eager and
    graphed: device time by kernel, host time by operator, host API calls,
    and the device's busy share against the wall time of unprofiled steps
    or chunks of the same engine; then each family cell's graphed decode
    step (``PROFILED_CELLS``). It runs before any cell serves."""
    import dataclasses
    import torch
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
    del params
    out["families"] = {}
    for name, arch in PROFILED_CELLS.items():
        fam = _family_cfg(arch)
        fam_params = bind(fam, "cuda").init_params(0)
        out["families"][name] = _profile_engine(fam, fam_params, True,
                                                f"{name}:profile")
        steps.clear_decode_steps()
        del fam_params
        gc.collect()
        torch.cuda.empty_cache()
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
    # the autotuner's caches: fresh files of this run's
    TUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    TUNE_CACHE.unlink(missing_ok=True)
    BASELINE_TUNE_CACHE.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(TUNE_CACHE)

    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))   # a debugging subset: no result
        if only & PROFILED_CELLS.keys():     # the family cells' profiles
            only.add("profile")
    t0 = time.perf_counter()
    card = phase_card()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    phases = (("build", phase_build), ("tune", phase_tune),
              ("sc_gemm", phase_sc_gemm),
              ("paged", phase_paged), ("flash", phase_flash),
              ("stream", phase_stream), ("paper", phase_paper),
              ("small_model", phase_small_model),
              # serve_spec first: its eager run (~1 minute) gives the
              # child time to compute the serve and serve_sc baselines
              ("profile", phase_profile), ("serve_spec", phase_serve_spec),
              ("serve", phase_serve), ("serve_sc", phase_serve_sc),
              ("serve_prefix", phase_serve_prefix),
              ("serve_ssm", phase_serve_ssm),
              ("serve_hybrid", phase_serve_hybrid),
              ("serve_vlm", phase_serve_vlm),
              ("serve_audio", phase_serve_audio),
              ("serve_moe", phase_serve_moe),
              ("serve_moe_llama4", phase_serve_moe_llama4),
              ("serve_qwen2_7b", phase_serve_qwen2_7b),
              ("serve_qwen2_5_14b", phase_serve_qwen2_5_14b),
              ("serve_gemma2_9b", phase_serve_gemma2_9b),
              ("train", phase_train),
              ("dist", lambda: phase_dist(report)),
              ("dryrun", phase_dryrun), ("serve_mesh", phase_serve_mesh),
              ("analysis", phase_analysis), ("examples", phase_examples))
    chosen = [(name, fn) for name, fn in phases
              if only is None or name in only]
    # the serving cells' baselines, in the order the phases read them
    keys = list(dict.fromkeys(key for name, _ in chosen
                              for key in BASELINE_KEYS.get(name, ())))
    seconds = {}
    try:
        for name, fn in chosen:
            if keys and name in BASELINE_KEYS and not _BASELINES.keys:
                _BASELINES.start(keys)
            t1 = time.perf_counter()
            report[name] = fn()
            seconds[name] = time.perf_counter() - t1
            log(f"[phase] {name}: {seconds[name]:.1f}s")
        _BASELINES.finish()
    finally:
        _BASELINES.stop()
    report["phase_seconds"] = seconds
    if "serve_spec" in report:
        _spec_beside(report)
    report["baselines"] = {key: {k2: b[k2] for k2 in ("seconds", "peak",
                                                      "waited")}
                           for key, b in _BASELINES.got.items()}
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
    tune = report["tune"]

    def tuned(family, bits="any"):
        """The tune phase's keys of a family (of one SC variant): each
        winner, its device ms, the default plan's, the grid's size."""
        return [{k2: r[k2] for k2 in ("key", "winner", "ms", "default_ms",
                                      "candidates")}
                for r in tune[family]
                if bits == "any" or r.get("sc_bits") == bits]

    step = report["sc_gemm"]["decode_step"]
    paged = report["paged"]["cases"]
    serve, serve_sc = report["serve"], report["serve_sc"]
    stream = report["stream"]["timing"][12]

    def paged_row(bits, shape):
        return next(r for r in paged if r["dtype"] == "bfloat16"
                    and r["sc_bits"] == bits and r["shape"] == shape)

    def paged_entry(name, bits, launches, softcap_launches):
        row, long_row = paged_row(bits, "serve"), paged_row(bits, "long")
        hybrid_row = paged_row(bits, "hybrid")
        layouts = {shape: paged_row(b, shape) for shape, b in
                   (("vlm", None if bits is None else 4),
                    ("audio", None)) if bits is None or shape == "vlm"}
        dev_ms = row["device_ms"]
        return {"name": name, "route": "cuda",
                "source": f"{src}/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:194",
                "launches": launches, "tuned": tuned("paged", bits),
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
                     "bound_ms", "bound_by")},
                **{f"{shape}_call": {
                    key: r[key] for key in
                    ("positions", "layout", "sc_bits", "ms", "device_ms",
                     "plain_ms", "bound_ms", "bound_by")}
                   for shape, r in layouts.items()},
                # the dense cells' layouts: gemma2-9b's with its softcap
                # (windowed and global) and without it, qwen2-7b's G 7
                # and qwen2.5-14b's G 5
                "softcap_launches": softcap_launches,
                **{f"{shape}_call": {
                    key: paged_row(bits, shape)[key] for key in
                    ("positions", "window", "softcap", "layout", "ms",
                     "device_ms", "plain_ms", "bound_ms", "bound_by")}
                   for shape in ("gemma2_local", "gemma2_global",
                                 "gemma2_nocap", "qwen2_7b",
                                 "qwen2_5_14b")}}

    def flash_entry(name, key, bits, launches):
        timing = report["flash"]["timing"][key]
        t = timing["chunked_prefill"]
        lib, dev_ms = t["library_ms"], t["device_ms"]
        by = {c["bound_by"] for c in timing["calls"][:4]}
        longs = timing["long_prompts"]
        return {"name": name, "route": "cuda",
                "source": f"{src}/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:91",
                "launches": launches, "tuned": tuned("flash", bits),
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
                     "library_ms", "library_device_ms")},
                **{f"{call}_call": {
                    k2: timing[call][k2] for k2 in
                    ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "library_device_ms")}
                   for call in ("vlm_prefill", "audio_chunk")
                   if call in timing}}

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
                             *(report[f][mode] for f in FAMILY_CELLS
                               for mode in ("chunked", "oneshot",
                                            "speculative")
                               if isinstance(report[f][mode], dict)))
              for r in runs(cell)]
    total = {name: sum(r["launches"][name] for r in served)
             for name in served[0]["launches"]}
    # the train phase's kill-and-resume (SC-GEMM and float flash only)
    trained = report["train"]["launches"]
    for name, n in trained.items():
        total[name] += n
    # the dryrun phase's mesh-bound train and paged decode steps, the
    # serve_mesh phase's mesh runs, the analysis phase's audits and the
    # examples phase's runs (the stream kernel's go to its own entry)
    for phase in ("dryrun", "serve_mesh", "analysis", "examples"):
        for name, n in report[phase]["launches"].items():
            if name in total:
                total[name] += n
    kernels = [
        {"name": "sc_gemm", "route": "cuda",
         "source": f"{src}/sc_matmul.cu",
         "replaces": "src/repro/kernels/sc_matmul.py:89",
         "launches": total["sc_linear"],
         "train_launches": trained["sc_linear"], "tuned": tuned("sc_gemm"),
         "max_abs_err": 0.0,
         "ms": step["ms"], "plain_ms": step["plain_ms"],
         "bound_ms": step["bound_ms"],
         "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in
                                     report["sc_gemm"]["timing"]
                                     if r["M"] == 4) else "operations"),
         "library_ms": None, "device_ms": step["device_ms"],
         "tuned_device_ms": step["tuned_device_ms"],
         "chain_ms": step["chain_ms"],
         "unit": "one smollm-360m decode step at M=4: 225 fused calls "
                 "(32 layers x 7 projections + the LM head), bf16 rows",
         "families": {
             arch: {what: fam[what] for what in ("decode_step",
                                                 "prefill_chunk")
                    if what in fam}
             for arch, fam in report["sc_gemm"]["families"].items()},
         "gemma2_head_call": next(
             {k2: r[k2] for k2 in ("M", "K", "N", "ms", "device_ms",
                                   "tuned_device_ms", "plain_ms",
                                   "bound_ms", "bound_by")}
             for r in report["sc_gemm"]["families"]["gemma2-9b"]["timing"]),
         "moe_batched": report["sc_gemm"]["moe"]["timing"]},
        paged_entry("paged_attention", None,
                    total["paged_attention"] - total["paged_attention_sc"],
                    total["paged_attention_softcap"]
                    - total["paged_attention_sc_softcap"]),
        paged_entry("paged_attention_sc", 8, total["paged_attention_sc"],
                    total["paged_attention_sc_softcap"]),
        flash_entry("flash_attention", "float", None,
                    total["flash_attention"] - total["flash_attention_sc"])
        | {"train_launches": trained["flash_attention"]
           - trained["flash_attention_sc"]},
        flash_entry("flash_attention_sc", "sc8", 8,
                    total["flash_attention_sc"]),
        {"name": "sc_stream_mul", "route": "cuda",
         "source": f"{src}/sc_bitops.cu",
         "replaces": "src/repro/kernels/sc_bitops.py:84",
         "launches": report["stream"]["launches"]
         + report["analysis"]["launches"]["sc_stream_mul"]
         + report["examples"]["launches"]["sc_stream_mul"],
         "tuned": tuned("stream"),
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
