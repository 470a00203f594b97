"""Model/config schema of the PyTorch port: a copy of ``repro/configs/base.py``
with the same fields and the same ``reduced()`` rule, so a config names the
same architecture in both packages. One instance fully describes an
architecture; the arch files in this package instantiate it with the exact
public-literature hyperparameters."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: Operand widths the SC attention path accepts (the JAX package's
#: ``kernels/sc_attention.py`` bounds).
SC_ATTN_BITS_MIN, SC_ATTN_BITS_MAX = 2, 8


def sc_attention_bits_ok(bits: int | None) -> bool:
    return bits is None or SC_ATTN_BITS_MIN <= bits <= SC_ATTN_BITS_MAX


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    # per-group window pattern; repeats over depth. (None,) = all-global.
    # gemma2: (4096, None); llama4: (8192, 8192, 8192, None).
    windows: tuple[int | None, ...] = (None,)
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE

    # --- MLP / MoE
    act: str = "silu"                # silu | gelu
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    # which positions in the repeating group are MoE (llama4 alternates);
    # length must divide evenly with len(windows) into the group size.
    moe_flags: tuple[bool, ...] = (False,)
    router_group_size: int = 512
    capacity_factor: float = 2.0

    # --- SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    shared_attn_every: int = 0       # zamba2: shared attn block every k mamba layers

    # --- modality stubs
    n_codebooks: int = 0             # musicgen: EnCodec codebooks (frontend stub)

    # --- norms / embeddings
    norm_eps: float = 1e-6
    norm_plus_one: bool = False      # gemma-style (1 + w) RMSNorm
    post_norms: bool = False         # gemma2 post-attn/post-mlp norms
    tie_embeddings: bool = False
    emb_scale: bool = False          # gemma: embeddings scaled by sqrt(d)

    # --- numerics
    dtype: str = "bfloat16"
    use_sc_gemm: bool = False        # route dense projections through SC-GEMM
    sc_bits: int = 8
    # Route attention's QK^T/PV contractions through the SC popcount path
    # (DESIGN.md §13) at ``sc_bits`` operand width — the paper's arithmetic
    # in the serving hot loop. Off by default: exact attention.
    attn_sc: bool = False
    # SC-GEMM kernel choice for every sc_dense call site (DESIGN.md §6):
    # auto | mxu_split | pallas | pallas_tuned | ref. "auto" defers to
    # $REPRO_SC_IMPL and then the backend/autotune-cache dispatch. With
    # packed weights (serving), auto | pallas | pallas_tuned take the fused
    # kernel; ref and mxu_split run their plain formulations per call.
    sc_impl: str = "auto"
    # Flash-attention execution: "auto" uses the tuned Pallas kernel when the
    # shape/backend qualify (TPU, causal, no window/softcap, 128-aligned),
    # "jnp" forces the XLA formulation, "pallas_tuned" forces the kernel.
    attn_kernel: str = "auto"
    # Paged decode-attention execution (DESIGN.md §9), resolved like
    # attn_kernel: "auto" walks block tables in-kernel on TPU when the
    # layout qualifies (GQA heads, no softcap, aligned extents), "jnp"
    # forces the per-layer gathered-dense formulation, "pallas_tuned"
    # forces the kernel on every eligible call regardless of backend
    # (interpret mode off TPU — used by the bit-identity tests).
    paged_attn_kernel: str = "auto"
    # Self-speculative decoding (DESIGN.md §14): draft k tokens per round
    # through the SC popcount path at ``draft_bits`` operand width (same
    # weights, cheaper multiplier), verify on this config's exact path.
    # 0 disables speculation. Greedy acceptance keeps streams bit-identical
    # to the non-speculative engine, so these are pure throughput knobs.
    speculate_k: int = 0
    draft_bits: int = 4

    # --- execution
    remat: bool = True
    q_block: int = 512
    kv_block: int = 1024
    skip_masked_blocks: bool = False  # §Perf: triangular causal schedule
    bf16_probs: bool = False          # §Perf: cast softmax probs to bf16 for PV
    attn_kv_gather: bool = False      # §Perf: gather K/V once per layer (hoist)
    loss_chunk: int = 2048
    sharding_strategy: str = "tp_sp"  # tp_sp | dp (§Perf: small-model layout)

    @property
    def group_size(self) -> int:
        """Layers per scan group (lcm of the window and moe patterns)."""
        import math
        g = math.lcm(len(self.windows), len(self.moe_flags))
        return g

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def window_at(self, pos: int) -> int | None:
        return self.windows[pos % len(self.windows)]

    def moe_at(self, pos: int) -> bool:
        return bool(self.n_experts) and self.moe_flags[pos % len(self.moe_flags)]

    def validate(self) -> "ModelConfig":
        from repro_torch.core.sc_matmul import SC_IMPLS   # lazy: keep configs light
        assert self.sc_impl in SC_IMPLS, (
            f"{self.name}: unknown sc_impl {self.sc_impl!r}")
        assert self.attn_kernel in ("auto", "jnp", "pallas_tuned"), (
            f"{self.name}: unknown attn_kernel {self.attn_kernel!r}")
        assert self.paged_attn_kernel in ("auto", "jnp", "pallas_tuned"), (
            f"{self.name}: unknown paged_attn_kernel "
            f"{self.paged_attn_kernel!r}")
        if self.attn_sc:
            assert sc_attention_bits_ok(self.sc_bits), (
                f"{self.name}: attn_sc needs 2 <= sc_bits <= 8, "
                f"got {self.sc_bits}")
        assert self.speculate_k >= 0, (
            f"{self.name}: speculate_k must be >= 0, got {self.speculate_k}")
        if self.speculate_k:
            assert sc_attention_bits_ok(self.draft_bits), (
                f"{self.name}: speculative draft needs 2 <= draft_bits <= 8, "
                f"got {self.draft_bits}")
        if self.family != "ssm":
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name
        assert self.n_layers % self.group_size == 0, (
            f"{self.name}: n_layers {self.n_layers} % group {self.group_size}")
        if self.shared_attn_every:
            assert self.family == "hybrid"
        return self

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test sized variant of the same family (tiny but structure-true)."""
        small = dict(
            n_layers=max(self.group_size * 2, 2 * self.shared_attn_every or 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            moe_d_ff=32 if self.n_experts else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            shared_expert_d_ff=32 if self.shared_expert_d_ff else 0,
            router_group_size=32,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 128,
            q_block=16,
            kv_block=16,
            loss_chunk=32,
            windows=tuple(8 if w else None for w in self.windows),
            mrope_sections=(2, 3, 3) if self.mrope_sections else None,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        cfg = dataclasses.replace(self, **small)
        return cfg.validate()
