"""SC-GEMM as a drop-in layer numeric with a straight-through gradient (port
of ``repro/core/sc_layers.py``).

``sc_dense`` replaces ``x @ w`` with the stochastic-multiplier GEMM in the
forward pass and backpropagates as if the matmul were exact (STE), the
usual recipe for quantization-aware training.

Dtype contract: the tensors saved for backward are the caller's ``x`` and
``w`` in their original dtype — the float32 upcast the SC kernels need
happens only inside the forward call and is never saved.

Serving does not quantize its weights per call: ``sc_proj`` takes a weight
packed once (``kernels.sc_matmul.pack_weight``, made for a whole parameter
tree by ``models.transformer.pack_sc_weights``) and runs the projection as
one fused kernel launch on the card (``kernels.sc_matmul.sc_linear``)
whenever the config's ``sc_impl`` (or ``$REPRO_SC_IMPL``) names the
kernel path: at the autotuner's plan for the shape
(``kernels/autotune.py``) under ``"pallas_tuned"`` and, on the card,
``"auto"``; at ``sc_matmul.plan``'s under ``"pallas"``. Gradients and the
plain formulations (``"ref"``, ``"mxu_split"``) keep the per-call path
through :func:`sc_dense`.
"""
from __future__ import annotations

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels.autotune import get_or_tune
from repro_torch.kernels.sc_matmul import sc_linear
from repro_torch.parallel.context import reshape

from .sc_matmul import resolve_impl, sc_matmul

__all__ = ["sc_dense", "sc_einsum_bd_df", "sc_proj", "ScDense"]

#: ``sc_impl`` values, once resolved, that ``sc_proj`` serves through the
#: packed weight: the kernel path's names and the device's own choice.
PACKED_IMPLS = ("auto", "pallas", "pallas_tuned")


def _sc_forward(x: torch.Tensor, w: torch.Tensor, bits: int,
                impl: str | None) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = reshape(x, -1, x.shape[-1])
    # row_quant: per-token activation scales, so a token's output is
    # independent of whatever else shares the batch — the serving engine's
    # batch-invariance rests on this.
    out = sc_matmul(x2.to(torch.float32), w.to(torch.float32), bits=bits,
                    impl=resolve_impl(impl), row_quant=True)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


class ScDense(torch.autograd.Function):
    """``x @ w`` through SC-GEMM forward, exact-matmul gradients backward."""

    @staticmethod
    def forward(ctx, x, w, bits, impl):
        ctx.save_for_backward(x, w)
        return _sc_forward(x, w, bits, impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # straight-through: gradients of the exact matmul, accumulated in
        # float32, delivered in the activation/parameter dtypes
        g32 = g.to(torch.float32)
        gx = torch.einsum("...n,kn->...k", g32,
                          w.to(torch.float32)).to(x.dtype)
        gw = torch.einsum("...k,...n->kn", x.to(torch.float32),
                          g32).to(w.dtype)
        return gx, gw, None, None


def sc_dense(x: torch.Tensor, w: torch.Tensor, bits: int = 8,
             impl: str | None = None) -> torch.Tensor:
    """``x @ w`` through SC-GEMM. ``x: (..., K)``, ``w: (K, N)``.

    ``impl`` ∈ {None/"auto", "ref", "mxu_split", "pallas", "pallas_tuned"};
    None defers to ``$REPRO_SC_IMPL`` and then the device choice.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return ScDense.apply(x, w, bits, impl)
    return _sc_forward(x, w, bits, impl)


def sc_einsum_bd_df(x: torch.Tensor, w: torch.Tensor, bits: int = 8,
                    impl: str | None = None) -> torch.Tensor:
    """:func:`sc_dense` under the name of its ``...d,df->...f``
    contraction."""
    return sc_dense(x, w, bits, impl)


def sc_proj(x: torch.Tensor, w: torch.Tensor, cfg,
            packed=None) -> torch.Tensor:
    """Config-driven dense projection — the dispatch point every model
    matmul goes through: exact ``x @ w``, or with ``cfg.use_sc_gemm`` the
    SC-GEMM at ``cfg.sc_bits``: through ``packed`` (``w`` packed once) when
    given, ``cfg.sc_impl`` resolves to one of :data:`PACKED_IMPLS` and no
    gradient is asked for (one kernel launch on the card, output in
    ``x``'s dtype; the launch plan is the autotuner's for ``(bucket_m(M),
    K, N, bits)`` under ``"pallas_tuned"`` and, on the card, ``"auto"``),
    else :func:`sc_dense` with the config's ``sc_impl``. All give the same
    bits.

    Batched (a MoE projection, the reference's ``jax.vmap`` of ``sc_proj``
    over experts): ``x (E, M, K)`` with ``w (E, K, N)`` gives ``(E, M,
    N)``, each expert quantized with its own per-tensor weight scale. The
    exact path is a float32 batched product; the packed path (``packed``
    a batched pack) one ``sc_linear`` launch for all experts; the per-call
    path :func:`sc_dense` expert by expert."""
    batched = w.dim() == 3
    if not cfg.use_sc_gemm:
        if batched:
            return torch.bmm(x.to(torch.float32),
                             w.to(torch.float32)).to(x.dtype)
        return x @ w
    impl = resolve_impl(cfg.sc_impl)
    if (packed is not None and impl in PACKED_IMPLS
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or w.requires_grad))):
        have = ((packed.experts, *packed.shape) if packed.experts
                else packed.shape)
        if packed.bits != cfg.sc_bits or have != tuple(w.shape):
            raise ConfigError(
                f"packed weight {have} at {packed.bits} bits does "
                f"not match the weight {tuple(w.shape)} at sc_bits="
                f"{cfg.sc_bits}: pack the parameters again")
        x2 = x if batched else reshape(x, -1, x.shape[-1])
        tuned = impl == "pallas_tuned" or (impl == "auto" and x2.is_cuda)
        out = sc_linear(x2, packed,
                        config=get_or_tune(x2, packed) if tuned else None)
        return out if batched else out.reshape(*x.shape[:-1],
                                               packed.shape[1])
    if batched:
        return torch.stack([sc_dense(x[e], w[e], cfg.sc_bits, cfg.sc_impl)
                            for e in range(w.shape[0])])
    return sc_dense(x, w, cfg.sc_bits, cfg.sc_impl)
