"""Family dispatch (port of ``repro/models/model_zoo.py``): one bound
interface over a config. The dense, ssm (Mamba-2) and hybrid (Zamba2)
families are ported; the others raise :class:`ConfigError` naming the
slice that brings them."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError
from repro_torch.kernels.sc_matmul import pack_weight

from . import ssm_lm, transformer, zamba2

__all__ = ["bind", "BoundModel", "pack_sc_weights"]

#: Families of the JAX package that later slices of the port bring.
_LATER = {"moe": "the MoE slice", "vlm": "the VLM slice",
          "audio": "the audio slice"}

_MODULES = {"dense": transformer, "ssm": ssm_lm, "hybrid": zamba2}


def _module(cfg: ModelConfig):
    mod = _MODULES.get(cfg.family)
    if mod is None:
        later = _LATER.get(cfg.family)
        if later is None:
            raise ConfigError(f"unknown family {cfg.family!r}")
        raise ConfigError(f"family {cfg.family!r} is not ported yet: it "
                          f"comes with {later} of the port")
    return mod


def pack_sc_weights(params: dict, cfg: ModelConfig,
                    pack=pack_weight) -> dict:
    """The parameter tree with every SC-GEMM weight of ``cfg``'s family
    packed once by ``pack`` beside its float weight
    (``transformer.pack_sc_weights`` and the families' counterparts); the
    tree as it is without ``cfg.use_sc_gemm``. Packs are always made anew
    from the float weights."""
    if not cfg.use_sc_gemm:
        return params
    return _module(cfg).pack_sc_weights(params, cfg, pack)


class BoundModel:
    """Config- and device-bound model functions; parameters are passed in."""

    def __init__(self, cfg: ModelConfig,
                 device: str | torch.device | None = None):
        cfg.validate()
        self._mod = _module(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, seed: int = 0) -> dict:
        return self._mod.init_params(self.cfg, seed, device=self.device)

    def forward_hidden(self, params, batch):
        return self._mod.forward_hidden(params, self.cfg, batch)

    def init_cache(self, batch_size: int, max_seq: int):
        init = (transformer.init_kv_cache if self._mod is transformer
                else self._mod.init_cache)
        return init(self.cfg, batch_size, max_seq, device=self.device)

    def decode_step(self, params, cache, batch):
        return self._mod.decode_step(params, self.cfg, cache, batch)

    def decode_window_step(self, params, cache, batch):
        """Speculative verify: ``W`` tokens a sequence in one forward, row
        ``i`` equal to the ``i + 1``-th sequential decode step. The dense
        family only: recurrent state cannot roll back."""
        if self._mod is not transformer:
            raise ConfigError(
                f"decode_window_step needs a transformer family (recurrent "
                f"state cannot roll back), got {self.cfg.family!r}")
        return self._mod.decode_window_step(params, self.cfg, cache, batch)

    def paged_decode_step(self, params, cache, tables, batch):
        """Fused paged decode: ``cache`` in the ``cache_ops.paged_init``
        layout, ``tables`` the ``(capacity, max_blocks)`` block table. The
        ssm family's is the decode step: its paged layout is its slot
        layout."""
        return self._mod.paged_decode_step(params, self.cfg, cache, tables,
                                           batch)

    def prefill_step(self, params, batch, *, extra_slots: int = 0):
        return self._mod.prefill_step(params, self.cfg, batch,
                                      extra_slots=extra_slots)

    def prefill_chunk_step(self, params, cache, batch):
        """Chunked prefill: advance a B=1 staging cache by one chunk."""
        return self._mod.prefill_chunk_step(params, self.cfg, cache, batch)


def bind(cfg: ModelConfig,
         device: str | torch.device | None = None) -> BoundModel:
    """Bind ``cfg`` on ``device`` (``None`` means the card)."""
    return BoundModel(cfg, device)
