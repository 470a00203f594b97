"""Family dispatch (port of ``repro/models/model_zoo.py``): one bound
interface over a config. This slice ports the dense family; every other
family raises :class:`ConfigError` naming the slice that brings it."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import ConfigError

from . import transformer

__all__ = ["bind", "BoundModel"]

#: Families of the JAX package that later slices of the port bring.
_LATER = {"moe": "the MoE slice", "vlm": "the VLM slice",
          "audio": "the audio slice", "ssm": "the SSM slice",
          "hybrid": "the hybrid (Zamba2) slice"}


class BoundModel:
    """Config- and device-bound model functions; parameters are passed in."""

    def __init__(self, cfg: ModelConfig,
                 device: str | torch.device | None = None):
        cfg.validate()
        if cfg.family != "dense":
            later = _LATER.get(cfg.family)
            if later is None:
                raise ConfigError(f"unknown family {cfg.family!r}")
            raise ConfigError(f"family {cfg.family!r} is not ported yet: it "
                              f"comes with {later} of the port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mod = transformer

    def init_params(self, seed: int = 0) -> dict:
        return self._mod.init_params(self.cfg, seed, device=self.device)

    def forward_hidden(self, params, batch):
        return self._mod.forward_hidden(params, self.cfg, batch)

    def init_cache(self, batch_size: int, max_seq: int):
        return self._mod.init_kv_cache(self.cfg, batch_size, max_seq,
                                       device=self.device)

    def decode_step(self, params, cache, batch):
        return self._mod.decode_step(params, self.cfg, cache, batch)

    def decode_window_step(self, params, cache, batch):
        """Speculative verify: ``W`` tokens a sequence in one forward, row
        ``i`` equal to the ``i + 1``-th sequential decode step."""
        return self._mod.decode_window_step(params, self.cfg, cache, batch)

    def paged_decode_step(self, params, cache, tables, batch):
        """Fused paged decode: ``cache`` in the ``cache_ops.paged_init``
        layout, ``tables`` the ``(capacity, max_blocks)`` block table."""
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
