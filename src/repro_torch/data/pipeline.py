"""Token data pipeline: a deterministic synthetic stream and a
memory-mapped int32 corpus, sharded per host (port of
``repro/data/pipeline.py``, kept in numpy).

The pipeline is host-side and deterministic in (seed, step, shard): a
restart resumes mid-epoch with no state beyond the step counter, which
the checkpointer relies on (it stores only the step). Batches are numpy
arrays; ``launch.train`` moves them to the device.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

__all__ = ["PipelineConfig", "TokenPipeline", "write_corpus"]


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_codebooks: int = 0             # musicgen-style multi-stream tokens
    shard_index: int = 0             # this host's shard
    shard_count: int = 1
    corpus_path: str | None = None   # None -> synthetic
    seed: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.shard_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.shard_count} shards")
        return self.global_batch // self.shard_count


class TokenPipeline:
    """``get_batch(step) -> {"tokens", "labels"}`` int32 numpy arrays of
    this host's shard."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self._mmap = None
        if cfg.corpus_path is not None:
            self._mmap = np.memmap(cfg.corpus_path, dtype=np.int32, mode="r")

    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        shape = (cfg.local_batch, cfg.seq_len + 1)
        if cfg.n_codebooks:
            shape = shape + (cfg.n_codebooks,)
        seed_bytes = f"{cfg.seed}:{step}:{cfg.shard_index}".encode()
        seed = int.from_bytes(hashlib.sha256(seed_bytes).digest()[:8],
                              "little")
        rng = np.random.default_rng(seed)
        # a Zipf-ish marginal, so cross-entropy falls within a few steps
        z = rng.zipf(1.3, size=shape)
        return np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)

    def _from_corpus(self, step: int) -> np.ndarray:
        cfg = self.cfg
        tokens_per_batch = cfg.local_batch * (cfg.seq_len + 1)
        n = self._mmap.shape[0]
        start = ((step * cfg.shard_count + cfg.shard_index)
                 * tokens_per_batch) % max(n - tokens_per_batch, 1)
        window = np.asarray(self._mmap[start:start + tokens_per_batch])
        out = window.reshape(cfg.local_batch, cfg.seq_len + 1)
        return np.clip(out, 0, cfg.vocab_size - 1).astype(np.int32)

    def get_batch(self, step: int) -> dict:
        block = (self._from_corpus(step) if self._mmap is not None
                 else self._synthetic(step))
        return {"tokens": block[:, :-1], "labels": block[:, 1:]}


def write_corpus(path: str | Path, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.int32).tofile(str(path))
