"""Minimal byte-level tokenizer: vocab 256 + BOS/EOS (port of
``repro/data/tokenizer.py``)."""
from __future__ import annotations

import numpy as np

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str, *, add_bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")
