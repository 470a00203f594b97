"""Request queue and admission scheduling for the serving engine (port of
``repro/serving/queue.py``).

Scheduling policy: strict FCFS admission. The engine asks the
queue for the next waiting request whenever a slot frees; there is no
reordering, so per-request token streams are a pure function of (params,
prompt, sampling settings) — deterministic SC-GEMM makes them token-exact —
and never of arrival interleaving. Fancier policies (shortest-prompt-first,
priority classes) would slot in here without touching the engine loop.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.errors import ConfigError

__all__ = ["Request", "RequestResult", "RequestQueue"]


@dataclass
class Request:
    """One generation request.

    ``prompt``: int32 token ids, shape (S,) — or (S, K) for codebook
    (audio) models. ``eos_id`` stops decode early when the model emits it
    (scalar-vocab families only); ``max_new_tokens`` always bounds length.
    ``temperature == 0`` is greedy (deterministic); > 0 samples through a
    per-request ``torch.Generator`` seeded by ``seed``, so the stream depends
    only on the request, never on which slot or step the scheduler gave it
    (the draws differ from the JAX package's PRNG chain).
    """
    uid: str
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None = None
    temperature: float = 0.0
    seed: int = 0
    enqueued_at: float = field(default_factory=time.perf_counter)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim not in (1, 2) or self.prompt.shape[0] == 0:
            raise ConfigError(f"request {self.uid}: prompt must be a nonempty "
                             f"(S,) or (S, K) id array, got {self.prompt.shape}")
        if self.max_new_tokens < 1:
            raise ConfigError(f"request {self.uid}: max_new_tokens must be ≥ 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclass
class RequestResult:
    """Completed request: the generated stream plus latency/step accounting."""
    uid: str
    tokens: np.ndarray            # (n,) or (n, K) generated ids
    prompt_len: int
    finished_reason: str          # "eos" | "length"
    enqueued_at: float
    admitted_at: float
    finished_at: float
    admit_step: int               # engine decode-step index at admission
    finish_step: int              # engine decode-step index at completion
    first_token_at: float = 0.0   # wall clock of the first emitted token

    def __post_init__(self):
        if not self.first_token_at:
            # admission samples the first token from the prefill logits, so
            # the two instants coincide unless the engine recorded an
            # earlier emission (preempted streams keep their original TTFT).
            self.first_token_at = self.admitted_at

    @property
    def n_generated(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def latency_s(self) -> float:
        """Queue-to-last-token latency (what a caller experiences)."""
        return self.finished_at - self.enqueued_at

    @property
    def ttft_s(self) -> float:
        """Time to first token: queue entry to the first emitted token (the
        prefill's last chunk yields the first sampled token)."""
        return self.first_token_at - self.enqueued_at

    @property
    def itl_s(self) -> float:
        """Mean inter-token latency over the stream after the first token
        (0.0 for single-token streams)."""
        return ((self.finished_at - self.first_token_at)
                / max(self.n_generated - 1, 1))


class RequestQueue:
    """FCFS waiting line. ``submit`` appends; ``pop`` hands the engine the
    oldest waiting request."""

    def __init__(self, requests: Any = ()):  # iterable of Request
        self._q: deque[Request] = deque()
        self._seen: set[str] = set()
        for r in requests:
            self.submit(r)

    def submit(self, request: Request) -> None:
        if request.uid in self._seen:
            raise ConfigError(f"duplicate request uid {request.uid!r}")
        self._seen.add(request.uid)
        self._q.append(request)

    def requeue(self, request: Request) -> None:
        """Return a preempted request to the *front* of the line (its uid is
        already known). The engine preempts youngest-first, so iterated
        requeues restore the original FCFS admission order. Partially
        prefilled requests land here too — their staging progress
        (``SlotEntry.prefill_offset``) is discarded and the prefill restarts
        from offset 0 on re-admission; determinism makes the replayed
        stream bit-identical, so correctness never depends on how far the
        abandoned prefill got."""
        self._q.appendleft(request)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request:
        return self._q[0]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
