"""Fault tolerance: heartbeats, straggler detection, elastic re-meshing and
the checkpoint-restart supervisor (port of
``repro/runtime/fault_tolerance.py``).

Everything here is host-side, deterministic Python: the policy — what to
do when a worker is late, dead or slow — not a transport.
:func:`device_chips` counts the chips a supervisor plans over.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["HeartbeatMonitor", "StragglerDetector", "plan_elastic_mesh",
           "TrainingSupervisor", "SupervisorConfig", "device_chips"]


def device_chips(device: torch.device) -> int:
    """The chips of ``device``'s kind: the visible cards on CUDA, 1 on the
    CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


# ------------------------------------------------------------------ heartbeat

class HeartbeatMonitor:
    """Tracks per-worker liveness from heartbeat timestamps."""

    def __init__(self, n_workers: int, *, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.n_workers = n_workers
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last = {w: now for w in range(n_workers)}

    def beat(self, worker: int) -> None:
        self._last[worker] = self._clock()

    def dead_workers(self) -> list[int]:
        now = self._clock()
        return [w for w, t in self._last.items() if now - t > self.timeout_s]

    def alive_count(self) -> int:
        return self.n_workers - len(self.dead_workers())


# ------------------------------------------------------------------ straggler

class StragglerDetector:
    """Flags workers whose step times drift beyond ``z_threshold`` robust
    standard deviations of the fleet median (EWMA-smoothed)."""

    def __init__(self, *, alpha: float = 0.2, z_threshold: float = 3.0,
                 min_samples: int = 8):
        self.alpha = alpha
        self.z = z_threshold
        self.min_samples = min_samples
        self._ewma: dict[int, float] = {}
        self._count = 0

    def record(self, worker: int, step_time_s: float) -> None:
        prev = self._ewma.get(worker, step_time_s)
        self._ewma[worker] = (1 - self.alpha) * prev + self.alpha * step_time_s
        self._count += 1

    def stragglers(self) -> list[int]:
        if self._count < self.min_samples or len(self._ewma) < 3:
            return []
        vals = sorted(self._ewma.values())
        median = vals[len(vals) // 2]
        mad = sorted(abs(v - median) for v in vals)[len(vals) // 2] or 1e-9
        sigma = 1.4826 * mad
        return [w for w, v in self._ewma.items()
                if (v - median) / sigma > self.z]


# -------------------------------------------------------------------- elastic

def plan_elastic_mesh(surviving_chips: int, *, model_parallelism: int,
                      min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) grid that fits the survivors: model
    parallelism stays fixed, the data axis shrinks, so a lost node costs
    one data-parallel replica group rather than the job."""
    if surviving_chips < model_parallelism * min_data:
        raise RuntimeError(
            f"only {surviving_chips} chips left; need >= {model_parallelism}")
    data = surviving_chips // model_parallelism
    return data, model_parallelism


# ------------------------------------------------------------------ supervisor

@dataclass
class SupervisorConfig:
    checkpoint_every: int = 200
    max_restarts: int = 100
    heartbeat_timeout_s: float = 60.0


@dataclass
class TrainingSupervisor:
    """Checkpoint-restart policy: the training loop calls :meth:`on_step`;
    on a worker's death the runner calls :meth:`on_failure`, which returns
    the restart plan (restore step and new mesh)."""
    cfg: SupervisorConfig
    n_chips: int
    model_parallelism: int
    restarts: int = 0
    last_checkpoint_step: int = -1

    def should_checkpoint(self, step: int) -> bool:
        return (step % self.cfg.checkpoint_every == 0
                and step != self.last_checkpoint_step)

    def on_step(self, step: int) -> None:
        if self.should_checkpoint(step):
            self.last_checkpoint_step = step

    def on_failure(self, dead_workers: list[int],
                   chips_per_worker: int) -> dict:
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise RuntimeError("restart budget exhausted")
        surviving = self.n_chips - len(dead_workers) * chips_per_worker
        data, model = plan_elastic_mesh(
            surviving, model_parallelism=self.model_parallelism)
        return {
            "restore_step": self.last_checkpoint_step,
            "new_mesh": (data, model),
            "surviving_chips": surviving,
            "restart_index": self.restarts,
        }
