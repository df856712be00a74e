"""Step timing — the port of ``ddl_tpu/utils/metrics.py``.

A steady-state step timer with percentile stats. On the card, PyTorch
returns before the device finishes, so every timed step closes with
:func:`barrier` (``torch.cuda.synchronize``). The profiler wrapper
(``trace``) is not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch


def barrier(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, where
    PyTorch runs synchronously)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class StepStats:
    steps: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    total_s: float
    images_per_sec: float
    p99_ms: float = 0.0

    @property
    def tokens_per_sec(self) -> float:
        """``images_per_sec`` under its name for the LM, which counts
        tokens (B * T) per step."""
        return self.images_per_sec

    def line(self) -> str:
        return (
            f"steps={self.steps} mean={self.mean_ms:.2f}ms "
            f"p50={self.p50_ms:.2f}ms p95={self.p95_ms:.2f}ms "
            f"p99={self.p99_ms:.2f}ms "
            f"throughput={self.images_per_sec:.0f} img/s"
        )

    @classmethod
    def from_times(cls, times_s, images) -> "StepStats":
        """Percentile stats over raw per-step durations (seconds) and the
        images each step processed."""
        times = np.asarray(list(times_s), np.float64)
        if times.size == 0:
            return cls(steps=0, mean_ms=0.0, p50_ms=0.0, p95_ms=0.0,
                       p99_ms=0.0, total_s=0.0, images_per_sec=0.0)
        total = float(times.sum())
        n_images = float(np.sum(images))
        return cls(
            steps=int(times.size),
            mean_ms=float(times.mean() * 1e3),
            p50_ms=float(np.percentile(times, 50) * 1e3),
            p95_ms=float(np.percentile(times, 95) * 1e3),
            p99_ms=float(np.percentile(times, 99) * 1e3),
            total_s=total,
            images_per_sec=n_images / total if total else 0.0,
        )


class StepTimer:
    """Per-step wall-clock timer. A "step" is one timed unit — the trainers
    time each span of ``k`` train steps as one step and pass its image
    count. The caller closes each ``step()`` with :func:`barrier`."""

    def __init__(self):
        self._times: list[float] = []
        self._images: list[int] = []

    @contextlib.contextmanager
    def step(self, images: int):
        t0 = time.perf_counter()
        yield
        self._times.append(time.perf_counter() - t0)
        self._images.append(images)

    @property
    def total_s(self) -> float:
        return float(sum(self._times))

    @property
    def total_images(self) -> int:
        return int(sum(self._images))

    def stats(self) -> StepStats:
        return StepStats.from_times(self._times, self._images)
