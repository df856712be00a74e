"""Step timing — the port of ``ddl_tpu/utils/metrics.py``.

A steady-state step timer with percentile stats, and :func:`trace`, the
profiler bracket (``torch.profiler`` in place of ``jax.profiler``). On the
card, PyTorch returns before the device finishes, so every timed step
closes with :func:`barrier` (``torch.cuda.synchronize``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
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
    # Items per second: images for the CNN, tokens for the LM and serving.
    images_per_sec: float
    p99_ms: float = 0.0

    @property
    def tokens_per_sec(self) -> float:
        """``images_per_sec`` under its name for the LM and serving, which
        count tokens."""
        return self.images_per_sec

    def line(self, unit: str = "img/s") -> str:
        """One-line summary; ``unit`` labels the throughput column
        (``"tok/s"`` for the LM and serving)."""
        return (
            f"steps={self.steps} mean={self.mean_ms:.2f}ms "
            f"p50={self.p50_ms:.2f}ms p95={self.p95_ms:.2f}ms "
            f"p99={self.p99_ms:.2f}ms "
            f"throughput={self.images_per_sec:.0f} {unit}"
        )

    @classmethod
    def from_times(cls, times_s, images=None) -> "StepStats":
        """Percentile stats over raw per-event durations (seconds): timer
        brackets, or the serving TTFT and inter-token latencies.
        ``images`` optionally weights throughput; absent, throughput reads
        0 (a latency-only distribution)."""
        times = np.asarray(list(times_s), np.float64)
        if times.size == 0:
            return cls(steps=0, mean_ms=0.0, p50_ms=0.0, p95_ms=0.0,
                       p99_ms=0.0, total_s=0.0, images_per_sec=0.0)
        total = float(times.sum())
        n_images = float(np.sum(images)) if images is not None else 0.0
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
    """Per-step wall-clock timer with warm-up exclusion. A "step" is one
    timed unit: the trainers time each span of ``k`` train steps as one
    step and pass its image (or token) count. The caller closes each
    ``step()`` with :func:`barrier`. ``stats()`` leaves out the first
    ``warmup`` steps; ``total_s`` keeps them."""

    def __init__(self, batch_size: int | None = None, warmup: int = 0):
        self.batch_size = batch_size
        self.warmup = warmup
        self._times: list[float] = []
        self._images: list[int] = []

    @contextlib.contextmanager
    def step(self, images: int | None = None):
        t0 = time.perf_counter()
        yield
        self._times.append(time.perf_counter() - t0)
        self._images.append(images if images is not None else (self.batch_size or 0))

    def add(self, seconds: float, images: int = 0) -> None:
        """Record one step bracketed elsewhere (a caller that learns its
        item count only after the call)."""
        self._times.append(float(seconds))
        self._images.append(int(images))

    @property
    def total_s(self) -> float:
        """Total timed seconds, warm-up included (throughput accounting)."""
        return float(sum(self._times))

    @property
    def total_images(self) -> int:
        return int(sum(self._images))

    def stats(self) -> StepStats:
        return StepStats.from_times(self._times[self.warmup:], self._images[self.warmup:])


@contextlib.contextmanager
def trace(log_dir: str | None, device: torch.device | str | None = None):
    """``torch.profiler`` over the block, written as ONE Chrome trace into
    ``log_dir`` (``torch_profile_p<rank>.json``, viewable in Perfetto);
    a no-op when ``log_dir`` is None. CPU and CUDA activities on a card
    (``device`` cuda, or None with a card present), CPU alone otherwise.
    No stacks, shapes or memory records, so the bracket stays cheap. The
    trainers open it after their warm-up, as JAX's bracket opens after
    compilation."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from ..obs.trace import _process_index

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"torch_profile_p{_process_index()}.json"))
