"""Device memory watermarks and compile-activity counters — the port of
``ddl_tpu/obs/memory.py``.

- **Memory watermarks**: :func:`device_memory_stats` maps the caching
  allocator's ``torch.cuda.memory_stats`` and CUDA's
  ``torch.cuda.mem_get_info`` onto JAX's PJRT keys: ``bytes_in_use``
  (``allocated_bytes.all.current``), ``peak_bytes_in_use``
  (``allocated_bytes.all.peak``, what ``torch.cuda.max_memory_allocated``
  reads) and ``bytes_limit`` (the card's total memory), sampled into the
  ``device_memory_bytes_in_use`` / ``device_memory_peak_bytes`` /
  ``device_memory_bytes_limit`` gauges. These are host queries of
  allocator state, no device sync. The CPU has no such counters: the
  sampler probes once and latches off, as JAX's does on XLA:CPU.
- **Compile activity**: ``xla_compiles_total{kind=}`` and
  ``xla_compile_seconds`` keep JAX's names. The port compiles nothing
  ahead of time; its "compile" is the warm-up call of a span program (the
  kernels' first launch, cuBLAS and cuDNN plan selection, the
  communicators' set-up), which the trainers run outside the clock where
  JAX's compile.
"""

from __future__ import annotations


def device_memory_stats(device) -> dict | None:
    """JAX's ``memory_stats()`` keys for a CUDA ``device``; None on the CPU
    or on any failure (no data is never an exception on the metrics
    path)."""
    import torch

    try:
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
    except Exception:  # noqa: BLE001 — an unsupported backend is a fine answer
        return None
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}


class MemorySampler:
    """Samples memory watermark gauges for ``devices`` into ``registry``.
    The first sample that finds NO device reporting stats latches the
    sampler off (``supported = False``), so the CPU pays one probe."""

    def __init__(self, registry, devices):
        self.registry = registry
        self.devices = list(devices)
        self.supported: bool | None = None  # None = not yet probed

    def sample(self) -> bool:
        """Record current watermarks; returns True when any device
        reported. No-op (False) once latched unsupported."""
        if self.supported is False:
            return False
        any_stats = False
        for i, dev in enumerate(self.devices):
            stats = device_memory_stats(dev)
            if stats is None:
                continue
            any_stats = True
            self.registry.gauge(
                "device_memory_bytes_in_use",
                "live allocator bytes per device",
            ).set(int(stats["bytes_in_use"]), device=i)
            self.registry.gauge(
                "device_memory_peak_bytes",
                "high-watermark allocator bytes per device",
            ).set(int(stats["peak_bytes_in_use"]), device=i)
            self.registry.gauge(
                "device_memory_bytes_limit",
                "allocator capacity per device",
            ).set(int(stats["bytes_limit"]), device=i)
        if self.supported is None:
            self.supported = any_stats
        return any_stats


def record_compile(registry, tracer, kind: str, *,
                   t0: float | None = None, t1: float | None = None,
                   **attrs) -> None:
    """Count one program warm-up (``xla_compiles_total{kind=}``, JAX's
    name) and trace it: a ``compile`` span when the caller measured the
    bracket, an instant event otherwise. ``registry``/``tracer`` may each
    be None/falsy: partial telemetry records what it can."""
    if registry is not None:
        registry.counter(
            "xla_compiles_total",
            "distinct span programs warmed up (the port's compiles: first "
            "kernel launches, cuBLAS/cuDNN plan selection), by kind",
        ).inc(kind=kind)
        if t0 is not None and t1 is not None:
            registry.histogram(
                "xla_compile_seconds",
                "wall seconds per measured program warm-up",
            ).observe(t1 - t0, kind=kind)
    if tracer:
        if t0 is not None and t1 is not None:
            tracer.complete("compile", t0, t1, kind=kind, **attrs)
        else:
            tracer.event("compile", kind=kind, **attrs)
