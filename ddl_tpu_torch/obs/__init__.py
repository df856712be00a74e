"""Observability — the port of ``ddl_tpu/obs``: the telemetry every
trainer reports through.

- :mod:`.registry`: counters, gauges and histograms with label sets, the
  JSONL ``MetricsWriter`` (run manifest first) and the Prometheus text
  exposition;
- :mod:`.trace`: nestable host wall-clock spans and instant events as
  JSONL, their Chrome/Perfetto conversion, and ``trace_context`` (the host
  tracer with the ``torch.profiler`` trace, ``utils.metrics.trace``);
- :mod:`.health`: in-step health signals (grad, param and update norms,
  non-finite counts), device tensors summed over each leaf's partition
  groups;
- :mod:`.cost`: analytic FLOPs (JAX's integers), the device peak table and
  ``mfu``;
- :mod:`.memory`: device memory watermarks and the compile counters;
- :mod:`.goodput`: per-phase wall-time attribution;
- :mod:`.comms`: the per-program collective ledger from the collective
  call sites' tally, the interconnect roofline;
- :mod:`.anomaly`, :mod:`.slo`: streaming robust-z anomaly detection and
  burn-rate SLO monitors (host logic);
- :mod:`.export`: the ``/metrics`` + ``/healthz`` pull endpoint;
- :mod:`.analyze`: the offline ``report``, ``comms`` and ``compare`` CLI
  over either package's traces and metrics files (``python -m
  ddl_tpu_torch.obs.analyze``).

The CLI surfaces it through ``--metrics-out``, ``--metrics-interval``,
``--trace-dir``, ``--profile``, ``--prom-port``, ``--peak-flops``,
``--ici-bw`` and ``--anomaly-rules`` on every training variant, and all
but ``--profile`` plus ``--slo-rules`` on serve, where the scheduler (or
the router) takes the writer, the SLO monitor and the anomaly detector.
"""

from .registry import (  # noqa: F401
    MetricRegistry,
    MetricsWriter,
    NoSamplesError,
    run_manifest,
)
from .trace import NULL_TRACER, Tracer, trace_context  # noqa: F401
