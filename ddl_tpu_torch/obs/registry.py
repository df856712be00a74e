"""Metric registry — the port of ``ddl_tpu/obs/registry.py``: counters,
gauges and histograms with label sets, Prometheus semantics.

- **Counter**: a monotonically increasing total (``inc``; a negative
  increment raises).
- **Gauge**: the last written value (``set``).
- **Histogram**: the raw samples of each label set; percentiles come from
  the raw samples with ``StepStats.from_times``'s definition (``stats()``
  delegates to it), so a histogram of step durations and a ``StepTimer`` of
  the same brackets agree.

Each distinct ``**labels`` dict (order-insensitive, values stringified) is
its own series under the metric name; one name registered as two kinds
raises. Two exports: :meth:`MetricRegistry.prometheus_text` (the text
exposition, byte-identical to JAX's for the same recorded sequence) and
:class:`MetricsWriter`, the JSONL sink behind ``--metrics-out``, whose FIRST
record is a run manifest (:func:`run_manifest`: torch and CUDA versions,
the device's name and power limit, the grid's shape, the config, the git
sha), then one snapshot a flush.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

from ..utils.metrics import StepStats


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(value: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double-quote and newline must be escaped or a value containing any
    of them silently corrupts the scrape. Order matters — backslash
    first, or the other escapes' backslashes double."""
    return (value.replace("\\", r"\\")
            .replace('"', r"\"")
            .replace("\n", r"\n"))


class NoSamplesError(LookupError):
    """``Histogram.percentile`` was asked about a label set that holds
    no samples — an empty registry, or a label set that was never
    observed (a typo'd label must not read 0.0)."""


class _Metric:
    kind = "?"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def label_sets(self) -> list[dict]:
        return [dict(k) for k in self._series]


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {value}); "
                "use a gauge for values that go down"
            )
        k = _label_key(labels)
        self._series[k] = self._series.get(k, 0) + value

    def value(self, **labels):
        return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = value

    def value(self, **labels):
        return self._series.get(_label_key(labels))


class Histogram(_Metric):
    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        self._series.setdefault(_label_key(labels), []).append(float(value))

    def observe_many(self, values, **labels) -> None:
        self._series.setdefault(_label_key(labels), []).extend(
            float(v) for v in values
        )

    def values(self, **labels) -> list[float]:
        return list(self._series.get(_label_key(labels), ()))

    def values_since(self, start: int, **labels) -> tuple[int, list[float]]:
        """``(total_count, samples[start:])`` for one label set — the
        incremental consumer's read (obs.slo ticks every scheduler
        step; copying the WHOLE series each tick would be O(history),
        this copies only the tail)."""
        vals = self._series.get(_label_key(labels), ())
        return len(vals), list(vals[start:])

    def count(self, **labels) -> int:
        return len(self._series.get(_label_key(labels), ()))

    def percentile(self, q: float, **labels) -> float:
        """Raw-unit percentile over the observed samples —
        ``np.percentile``'s linear interpolation, the SAME definition
        ``StepStats.from_times`` uses (parity pinned in test_obs).
        Raises :class:`NoSamplesError` when the label set holds no
        samples — a percentile of nothing is a question error, not 0.0
        (``stats()`` keeps its zero-filled ``StepStats`` contract for
        aggregate reporting)."""
        vals = self._series.get(_label_key(labels))
        if not vals:
            raise NoSamplesError(
                f"histogram {self.name!r} has no samples for label set "
                f"{dict(labels)!r} (observed label sets: "
                f"{self.label_sets()!r})"
            )
        return float(np.percentile(np.asarray(vals, np.float64), q))

    def stats(self, **labels) -> StepStats:
        """The observed samples as a ``StepStats`` (ms percentiles for
        second-valued observations) — DELEGATES to
        ``StepStats.from_times`` so the two percentile surfaces are one
        computation."""
        return StepStats.from_times(self.values(**labels))


class MetricRegistry:
    """Name -> metric map with kind checking. ``counter``/``gauge``/
    ``histogram`` create on first use and return the existing instance
    after (same-name re-registration with a different kind raises)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif type(m) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def get(self, name: str) -> _Metric | None:
        """NON-creating lookup: read-only consumers — the
        ``/healthz`` goodput summary, probes — must never materialize
        an empty series just by asking (the create-on-first-use
        accessors above are for writers)."""
        return self._metrics.get(name)

    def metrics(self) -> list[_Metric]:
        return [self._metrics[n] for n in sorted(self._metrics)]

    # -- exports -----------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """One plain-dict record per (metric, label set). Counters and
        gauges carry ``value``; histograms carry count/sum/mean and
        raw-unit p50/p95/p99 (linear interpolation — the from_times
        definition)."""
        out = []
        for m in self.metrics():
            for lk in sorted(m._series):
                rec = {"name": m.name, "kind": m.kind, "labels": dict(lk)}
                state = m._series[lk]
                if m.kind == "histogram":
                    a = np.asarray(state, np.float64)
                    rec.update(
                        count=int(a.size),
                        sum=float(a.sum()),
                        mean=float(a.mean()) if a.size else 0.0,
                        p50=float(np.percentile(a, 50)) if a.size else 0.0,
                        p95=float(np.percentile(a, 95)) if a.size else 0.0,
                        p99=float(np.percentile(a, 99)) if a.size else 0.0,
                    )
                else:
                    rec["value"] = state
                out.append(rec)
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the current state (histograms
        as summaries: quantile rows + ``_sum``/``_count``)."""

        def fmt_labels(labels: dict, extra: dict | None = None) -> str:
            items = {**labels, **(extra or {})}
            if not items:
                return ""
            body = ",".join(
                f'{k}="{_escape_label_value(str(v))}"'
                for k, v in sorted(items.items())
            )
            return "{" + body + "}"

        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            kind = "summary" if m.kind == "histogram" else m.kind
            lines.append(f"# TYPE {m.name} {kind}")
            for lk in sorted(m._series):
                labels = dict(lk)
                state = m._series[lk]
                if m.kind == "histogram":
                    a = np.asarray(state, np.float64)
                    for q in (0.5, 0.95, 0.99):
                        v = float(np.percentile(a, q * 100)) if a.size else 0.0
                        lines.append(
                            f"{m.name}{fmt_labels(labels, {'quantile': q})}"
                            f" {v}"
                        )
                    lines.append(
                        f"{m.name}_sum{fmt_labels(labels)} {float(a.sum())}"
                    )
                    lines.append(
                        f"{m.name}_count{fmt_labels(labels)} {int(a.size)}"
                    )
                else:
                    lines.append(f"{m.name}{fmt_labels(labels)} {state}")
        return "\n".join(lines) + "\n"


# -- run manifest ------------------------------------------------------------


def _git_sha() -> str | None:
    try:
        import subprocess

        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo, timeout=5,
            capture_output=True, text=True,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:  # noqa: BLE001 — no git is a fine answer
        return None


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first line), or
    None without a card or the tool: a card may be set below its maximum
    power and then runs slower, so every reading carries it."""
    try:
        import subprocess

        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], timeout=10, capture_output=True, text=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _mesh_shape(grid) -> dict:
    """The axes of JAX's mesh for this grid (``make_mesh_2d`` / ``_3d`` /
    ``_4d``: dp and sp always, tp at tp > 1, pp at pp > 1 with tp)."""
    shape = {"dp": grid.data_parallel, "sp": grid.num_workers}
    if grid.tensor_parallel > 1 or grid.pipeline_parallel > 1:
        shape["tp"] = grid.tensor_parallel
    if grid.pipeline_parallel > 1:
        shape["pp"] = grid.pipeline_parallel
    return shape


def run_manifest(config=None, mesh=None, extra: dict | None = None) -> dict:
    """Reproducibility header for a metrics file: versions, the device,
    topology, config, git sha. JAX's keys and ``schema``; in place of the
    jax/jaxlib versions, ``torch_version``, ``cuda_version`` (None on a
    CPU build), ``device_name`` and ``power_limit`` (None without a card).
    ``mesh`` is the trainer's ``parallel.mesh.Grid``. Every field degrades
    to None instead of raising: a manifest must never kill a run."""
    man: dict = {"schema": "ddl_tpu.metrics.v1"}
    try:
        import torch

        man["torch_version"] = torch.__version__
        man["cuda_version"] = torch.version.cuda
        cuda = torch.cuda.is_available()
        man["platform"] = "gpu" if cuda else "cpu"
        man["device_count"] = torch.cuda.device_count() if cuda else 1
        man["device_name"] = torch.cuda.get_device_name(0) if cuda else None
        import torch.distributed as dist

        man["process_index"] = dist.get_rank() if dist.is_initialized() else 0
    except Exception:  # noqa: BLE001
        man["torch_version"] = None
    man["power_limit"] = power_limit()
    if mesh is not None:
        man["mesh_shape"] = _mesh_shape(mesh)
    if config is not None:
        man["config"] = (
            dataclasses.asdict(config)
            if dataclasses.is_dataclass(config) else config
        )
    man["git_sha"] = _git_sha()
    man["pid"] = os.getpid()
    man["argv"] = list(sys.argv)
    man["python"] = sys.version.split()[0]
    man["t_wall"] = time.time()
    if extra:
        man.update(extra)
    return man


class MetricsWriter:
    """The JSONL sink behind ``--metrics-out``: manifest record first
    (``{"record": "manifest", ...}``), then one
    ``{"record": "snapshot", "t_wall", "t_mono", "metrics": [...]}``
    per flush. ``maybe_flush()`` is rate-limited by ``interval_s`` (the
    trainer loops call it freely); ``flush(force=True)`` and ``close()``
    always write, so the file ends with a complete final state on any
    clean exit path."""

    def __init__(self, path, registry: MetricRegistry, manifest: dict |
                 None = None, *, interval_s: float = 10.0):
        self.registry = registry
        self.interval_s = interval_s
        self._last = float("-inf")
        path = os.fspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file = open(path, "w")
        rec = {"record": "manifest", **(manifest or run_manifest())}
        self._file.write(json.dumps(rec, default=str) + "\n")
        self._file.flush()

    def maybe_flush(self, force: bool = False) -> bool:
        if self._file is None:
            return False
        now = time.monotonic()
        if not force and now - self._last < self.interval_s:
            return False
        self._last = now
        self._file.write(json.dumps({
            "record": "snapshot",
            "t_wall": time.time(),
            "t_mono": time.perf_counter(),
            "metrics": self.registry.snapshot(),
        }) + "\n")
        self._file.flush()
        return True

    def close(self) -> None:
        if self._file is not None:
            self.maybe_flush(force=True)
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
