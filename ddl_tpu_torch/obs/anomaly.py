"""Streaming anomaly detection — the port of ``ddl_tpu/obs/anomaly.py``
(pure host logic, JAX's whole module): rolling median/MAD baselines on the
deterministic tick clock.

The robust-z test: the last ``window`` samples of a signal are its
baseline; the current sample is scored BEFORE it joins the window;
``z = (x - median) / max(1.4826 * MAD, min_scale)`` (``min_scale`` floors a
constant baseline's zero MAD); ``direction`` gates which tail alarms
(``high``, ``low`` or ``both``). Firing is edge-triggered: entry into the
anomalous state increments ``anomaly_total{signal=}``, stamps
``anomaly_last_tick{signal=}`` and traces an ``anomaly`` event;
``anomaly_z{signal=}`` updates every scored tick. The same value stream
fires on the same ticks as JAX's. The trainers feed ``step_time`` and
``mfu`` once a span; a loop built without a detector makes no
``anomaly_*`` metric.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics

from .registry import MetricRegistry
from .trace import NULL_TRACER

_DIRECTIONS = ("high", "low", "both")


@dataclasses.dataclass(frozen=True)
class AnomalyRule:
    """One monitored signal (module docstring). ``signal`` names the
    per-tick value the feeding loop publishes (see the loop's
    docstring for its vocabulary); ``window`` bounds the baseline,
    ``min_history`` is how many baseline samples must exist before
    anything can fire (a cold baseline flags nothing), ``threshold``
    the robust-z magnitude that alarms, ``min_scale`` the MAD floor."""

    signal: str
    window: int = 32
    min_history: int = 8
    threshold: float = 6.0
    direction: str = "both"
    min_scale: float = 1e-9

    def __post_init__(self):
        if not self.signal:
            raise ValueError("AnomalyRule needs a non-empty signal name")
        if self.window < 2:
            raise ValueError(
                f"signal {self.signal!r}: window must be >= 2, got "
                f"{self.window}"
            )
        if not 1 <= self.min_history <= self.window:
            raise ValueError(
                f"signal {self.signal!r}: need 1 <= min_history <= "
                f"window, got {self.min_history}/{self.window}"
            )
        if self.threshold <= 0:
            raise ValueError(
                f"signal {self.signal!r}: threshold must be > 0, got "
                f"{self.threshold}"
            )
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                f"signal {self.signal!r}: direction must be one of "
                f"{_DIRECTIONS}, got {self.direction!r}"
            )
        if self.min_scale <= 0:
            raise ValueError(
                f"signal {self.signal!r}: min_scale must be > 0, got "
                f"{self.min_scale}"
            )


class _SignalState:
    def __init__(self, window: int):
        self.history: collections.deque = collections.deque(maxlen=window)
        self.firing = False
        self.alerts = 0
        self.fired_ticks: list[int] = []
        self.last_z = 0.0


class AnomalyDetector:
    """Scores ``rules`` against the per-tick ``values`` dict the owning
    loop passes to :meth:`tick` — one call per scheduler/router/trainer
    tick, the deterministic clock. A declared signal absent from a
    tick's values is simply not scored that tick (ITL does not exist on
    an idle tick). Emits into (and is validated against) the SAME
    registry the loop publishes its other metrics to; ``tracer`` is a
    plain attribute so the CLI can attach the run-scoped tracer after
    construction."""

    def __init__(self, rules, registry: MetricRegistry, tracer=None):
        rules = tuple(rules)
        if not rules:
            raise ValueError("AnomalyDetector needs at least one rule")
        names = [r.signal for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate anomaly signal names in {names}")
        if registry is None:
            raise ValueError(
                "AnomalyDetector needs the MetricRegistry it emits "
                "anomaly_* metrics into"
            )
        self.rules = rules
        self.registry = registry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.ticks = 0
        self._state = {r.signal: _SignalState(r.window) for r in rules}

    def tick(self, values: dict) -> list[str]:
        """Score one tick's signals; returns the signals that ENTERED
        the anomalous state this tick."""
        self.ticks += 1
        entered: list[str] = []
        z_gauge = None
        for rule in self.rules:
            if rule.signal not in values:
                continue
            x = float(values[rule.signal])
            st = self._state[rule.signal]
            fire = False
            z = 0.0
            if len(st.history) >= rule.min_history:
                med = statistics.median(st.history)
                mad = statistics.median(abs(h - med) for h in st.history)
                scale = max(1.4826 * mad, rule.min_scale)
                z = (x - med) / scale
                dev = (z if rule.direction == "high"
                       else -z if rule.direction == "low" else abs(z))
                fire = dev >= rule.threshold
                st.last_z = z
                if z_gauge is None:
                    z_gauge = self.registry.gauge(
                        "anomaly_z",
                        "robust z-score of the last scored sample per "
                        "signal",
                    )
                z_gauge.set(z, signal=rule.signal)
                if fire and not st.firing:
                    st.alerts += 1
                    st.fired_ticks.append(self.ticks)
                    entered.append(rule.signal)
                    self.registry.counter(
                        "anomaly_total",
                        "entries into the anomalous state per signal",
                    ).inc(signal=rule.signal)
                    self.registry.gauge(
                        "anomaly_last_tick",
                        "detector tick of the most recent anomaly entry "
                        "per signal",
                    ).set(self.ticks, signal=rule.signal)
                    if self.tracer:
                        self.tracer.event(
                            "anomaly", signal=rule.signal, tick=self.ticks,
                            value=x, median=float(med), mad=float(mad),
                            z=float(z),
                        )
                st.firing = fire
            # Evaluate-then-insert: the sample joins the baseline only
            # after it was scored against it.
            st.history.append(x)
        return entered

    # -- introspection ------------------------------------------------------

    def alerts(self, signal: str) -> int:
        return self._st(signal).alerts

    def fired_ticks(self, signal: str) -> list[int]:
        """Detector tick indices at which ``signal`` entered the
        anomalous state — the determinism pin compares these across
        fresh runs."""
        return list(self._st(signal).fired_ticks)

    def baseline(self, signal: str) -> tuple[float, float]:
        """Current ``(median, mad)`` of the signal's rolling window
        (``(0.0, 0.0)`` before any history)."""
        hist = self._st(signal).history
        if not hist:
            return 0.0, 0.0
        med = statistics.median(hist)
        return float(med), float(statistics.median(
            abs(h - med) for h in hist
        ))

    @property
    def anomalous(self) -> set[str]:
        return {n for n, st in self._state.items() if st.firing}

    def summary(self) -> dict:
        """JSON-able digest (the CLI surface): per-signal alert counts,
        fired ticks and the last z."""
        return {
            r.signal: {
                "alerts": self._state[r.signal].alerts,
                "fired_ticks": list(self._state[r.signal].fired_ticks),
                "last_z": self._state[r.signal].last_z,
            }
            for r in self.rules
        }

    def _st(self, signal: str) -> _SignalState:
        try:
            return self._state[signal]
        except KeyError:
            raise KeyError(
                f"no anomaly rule for signal {signal!r} "
                f"(rules: {[r.signal for r in self.rules]})"
            ) from None


# -- CLI spec grammar ---------------------------------------------------------

_RULE_KEYS = ("window", "min", "threshold", "direction", "scale")


def parse_anomaly_rules(spec: str) -> tuple[AnomalyRule, ...]:
    """``--anomaly-rules`` grammar -> :class:`AnomalyRule` tuple.
    Segments are ``;``-separated ``SIGNAL[:key=val,...]`` with keys
    ``window``, ``min`` (min_history), ``threshold``, ``direction``
    (high/low/both) and ``scale`` (min_scale). The signal names are the
    feeding loop's per-tick vocabulary — serve: ``step_time``, ``itl``,
    ``mfu``, ``queue_depth``, ``active_slots``, ``occupied_slots``,
    ``pages_free`` (paged only); router: ``backlog``, ``shed_rate``;
    trainers: ``step_time``, ``mfu``. Example::

        itl:window=32,threshold=8,direction=high;pages_free:direction=low
    """
    rules = []
    for seg in spec.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        name, _, body = seg.partition(":")
        name = name.strip()
        kw: dict = {"signal": name}
        for part in body.split(",") if body else []:
            part = part.strip()
            if not part:
                continue
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq:
                raise ValueError(
                    f"signal {name!r}: bad key {part!r} (expected key=val)"
                )
            if key == "window":
                kw["window"] = int(val)
            elif key == "min":
                kw["min_history"] = int(val)
            elif key == "threshold":
                kw["threshold"] = float(val)
            elif key == "direction":
                kw["direction"] = val.strip()
            elif key == "scale":
                kw["min_scale"] = float(val)
            else:
                raise ValueError(
                    f"signal {name!r}: unknown key {key!r} (valid: "
                    f"{list(_RULE_KEYS)})"
                )
        rules.append(AnomalyRule(**kw))
    if not rules:
        raise ValueError(f"--anomaly-rules spec {spec!r} declares no rules")
    names = [r.signal for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate anomaly signal names in {names}")
    return tuple(rules)


__all__ = [
    "AnomalyRule",
    "AnomalyDetector",
    "parse_anomaly_rules",
]
