"""Streaming SLO evaluation — the port of ``ddl_tpu/obs/slo.py`` (pure
host logic, JAX's whole module): multi-window burn-rate monitors over the
metric registry.

An :class:`SloRule` names a bad-event stream in the registry: a latency
histogram whose samples above ``target_s`` are misses (histogram mode), or
a counter of bad events over a counter of attempts (counter mode). The burn
rate over a window of W ticks is ``(misses / events) / (1 - objective)``; an
alert fires when the fast and the slow window both reach ``threshold``,
edge-triggered (``slo_alerts_total{rule=}``, an ``slo_alert`` trace event;
``slo_burn_rate{rule=,window=}`` gauges every tick). The same streams fire
on the same ticks as JAX's. Its consumers (the serve scheduler's and the
router's ticks, ``--slo-rules``) come with the rest of serving.
"""

from __future__ import annotations

import collections
import dataclasses

from .registry import MetricRegistry
from .trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One burn-rate rule (module docstring). Exactly one of
    ``target_s`` (histogram mode) and ``total_metric`` (counter mode)
    must be set. ``labels`` selects ONE series of the metric (and of
    ``total_metric`` in counter mode) — a dict is accepted and
    normalized to a sorted tuple so rules stay hashable."""

    name: str
    metric: str
    target_s: float | None = None
    total_metric: str | None = None
    objective: float = 0.9
    fast_window: int = 8
    slow_window: int = 32
    threshold: float = 1.0
    labels: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        if isinstance(self.labels, dict):
            object.__setattr__(self, "labels", tuple(
                sorted((str(k), str(v)) for k, v in self.labels.items())
            ))
        if not self.name:
            raise ValueError("SloRule needs a non-empty name")
        if (self.target_s is None) == (self.total_metric is None):
            raise ValueError(
                f"rule {self.name!r}: set exactly one of target_s "
                "(histogram mode: latency samples above the target are "
                "misses) and total_metric (counter mode: metric counts "
                "bad events, total_metric the attempts)"
            )
        if self.target_s is not None and self.target_s <= 0:
            raise ValueError(
                f"rule {self.name!r}: target_s must be > 0 seconds, got "
                f"{self.target_s}"
            )
        if not 0.0 <= self.objective < 1.0:
            raise ValueError(
                f"rule {self.name!r}: objective must be in [0, 1), got "
                f"{self.objective} (1.0 leaves a zero error budget — "
                "every miss would burn infinitely)"
            )
        if not 1 <= self.fast_window < self.slow_window:
            raise ValueError(
                f"rule {self.name!r}: need 1 <= fast_window < "
                f"slow_window, got {self.fast_window}/{self.slow_window}"
            )
        if self.threshold <= 0:
            raise ValueError(
                f"rule {self.name!r}: threshold must be > 0, got "
                f"{self.threshold}"
            )

    @property
    def label_dict(self) -> dict:
        return dict(self.labels)

    @property
    def budget(self) -> float:
        """The error budget: the miss fraction the objective allows."""
        return 1.0 - self.objective


class _RuleState:
    """Streaming state of one rule: the bounded history of cumulative
    ``(misses, total)`` pairs (one per tick, plus the attach-time
    baseline at index 0 — window deltas subtract pairs, so only
    ``slow_window + 1`` entries ever matter), the histogram scan
    position, and the edge-trigger latch."""

    def __init__(self, slow_window: int):
        self.history: collections.deque = collections.deque(
            maxlen=slow_window + 1
        )
        self.seen = 0  # histogram samples already classified
        self.misses = 0  # cumulative histogram misses
        self.firing = False
        self.alerts = 0
        self.fired_ticks: list[int] = []


class SloMonitor:
    """Evaluates ``rules`` against ``registry`` once per
    :meth:`tick` — the scheduler/router call it at their own tick
    boundary, so a "window" is a window of scheduler ticks (the
    deterministic clock that makes the burst-alert scenario replayable;
    wall-clock windows would make alerts host-noise-dependent).

    Emits into the SAME registry it reads: ``slo_burn_rate{rule=,
    window=fast|slow}`` gauges every tick, ``slo_alerts_total{rule=}``
    on each entry into the alerting state, plus an ``slo_alert`` tracer
    event. ``tracer`` is a plain attribute so the serve CLI can attach
    the run-scoped tracer after construction."""

    def __init__(self, rules, registry: MetricRegistry, tracer=None):
        rules = tuple(rules)
        if not rules:
            raise ValueError("SloMonitor needs at least one rule")
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names in {names}")
        if registry is None:
            raise ValueError(
                "SloMonitor needs the MetricRegistry it evaluates "
                "against (and emits slo_* metrics into)"
            )
        self.rules = rules
        self.registry = registry
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.ticks = 0
        self._state = {r.name: _RuleState(r.slow_window) for r in rules}
        for rule in rules:
            st = self._state[rule.name]
            # Attach-time baseline: events that happened before the
            # monitor existed are history, not budget burn.
            st.history.append(self._read(rule, st))

    # -- reading the registry ----------------------------------------------

    def _read(self, rule: SloRule, st: _RuleState) -> tuple[int, int]:
        """Current cumulative ``(misses, total)`` for one rule. The
        registry's create-on-first-use semantics make a not-yet-touched
        metric an empty series (0, 0) — and a NAME collision with the
        wrong kind a loud ValueError at the first tick."""
        labels = rule.label_dict
        if rule.target_s is not None:
            h = self.registry.histogram(rule.metric)
            total, new = h.values_since(st.seen, **labels)
            st.seen = total
            st.misses += sum(1 for v in new if v > rule.target_s)
            return st.misses, total
        bad = self.registry.counter(rule.metric).value(**labels)
        total = self.registry.counter(rule.total_metric).value(**labels)
        return int(bad), int(total)

    @staticmethod
    def _window_burn(rule: SloRule, history, window: int) -> float:
        """Burn rate over the last ``window`` ticks of ``history``
        (cumulative pairs; earlier-than-recorded clamps to the
        baseline). Zero events in the window burns 0.0."""
        i = max(0, len(history) - 1 - window)
        m0, t0 = history[i]
        m1, t1 = history[-1]
        total = t1 - t0
        if total <= 0:
            return 0.0
        return ((m1 - m0) / total) / rule.budget

    # -- the tick ----------------------------------------------------------

    def tick(self) -> list[str]:
        """Advance every rule one window step; returns the rules that
        ENTERED the alerting state this tick."""
        self.ticks += 1
        burn_g = self.registry.gauge(
            "slo_burn_rate",
            "error-budget burn rate per rule and window (1.0 = on "
            "budget)",
        )
        entered = []
        for rule in self.rules:
            st = self._state[rule.name]
            st.history.append(self._read(rule, st))
            fast = self._window_burn(rule, st.history, rule.fast_window)
            slow = self._window_burn(rule, st.history, rule.slow_window)
            burn_g.set(fast, rule=rule.name, window="fast")
            burn_g.set(slow, rule=rule.name, window="slow")
            firing = fast >= rule.threshold and slow >= rule.threshold
            if firing and not st.firing:
                st.alerts += 1
                st.fired_ticks.append(self.ticks)
                entered.append(rule.name)
                self.registry.counter(
                    "slo_alerts_total",
                    "entries into the alerting state per rule",
                ).inc(rule=rule.name)
                # The /healthz goodput summary
                # reads this non-creatingly — probes see "when did an
                # alert last fire" without scraping /metrics.
                self.registry.gauge(
                    "slo_last_alert_tick",
                    "monitor tick of the most recent alert entry per "
                    "rule",
                ).set(self.ticks, rule=rule.name)
                if self.tracer:
                    self.tracer.event(
                        "slo_alert", rule=rule.name, tick=self.ticks,
                        fast_burn=fast, slow_burn=slow,
                    )
            st.firing = firing
        return entered

    # -- introspection ------------------------------------------------------

    def burn_rate(self, name: str, window: str = "fast") -> float:
        if window not in ("fast", "slow"):
            raise ValueError(
                f"window must be 'fast' or 'slow', got {window!r}"
            )
        rule = self._rule(name)
        w = rule.fast_window if window == "fast" else rule.slow_window
        return self._window_burn(rule, self._state[name].history, w)

    def cumulative(self, name: str) -> tuple[int, int]:
        """Cumulative ``(misses, total)`` as of the last tick — the
        quantity the brute-force ``request_slo_samples`` pin recounts."""
        return self._state[name].history[-1]

    def alerts(self, name: str) -> int:
        return self._state[name].alerts

    def fired_ticks(self, name: str) -> list[int]:
        """Monitor tick indices at which ``name`` entered the alerting
        state — the determinism pin compares these across runs."""
        return list(self._state[name].fired_ticks)

    @property
    def alerting(self) -> set[str]:
        return {n for n, st in self._state.items() if st.firing}

    def _rule(self, name: str) -> SloRule:
        for r in self.rules:
            if r.name == name:
                return r
        raise KeyError(f"no SLO rule named {name!r} "
                       f"(rules: {[r.name for r in self.rules]})")


# -- CLI spec grammar ---------------------------------------------------------


_RULE_KEYS = ("metric", "target", "total", "objective", "fast", "slow",
              "threshold")


def parse_slo_rules(spec: str) -> tuple[SloRule, ...]:
    """``--slo-rules`` grammar -> :class:`SloRule` tuple. Segments are
    ``;``-separated ``NAME:key=val,...`` with keys ``metric``
    (required), ``target`` (seconds — histogram mode), ``total``
    (counter mode denominator), ``objective``, ``fast``/``slow``
    (window ticks), ``threshold``, and ``label.K=V`` (repeatable)
    series selectors. The rules read the registry the monitor is built
    on: single-engine serve publishes the ``serve_*`` histograms there,
    while under ``--replicas`` those land in per-replica registries —
    router-mode histogram rules must target
    ``router_ttft_seconds`` + ``label.class=...`` (observed live per
    global tick) and counter rules the ``router_*_total`` counters.
    Example::

        bulk_shed:metric=router_shed_total,total=router_requests_total,\
label.class=bulk,objective=0.5,fast=4,slow=8;\
chat_ttft:metric=router_ttft_seconds,label.class=chat,target=0.5
    """
    rules = []
    for seg in spec.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        name, colon, body = seg.partition(":")
        name = name.strip()
        if not colon or not body:
            raise ValueError(
                f"slo rule segment {seg!r} needs NAME:key=val[,...]"
            )
        kw: dict = {"name": name}
        labels: dict = {}
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq:
                raise ValueError(
                    f"rule {name!r}: bad key {part!r} (expected key=val)"
                )
            if key.startswith("label."):
                labels[key[len("label."):]] = val.strip()
            elif key == "metric":
                kw["metric"] = val.strip()
            elif key == "target":
                kw["target_s"] = float(val)
            elif key == "total":
                kw["total_metric"] = val.strip()
            elif key == "objective":
                kw["objective"] = float(val)
            elif key == "fast":
                kw["fast_window"] = int(val)
            elif key == "slow":
                kw["slow_window"] = int(val)
            elif key == "threshold":
                kw["threshold"] = float(val)
            else:
                raise ValueError(
                    f"rule {name!r}: unknown key {key!r} (valid: "
                    f"{list(_RULE_KEYS)} and label.K)"
                )
        if "metric" not in kw:
            raise ValueError(f"rule {name!r}: metric= is required")
        if labels:
            kw["labels"] = labels
        rules.append(SloRule(**kw))
    if not rules:
        raise ValueError(f"--slo-rules spec {spec!r} declares no rules")
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO rule names in {names}")
    return tuple(rules)


__all__ = [
    "SloRule",
    "SloMonitor",
    "parse_slo_rules",
]
