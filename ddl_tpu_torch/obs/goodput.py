"""Goodput and wall-clock time attribution — the port of
``ddl_tpu/obs/goodput.py`` (pure host arithmetic, JAX's whole module).

Every second a run loop observes is assigned to exactly ONE phase,
published as gauges beside the MFU:

- ``time_in_seconds{phase=}``: cumulative seconds per phase,
- ``time_observed_seconds``: total bracketed wall time,
- ``goodput_fraction``: goodput phases over observed time.

The identity: phase times SUM to the observed wall time (float
re-association is the only slack). Trainer brackets are attributed whole
(a guarded span splits into ``compute`` + ``stall`` shares that sum back
exactly); a serve tick's residual lands in ``host`` or ``idle``.

Phases: ``train``: ``compute`` (span dispatch, the goodput), ``staging``
(host-to-device upload of the train set), ``compile`` (the warm-up calls,
the port's compiles), ``eval``, ``checkpoint_io``, ``stall`` (guard-skipped
step share and rollback restores). ``serve``: ``prefill`` + ``decode``
(the goodput), ``prefix_copy``, ``shed``, ``handoff``, ``idle``, ``host``.

Everything here is arithmetic on brackets the loops already close; with no
registry no tracker exists at all.
"""

from __future__ import annotations

import time

TRAIN_PHASES = ("compute", "staging", "compile", "eval", "checkpoint_io",
                "stall")
SERVE_PHASES = ("prefill", "decode", "prefix_copy", "shed", "handoff",
                "idle", "host")

# The phases that count as goodput — useful device work — per kind.
GOODPUT_PHASES = {
    "train": ("compute",),
    "serve": ("prefill", "decode"),
}

_PHASES = {"train": TRAIN_PHASES, "serve": SERVE_PHASES}


class GoodputTracker:
    """Accumulates the per-phase wall-clock decomposition of one run
    loop and publishes it as live gauges (module docstring).

    Two usage shapes, matching the two loop styles:

    - **Trainers** call :meth:`add` with whole brackets they already
      measure (span seconds, compile seconds, ...); the observed total
      is the sum of everything added.
    - **The serve scheduler** wraps each tick in :meth:`begin_tick` /
      :meth:`end_tick` and ``add``\\ s sub-brackets inside; ``end_tick``
      measures the tick wall time and files the residual under
      ``host`` (device work happened) or ``idle`` (it did not — only
      ``add(..., work=True)`` marks device work).
    """

    def __init__(self, registry, kind: str):
        if kind not in _PHASES:
            raise ValueError(
                f"kind must be one of {sorted(_PHASES)}, got {kind!r}"
            )
        if registry is None:
            raise ValueError(
                "GoodputTracker needs the MetricRegistry it publishes "
                "into (no registry -> no tracker: the off path makes no "
                "goodput gauges)"
            )
        self.kind = kind
        self.registry = registry
        self.phases: dict[str, float] = dict.fromkeys(_PHASES[kind], 0.0)
        self.observed_s = 0.0
        self._tick_t0: float | None = None
        self._tick_sub = 0.0
        self._tick_work = False

    # -- accumulation -------------------------------------------------------

    def add(self, phase: str, seconds: float, *, work: bool = True) -> None:
        """Attribute ``seconds`` to ``phase``. Inside a tick bracket the
        amount also counts toward the tick's measured sub-total (so the
        residual excludes it); ``work=False`` attributes time without
        marking the tick as having done device work (the shed sweep is
        bookkeeping, not goodput-adjacent activity)."""
        if phase not in self.phases:
            raise ValueError(
                f"unknown {self.kind} phase {phase!r} "
                f"(valid: {list(self.phases)})"
            )
        if seconds < 0:
            seconds = 0.0
        self.phases[phase] += seconds
        if self._tick_t0 is not None:
            self._tick_sub += seconds
            self._tick_work = self._tick_work or work
        else:
            # Outside a tick bracket (the trainer shape) every add IS
            # observed time — the identity's other half.
            self.observed_s += seconds

    def begin_tick(self) -> None:
        """Open the serve tick bracket (one ``perf_counter`` read)."""
        self._tick_sub = 0.0
        self._tick_work = False
        self._tick_t0 = time.perf_counter()

    def end_tick(self, publish: bool = True) -> float:
        """Close the tick bracket: measure the tick's wall time, file
        the residual (tick minus sub-brackets) under ``host``/``idle``,
        and publish the gauges. Returns the tick wall seconds."""
        if self._tick_t0 is None:
            raise RuntimeError("end_tick without begin_tick")
        t = time.perf_counter() - self._tick_t0
        self._tick_t0 = None
        resid = t - self._tick_sub
        if resid < 0:
            # Sub-brackets and the tick bracket read the same monotonic
            # clock in nested order, so a negative residual is float
            # noise at most — clamp, and keep the identity by observing
            # exactly what the phases hold.
            resid = 0.0
        self.phases["host" if self._tick_work else "idle"] += resid
        self.observed_s += self._tick_sub + resid
        if publish:
            self.publish()
        return t

    # -- the derived quantities ---------------------------------------------

    @property
    def total_s(self) -> float:
        """Sum of the phase times — equals :attr:`observed_s` up to
        float re-association (the pinned identity)."""
        return sum(self.phases.values())

    @property
    def goodput_s(self) -> float:
        return sum(self.phases[p] for p in GOODPUT_PHASES[self.kind])

    @property
    def goodput_fraction(self) -> float:
        tot = self.observed_s
        return self.goodput_s / tot if tot > 0 else 0.0

    def publish(self) -> None:
        """Set the three gauge surfaces from the current totals."""
        g = self.registry.gauge(
            "time_in_seconds",
            "cumulative observed wall seconds per attribution phase",
        )
        for phase, s in self.phases.items():
            g.set(s, phase=phase)
        self.registry.gauge(
            "time_observed_seconds",
            "total bracketed wall seconds the attribution covers",
        ).set(self.observed_s)
        self.registry.gauge(
            "goodput_fraction",
            "goodput phase seconds over observed seconds",
        ).set(self.goodput_fraction)

    def summary(self) -> dict:
        """JSON-able digest (the CLI / bench surface)."""
        return {
            "kind": self.kind,
            "observed_s": self.observed_s,
            "goodput_fraction": self.goodput_fraction,
            "phases_s": dict(self.phases),
        }


def attribute_train_span(tracker: GoodputTracker, span_s: float,
                         compile_in_span: float, n_skip: int,
                         k: int) -> None:
    """File one dispatched train span's bracket — the ONE copy of the
    split both span trainers share (a one-trainer edit must not let
    the other's pinned identity silently diverge). Any compile that
    ran INSIDE the bracket (a guard-rollback realignment build) was
    already attributed under ``compile`` and is carved out; the
    remaining work splits into ``compute`` plus the guard-skipped
    share as ``stall``. The shares sum back EXACTLY
    (``a + (b - a) == b``) — the pinned identity — and in the
    AOT-precompiled steady state ``compile_in_span`` is 0.0, so
    ``compute`` equals the StepTimer bracket to the float."""
    span_compile = min(max(compile_in_span, 0.0), span_s)
    work_s = span_s - span_compile
    stall_s = work_s * (n_skip / k) if n_skip else 0.0
    tracker.add("stall", stall_s)
    tracker.add("compute", work_s - stall_s)
    tracker.publish()


def goodput_summary(registry) -> dict:
    """Compact probe digest read NON-CREATINGLY from a registry (the
    ``/healthz`` surface): current
    ``goodput_fraction``, the last anomaly tick (max over
    ``anomaly_last_tick{signal=}``), cumulative anomaly count, and the
    last SLO alert tick when present. Missing metrics are simply
    absent — a train run without a detector reports only its fraction,
    and reading never mutates the registry (``MetricRegistry.get``)."""
    out: dict = {}
    g = registry.get("goodput_fraction")
    if g is not None and g.kind == "gauge":
        v = g.value()
        if v is not None:
            out["goodput_fraction"] = v
    last = registry.get("anomaly_last_tick")
    if last is not None and last.kind == "gauge":
        ticks = [last.value(**ls) for ls in last.label_sets()]
        ticks = [t for t in ticks if t is not None]
        if ticks:
            out["last_anomaly_tick"] = int(max(ticks))
    tot = registry.get("anomaly_total")
    if tot is not None and tot.kind == "counter":
        out["anomalies_total"] = int(sum(
            tot.value(**ls) for ls in tot.label_sets()
        ))
    alert = registry.get("slo_last_alert_tick")
    if alert is not None and alert.kind == "gauge":
        ticks = [alert.value(**ls) for ls in alert.label_sets()]
        ticks = [t for t in ticks if t is not None]
        if ticks:
            out["last_slo_alert_tick"] = int(max(ticks))
    return out


def fleet_summary(registry) -> dict:
    """Compact fleet digest read NON-CREATINGLY from a registry (the
    ``/healthz`` surface — same
    ``MetricRegistry.get`` pattern as :func:`goodput_summary`):
    replicas active/draining, the last scale-event tick, and the
    cumulative preemption count. Missing metrics are simply absent — a
    run without a fleet controller reports nothing here, and reading
    never mutates the registry."""
    out: dict = {}
    for key, name in (("replicas_active", "fleet_replicas_active"),
                      ("replicas_draining", "fleet_replicas_draining"),
                      ("last_scale_tick", "fleet_last_scale_tick")):
        g = registry.get(name)
        if g is not None and g.kind == "gauge":
            v = g.value()
            if v is not None:
                out[key] = int(v)
    g = registry.get("fleet_replicas_active")
    if g is not None and g.kind == "gauge":
        # Per-role replica counts: the disagg coordinator /
        # controller publish `fleet_replicas_active{role=}` next to the
        # unlabeled total, so a role-starved fleet (prefill replicas
        # with no decode replica to hand to) is visible at a glance.
        by_role = {
            ls["role"]: int(g.value(**ls))
            for ls in g.label_sets()
            if "role" in ls and g.value(**ls) is not None
        }
        if by_role:
            out["replicas_by_role"] = by_role
    for name, key in (("preemptions_total", "preemptions_total"),
                      ("handoff_total", "handoffs_total")):
        c = registry.get(name)
        if c is not None and c.kind == "counter":
            out[key] = int(sum(
                c.value(**ls) for ls in c.label_sets()
            ))
    g = registry.get("fleet_engine_sim")
    if g is not None and g.kind == "gauge":
        # Twin transparency: the router stamps this gauge at
        # construction, so /healthz and every fleet digest says whether
        # the numbers came from real engines or the cost-model twin — a
        # sim run can never masquerade as measured.
        v = g.value()
        if v is not None:
            out["engine_kind"] = "sim" if v else "real"
    return out


# Per-phase cost fitting: phase name -> (fitted key, the
# denominator metric that normalizes it, that metric's kind). The
# denominators are the exact unit each cost-model charge uses:
# prefill charges per PROMPT TOKEN, decode per BATCHED STEP (one
# histogram sample per decode call), hand-off per MOVED PAGE.
_PHASE_FIT = {
    "prefill": ("prefill_s_per_token", "serve_prefill_tokens_total",
                "counter"),
    "decode": ("decode_s_per_tick", "serve_decode_step_seconds",
               "histogram"),
    "handoff": ("handoff_s_per_page", "handoff_pages_total", "counter"),
}


def _last_snapshot(path) -> list[dict]:
    import json

    last = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("record") == "snapshot":
                last = rec
    if last is None:
        raise ValueError(
            f"{path}: no snapshot records — not a MetricsWriter JSONL "
            "(or the run never flushed one)"
        )
    return last["metrics"]


def phase_cost_fit(source, *, phases=("prefill", "decode")) -> dict:
    """Fit per-phase virtual-time costs from a MEASURED run — the
    digital twin's cost table (``serve.sim.CostModel.from_phase_fit``),
    normalized per unit of work:

    - ``prefill_s_per_token`` = ``time_in_seconds{phase=prefill}`` /
      ``serve_prefill_tokens_total``
    - ``decode_s_per_tick``   = ``time_in_seconds{phase=decode}`` /
      ``serve_decode_step_seconds`` sample count (batched steps)
    - ``handoff_s_per_page``  = ``time_in_seconds{phase=handoff}`` /
      ``handoff_pages_total``

    ``source`` is a live :class:`~ddl_tpu_torch.obs.registry.MetricRegistry`
    (a replica registry — that is where the serve-side attribution
    lands) or a path to a ``MetricsWriter`` JSONL (the LAST snapshot
    wins — costs are cumulative ratios). Any requested phase whose
    numerator or denominator is missing/zero is a LOUD error naming the
    phase and the absent metric — a fit from a run that never decoded
    must fail, not silently return a zero cost. Fit ``handoff`` only
    from disaggregated runs (default phases omit it)."""
    bad = [p for p in phases if p not in _PHASE_FIT]
    if bad:
        raise ValueError(
            f"unknown fit phase(s) {', '.join(map(repr, bad))} "
            f"(fittable: {', '.join(_PHASE_FIT)})"
        )
    if hasattr(source, "get") and not isinstance(source, (str, bytes)) \
            and not hasattr(source, "__fspath__"):
        def num_of(phase):
            g = source.get("time_in_seconds")
            if g is None or g.kind != "gauge":
                return None
            return g.value(phase=phase)

        def den_of(name, kind):
            m = source.get(name)
            if m is None or m.kind != kind:
                return None
            if kind == "histogram":
                return sum(m.count(**ls) for ls in m.label_sets())
            return sum(m.value(**ls) for ls in m.label_sets())
    else:
        metrics = _last_snapshot(source)

        def num_of(phase):
            for e in metrics:
                if e["name"] == "time_in_seconds" \
                        and e.get("labels", {}).get("phase") == phase:
                    return e.get("value")
            return None

        def den_of(name, kind):
            got = [e for e in metrics
                   if e["name"] == name and e.get("kind") == kind]
            if not got:
                return None
            key = "count" if kind == "histogram" else "value"
            return sum(e.get(key, 0) for e in got)

    out: dict = {}
    problems = []
    for phase in phases:
        key, den_name, den_kind = _PHASE_FIT[phase]
        num = num_of(phase)
        den = den_of(den_name, den_kind)
        if num is None or num <= 0:
            problems.append(
                f"{phase} (time_in_seconds{{phase={phase}}} absent or 0 "
                "— the run never attributed that phase)"
            )
        elif not den:
            problems.append(
                f"{phase} ({den_name} absent or 0 — no work units to "
                "normalize by)"
            )
        else:
            out[key] = float(num) / float(den)
    if problems:
        raise ValueError(
            "phase_cost_fit: cannot fit " + "; ".join(problems)
        )
    return out


__all__ = [
    "GoodputTracker",
    "attribute_train_span",
    "fleet_summary",
    "goodput_summary",
    "phase_cost_fit",
    "TRAIN_PHASES",
    "SERVE_PHASES",
    "GOODPUT_PHASES",
]
