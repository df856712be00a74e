"""Self-healing serve fleet — the port of ``ddl_tpu/serve/controller.py``:
the controller over the router's replicas.

The controller is ticked on the router's GLOBAL clock and every decision
reads only host state (pressure counts, tick counters), so every scale,
drain, preempt and crash event is a replayable seeded scenario: two fresh
runs fire at identical ticks. Four closed loops:

- **Scale out** (``_maybe_scale_out``): when mean outstanding work per live
  replica stays at or above ``backlog_per_replica`` for ``sustain_ticks``
  ticks, a replica spins up sharing the fleet's one placed copy of the
  params (no warm-up: the eager engine has nothing to compile). While the
  fleet can still grow, the router DEFERS its door shed.
- **Scale in via drain** (``_maybe_scale_in`` -> ``_finish_drains``): a
  replica idle for ``idle_ticks`` ticks (fleet above ``min_replicas``)
  DRAINS (placement skips it, its occupants finish), then is collected,
  released (its pool whole again) and removed.
- **Crash recovery** (``_maybe_crash``): ``--inject-fault
  replica_crash@T:R`` kills replica R at global tick T; its engine and pool
  are discarded, its in-flight and queued requests re-queue at the door
  (``Completion.status="requeued"`` placeholders, overwritten once), and
  the fleet heals below ``min_replicas`` the same tick. Re-served requests
  give the SAME tokens: sampling keys fold in only (seed, request_id,
  token_index).
- **Cross-replica preemption** (``_maybe_preempt``): a queue head whose
  class is at least ``preempt_priority_gap`` more protected than an ACTIVE
  occupant of its replica, after ``preempt_wait_ticks`` ticks, evicts the
  lowest-priority occupant mid-decode: its pages go to the host
  (``Scheduler.preempt``) and it resumes on the least-loaded replica with a
  free slot and pages (``Scheduler.adopt``), its tokens equal to an
  unpreempted run's. Paged engines only.

Telemetry: ``scale_events_total{kind=}``, ``preemptions_total``,
``fleet_requeues_total``, ``fleet_crashes_total`` counters and
``fleet_replicas_active`` / ``fleet_replicas_draining`` /
``fleet_last_scale_tick`` gauges on the router registry; trace events
``scale_out``, ``scale_in``, ``drain``, ``preempt_move``,
``replica_crash`` and ``requeue``.

Burn rules (``burn_rules``, ``--autoscale ...,burn=RULE|RULE``): a named
rule of the router's SLO monitor whose fast AND slow burn rates both reach
its threshold also triggers scale-out (``reason="burn"``); on a role fleet
it grows the hottest role. The names are checked against the monitor at
bind, with JAX's texts.
"""

from __future__ import annotations

import dataclasses

from .disagg import ROLES
from .scheduler import Completion


@dataclasses.dataclass(frozen=True)
class RoleScale:
    """Per-role autoscale overrides: on a disaggregated
    fleet each role scales off ITS OWN pressure — prefill replicas
    saturate on prompt ingestion while decode replicas saturate on
    resident tokens, and one shared threshold would always scale the
    wrong phase first. ``None`` fields inherit the fleet-wide
    :class:`AutoscaleConfig` value; ``min_replicas`` defaults to 1 for
    every role present at bind (the both-sides invariant the router's
    run loop depends on)."""

    role: str
    max_replicas: int | None = None
    min_replicas: int | None = None
    backlog_per_replica: float | None = None
    sustain_ticks: int | None = None
    idle_ticks: int | None = None

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(
                f"unknown role {self.role!r} (valid: {', '.join(ROLES)})"
            )
        for name in ("max_replicas", "min_replicas", "sustain_ticks",
                     "idle_ticks"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(
                    f"{self.role}.{name} must be >= 1, got {v}"
                )
        if self.backlog_per_replica is not None \
                and self.backlog_per_replica <= 0:
            raise ValueError(
                f"{self.role}.backlog_per_replica must be > 0, got "
                f"{self.backlog_per_replica}"
            )


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Fleet policy. ``max_replicas`` bounds the fleet (every replica is
    a full engine — compiled programs + KV pool); ``min_replicas`` is
    the floor scale-in and crash healing maintain. Scale-out triggers
    on SUSTAINED pressure (``backlog_per_replica`` mean outstanding work
    per live replica for ``sustain_ticks`` ticks) or on any
    ``burn_rules``-named SLO rule alerting (fast AND slow windows hot —
    the monitor's own condition). ``idle_ticks`` consecutive idle ticks
    drain a surplus replica. Preemption (``preempt``) moves a
    lower-priority ACTIVE occupant when a class at least
    ``preempt_priority_gap`` more protected has waited
    ``preempt_wait_ticks`` ticks at its replica and another replica has
    a free slot + pages."""

    max_replicas: int
    min_replicas: int = 1
    backlog_per_replica: float = 2.0
    sustain_ticks: int = 2
    idle_ticks: int = 8
    preempt: bool = True
    preempt_wait_ticks: int = 2
    preempt_priority_gap: int = 1
    burn_rules: tuple[str, ...] = ()
    # While the fleet can still grow, the router's door shed defers to
    # scale-out. The TRADE: if
    # the scale thresholds are conservative enough that the fleet never
    # actually grows, class-margin door shedding stays off the whole
    # run and only the per-replica (class-blind) shed bounds admitted
    # overload. Operators with deliberately high thresholds should set
    # defer_door_shed=False (spec key ``defer=0``) to keep the static
    # door-shed behavior alongside the controller.
    defer_door_shed: bool = True
    # Per-role overrides: one RoleScale per specialized role
    # to scale independently. Empty on a mixed fleet — the config is
    # byte-compatible with every pre-disagg caller.
    roles: tuple[RoleScale, ...] = ()

    def role_scale(self, role: str) -> RoleScale:
        """The (possibly all-default) override record for ``role``."""
        for rs in self.roles:
            if rs.role == role:
                return rs
        return RoleScale(role)

    def __post_init__(self):
        names = [rs.role for rs in self.roles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate role overrides in {names}")
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) below min_replicas "
                f"({self.min_replicas})"
            )
        if self.backlog_per_replica <= 0:
            raise ValueError(
                f"backlog_per_replica must be > 0, got "
                f"{self.backlog_per_replica}"
            )
        for name in ("sustain_ticks", "idle_ticks", "preempt_wait_ticks",
                     "preempt_priority_gap"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}"
                )


def parse_autoscale_spec(spec: str, *, max_replicas: int | None = None,
                         replicas: int = 1) -> AutoscaleConfig:
    """``--autoscale`` grammar -> :class:`AutoscaleConfig`. Comma-joined
    ``key=val`` with keys ``max`` (cap; ``--max-replicas`` overrides),
    ``min``, ``backlog`` (mean outstanding per replica), ``sustain``
    (ticks), ``idle`` (ticks before drain), ``preempt`` (0/1), ``wait``
    (preempt wait ticks), ``gap`` (priority gap), ``burn`` ('|'-joined
    SLO rule names to watch; not ported). Per-role knobs (disaggregated
    fleets) ride as ``ROLE.key=val`` with keys ``max``/``min``/
    ``backlog``/``sustain``/``idle`` — each role then scales off its
    own pressure signal. Example::

        backlog=3,sustain=2,idle=6,burn=bulk_shed
        max=4,prefill.backlog=2,decode.backlog=4,decode.min=1
    """
    key_map = {
        "max": ("max_replicas", int),
        "min": ("min_replicas", int),
        "backlog": ("backlog_per_replica", float),
        "sustain": ("sustain_ticks", int),
        "idle": ("idle_ticks", int),
        "preempt": ("preempt", lambda v: bool(int(v))),
        "wait": ("preempt_wait_ticks", int),
        "gap": ("preempt_priority_gap", int),
        "burn": ("burn_rules", lambda v: tuple(
            s.strip() for s in v.split("|") if s.strip()
        )),
        "defer": ("defer_door_shed", lambda v: bool(int(v))),
    }
    role_key_map = {
        "max": ("max_replicas", int),
        "min": ("min_replicas", int),
        "backlog": ("backlog_per_replica", float),
        "sustain": ("sustain_ticks", int),
        "idle": ("idle_ticks", int),
    }
    kw: dict = {}
    role_kw: dict[str, dict] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip()
        if not eq:
            raise ValueError(
                f"autoscale segment {part!r} needs key=val"
            )
        if "." in key:
            # Per-role knob: ROLE.key=val.
            role, _, sub = key.partition(".")
            if role not in ROLES:
                raise ValueError(
                    f"unknown role {role!r} in autoscale segment "
                    f"{part!r} (valid: {', '.join(ROLES)})"
                )
            if sub not in role_key_map:
                raise ValueError(
                    f"unknown per-role autoscale key {sub!r} in "
                    f"{part!r} (valid: {', '.join(role_key_map)})"
                )
            dest, conv = role_key_map[sub]
            try:
                role_kw.setdefault(role, {})[dest] = conv(val)
            except ValueError as e:
                raise ValueError(
                    f"autoscale segment {part!r}: bad value ({e})"
                )
            continue
        if key not in key_map:
            raise ValueError(
                f"unknown autoscale key {key!r} "
                f"(valid: {', '.join(key_map)})"
            )
        dest, conv = key_map[key]
        try:
            kw[dest] = conv(val)
        except ValueError as e:
            raise ValueError(
                f"autoscale segment {part!r}: bad value ({e})"
            )
    if role_kw:
        kw["roles"] = tuple(
            RoleScale(role, **fields)
            for role, fields in sorted(role_kw.items())
        )
    if max_replicas is not None:
        kw["max_replicas"] = max_replicas
    if "max_replicas" not in kw:
        raise ValueError(
            "autoscale needs a fleet cap: pass --max-replicas N or a "
            "max=N key"
        )
    kw.setdefault("min_replicas", min(replicas, kw["max_replicas"]))
    return AutoscaleConfig(**kw)


class FleetController:
    """The deterministic fleet controller (module docstring). Bound to
    exactly one :class:`serve.router.Router` (its ctor calls
    :meth:`bind`); the router's run loop calls :meth:`begin_tick`
    before routing, :meth:`after_route` after, and :meth:`finish` when
    the stream drains. ``events`` records every action as
    ``(tick, kind, detail)`` — the tick-reproducibility pin surface."""

    def __init__(self, config: AutoscaleConfig, *, injector=None):
        self.config = config
        self.injector = injector
        self.router = None
        self._sustain = 0
        self._role_sustain: dict[str, int] = {}
        self._idle: dict[int, int] = {}
        self._wait_since: dict[int, int] = {}
        self._moved: set[int] = set()
        self.scale_outs = 0
        self.scale_ins = 0
        self.drains = 0
        self.preemptions = 0
        self.requeues = 0
        self.crashes = 0
        self.last_scale_tick = -1
        self.events: list[tuple] = []

    def bind(self, router) -> None:
        if self.router is not None and self.router is not router:
            raise ValueError(
                "this FleetController is already bound to another router"
            )
        if router.config.replicas > self.config.max_replicas:
            raise ValueError(
                f"router starts with {router.config.replicas} replicas, "
                f"above max_replicas {self.config.max_replicas}"
            )
        # burn= rules are checked HERE, not mid-run: a typo'd rule name (or
        # burn rules with no monitor to read) is a config error at bind,
        # never a silently-never-firing trigger.
        if self.config.burn_rules:
            if router.slo_monitor is None:
                raise ValueError(
                    "autoscale burn rules "
                    f"{list(self.config.burn_rules)} need an SLO "
                    "monitor on the router (--slo-rules) — without one "
                    "the burn trigger could never fire"
                )
            known = {r.name for r in router.slo_monitor.rules}
            bad = [n for n in self.config.burn_rules if n not in known]
            if bad:
                raise ValueError(
                    f"autoscale burn rules {bad} are not among the "
                    f"monitor's rules ({sorted(known)})"
                )
        # Per-role overrides are validated HERE, not mid-run: a
        # RoleScale every consumer is gated off (all-mixed fleet, or a
        # role the fleet never runs) would be a silently-never-firing
        # knob — the operator believes a floor/threshold is in force.
        if self.config.roles:
            fleet_roles = set(router.roles)
            if not any(r != "mixed" for r in fleet_roles):
                raise ValueError(
                    "autoscale per-role knobs "
                    f"{[rs.role for rs in self.config.roles]} need a "
                    "disaggregated fleet (--roles) — on an all-mixed "
                    "fleet they would silently never apply"
                )
            bad = [rs.role for rs in self.config.roles
                   if rs.role not in fleet_roles]
            if bad:
                raise ValueError(
                    f"autoscale per-role knobs for {bad} name roles "
                    f"the fleet does not run ({sorted(fleet_roles)}) — "
                    "they would silently never apply"
                )
        self.router = router

    def reset(self) -> None:
        """Clear per-run state AND the cumulative event ledger (the
        router's ``reset`` calls this): a fresh run from the same seed
        and the same fleet topology replays the same events, and
        ``summary()`` reports that run alone. Fleet TOPOLOGY is the one
        thing reset cannot restore — replicas removed or crashed in a
        previous run stay gone (their device state is gone)."""
        self._sustain = 0
        self._role_sustain.clear()
        self._idle.clear()
        self._wait_since.clear()
        self._moved.clear()
        self.scale_outs = self.scale_ins = self.drains = 0
        self.preemptions = self.requeues = self.crashes = 0
        self.last_scale_tick = -1
        self.events.clear()
        if self.injector is not None:
            self.injector.rearm()

    # -- the per-tick hooks (called by Router.run) ---------------------------

    def begin_tick(self, t: int, done: dict) -> None:
        """Pre-routing phase: deliver any injected crash, heal below the
        floor, and finalize drains whose replica has gone idle."""
        self._maybe_crash(t, done)
        self._heal(t)
        self._finish_drains(t, done)
        self._publish()

    def after_route(self, t: int) -> None:
        """Post-routing phase: preempt, then scale on pressure/burns,
        then begin drains — all from this tick's routed state."""
        self._maybe_preempt(t)
        self._maybe_scale_out(t)
        self._maybe_scale_in(t)
        self._publish()

    def finish(self, t: int, done: dict) -> None:
        """Stream drained: complete the scale-in story — finalize any
        drain already in flight, then drain-and-remove surplus ROUTABLE
        replicas down to the floor (every live replica is idle by the
        loop's exit condition). Counting routable replicas — never the
        already-draining ones — is what keeps a drain from being begun
        twice and the fleet from dipping below ``min_replicas``. An
        armed replica_crash that never fired (trigger tick beyond the
        run) fails the run LOUDLY — a chaos run that exercised nothing
        must not report a clean pass."""
        if self.injector is not None and self.injector.crash_pending:
            raise RuntimeError(
                f"replica_crash@{self.injector.spec.step} never fired: "
                f"the run ended at tick {t} — move the trigger inside "
                "the traffic horizon"
            )
        r = self.router
        self._finish_drains(t, done)
        while True:
            live = self._routable()
            if len(live) <= self.config.min_replicas:
                break
            k = max(live)
            if self._role_fleet():
                # End-of-stream scale-in respects role floors too: the
                # surplus candidates are replicas whose role is above
                # its floor (highest id first, LIFO like the live
                # path).
                cands = [
                    j for j in live
                    if sum(1 for i in live
                           if self._role_of(i) == self._role_of(j))
                    > self._role_floor(self._role_of(j))
                ]
                if not cands:
                    break
                k = max(cands)
            if not r.scheds[k].idle:
                break
            self._begin_drain(t, k)
            self._finish_drains(t, done)
        self._publish()

    def can_scale_out(self) -> bool:
        """True while the fleet can still grow."""
        return len(self._live()) < self.config.max_replicas

    def defers_door_shed(self) -> bool:
        """True while the router should defer its door shed to
        scale-out (capacity is coming; acting on load beats shedding
        it). At max scale — or with ``defer_door_shed=False`` (the
        conservative-thresholds opt-out, config docstring) — the door
        shed is the backstop again."""
        return self.config.defer_door_shed and self.can_scale_out()

    # -- state probes -------------------------------------------------------

    def _live(self) -> list[int]:
        return self.router.live_ids()

    def _routable(self) -> list[int]:
        return self.router.live_ids(routable=True)

    # -- role fleet probes ---------------------------------------------------

    def _role_fleet(self) -> bool:
        """True when the bound router runs specialized roles — the
        per-role scale/heal/drain paths engage; an all-mixed fleet runs
        the byte-identical pre-disagg controller."""
        return any(r != "mixed" for r in self.router.roles)

    def _role_of(self, k: int) -> str:
        return self.router.roles[k]

    def _role_floor(self, role: str) -> int:
        """Scale-in/heal floor for one role: the explicit override, or
        1 — a specialized fleet must keep both sides alive (the router
        run loop's both-sides invariant)."""
        v = self.config.role_scale(role).min_replicas
        return v if v is not None else 1

    def _event(self, t: int, kind: str, **detail) -> None:
        self.events.append((t, kind, tuple(sorted(detail.items()))))
        if self.router.tracer:
            self.router.tracer.event(kind, tick=t, **detail)

    def _count(self, name: str, **labels) -> None:
        reg = self.router.registry
        if reg is not None:
            reg.counter(name).inc(**labels)

    def _publish(self) -> None:
        reg = self.router.registry
        if reg is None:
            return
        reg.gauge("fleet_replicas_active").set(len(self._routable()))
        reg.gauge("fleet_replicas_draining").set(len(self.router.draining))
        reg.gauge("fleet_last_scale_tick").set(self.last_scale_tick)

    # -- crash recovery -----------------------------------------------------

    def _maybe_crash(self, t: int, done: dict) -> None:
        if self.injector is None:
            return
        k = self.injector.crashes_replica(t)
        if k is None:
            return
        r = self.router
        if k >= len(r.scheds):
            # A victim the fleet never created is a scenario error —
            # silently spending the one-shot latch would fake a passing
            # chaos run (the cli.py guard's rationale).
            raise ValueError(
                f"replica_crash targets replica {k} at tick {t} but the "
                f"fleet has only ever had {len(r.scheds)} replicas"
            )
        if r.scheds[k] is None:
            # Legitimately gone already (drained or double-crashed) —
            # record the miss instead of killing nothing silently.
            self._event(t, "replica_crash", replica=k, missed=True)
            return
        # Host byte plane: a crash moves no pages — the
        # requeue debt is the resident KV the re-run must REBUILD.
        # Sized from the block tables BEFORE abandon() zeroes them,
        # via the kv_row_bytes oracle; paged engines only (contiguous
        # slots hold no page table to size).
        eng = r.scheds[k].engine
        if eng.paged:
            debt = sum(int(eng.table_len[s])
                       for s, _req, _a in r.scheds[k].occupant_requests())
            if debt and r.registry is not None:
                r.registry.counter(
                    "handoff_bytes_total",
                    help="KV bytes moved through the host, by "
                         "hand-off path",
                ).inc(eng.handoff_bytes(debt), path="requeue")
        cdone, inflight, queued = r.scheds[k].abandon()
        done.update(cdone)
        inflight_ids = {q.id for q in inflight}
        for req in inflight + queued:
            # Idempotent placeholder: the final completion (from the
            # re-run) overwrites it exactly once at merge time; a
            # double crash re-writing "requeued" is harmless. A request
            # that was ADMITTED before the crash re-routes shed-exempt:
            # its admission decision is never re-made (a crash must not
            # convert served work into a refusal); queued-at-crash
            # requests face re-admission like any arrival.
            done[req.id] = Completion(
                id=req.id,
                prompt_len=int(len(req.prompt)),
                tokens=[], admitted_step=-1, finished_step=t,
                status="requeued",
            )
            r.requeue(req, shed_exempt=req.id in inflight_ids)
            self.requeues += 1
            self._event(t, "requeue", req=int(req.id), replica=k)
            self._count("fleet_requeues_total")
        r.kill_replica(k)
        self.crashes += 1
        self._idle.pop(k, None)
        self._event(t, "replica_crash", replica=k,
                    inflight=len(inflight), queued=len(queued))
        self._count("fleet_crashes_total")

    def _heal(self, t: int) -> None:
        if self._role_fleet():
            # Per-role floors: a crash must heal the PHASE
            # it killed — replacing a dead decode replica with a mixed
            # one would silently re-colocate the fleet. The role ledger
            # covers dead entries too, so a role whose every replica
            # crashed still heals.
            for role in sorted(set(self.router.roles)):
                floor = self._role_floor(role)
                while sum(1 for k in self._live()
                          if self._role_of(k) == role) < floor:
                    k = self.router.add_replica(role)
                    self.scale_outs += 1
                    self.last_scale_tick = t
                    self._event(t, "scale_out", replica=k, reason="heal",
                                role=role)
                    self._count("scale_events_total", kind="scale_out")
            # The fleet-wide floor holds on role fleets too (scale-in
            # already honors it on the way down — a crash must not be
            # the one path that leaves the fleet below min_replicas):
            # top up with the thinnest role, deterministically.
            while len(self._live()) < self.config.min_replicas:
                live = self._live()
                role = min(
                    sorted(set(self.router.roles)),
                    key=lambda r: (sum(1 for k in live
                                       if self._role_of(k) == r), r),
                )
                k = self.router.add_replica(role)
                self.scale_outs += 1
                self.last_scale_tick = t
                self._event(t, "scale_out", replica=k, reason="heal",
                            role=role)
                self._count("scale_events_total", kind="scale_out")
            return
        while len(self._live()) < self.config.min_replicas:
            k = self.router.add_replica()
            self.scale_outs += 1
            self.last_scale_tick = t
            self._event(t, "scale_out", replica=k, reason="heal")
            self._count("scale_events_total", kind="scale_out")

    # -- scale out ----------------------------------------------------------

    def _maybe_scale_out(self, t: int) -> None:
        if self._role_fleet():
            self._maybe_scale_out_role(t)
            return
        live = self._routable()
        if not live:
            return
        backlog = 0
        for k in live:
            p = self.router.scheds[k].pressure()
            backlog += p.occupied_slots + p.pending_total
        if backlog / len(live) >= self.config.backlog_per_replica:
            self._sustain += 1
        else:
            self._sustain = 0
        burn_hot = self._burn_hot()
        if not (self._sustain >= self.config.sustain_ticks or burn_hot):
            return
        if len(self._live()) >= self.config.max_replicas:
            return
        k = self.router.add_replica()
        self.scale_outs += 1
        self.last_scale_tick = t
        self._sustain = 0
        self._event(t, "scale_out", replica=k, reason="burn" if burn_hot else "pressure")
        self._count("scale_events_total", kind="scale_out")

    def _burn_hot(self) -> bool:
        """A ``burn_rules`` rule alerts: its fast AND slow burn rates both
        reach its threshold (names checked against the monitor at bind)."""
        mon = self.router.slo_monitor
        if mon is None:
            return False
        for name in self.config.burn_rules:
            rule = next(rr for rr in mon.rules if rr.name == name)
            if (mon.burn_rate(name, "fast") >= rule.threshold
                    and mon.burn_rate(name, "slow") >= rule.threshold):
                return True
        return False

    def _maybe_scale_out_role(self, t: int) -> None:
        """Role-aware scale-out: each role's mean
        outstanding work is compared against ITS OWN threshold
        (``RoleScale`` overrides, fleet defaults otherwise) with its
        own sustain counter, and the hottest sustained role grows — at
        most one replica per tick, capped by the fleet total AND the
        role's own ``max``. A burn alert scales the hottest role (the
        monitor cannot attribute a latency burn to a phase; backlog
        can)."""
        cfg = self.config
        r = self.router
        live = self._routable()
        per_role: dict[str, list[int]] = {}
        for k in live:
            per_role.setdefault(self._role_of(k), []).append(k)
        loads: dict[str, float] = {}
        for role, ks in per_role.items():
            backlog = 0
            for k in ks:
                p = r.scheds[k].pressure()
                backlog += p.occupied_slots + p.pending_total
            loads[role] = backlog / len(ks)
            rs = cfg.role_scale(role)
            thresh = (rs.backlog_per_replica
                      if rs.backlog_per_replica is not None
                      else cfg.backlog_per_replica)
            if loads[role] >= thresh:
                self._role_sustain[role] = \
                    self._role_sustain.get(role, 0) + 1
            else:
                self._role_sustain[role] = 0
        burn_hot = self._burn_hot()
        ready = []
        for role in per_role:
            rs = cfg.role_scale(role)
            need = (rs.sustain_ticks if rs.sustain_ticks is not None
                    else cfg.sustain_ticks)
            if not (self._role_sustain.get(role, 0) >= need or burn_hot):
                continue
            if rs.max_replicas is not None and sum(
                1 for k in self._live() if self._role_of(k) == role
            ) >= rs.max_replicas:
                continue
            ready.append((-loads[role], role))
        if not ready or len(self._live()) >= cfg.max_replicas:
            return
        role = min(ready)[1]
        k = r.add_replica(role)
        self.scale_outs += 1
        self.last_scale_tick = t
        self._role_sustain[role] = 0
        self._event(t, "scale_out", replica=k, role=role,
                    reason="burn" if burn_hot else "pressure")
        self._count("scale_events_total", kind="scale_out")

    # -- scale in / drain ---------------------------------------------------

    def _maybe_scale_in(self, t: int) -> None:
        live = self._routable()
        for k in list(self._idle):
            if k not in live:
                del self._idle[k]
        for k in live:
            self._idle[k] = (self._idle.get(k, 0) + 1
                             if self.router.scheds[k].idle else 0)
        if self._role_fleet():
            # Role floors: a role drains only above ITS
            # floor — the fleet must never drain its last decode
            # replica because the prefill side happens to be busy.
            ripe = []
            for k in live:
                role = self._role_of(k)
                rs = self.config.role_scale(role)
                need = (rs.idle_ticks if rs.idle_ticks is not None
                        else self.config.idle_ticks)
                if self._idle.get(k, 0) < need:
                    continue
                if sum(1 for j in live if self._role_of(j) == role) \
                        <= self._role_floor(role):
                    continue
                ripe.append(k)
            if ripe and len(live) > self.config.min_replicas:
                self._begin_drain(t, max(ripe))
            return
        if len(live) <= self.config.min_replicas:
            return
        ripe = [k for k in live
                if self._idle.get(k, 0) >= self.config.idle_ticks]
        if not ripe:
            return
        # Highest id first: the most-recently scaled-out replica goes
        # back first (LIFO capacity), one drain per tick.
        self._begin_drain(t, max(ripe))

    def _begin_drain(self, t: int, k: int) -> None:
        self.router.draining.add(k)
        self._idle.pop(k, None)
        self.drains += 1
        self._event(t, "drain", replica=k)
        self._count("scale_events_total", kind="drain")

    def _finish_drains(self, t: int, done: dict) -> None:
        r = self.router
        for k in sorted(r.draining):
            sched = r.scheds[k]
            if sched is None or not sched.idle:
                continue  # occupants still finishing — keep ticking it
            r.remove_replica(k, done)
            self.scale_ins += 1
            self.last_scale_tick = t
            self._event(t, "scale_in", replica=k)
            self._count("scale_events_total", kind="scale_in")

    # -- cross-replica preemption -------------------------------------------

    def _maybe_preempt(self, t: int) -> None:
        if not self.config.preempt:
            return
        r = self.router
        live = self._routable()
        if not live or not r.engines[live[0]].paged:
            # Preemption is a page hand-off: the contiguous layout has
            # no slot-independent pages to move (config docstring).
            return
        # Age the waiting ledger: first-seen tick per HEAD waiter. Only
        # the FIFO head can trigger a preemption — admission is
        # strictly FIFO, so a freed slot goes to the head; firing for a
        # deeper waiter would migrate pages without serving it.
        waiting_now: dict[int, tuple[int, object]] = {}
        for k in live:
            heads = r.scheds[k].waiting_eligible_requests()
            if heads:
                req = heads[0]
                waiting_now[req.id] = (k, req)
                self._wait_since.setdefault(req.id, t)
        for rid in list(self._wait_since):
            if rid not in waiting_now:
                del self._wait_since[rid]
        for rid, (src, req) in sorted(waiting_now.items()):
            if t - self._wait_since[rid] < self.config.preempt_wait_ticks:
                continue
            wait_pri = r.priority_of(req)
            # Victim: the source replica's lowest-priority ACTIVE
            # occupant, at least `gap` less protected than the waiter.
            # A request moves at most ONCE (self._moved): re-evicting a
            # freshly adopted occupant would ping-pong its growing
            # pages between replicas without serving anyone sooner.
            victims = [
                (r.priority_of(occ), s, occ)
                for s, occ, active in r.scheds[src].occupant_requests()
                if active
                and occ.id not in self._moved
                and r.priority_of(occ) - wait_pri
                >= self.config.preempt_priority_gap
            ]
            if not victims:
                continue
            _, _, victim = max(victims, key=lambda v: (v[0], v[1]))
            need = r.engines[src].pages_needed(
                int(len(victim.prompt)) + victim.max_new_tokens
            )
            # Destination: a free slot + pages AND no waiters of its
            # own — adopting into a replica whose queue is non-empty
            # would queue-jump that replica's FIFO.
            dests = []
            for k in live:
                if k == src:
                    continue
                if self._role_fleet() and self._role_of(k) == "prefill":
                    # A prefill specialist never decodes — adopting a
                    # mid-decode victim there would park it forever.
                    continue
                p = r.scheds[k].pressure()
                # pending_total, not waiting_eligible: a freshly
                # scaled-out replica's local clock lags the router's,
                # so routed-but-not-yet-locally-eligible arrivals must
                # still count as "this replica has its own queue".
                if (p.occupied_slots < r.config.serve.slots
                        and p.pending_total == 0
                        and p.pages_available >= need):
                    dests.append((p.occupied_slots + p.pending_total,
                                  -p.pages_available, k))
            if not dests:
                continue
            dst = min(dests)[2]
            pre = r.scheds[src].preempt(victim.id)
            r.scheds[dst].adopt(pre)
            r.note_move(victim.id, dst)
            self._moved.add(victim.id)
            self.preemptions += 1
            self._event(t, "preempt_move", req=int(victim.id),
                        src=src, dst=dst)
            self._count("preemptions_total")
            if r.registry is not None:
                # The fleet-level byte count on the ROUTER
                # registry; the source scheduler counted the same move
                # on its OWN registry inside preempt() — distinct
                # registries, no double count.
                r.registry.counter(
                    "handoff_bytes_total",
                    help="KV bytes moved through the host, by "
                         "hand-off path",
                ).inc(r.engines[src].handoff_bytes(
                    int(pre.pos.shape[0])), path="preempt")
            return  # one preemption per tick — deterministic and gentle

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        """JSON-able digest (the CLI / bench surface)."""
        return {
            "max_replicas": self.config.max_replicas,
            "min_replicas": self.config.min_replicas,
            "scale_outs": self.scale_outs,
            "scale_ins": self.scale_ins,
            "drains": self.drains,
            "preemptions": self.preemptions,
            "requeues": self.requeues,
            "crashes": self.crashes,
            "last_scale_tick": self.last_scale_tick,
            "events": [
                {"tick": t, "kind": kind, **dict(detail)}
                for t, kind, detail in self.events
            ],
        }
