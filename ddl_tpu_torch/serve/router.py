"""Multi-tenant front door — the port of ``ddl_tpu/serve/router.py``: an
SLO-aware router over N engine replicas.

The router owns ``replicas`` independent ``Scheduler``/``InferenceEngine``
pairs (each with its own KV pool and prefix index, all serving ONE set of
params, placed once and shared) and spreads an open-loop request stream
(``data.lm.synthesize_mixed_traffic``) over them:

- **Prefix-affinity placement**: a request goes to the replica whose
  ``PrefixIndex`` already covers its prompt (a pure probe), else to the
  replica of its sticky family (the prompt's page-aligned leading window),
  else to the least loaded (``Scheduler.pressure()``: occupied slots and
  queue backlog, free pages as the tie-breaker).
- **Priority admission**: each ``traffic_class`` carries a priority; when
  every replica's backlog is within the class's ``shed_margin`` of the shed
  threshold, that class sheds at the ROUTER (bulk before chat), and each
  replica's own shed and deadline machinery stays the last line.
- **Per-class SLO accounting**: the replicas share one tracer, so
  ``request_slo_samples`` recovers per-class TTFT and ITL from one record
  stream; ``RouterStats`` reports attainment against each class's targets,
  and the registry gets ``{class=...}``-labelled metrics.

**Determinism**: the router owns a global tick clock. Arrivals are routed
when the clock reaches them (decisions read only host state), then every
non-idle replica ticks once, in replica order. An idle scheduler tick makes
no device call, so a 1-replica router run equals ``Scheduler.run`` on the
same stream (tokens and each step's logits, bitwise), and an N-replica run
is reproducible (same tokens, same placements) while wall-clock deadlines
are off.

**Fleet dynamics**: with a ``serve.controller.FleetController`` the replica
set is dynamic: ``add_replica`` (shared placed params, armed mid-run, no
warm-up of its own), ``remove_replica`` after a drain, ``kill_replica`` on
a crash; the door queue re-routes crash-orphaned requests, and while the
fleet can grow the door shed defers to scale-out. Without a controller the
loop is the static router's.

**Live control plane**: ``slo_monitor=`` and ``anomaly_detector=`` live
on the ROUTER registry (checked, with JAX's texts) and step once per global
tick: the monitor reads the ``{class=}`` shed and request counters and
``router_ttft_seconds{class=}`` (observed live each tick), the detector the
fleet signals ``backlog`` and ``shed_rate``. The replicas' schedulers keep
neither, as JAX's; ``peak_flops=`` reaches each of them.

**The digital twin**: ``RouterConfig.engine_factory`` builds the replicas'
engines (``serve.sim.sim_engine_factory()`` for cost-model engines); the
router registry's ``fleet_engine_sim`` gauge says which kind served. With
no factory the router builds ``InferenceEngine``s where ``device=`` or
``grid=`` says. With ``params=None`` those serve the port's own init from
``serve.seed`` (not JAX's draw); ``placed_params=`` shares a tree already on
the device (the port's engine takes the same keyword).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..obs.trace import Tracer
from .disagg import DisaggCoordinator, validate_roles
from .engine import InferenceEngine, ServeConfig
from .engine_iface import engine_kind
from .scheduler import (
    MIN_PREFIX_HIT,
    Completion,
    Request,
    Scheduler,
    ServeStats,
    request_slo_samples,
)


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One traffic class's SLO contract. ``ttft_slo_s``/``itl_slo_s``
    are attainment targets (accounting only — they gate no scheduling);
    ``priority`` orders classes under overload (0 = most protected);
    ``shed_margin`` is how many requests BELOW the shed threshold this
    class starts shedding at the router (default: ``priority`` — lower
    priority sheds earlier), so bulk absorbs a burst before chat feels
    it."""

    name: str
    ttft_slo_s: float = math.inf
    itl_slo_s: float = math.inf
    priority: int = 0
    shed_margin: int | None = None

    @property
    def margin(self) -> int:
        return self.priority if self.shed_margin is None else self.shed_margin


# Targets for the canonical three-class mix — illustrative CPU-scale
# numbers.
DEFAULT_CLASS_SPECS: tuple[ClassSpec, ...] = (
    ClassSpec("chat", ttft_slo_s=0.5, itl_slo_s=0.1, priority=0),
    ClassSpec("longdoc", ttft_slo_s=5.0, itl_slo_s=0.25, priority=1),
    ClassSpec("bulk", ttft_slo_s=60.0, itl_slo_s=2.0, priority=2),
)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router topology + policy. ``serve`` configures EACH replica
    (slots, capacity, paging, prefix pool — all per replica);
    ``classes`` declares the traffic classes the stream may carry
    (unknown classes are submit-time errors). ``shed_threshold`` is the
    per-replica outstanding-work bound the PR-6 machinery enforces,
    AND the reference point the router's class margins subtract from;
    None disables shedding everywhere. ``prefix_affinity=False``
    degrades placement to pure least-load (the A/B lever the
    fleet_router smoke phase measures). ``affinity_window`` bounds
    the sticky family key (tokens; page-aligned on paged engines) —
    size it <= the shared-prefix length your traffic actually carries:
    a wider window folds post-prefix tokens into the key and no two
    family members ever share it (the live index probe still works,
    but only after the first member's registration lands)."""

    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    replicas: int = 2
    classes: tuple[ClassSpec, ...] = DEFAULT_CLASS_SPECS
    prefix_affinity: bool = True
    affinity_window: int = 16
    shed_threshold: int | None = None
    eos_id: int | None = None
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None
    # Disaggregated prefill/decode roles (serve.disagg): one
    # role per replica ("prefill"/"decode"/"mixed"); None = all mixed,
    # the byte-identical pre-disaggregation fleet. A specialized fleet
    # needs the paged layout (the hand-off moves KV pages) and both
    # sides present (serve.disagg.validate_roles).
    roles: tuple[str, ...] | None = None
    # Engine construction: ``factory(serve_config, params=None, *,
    # placed_params=...)`` returning a ServeEngine
    # (``serve.sim.sim_engine_factory()`` for the twin). None builds the
    # real InferenceEngine where the router's device= or grid= says.
    engine_factory: object | None = None


@dataclasses.dataclass
class ClassReport:
    """Per-class outcome of one router run. ``ttft``/``itl`` pool the
    PER-REQUEST samples (``serve.request_slo_samples``) of the class's
    members; attainment counts a shed/expired request as a MISS (it got
    no first token), so ``ttft_slo_attained`` is the fraction of ALL
    the class's requests served within target."""

    name: str
    requests: int
    ok: int
    shed: int
    deadline_exceeded: int
    ttft: object  # StepStats
    itl: object  # StepStats
    ttft_slo_attained: float
    # No ITL samples reads 1.0 only when the class completed requests
    # (1-token answers have no gaps); a fully-shed class reads 0.0.
    itl_slo_attained: float


@dataclasses.dataclass
class RouterStats:
    """One router run's accounting: per-class SLO reports, placement
    ledger (request id -> replica), policy counters, and each replica's
    own ``ServeStats``. ``replica`` has one entry per replica id EVER
    created this run (the fleet controller may grow the list); a
    crashed replica's entry is ``None`` — its device-side stats died
    with it. ``fleet`` is the controller's digest (None on a static
    fleet)."""

    per_class: dict[str, ClassReport]
    placements: dict[int, int]
    affinity_placements: int
    load_placements: int
    router_sheds: int
    ticks: int
    replica: list[ServeStats | None]
    fleet: dict | None = None
    # Disaggregation digest: hand-off counts + per-role
    # replica split; None on an all-mixed fleet.
    disagg: dict | None = None

    @property
    def prefix_lookups(self) -> int:
        return sum(s.prefix_lookups for s in self.replica if s is not None)

    @property
    def prefix_hits(self) -> int:
        return sum(s.prefix_hits for s in self.replica if s is not None)

    @property
    def prefix_hit_rate(self) -> float:
        lk = self.prefix_lookups
        return self.prefix_hits / lk if lk else 0.0

    def summary(self) -> dict:
        """JSON-able digest (the CLI/serve_bench surface)."""
        return {
            "per_class": {
                name: {
                    "requests": r.requests,
                    "ok": r.ok,
                    "shed": r.shed,
                    "deadline_exceeded": r.deadline_exceeded,
                    "ttft_ms": {"p50": r.ttft.p50_ms, "p95": r.ttft.p95_ms},
                    "itl_ms": {"p50": r.itl.p50_ms, "p95": r.itl.p95_ms},
                    "ttft_slo_attained": r.ttft_slo_attained,
                    "itl_slo_attained": r.itl_slo_attained,
                }
                for name, r in sorted(self.per_class.items())
            },
            "replicas": len(self.replica),
            "per_replica_requests": [
                sum(1 for v in self.placements.values() if v == k)
                for k in range(len(self.replica))
            ],
            "affinity_placements": self.affinity_placements,
            "load_placements": self.load_placements,
            "router_sheds": self.router_sheds,
            "prefix_hit_rate": round(self.prefix_hit_rate, 3),
            "ticks": self.ticks,
            **({"fleet": self.fleet} if self.fleet is not None else {}),
            **({"disagg": self.disagg} if self.disagg is not None
               else {}),
        }


class Router:
    """The front door. Owns ``config.replicas`` scheduler/engine pairs
    sharing one checkpoint's placed params; :meth:`run` drives an
    open-loop stream (``data.lm.MixedRequest`` items, or ``Request``s
    carrying ``traffic_class``) to completion and returns
    ``(completions, RouterStats)``.

    ``registry`` (optional) receives the router's ``{class=...}``-
    labeled metrics AND hands each replica its own registry (exposed as
    ``replica_registries`` — per-replica gauges/counters under the
    standard ``serve_*`` names). ``tracer`` defaults to an in-memory
    tracer shared by every replica — the per-class SLO derivation reads
    its records, so pass ``keep=True`` tracers when supplying your
    own."""

    def __init__(self, config: RouterConfig, params=None, *,
                 registry=None, tracer=None, injector=None,
                 slo_monitor=None, peak_flops: float | None = None,
                 anomaly_detector=None, controller=None, device=None, grid=None,
                 placed_params=None):
        if config.replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {config.replicas}"
            )
        names = [c.name for c in config.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate traffic class names in {names}")
        if not names:
            raise ValueError("at least one traffic class is required")
        if config.affinity_window < 2:
            raise ValueError(
                f"affinity_window must be >= 2 (BOS + >= 1 payload "
                f"token), got {config.affinity_window}"
            )
        if config.shed_threshold is not None:
            for c in config.classes:
                if config.shed_threshold - c.margin < 1:
                    raise ValueError(
                        f"class {c.name!r}: shed margin {c.margin} leaves "
                        f"no admissible headroom under shed_threshold "
                        f"{config.shed_threshold} (threshold - margin must "
                        "be >= 1)"
                    )
        if slo_monitor is not None:
            if registry is None:
                raise ValueError(
                    "slo_monitor needs the router registry it evaluates "
                    "against; pass registry= as well"
                )
            if slo_monitor.registry is not registry:
                raise ValueError(
                    "slo_monitor was built on a different registry than "
                    "this router's — it would read counters the router "
                    "never writes (burn 0.0 forever). Build it on the "
                    "registry passed as registry="
                )
        if anomaly_detector is not None:
            if registry is None:
                raise ValueError(
                    "anomaly_detector needs the router registry it emits "
                    "anomaly_* metrics into; pass registry= as well"
                )
            if anomaly_detector.registry is not registry:
                raise ValueError(
                    "anomaly_detector was built on a different registry "
                    "than this router's — its anomaly_* metrics would "
                    "land where nothing reads them. Build it on the "
                    "registry passed as registry="
                )
        # The role fleet is validated before any engine is built —
        # a malformed split is a config error, never a mid-run hang.
        if config.roles is not None:
            if len(config.roles) != config.replicas:
                raise ValueError(
                    f"roles {tuple(config.roles)} names "
                    f"{len(config.roles)} replicas but replicas="
                    f"{config.replicas} — one role per replica"
                )
            validate_roles(config.roles)
            if any(r != "mixed" for r in config.roles) \
                    and config.serve.page_size <= 0:
                raise ValueError(
                    f"roles {tuple(config.roles)} need the paged KV "
                    "layout (page_size > 0): the prefill->decode "
                    "hand-off moves KV pages, and contiguous slot "
                    "rings have none"
                )
        self.roles: list[str] = (list(config.roles)
                                 if config.roles is not None
                                 else ["mixed"] * config.replicas)
        self.config = config
        self.classes = {c.name: c for c in config.classes}
        self.tracer = tracer if tracer is not None else Tracer()
        self.registry = registry
        factory = config.engine_factory
        if factory is None:
            # Replica engines run where the caller says: a device, or the
            # tp group of a grid (one engine a rank).
            where = dict(grid=grid) if grid is not None else dict(device=device)

            def factory(serve, params=None, *, placed_params=None):
                return InferenceEngine(serve, params=params, placed_params=placed_params,
                                       **where)
        self._engine_factory = factory
        self._injector = injector
        self._peak_flops = peak_flops
        if params is not None and placed_params is not None:
            raise ValueError("pass params (host tree, placed once) OR placed_params (an "
                             "already-placed tree every replica shares), not both")
        self.engines: list[InferenceEngine | None] = []
        for k in range(config.replicas):
            # One checkpoint, one placed copy: replica 0 places the host
            # tree; every other replica SHARES its device tensors (no
            # replica writes params, so sharing is safe). A custom
            # engine_factory receives the same wiring (a cost-model engine
            # ignores the shared tree).
            eng = (factory(config.serve, params=params, placed_params=placed_params)
                   if k == 0 else factory(config.serve, placed_params=self.engines[0].params))
            self.engines.append(eng)
        if registry is not None:
            # /healthz and fleet_summary read this: a twin run never passes
            # for a measured one.
            registry.gauge("fleet_engine_sim").set(
                1.0 if engine_kind(self.engines[0]) == "sim" else 0.0)
        # The fleet's ONE placed param tree, held by the router itself:
        # scale-out and crash healing build replacement replicas from
        # it even after replica 0 is gone.
        self._placed_params = self.engines[0].params
        self.replica_registries = None
        regs: list = [None] * config.replicas
        if registry is not None:
            from ..obs import MetricRegistry

            self.replica_registries = [MetricRegistry()
                                       for _ in range(config.replicas)]
            regs = self.replica_registries
        self.scheds: list[Scheduler | None] = [
            self._make_scheduler(eng, regs[k], role=self.roles[k])
            for k, eng in enumerate(self.engines)
        ]
        # The hand-off coordinator exists only on a SPECIALIZED fleet —
        # an all-mixed router runs the byte-identical pre-disagg loop
        # (the transparency bar every fleet feature clears).
        self.disagg = (DisaggCoordinator(self)
                       if any(r != "mixed" for r in self.roles) else None)
        # One clock, one evaluator: both step once per GLOBAL tick in run()
        # on the router registry; the replicas' schedulers keep neither.
        self.slo_monitor = slo_monitor
        self.anomaly = anomaly_detector
        self._sticky: dict[bytes, int] = {}
        # Fleet state: a DRAINING replica stops receiving
        # routed arrivals but keeps ticking until its occupants finish;
        # the door queue holds requests awaiting (re-)routing — crash
        # requeues, and any arrival landing while no replica is
        # routable. Both empty forever on a static fleet.
        self.draining: set[int] = set()
        # Door entries are (request, first): `first` is False once the
        # request has been COUNTED as an arrival (a crash requeue, or a
        # retry of an arrival that found no routable replica) — the
        # attempts counter moves once per request, while the shed
        # decision re-runs on every pass unless the request is
        # shed_exempt (already admitted before a crash).
        self._door: list[tuple[Request, bool]] = []
        # Per-routing-pass Pressure cache: run() arms it for
        # the door+arrival pass of each tick; None means _route probes
        # fresh (the direct-call path). Decision-identical to fresh
        # probes — see _route.
        self._pressure_cache: dict | None = None
        self._armed = False
        self._run_counters: dict | None = None
        self._collected: dict[int, ServeStats] = {}
        self._requeue_marks: dict[int, int] = {}
        self._rec_start = 0
        self.controller = controller
        if controller is not None:
            controller.bind(self)

    # -- fleet surgery (driven by serve.controller) -------------------------

    def _make_scheduler(self, eng: InferenceEngine, reg, *,
                        role: str = "mixed") -> Scheduler:
        cfg = self.config
        return Scheduler(
            eng, eos_id=cfg.eos_id, tracer=self.tracer,
            registry=reg, shed_threshold=cfg.shed_threshold,
            ttft_deadline_s=cfg.ttft_deadline_s,
            deadline_s=cfg.deadline_s, injector=self._injector,
            peak_flops=self._peak_flops, role=role,
        )

    def live_ids(self, *, routable: bool = False) -> list[int]:
        """Replica ids with a live scheduler; ``routable=True``
        additionally excludes draining replicas (they tick, they do not
        receive)."""
        return [k for k, s in enumerate(self.scheds)
                if s is not None
                and (not routable or k not in self.draining)]

    def priority_of(self, req: Request) -> int:
        """The request's class priority (0 = most protected) — the
        controller's preemption ordering."""
        return self.classes[req.traffic_class].priority

    def add_replica(self, role: str = "mixed") -> int:
        """Scale out: a new replica sharing the fleet's placed params
        (no second placement), armed mid-run so it can receive the very
        next routed arrival. ``role`` specializes the newcomer on a
        disaggregated fleet (the role-aware controller scales each phase
        off its own pressure). Returns the replica id.

        Unlike JAX's router, the newcomer runs no warm-up: an eager
        engine has no programs to compile, and every shape its first
        ticks run was already run on this device by the replicas the
        router warmed. A warm-up here would be device work inside the
        timed run that no request needs."""
        k = len(self.engines)
        eng = self._engine_factory(self.config.serve, placed_params=self._placed_params)
        self.engines.append(eng)
        self.roles.append(role)
        reg = None
        if self.replica_registries is not None:
            # Parity with the ctor: one per-replica serve_* registry
            # per engine (absent entirely when the router was built
            # without a registry — a post-hoc registry attach gets
            # router-level metrics only).
            from ..obs import MetricRegistry

            reg = MetricRegistry()
            self.replica_registries.append(reg)
        sched = self._make_scheduler(eng, reg, role=role)
        self.scheds.append(sched)
        if self._armed:
            sched.begin()
        return k

    def remove_replica(self, k: int, done: dict) -> None:
        """Scale in, the graceful half: collect the drained replica's
        completions/stats, release its run (the hardened
        ``Scheduler.release`` — pool byte-whole, reservations
        included), and drop it from the fleet."""
        sched = self.scheds[k]
        rd, stats = sched.collect()
        sched.release()
        done.update(rd)
        self._collected[k] = stats
        self._drop(k)

    def kill_replica(self, k: int) -> None:
        """Crash: discard the replica wholesale — engine, page pool and
        armed run state are gone (the controller already harvested the
        host-side ledger via ``Scheduler.abandon``). No release: the
        device state no longer exists."""
        self._drop(k)

    def _drop(self, k: int) -> None:
        self.engines[k] = None
        self.scheds[k] = None
        self.draining.discard(k)
        self._sticky = {key: r for key, r in self._sticky.items()
                        if r != k}
        if self.registry is not None:
            self.registry.gauge("router_replica_outstanding").set(
                0, replica=k
            )

    def requeue(self, req: Request, *, shed_exempt: bool = False) -> None:
        """Put a crash-orphaned request back at the front door: it
        re-routes at the next tick's routing pass, immediately eligible
        (``arrival=0`` — its original arrival already passed).
        ``shed_exempt=True`` for requests that were ALREADY ADMITTED
        before the crash (their admission decision is not re-made).
        Sampling keys fold in only (seed, request_id, token_index), so
        the re-served stream is the SAME tokens. The request's trace
        watermark is recorded so per-request SLO derivation uses its
        FINAL serve's token emissions only — folding the crashed
        attempt's in would duplicate ITL samples — while the ORIGINAL
        eligibility survives: the request's TTFT honestly spans the
        crash window (attainment must pay for the incident)."""
        self._requeue_marks[req.id] = \
            len(self.tracer.records) - self._rec_start
        self._door.append((
            dataclasses.replace(req, arrival=0, shed_exempt=shed_exempt),
            False,
        ))

    @staticmethod
    def _final_serve_records(records, marks: dict[int, int]) -> list:
        """Drop a requeued request's token-emission records from BEFORE
        its last requeue watermark (and strip it from earlier
        decode_tick ``reqs`` lists), so ``request_slo_samples`` sees
        one serve's emissions per request — the final one. The
        request's FIRST ``eligible`` record is kept: its TTFT spans the
        crash (honest end-to-end latency). Identity when nothing
        requeued."""
        if not marks:
            return records
        out = []
        for i, rec in enumerate(records):
            name = rec.get("name")
            attrs = rec.get("attrs", {})
            rid = attrs.get("req")
            if name != "eligible" and rid in marks and i < marks[rid]:
                continue
            if name == "decode_tick":
                reqs = attrs.get("reqs", ())
                kept = [q for q in reqs
                        if not (q in marks and i < marks[q])]
                if len(kept) != len(reqs):
                    rec = {**rec, "attrs": {**attrs, "reqs": kept}}
            out.append(rec)
        return out

    def note_move(self, rid: int, dst: int) -> None:
        """Record a preemption move in the run's placement ledger (the
        request now lives on ``dst``)."""
        if self._run_counters is not None:
            self._run_counters["placements"][rid] = dst

    @classmethod
    def from_checkpoint(cls, config: RouterConfig, path, **kw) -> "Router":
        """Build a router serving a checkpoint's params (params-only
        load from any trained topology, either package's file, placed
        ONCE for all replicas)."""
        from .engine import _load_host_params

        return cls(config,
                   params=_load_host_params(path, config.serve.spec), **kw)

    def reset(self) -> None:
        """Fresh caches/prefix pools on every (live) replica, a cleared
        sticky family map, an empty door queue and reset controller
        state — two runs from the same reset point are identical (the
        seed-determinism pin)."""
        for eng in self.engines:
            if eng is not None:
                eng.reset()
        self._sticky.clear()
        self._door.clear()
        self.draining.clear()
        if self.controller is not None:
            self.controller.reset()
        if self.disagg is not None:
            self.disagg.reset()

    def warmup(self, items) -> None:
        """Run every replica's program ladder for ``items`` outside any
        timed run (each replica may receive any request, so each warms
        on the whole stream), then reset."""
        reqs = [self._to_request(it) for it in items]
        for sched in self.scheds:
            if sched is not None:
                sched.warmup(reqs)
        self.reset()

    # -- placement policy --------------------------------------------------

    def _to_request(self, it) -> Request:
        """Accept ``data.lm.MixedRequest`` items or ``Request``s with a
        ``traffic_class`` — the router's admission validates the class
        name; shape/length validation stays with the scheduler."""
        cls = getattr(it, "traffic_class", "default")
        if cls not in self.classes:
            raise ValueError(
                f"request {it.id}: unknown traffic_class {cls!r} "
                f"(declared: {sorted(self.classes)})"
            )
        if isinstance(it, Request):
            return it
        return Request(
            id=int(it.id), prompt=np.asarray(it.prompt, np.int32),
            max_new_tokens=int(it.max_new_tokens), arrival=int(it.arrival),
            traffic_class=cls,
        )

    def _family_key(self, prompt: np.ndarray) -> bytes | None:
        """The sticky-affinity key: the prompt's leading
        ``affinity_window`` tokens, never the whole prompt (two family
        members differ in their tails), page-ALIGNED on paged engines
        so the key covers exactly the pages a hit would share."""
        w = self.config.affinity_window
        live = self.live_ids()
        eng = self.engines[live[0] if live else 0]
        if eng.paged and w >= eng.page_size:
            w -= w % eng.page_size
        k = min(int(prompt.shape[0]) - 1, w)
        if k < 2:
            return None  # BOS alone is every prompt's prefix — no family
        return np.asarray(prompt[:k], np.int32).tobytes()

    def _place(self, req: Request, cand: list[int],
               pressures: dict) -> tuple[int, str]:
        """Choose a replica among the ROUTABLE candidates: deepest live
        prefix coverage first (pure probes), then the sticky family
        map, then least load — backlog (occupied + every queued
        request), free pages as the tie-breaker, replica id as the
        deterministic last word. On a static fleet the candidate list
        is every replica — byte-identical decisions to the pre-fleet
        router."""
        key = None
        if self.config.prefix_affinity:
            depths = []
            for k in cand:
                eng = self.engines[k]
                d = 0
                if eng.prefix is not None:
                    _, d = eng.prefix.match(req.prompt)
                depths.append(int(d))
            best = max(depths)
            if best >= MIN_PREFIX_HIT:
                return cand[depths.index(best)], "affinity"
            key = self._family_key(req.prompt)
            if key is not None and self._sticky.get(key) in cand:
                return self._sticky[key], "affinity"
        k = min(
            cand,
            key=lambda i: (
                pressures[i].occupied_slots + pressures[i].pending_total,
                -pressures[i].pages_available,
                i,
            ),
        )
        return k, "load"

    def _route(self, req: Request, t: int, done: dict, cls_of: dict,
               counters: dict, *, first: bool = True) -> None:
        cls = self.classes[req.traffic_class]
        cls_of[req.id] = cls.name
        if self.registry is not None and first:
            # EVERY arrival is an attempt — counted BEFORE the shed
            # decision, or the canonical shed-fraction SLO rule
            # (router_shed_total over router_requests_total) would read
            # burn 0.0 in an all-shed window: sheds with no admits
            # would leave the attempts denominator empty exactly when
            # the overload is worst. Door RETRIES and crash requeues
            # are not second attempts — each request counts once.
            self.registry.counter("router_requests_total").inc(
                **{"class": cls.name}
            )
        # Arrivals land only on PREFILL-CAPABLE replicas:
        # decode-role replicas receive work exclusively through the
        # coordinator's page hand-off. All-mixed fleets filter nothing.
        cand = [k for k in self.live_ids(routable=True)
                if self.roles[k] != "decode"]
        if not cand:
            # No routable replica this tick (a crash mid-heal, or the
            # whole fleet draining): wait at the door — the controller
            # heals before the next routing pass. Already counted as an
            # arrival above (first=False on the retry).
            self._door.append((req, False))
            return
        # One Pressure probe per candidate per ROUTING PASS, not per
        # request: during a pass only submit() mutates scheduler state,
        # and submit changes exactly pending_total (+1 on the chosen
        # replica — applied to the cache below), so the cached probe is
        # decision-identical to a fresh one while routing a
        # million-request trace stops being O(replicas · pending) per
        # arrival. Outside run() (cache unarmed) probes stay fresh.
        cache = self._pressure_cache
        if cache is None:
            pressures = {k: self.scheds[k].pressure() for k in cand}
        else:
            for k in cand:
                if k not in cache:
                    cache[k] = self.scheds[k].pressure()
            pressures = cache
        # While the fleet can still scale out, the door shed DEFERS —
        # capacity is coming, and acting on load beats shedding it
        # (the bulk burst that sheds bulk on a static fleet instead
        # triggers scale-out). At max scale the shed is
        # the backstop again. A shed_exempt request (admitted before
        # its replica crashed) is never re-shed — its admission was
        # decided once.
        defer_shed = req.shed_exempt or (
            self.controller is not None
            and self.controller.defers_door_shed()
        )
        if self.config.shed_threshold is not None and not defer_shed:
            shed_at = self.config.shed_threshold - cls.margin
            backlog = min(pressures[k].occupied_slots
                          + pressures[k].pending_total for k in cand)
            if backlog >= shed_at:
                # Router-level priority shed: no replica has headroom
                # for this class's margin — refuse at the door, decided
                # once, counted per class. (The replica scheduler's own
                # threshold still backstops whatever was admitted.)
                done[req.id] = Completion(
                    id=req.id,
                    prompt_len=int(np.asarray(req.prompt).shape[0]),
                    tokens=[], admitted_step=-1, finished_step=t,
                    status="shed",
                )
                counters["router_sheds"] += 1
                if self.tracer:
                    self.tracer.event("router_shed", req=int(req.id),
                                      tick=t, cls=cls.name,
                                      backlog=int(backlog))
                if self.registry is not None:
                    self.registry.counter("router_shed_total").inc(
                        **{"class": cls.name}
                    )
                return
        replica, reason = self._place(req, cand, pressures)
        counters["placements"][req.id] = replica
        counters["affinity" if reason == "affinity" else "load"] += 1
        if self.config.prefix_affinity:
            key = self._family_key(req.prompt)
            if key is not None:
                # The family now lives where this request went —
                # co-arriving siblings follow before registration lands.
                self._sticky[key] = replica
        if self.tracer:
            self.tracer.event("route", req=int(req.id), tick=t,
                              replica=replica, reason=reason,
                              cls=cls.name)
        if self.registry is not None:
            self.registry.counter(
                "router_affinity_placements_total" if reason == "affinity"
                else "router_load_placements_total"
            ).inc()
        self.scheds[replica].submit(req)
        if self._pressure_cache is not None \
                and replica in self._pressure_cache:
            # Keep the cached probe exact: submit() queued one more
            # pending request on this replica and changed nothing else
            # the placement/shed reads (occupied slots, pages and
            # prefix state move only in tick()/preempt/adopt — never
            # mid-pass).
            p = self._pressure_cache[replica]
            self._pressure_cache[replica] = dataclasses.replace(
                p, pending_total=p.pending_total + 1,
                waiting_eligible=p.waiting_eligible
                + (1 if req.arrival <= t else 0),
            )

    # -- the replica-stepping loop -----------------------------------------

    def run(self, items) -> tuple[dict[int, Completion], RouterStats]:
        """Serve an open-loop stream to completion. Each global tick:
        controller pre-phase (crash delivery, healing, drain
        finalization), route the door queue then every request whose
        arrival has come (shed or submit), controller post-phase
        (preempt, scale), then tick every live replica once, in
        replica order. On a static fleet (no controller) the loop
        fast-forwards over globally idle gaps exactly like the
        scheduler's own tick loop; with a controller every tick is
        real — idle ticks are what drive drain decisions, and skipping
        them would skip a seeded crash tick."""
        reqs = sorted((self._to_request(it) for it in items),
                      key=lambda r: (r.arrival, r.id))
        ids = [r.id for r in reqs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate request ids in {ids}")
        done: dict[int, Completion] = {}
        cls_of: dict[int, str] = {}
        counters = {"placements": {}, "affinity": 0, "load": 0,
                    "router_sheds": 0}
        self._run_counters = counters
        self._collected = {}
        self._requeue_marks: dict[int, int] = {}
        # THIS run's slice of the (possibly shared, possibly reused)
        # tracer: stats derive from records emitted after this point,
        # so a reset-and-rerun router never folds a previous run's
        # timestamps into the new run's SLO samples (a repeated request
        # id would otherwise pair run 1's `eligible` with run 2's
        # `first_token` — a TTFT spanning the inter-run gap).
        rec_start = len(self.tracer.records)
        self._rec_start = rec_start
        for sched in self.scheds:
            if sched is not None:
                sched.begin()
        self._armed = True
        t = 0
        i = 0
        ticks = 0
        # Live per-class TTFT: the shared tracer's records
        # are append-only, so an incremental scan per global tick pairs
        # each new `first_token` with its `eligible` — the SAME
        # definition request_slo_samples derives post-hoc — and
        # observes router_ttft_seconds{class=} (serve_* histograms land
        # in the per-replica registries).
        scanned = rec_start
        eligible_t: dict[int, float] = {}
        # One LIVE sample per request: a crash-requeued request whose
        # first attempt already reached first token must not observe a
        # second, crash-window-excluding TTFT on its re-serve (the
        # post-hoc ClassReport reports the end-to-end spanning value;
        # the live histogram keeps the first genuinely-served latency).
        ttft_observed: set[int] = set()
        shed_prev = 0
        ctrl = self.controller
        try:
            while i < len(reqs) or self._door or any(
                s is not None and not s.idle for s in self.scheds
            ):
                if ctrl is not None:
                    ctrl.begin_tick(t, done)
                # One routing pass (door retries + due arrivals) shares
                # one Pressure cache; the controller/tick phases below
                # mutate scheduler state, so the cache dies with the
                # pass.
                self._pressure_cache = {}
                try:
                    if self._door:
                        door, self._door = self._door, []
                        for req, first in door:
                            self._route(req, t, done, cls_of, counters,
                                        first=first)
                    while i < len(reqs) and reqs[i].arrival <= t:
                        self._route(reqs[i], t, done, cls_of, counters)
                        i += 1
                finally:
                    self._pressure_cache = None
                if ctrl is not None:
                    ctrl.after_route(t)
                if self.disagg is not None:
                    # Hand held first-token prefixes to decode replicas
                    # BEFORE replicas tick: the adoptee decodes this
                    # very tick. Deterministic host state only — the
                    # seeded stream hands off at identical ticks.
                    self.disagg.transfer(t)
                    self.disagg.publish()
                for k, sched in enumerate(self.scheds):
                    if sched is not None and not sched.idle:
                        sched.tick()
                if self.registry is not None:
                    recs = self.tracer.records
                    for r in recs[scanned:]:
                        name = r.get("name")
                        if name == "eligible":
                            # setdefault: FIRST eligible wins, the
                            # request_slo_samples definition; a rid
                            # already observed (crash re-serve) never
                            # re-enters the ledger.
                            rid = r["attrs"]["req"]
                            if rid not in ttft_observed:
                                eligible_t.setdefault(rid, r["t"])
                        elif name == "first_token":
                            rid = r["attrs"]["req"]
                            if rid in eligible_t and rid in cls_of:
                                self.registry.histogram(
                                    "router_ttft_seconds"
                                ).observe(
                                    r["t"] - eligible_t.pop(rid),
                                    **{"class": cls_of[rid]},
                                )
                                ttft_observed.add(rid)
                    scanned = len(recs)
                    total_backlog = 0
                    for k, sched in enumerate(self.scheds):
                        if sched is None:
                            continue
                        p = sched.pressure()
                        outstanding = p.occupied_slots + p.pending_total
                        total_backlog += outstanding
                        self.registry.gauge(
                            "router_replica_outstanding"
                        ).set(outstanding, replica=k)
                    if self.anomaly is not None:
                        # Fleet signals on the global tick clock, both
                        # deterministic.
                        sheds_now = counters["router_sheds"]
                        self.anomaly.tick({"backlog": total_backlog,
                                           "shed_rate": sheds_now - shed_prev})
                        shed_prev = sheds_now
                if self.slo_monitor is not None:
                    # One burn-window step per GLOBAL tick, the clock the
                    # routing decisions use.
                    self.slo_monitor.tick()
                ticks += 1
                t += 1
                if ctrl is None and i < len(reqs) \
                        and all(s.idle for s in self.scheds):
                    # Static-fleet fast-forward only: with a controller
                    # every tick is real (docstring).
                    t = max(t, reqs[i].arrival)
            if ctrl is not None:
                ctrl.finish(t, done)
            for k, sched in enumerate(self.scheds):
                if sched is None:
                    continue
                rd, s = sched.collect()
                done.update(rd)
                self._collected[k] = s
        finally:
            self._armed = False
            self._run_counters = None
            for sched in self.scheds:
                if sched is not None:
                    sched.release()
        replica_stats = [self._collected.get(k)
                         for k in range(len(self.engines))]
        stats = self._stats(done, cls_of, counters, replica_stats, ticks,
                            self.tracer.records[rec_start:])
        return done, stats

    def _stats(self, done, cls_of, counters, replica_stats, ticks,
               records) -> RouterStats:
        from ..utils.metrics import StepStats

        samples = request_slo_samples(
            self._final_serve_records(records, self._requeue_marks)
        )
        per_class: dict[str, ClassReport] = {}
        for name, spec in self.classes.items():
            members = [rid for rid, c in cls_of.items() if c == name]
            if not members:
                continue
            statuses = [done[rid].status for rid in members]
            ttfts = [samples[rid][0] for rid in members if rid in samples]
            itls = [g for rid in members if rid in samples
                    for g in samples[rid][1]]
            ttft_ok = sum(1 for v in ttfts if v <= spec.ttft_slo_s)
            itl_ok = sum(1 for v in itls if v <= spec.itl_slo_s)
            per_class[name] = ClassReport(
                name=name,
                requests=len(members),
                ok=statuses.count("ok"),
                shed=statuses.count("shed"),
                deadline_exceeded=statuses.count("deadline_exceeded"),
                ttft=StepStats.from_times(ttfts),
                itl=StepStats.from_times(itls),
                # Sheds/expiries produced no first token and count as
                # misses: attained = served-within-target / ALL requests.
                ttft_slo_attained=(ttft_ok / len(members)) if members
                else 1.0,
                # No ITL samples is vacuous attainment ONLY when the
                # class actually served something (1-token requests
                # legitimately have no inter-token gaps); a class with
                # zero completions did not attain anything.
                itl_slo_attained=(itl_ok / len(itls)) if itls
                else (1.0 if statuses.count("ok") else 0.0),
            )
            if self.registry is not None:
                # router_ttft_seconds was observed LIVE per global tick
                # in run() (the incremental trace scan) — re-observing
                # here would double-count. ITL stays post-run: per-
                # request gap reconstruction needs the full decode_tick
                # history.
                self.registry.histogram("router_itl_seconds").observe_many(
                    itls, **{"class": name}
                )
                for status in ("ok", "shed", "deadline_exceeded"):
                    n = statuses.count(status)
                    if n:
                        self.registry.counter(
                            "router_completions_total"
                        ).inc(n, **{"class": name, "status": status})
        return RouterStats(
            per_class=per_class,
            placements=dict(counters["placements"]),
            affinity_placements=counters["affinity"],
            load_placements=counters["load"],
            router_sheds=counters["router_sheds"],
            ticks=ticks,
            replica=list(replica_stats),
            fleet=(self.controller.summary()
                   if self.controller is not None else None),
            disagg=(
                {
                    **self.disagg.summary(),
                    "roles": {
                        role: sum(
                            1 for k in self.live_ids()
                            if self.roles[k] == role
                        )
                        for role in sorted(set(self.roles))
                    },
                }
                if self.disagg is not None else None
            ),
        )


# -- CLI spec grammars --------------------------------------------------------


def parse_traffic_spec(spec: str) -> dict:
    """``--traffic`` grammar -> :func:`data.lm.synthesize_mixed_traffic`
    kwargs. Segments are ``;``-separated: global keys
    (``horizon=N``, ``seed=N``, ``max_requests=N``,
    ``burst=START:LEN:MULT[:CLASS]``, ``diurnal=AMPLITUDE:PERIOD``) or
    class segments ``NAME:key=val,...`` with keys ``rate`` (per-tick
    Poisson mean), ``pmin``/``pmax`` (prompt length bounds), ``new``
    (max_new_tokens), ``families``/``fprefix`` (shared-prefix families).
    Example::

        horizon=48;chat:rate=0.6,pmin=8,pmax=24,new=8,families=4,\
fprefix=6;bulk:rate=0.3,pmin=8,pmax=32,new=16
    """
    kw: dict = {"classes": {}}
    key_map = {"rate": ("rate", float), "pmin": ("prompt_min", int),
               "pmax": ("prompt_max", int), "new": ("max_new_tokens", int),
               "families": ("families", int),
               "fprefix": ("family_prefix_len", int)}
    for seg in spec.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        head, _, body = seg.partition(":")
        head = head.strip()
        if "=" in head:  # a global key=value segment
            key, _, val = head.partition("=")
            key = key.strip()
            if key in ("horizon", "seed", "max_requests"):
                kw[key] = int(val)
            elif key == "burst":
                parts = [p.strip() for p in (val + ":" + body).split(":")
                         if p.strip()] if body else \
                    [p.strip() for p in val.split(":")]
                if not 3 <= len(parts) <= 4:
                    raise ValueError(
                        f"burst takes START:LEN:MULT[:CLASS], got {seg!r}"
                    )
                kw["burst"] = (int(parts[0]), int(parts[1]),
                               float(parts[2]),
                               *([parts[3]] if len(parts) == 4 else []))
            elif key == "diurnal":
                parts = [p.strip() for p in (val + ":" + body).split(":")
                         if p.strip()] if body else \
                    [p.strip() for p in val.split(":")]
                if len(parts) != 2:
                    raise ValueError(
                        f"diurnal takes AMPLITUDE:PERIOD, got {seg!r}"
                    )
                kw["diurnal_amplitude"] = float(parts[0])
                kw["diurnal_period"] = int(parts[1])
            else:
                raise ValueError(
                    f"unknown traffic key {key!r} in segment {seg!r}"
                )
            continue
        if not body:
            raise ValueError(
                f"class segment {seg!r} needs NAME:key=val[,key=val...]"
            )
        cls: dict = {}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, eq, val = kv.partition("=")
            key = key.strip()
            if not eq or key not in key_map:
                raise ValueError(
                    f"class {head!r}: bad key {kv!r} "
                    f"(valid: {sorted(key_map)})"
                )
            dest, conv = key_map[key]
            cls[dest] = conv(val)
        kw["classes"][head] = cls
    if not kw["classes"]:
        raise ValueError(
            f"--traffic spec {spec!r} declares no traffic classes"
        )
    return kw


def parse_slo_spec(spec: str, class_names) -> tuple[ClassSpec, ...]:
    """``--slo`` grammar -> :class:`ClassSpec` tuple for the given
    traffic classes. Segments ``NAME:key=val,...`` with keys ``ttft``
    (seconds), ``itl`` (seconds), ``priority`` (0 = most protected),
    ``margin`` (shed margin; default = priority). Classes not named get
    defaults from :data:`DEFAULT_CLASS_SPECS` (matching by name) or a
    zero-priority, no-target spec. Example::

        chat:ttft=0.5,itl=0.1,priority=0;bulk:ttft=60,priority=2
    """
    overrides: dict[str, dict] = {}
    for seg in spec.split(";") if spec else []:
        seg = seg.strip()
        if not seg:
            continue
        name, colon, body = seg.partition(":")
        name = name.strip()
        if not colon or not body:
            raise ValueError(
                f"slo segment {seg!r} needs NAME:key=val[,key=val...]"
            )
        if name not in class_names:
            raise ValueError(
                f"--slo names unknown class {name!r} "
                f"(traffic classes: {sorted(class_names)})"
            )
        kv: dict = {}
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            key, eq, val = part.partition("=")
            key = key.strip()
            if not eq or key not in ("ttft", "itl", "priority", "margin"):
                raise ValueError(
                    f"class {name!r}: bad slo key {part!r} (valid: ttft, "
                    "itl, priority, margin)"
                )
            if key == "ttft":
                kv["ttft_slo_s"] = float(val)
            elif key == "itl":
                kv["itl_slo_s"] = float(val)
            elif key == "priority":
                kv["priority"] = int(val)
            else:
                kv["shed_margin"] = int(val)
        overrides[name] = kv
    defaults = {c.name: c for c in DEFAULT_CLASS_SPECS}
    out = []
    for name in sorted(class_names):
        base = defaults.get(name, ClassSpec(name))
        out.append(dataclasses.replace(base, name=name,
                                       **overrides.get(name, {})))
    return tuple(out)
