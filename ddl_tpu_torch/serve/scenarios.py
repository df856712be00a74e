"""The serve scenario library — the port of ``ddl_tpu/serve/scenarios.py``:
seeded traffic, fault and fleet specs as named surfaces.

A scenario is everything a fleet run needs but the model spec and the
engine: seeded traffic (or an explicit seeded request list), class specs,
shed threshold, fleet topology, autoscale policy, fault schedule, role mix.
**bulk_burst** and **replica_crash** are JAX's pinned fleet reproductions;
**diurnal**, **crash_storm**, **role_mix** and **longtail_prefix** are the
policy-search surfaces the twin (``serve.sim``, ``python -m ddl_tpu_torch
sim``) replays. Every scenario is deterministic: traffic is seeded, faults
fire on the tick clock, and the controller's event timeline replays alike
across runs and across engines (real or cost-model; tests/test_torch_twin.py
holds both against JAX's).

Scenario spec grammar (the CLI's ``--scenario``)::

    NAME[:key=value,...]     e.g.  diurnal:horizon=512,rate_scale=4,replicas=16

with override keys ``horizon``, ``max_requests``, ``rate_scale``, ``seed``
(traffic scale, refused by the seeded-request scenarios, whose request
lists are pinned) and ``replicas`` (topology scale; role-mix scenarios
repeat their role pattern to fill). The scenarios, texts and grammar are
JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from ..data.lm import synthesize_mixed_traffic
from ..obs.slo import SloRule
from ..resilience.faults import FaultInjector, FaultSpec, FaultStorm
from .controller import AutoscaleConfig, FleetController
from .engine import ServeConfig
from .router import ClassSpec, RouterConfig
from .scheduler import Request

__all__ = [
    "Scenario", "SeededRequest", "SCENARIOS", "get_scenario",
    "parse_scenario",
    "BULK_BURST", "REPLICA_CRASH", "DIURNAL", "CRASH_STORM", "ROLE_MIX",
    "LONGTAIL_PREFIX",
]


@dataclasses.dataclass(frozen=True)
class SeededRequest:
    """One pinned request: the prompt is
    ``default_rng(prompt_seed).integers(1, vocab, size=prompt_len)`` —
    the exact ``_prompt`` recipe the fleet tests pinned."""

    prompt_len: int
    prompt_seed: int
    max_new_tokens: int
    arrival: int
    traffic_class: str


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded fleet scenario. Builder methods construct the run's
    pieces (traffic, ServeConfig, RouterConfig, controller) so a test and
    the sim CLI assemble the same run from the one definition."""

    name: str
    description: str
    classes: tuple
    replicas: int = 1
    slots: int = 1
    capacity: int = 64
    page_size: int = 0
    num_pages: int = 0
    prefix_slots: int | None = None  # None = ServeConfig default
    shed_threshold: int | None = None
    traffic: Mapping | None = None  # synthesize_mixed_traffic kwargs
    seeded_requests: tuple = ()  # explicit pinned request list
    autoscale: AutoscaleConfig | None = None
    faults: tuple = ()  # FaultSpec schedule (1 -> FaultInjector, n -> storm)
    roles: tuple | None = None  # per-replica role pattern (disagg)
    slo_rule_classes: tuple = ()  # shed-burn rule order (pinned)

    def __post_init__(self):
        if (self.traffic is None) == (not self.seeded_requests):
            raise ValueError(
                f"scenario {self.name!r}: define traffic XOR "
                "seeded_requests — a scenario with neither generates no "
                "load, with both an ambiguous one"
            )

    # -- builders ----------------------------------------------------------

    def build_traffic(self, vocab: int, *, horizon: int | None = None,
                      max_requests: int | None = None,
                      rate_scale: float = 1.0, seed: int | None = None):
        """The scenario's request list. Traffic scenarios accept scale
        overrides; seeded-request scenarios are pinned, and an override is
        a loud error, not a silent no-op."""
        if self.seeded_requests:
            if horizon is not None or max_requests is not None \
                    or rate_scale != 1.0 or seed is not None:
                raise ValueError(
                    f"scenario {self.name!r} pins an explicit request "
                    "list — horizon/max_requests/rate_scale/seed do not "
                    "apply"
                )
            return [
                Request(
                    id=i,
                    prompt=np.random.default_rng(sr.prompt_seed).integers(
                        1, vocab, size=sr.prompt_len, dtype=np.int32
                    ),
                    max_new_tokens=sr.max_new_tokens,
                    arrival=sr.arrival,
                    traffic_class=sr.traffic_class,
                )
                for i, sr in enumerate(self.seeded_requests)
            ]
        kw = {k: v for k, v in self.traffic.items()}
        if rate_scale != 1.0:
            if rate_scale <= 0:
                raise ValueError(f"rate_scale must be > 0, got {rate_scale}")
            kw["classes"] = {
                c: {**spec, "rate": spec["rate"] * rate_scale}
                for c, spec in kw["classes"].items()
            }
        if horizon is not None:
            kw["horizon"] = horizon
        if max_requests is not None:
            kw["max_requests"] = max_requests
        if seed is not None:
            kw["seed"] = seed
        return synthesize_mixed_traffic(vocab=vocab, **kw)

    def serve_config(self, spec, **over) -> ServeConfig:
        kw = dict(spec=spec, slots=self.slots, capacity=self.capacity)
        if self.page_size:
            kw["page_size"] = self.page_size
            if self.num_pages:
                kw["num_pages"] = self.num_pages
        if self.prefix_slots is not None:
            kw["prefix_slots"] = self.prefix_slots
        kw.update(over)
        return ServeConfig(**kw)

    def router_config(self, spec, *, replicas: int | None = None,
                      engine_factory=None, **over) -> RouterConfig:
        n = self.replicas if replicas is None else replicas
        kw = dict(serve=self.serve_config(spec), replicas=n,
                  classes=self.classes)
        if self.shed_threshold is not None:
            kw["shed_threshold"] = self.shed_threshold
        if self.roles is not None:
            pattern = self.roles
            kw["roles"] = tuple(pattern[i % len(pattern)]
                                for i in range(n))
        if engine_factory is not None:
            kw["engine_factory"] = engine_factory
        kw.update(over)
        return RouterConfig(**kw)

    def make_injector(self):
        """The scenario's fault injector: one spec is a plain
        :class:`FaultInjector`, several a :class:`FaultStorm`, none is
        ``None``."""
        if not self.faults:
            return None
        if len(self.faults) == 1:
            return FaultInjector(self.faults[0])
        return FaultStorm(self.faults)

    def make_controller(self, *, autoscale: AutoscaleConfig | None = None,
                        replicas: int | None = None):
        """A fresh :class:`FleetController` (with the scenario's fault
        schedule injected), or ``None`` for a static no-fault fleet.
        ``autoscale`` overrides the scenario's policy (the policy-sweep
        knob); ``replicas`` sizes the synthesized static controller when
        the topology is scaled past the scenario default (the sim CLI's
        ``replicas=`` override)."""
        acfg = self.autoscale if autoscale is None else autoscale
        inj = self.make_injector()
        if acfg is None and inj is None:
            return None
        if acfg is None:
            # A fault schedule needs a controller to deliver it; a
            # static fleet that never scales still heals.
            n = self.replicas if replicas is None else replicas
            acfg = AutoscaleConfig(max_replicas=n, min_replicas=n,
                                   preempt=False,
                                   backlog_per_replica=1e9)
        return FleetController(acfg, injector=inj)

    def slo_rules(self, *, objective: float = 0.5, fast_window: int = 3,
                  slow_window: int = 6) -> tuple:
        """Per-class shed burn-rate rules over the router's own
        counters, in the scenario's pinned rule order."""
        return tuple(
            SloRule(name=f"{c}_shed", metric="router_shed_total",
                    total_metric="router_requests_total",
                    labels={"class": c}, objective=objective,
                    fast_window=fast_window, slow_window=slow_window)
            for c in self.slo_rule_classes
        )


# -- the pinned fleet scenarios ------------------------------------------------

BULK_BURST = Scenario(
    name="bulk_burst",
    description="Seeded bulk burst: a 6x bulk spike at "
                "ticks 4-10 over steady chat+bulk Poisson traffic — the "
                "static fleet sheds and fires bulk_shed; the autoscale "
                "arm scales out instead (tick-reproducible pin).",
    classes=(ClassSpec("chat", priority=0),
             ClassSpec("bulk", priority=1, shed_margin=1)),
    replicas=1, slots=1, capacity=64, shed_threshold=2,
    traffic=dict(
        classes={
            "chat": dict(rate=0.3, prompt_min=4, prompt_max=8,
                         max_new_tokens=2),
            "bulk": dict(rate=0.4, prompt_min=4, prompt_max=8,
                         max_new_tokens=2),
        },
        horizon=16, seed=0, burst=(4, 6, 6.0, "bulk"), max_requests=16,
    ),
    autoscale=AutoscaleConfig(max_replicas=2, min_replicas=1,
                              backlog_per_replica=2.0, sustain_ticks=2,
                              idle_ticks=4, preempt=False),
    slo_rule_classes=("bulk", "chat"),
)

REPLICA_CRASH = Scenario(
    name="replica_crash",
    description="Seeded crash: replica 1 dies wholesale at "
                "tick 2 mid-decode; in-flight and queued requests "
                "requeue at the door, the fleet heals to min_replicas, "
                "every request completes exactly once (pinned).",
    classes=(ClassSpec("bulk", priority=1),),
    replicas=2, slots=1, capacity=32, page_size=8, num_pages=8,
    seeded_requests=tuple(
        SeededRequest(prompt_len=6, prompt_seed=10 + i, max_new_tokens=6,
                      arrival=i // 2, traffic_class="bulk")
        for i in range(4)
    ),
    faults=(FaultSpec(kind="replica_crash", step=2, replica=1),),
    autoscale=AutoscaleConfig(max_replicas=2, min_replicas=2,
                              preempt=False, backlog_per_replica=10.0),
)

# -- policy-search scenarios --------------------------------------------------

DIURNAL = Scenario(
    name="diurnal",
    description="Day/night sinusoidal load (amplitude 0.8, period 32 "
                "ticks) over chat+bulk — the autoscale ride-the-wave "
                "scenario; scale horizon/rate_scale/replicas for the "
                "million-request twin run.",
    classes=(ClassSpec("chat", priority=0),
             ClassSpec("bulk", priority=1, shed_margin=1)),
    replicas=2, slots=2, capacity=64, shed_threshold=4,
    traffic=dict(
        classes={
            "chat": dict(rate=0.5, prompt_min=4, prompt_max=8,
                         max_new_tokens=2),
            "bulk": dict(rate=0.3, prompt_min=4, prompt_max=8,
                         max_new_tokens=4),
        },
        horizon=64, seed=1, diurnal_amplitude=0.8, diurnal_period=32,
    ),
    autoscale=AutoscaleConfig(max_replicas=4, min_replicas=1,
                              backlog_per_replica=2.0, sustain_ticks=2,
                              idle_ticks=8, preempt=False),
    slo_rule_classes=("bulk", "chat"),
)

CRASH_STORM = Scenario(
    name="crash_storm",
    description="Two replica crashes in one run (ticks 3 and 9) under "
                "steady mixed load — the repeated-heal scenario a "
                "single-fault run never reaches.",
    classes=(ClassSpec("chat", priority=0), ClassSpec("bulk", priority=1)),
    replicas=3, slots=1, capacity=32, page_size=8, num_pages=8,
    traffic=dict(
        classes={
            "chat": dict(rate=0.3, prompt_min=4, prompt_max=8,
                         max_new_tokens=2),
            "bulk": dict(rate=0.3, prompt_min=4, prompt_max=8,
                         max_new_tokens=4),
        },
        horizon=24, seed=2, max_requests=24,
    ),
    faults=(FaultSpec(kind="replica_crash", step=3, replica=1),
            FaultSpec(kind="replica_crash", step=9, replica=2)),
    autoscale=AutoscaleConfig(max_replicas=3, min_replicas=3,
                              preempt=False, backlog_per_replica=10.0),
)

ROLE_MIX = Scenario(
    name="role_mix",
    description="Disaggregated prefill/decode fleet (1:2 role pattern, "
                "repeated to fill larger fleets) under mixed load — the "
                "prefill:decode ratio sweep surface.",
    classes=(ClassSpec("chat", priority=0), ClassSpec("bulk", priority=1)),
    replicas=3, slots=2, capacity=32, page_size=8, num_pages=16,
    roles=("prefill", "decode", "decode"),
    traffic=dict(
        classes={
            "chat": dict(rate=0.4, prompt_min=4, prompt_max=8,
                         max_new_tokens=2),
            "bulk": dict(rate=0.3, prompt_min=4, prompt_max=8,
                         max_new_tokens=4),
        },
        horizon=32, seed=3, max_requests=32,
    ),
)

LONGTAIL_PREFIX = Scenario(
    name="longtail_prefix",
    description="Prefix-family longtail: chat traffic drawn from 4 "
                "shared 8-token prefix families — the affinity/prefix-"
                "cache scenario (hit economics at fleet scale).",
    classes=(ClassSpec("chat", priority=0),),
    replicas=2, slots=2, capacity=64, page_size=8, num_pages=32,
    prefix_slots=8,
    traffic=dict(
        classes={
            "chat": dict(rate=0.8, prompt_min=10, prompt_max=18,
                         max_new_tokens=2, families=4,
                         family_prefix_len=8),
        },
        horizon=48, seed=4, max_requests=64,
    ),
)

SCENARIOS = {
    s.name: s
    for s in (BULK_BURST, REPLICA_CRASH, DIURNAL, CRASH_STORM, ROLE_MIX,
              LONGTAIL_PREFIX)
}

_OVERRIDE_KEYS = ("horizon", "max_requests", "rate_scale", "seed",
                  "replicas")


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r} (choices: "
            f"{', '.join(sorted(SCENARIOS))})"
        )
    return SCENARIOS[name]


def parse_scenario(text: str):
    """``NAME[:key=value,...]`` -> ``(Scenario, overrides dict)``.
    Override keys: horizon, max_requests, seed, replicas (ints);
    rate_scale (float). Unknown names and keys are loud errors."""
    name, colon, rest = text.partition(":")
    scenario = get_scenario(name)
    over: dict = {}
    if colon and rest:
        for part in rest.split(","):
            key, eq, val = part.partition("=")
            if not eq or key not in _OVERRIDE_KEYS:
                raise ValueError(
                    f"bad scenario override {part!r} (keys: "
                    f"{', '.join(_OVERRIDE_KEYS)})"
                )
            try:
                over[key] = float(val) if key == "rate_scale" else int(val)
            except ValueError:
                raise ValueError(
                    f"bad scenario override value {part!r}"
                )
    return scenario, over
