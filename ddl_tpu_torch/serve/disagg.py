"""Disaggregated prefill/decode serving — the port of
``ddl_tpu/serve/disagg.py``: phase-specialized replicas behind the router.

Prefill is matmul-bound (whole prompt blocks) while decode is
bandwidth-bound at the attended width; colocating them is why chunked
prefill exists at all (one long prompt stalls every co-resident decoder).
The disaggregated fleet splits the phases across REPLICAS:

- **prefill replicas** run prompts to their first token and then HOLD the
  slot (``Scheduler(role="prefill")`` skips the decode phase wholesale);
- **decode replicas** receive the finished prefix as a PAGE HAND-OFF: the
  coordinator lifts the held slot out with ``Scheduler.preempt``
  (``engine.dump_slot_pages``: the resident pages to the host) and
  installs it with ``Scheduler.adopt`` (``engine.load_slot_pages``: one
  whole-page write into fresh pages of the destination's pool). Pages move
  as bits and sampling keys fold in only (seed, request_id, token_index),
  so the decode replica's tokens equal a colocated run's.

The router places arrivals only on prefill-capable replicas (``prefill``
or ``mixed``); the coordinator runs once a global tick, BEFORE replicas
tick, so a hand-off lands the tick it is decided. Every decision reads
deterministic host state (``Scheduler.pressure()``, occupant probes), so a
seeded stream hands off at identical ticks across runs.

Telemetry: ``handoff_total`` / ``handoff_pages_total`` /
``handoff_bytes_total{path="disagg"}`` counters and
``fleet_replicas_active{role=}`` gauges on the router registry, a
``handoff`` trace event a move, and the transfer's wall time filed under
the SOURCE replica's goodput ``handoff`` phase.
"""

from __future__ import annotations

import time

ROLES = ("prefill", "decode", "mixed")


def parse_roles_spec(spec: str, replicas: int) -> tuple[str, ...]:
    """``--roles`` grammar -> per-replica role tuple. Comma-joined
    ``ROLE=COUNT`` segments (roles from :data:`ROLES`); counts must sum
    to ``replicas`` (the flag SPLITS the declared fleet, it does not
    resize it), and a split fleet needs BOTH sides — at least one
    prefill-capable replica (``prefill``/``mixed``: somewhere for
    arrivals to land), a ``decode``/``mixed`` replica whenever any
    ``prefill`` exists (somewhere for held prefixes to go), and a
    ``prefill`` replica whenever any ``decode`` exists (hand-offs are
    sourced only from prefill replicas — a decode replica in a
    prefill-less fleet would idle forever). Replica ids follow segment
    order. Example::

        prefill=1,decode=2
    """
    counts: dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        role, eq, val = part.partition("=")
        role = role.strip()
        if not eq:
            raise ValueError(f"roles segment {part!r} needs ROLE=COUNT")
        if role not in ROLES:
            raise ValueError(
                f"unknown role {role!r} in segment {part!r} "
                f"(valid: {', '.join(ROLES)})"
            )
        if role in counts:
            raise ValueError(f"role {role!r} named twice in {spec!r}")
        try:
            n = int(val)
        except ValueError:
            raise ValueError(f"roles segment {part!r}: COUNT must be an int")
        if n < 0:
            raise ValueError(f"roles segment {part!r}: COUNT must be >= 0")
        counts[role] = n
    total = sum(counts.values())
    if total == 0:
        raise ValueError(f"roles spec {spec!r} declares no replicas")
    if total != replicas:
        raise ValueError(
            f"roles spec {spec!r} declares {total} replicas but "
            f"--replicas is {replicas} — the spec splits the declared "
            "fleet, make the counts sum to it"
        )
    # Replica ids follow SEGMENT order (the documented contract):
    # "decode=1,prefill=1" makes replica 0 the decode specialist —
    # operators correlate replica ids in traces/registries with the
    # order they wrote.
    roles = tuple(
        role for role in counts for _ in range(counts[role])
    )
    validate_roles(roles)
    return roles


def validate_roles(roles) -> None:
    """The both-sides invariant (``parse_roles_spec`` docstring), also
    enforced on programmatic ``RouterConfig.roles`` tuples: a fleet
    arrivals cannot enter, or held prefixes cannot leave, would spin
    the run loop forever — a config error, never a hang."""
    bad = [r for r in roles if r not in ROLES]
    if bad:
        raise ValueError(
            f"unknown roles {bad} (valid: {', '.join(ROLES)})"
        )
    if not any(r in ("prefill", "mixed") for r in roles):
        raise ValueError(
            f"roles {tuple(roles)} has no prefill-capable replica "
            "(prefill or mixed) — arrivals could never be placed"
        )
    if "prefill" in roles and not any(
        r in ("decode", "mixed") for r in roles
    ):
        raise ValueError(
            f"roles {tuple(roles)} has prefill replicas but no decode-"
            "capable replica (decode or mixed) — held prefixes could "
            "never hand off"
        )
    if "decode" in roles and "prefill" not in roles:
        # The symmetric starvation: hand-offs are sourced only from
        # prefill replicas and arrivals never route to decode ones, so
        # a decode replica in a prefill-less fleet is silently dead
        # capacity — loud config error, same discipline as above.
        raise ValueError(
            f"roles {tuple(roles)} has decode replicas but no prefill "
            "replica to hand work to them — they would sit idle "
            "forever (use mixed, or add a prefill replica)"
        )


class DisaggCoordinator:
    """The prefill->decode hand-off loop (module docstring). Built by
    the router when its config names non-mixed roles; ``transfer`` runs
    once per global tick. ``handoffs``/``handoff_pages`` mirror the
    registry counters for registry-less runs; ``events`` records
    ``(tick, request_id, src, dst, pages)`` — the tick-reproducibility
    pin surface."""

    def __init__(self, router):
        self.router = router
        self.handoffs = 0
        self.handoff_pages = 0
        self.events: list[tuple] = []

    def reset(self) -> None:
        self.handoffs = 0
        self.handoff_pages = 0
        self.events.clear()

    def transfer(self, t: int) -> None:
        """Move every held first-token slot on a prefill replica to the
        best decode-capable replica with room: a free slot AND enough
        available pages for the request's remaining worst case (the
        same bound ``adopt`` re-reserves). Least-loaded destination,
        pages as tie-breaker, replica id as the deterministic last
        word; a prefix that cannot move this tick waits held — decode
        capacity frees as requests finish. DRAINING prefill replicas
        still hand off (that IS their drain); draining decode replicas
        receive nothing new."""
        r = self.router
        dests = [k for k in r.live_ids(routable=True)
                 if r.roles[k] in ("decode", "mixed")]
        srcs = [k for k in r.live_ids()
                if r.roles[k] == "prefill"]
        if not srcs:
            return
        for src in srcs:
            sched = r.scheds[src]
            held = [(s, occ) for s, occ, active
                    in sched.occupant_requests() if active]
            for _, occ in held:
                need = r.engines[src].pages_needed(
                    int(len(occ.prompt)) + occ.max_new_tokens
                )
                ranked = []
                for k in dests:
                    p = r.scheds[k].pressure()
                    if (p.occupied_slots < r.config.serve.slots
                            and p.pages_available >= need):
                        ranked.append((
                            p.occupied_slots + p.pending_total,
                            -p.pages_available, k,
                        ))
                if not ranked:
                    continue  # no room anywhere: stay held this tick
                dst = min(ranked)[2]
                t0 = time.perf_counter()
                pre = sched.preempt(occ.id, path="disagg")
                r.scheds[dst].adopt(pre)
                dt = time.perf_counter() - t0
                pages = int(pre.pos.shape[0])
                r.note_move(occ.id, dst)
                self.handoffs += 1
                self.handoff_pages += pages
                self.events.append((t, int(occ.id), src, dst, pages))
                if sched.goodput is not None:
                    # The transfer is the PREFILL replica's overhead —
                    # the price of specializing — filed outside any
                    # tick bracket (trainer-style add: observed time
                    # grows with it, the sum identity holds).
                    sched.goodput.add("handoff", dt, work=False)
                if r.tracer:
                    r.tracer.event("handoff", req=int(occ.id), tick=t,
                                   src=src, dst=dst, pages=pages)
                if r.registry is not None:
                    r.registry.counter("handoff_total").inc()
                    r.registry.counter("handoff_pages_total").inc(pages)
                    # The fleet-level byte count on the ROUTER
                    # registry — the per-replica count above lives on
                    # the source scheduler's own registry, so neither
                    # double-counts the other.
                    r.registry.counter(
                        "handoff_bytes_total",
                        help="KV bytes moved through the host, by "
                             "hand-off path",
                    ).inc(r.engines[src].handoff_bytes(pages),
                          path="disagg")

    def publish(self) -> None:
        """Per-role live-replica gauges on the router registry
        (``fleet_replicas_active`` with a ``role`` label next to the
        controller's unlabeled total). Draining replicas are excluded exactly as the
        controller's total excludes them."""
        reg = self.router.registry
        if reg is None:
            return
        routable = set(self.router.live_ids(routable=True))
        counts: dict[str, int] = {}
        for k in routable:
            role = self.router.roles[k]
            counts[role] = counts.get(role, 0) + 1
        g = reg.gauge("fleet_replicas_active")
        for role in ROLES:
            if role in counts or any(
                "role" in ls and ls["role"] == role
                for ls in g.label_sets()
            ):
                g.set(counts.get(role, 0), role=role)

    def summary(self) -> dict:
        """JSON-able digest (the CLI / bench surface)."""
        return {
            "handoffs": self.handoffs,
            "handoff_pages": self.handoff_pages,
            "events": [
                {"tick": t, "req": rid, "src": src, "dst": dst,
                 "pages": pages}
                for t, rid, src, dst, pages in self.events
            ],
        }


__all__ = ["ROLES", "DisaggCoordinator", "parse_roles_spec",
           "validate_roles"]
