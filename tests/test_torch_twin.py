"""The digital twin (ddl_tpu_torch/serve/sim.py, serve/scenarios.py) against
``ddl_tpu`` on the CPU.

Pinned against JAX's twin, on each of the six scenarios (exact): the
controller's events, every request's status, ``admitted_step``,
``finished_step`` and hashed tokens, the per-class tallies, the router's
sheds, each SLO rule's ledger, and the virtual time of each phase. JAX's
twin raises ``AttributeError`` under a registry wherever its control plane
prices a hand-off (``CostModelEngine`` has no ``handoff_bytes``:
replica_crash's requeues, role_mix's disagg hand-offs); there JAX's twin
runs without one and the port's with one. Also held to JAX: the scenario
grammar and its error texts, the pinned request lists, ``_sim_token``,
``phase_cost_fit`` -> ``CostModel`` and its errors.

Port-only: the port's twin and its real fleet (tiny width, the CPU) make
the same decisions tick for tick on bulk_burst and replica_crash, with a
registry on both, ``handoff_bytes_total`` equal; the sim engine drives the
real scheduler, preempts and adopts like the real engine, and refuses
speculation; ``/healthz`` and ``fleet_summary`` say which engine kind
served; a twin's trace reads through ``obs.analyze``.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from ddl_tpu.models.transformer import TINY_SPEC as JSPEC
from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu.obs import Tracer as JTracer
from ddl_tpu.obs.goodput import phase_cost_fit as jfit
from ddl_tpu.obs.slo import SloMonitor as JMonitor
from ddl_tpu.serve import Router as JRouter
from ddl_tpu.serve import scenarios as jscn
from ddl_tpu.serve import sim as jsim
from ddl_tpu_torch.models.transformer import TINY_SPEC as TSPEC
from ddl_tpu_torch.obs import MetricRegistry, Tracer
from ddl_tpu_torch.obs.analyze import build_report
from ddl_tpu_torch.obs.export import MetricsExporter
from ddl_tpu_torch.obs.goodput import fleet_summary, phase_cost_fit
from ddl_tpu_torch.obs.slo import SloMonitor
from ddl_tpu_torch.serve import Request, Router, Scheduler, ServeConfig
from ddl_tpu_torch.serve import scenarios as tscn
from ddl_tpu_torch.serve import sim as tsim
from ddl_tpu_torch.serve.engine_iface import ServeEngine, engine_kind

SCENARIOS = list(tscn.SCENARIOS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arm(pkg, name, *, sim=True, registry=True):
    """One fleet run of scenario ``name`` in package ``pkg``: the twin
    (``sim``) or real engines on the CPU (the port only)."""
    if pkg == "jax":
        scn, spec, R, Tr, M, S = (jscn.SCENARIOS[name], JSPEC, JRegistry, JTracer, JMonitor,
                                  JRouter)
        factory, where = jsim.sim_engine_factory(), {}
    else:
        scn, spec, R, Tr, M, S = (tscn.SCENARIOS[name], TSPEC, MetricRegistry, Tracer,
                                  SloMonitor, Router)
        factory = tsim.sim_engine_factory() if sim else None
        # Real engines serve the port's seeded init on the CPU.
        where = {} if sim else dict(device="cpu")
    reg, tracer = (R() if registry else None), Tr()
    mon = (M(scn.slo_rules(), reg, tracer=tracer)
           if scn.slo_rule_classes and registry else None)
    ctrl = scn.make_controller()
    router = S(scn.router_config(spec, engine_factory=factory), registry=reg, tracer=tracer,
               slo_monitor=mon, controller=ctrl, **where)
    done, stats = router.run(scn.build_traffic(spec.vocab))
    vt = {}
    for eng in router.engines:
        if eng is not None and sim:
            for k, v in eng.virtual_time().items():
                vt[k] = vt.get(k, 0.0) + v
    return dict(done=done, stats=stats, ctrl=ctrl, mon=mon, reg=reg, tracer=tracer,
                router=router, vt=vt)


def _decisions(arm, tokens=True):
    out = {i: (c.status, c.admitted_step, c.finished_step) + ((tuple(c.tokens),) if tokens
                                                                else ())
           for i, c in arm["done"].items()}
    return dict(
        events=arm["ctrl"].events if arm["ctrl"] is not None else None,
        done=out,
        per_class={c: (r.requests, r.ok, r.shed, r.deadline_exceeded)
                   for c, r in arm["stats"].per_class.items()},
        sheds=arm["stats"].router_sheds, placements=arm["stats"].placements,
        ticks=arm["stats"].ticks,
    )


@pytest.mark.parametrize("name", SCENARIOS)
def test_twin_matches_jax_twin(name):
    """Decisions, hashed tokens, tallies, sheds, SLO ledgers and virtual
    time, exactly; JAX's twin runs without a registry where it raises
    under one."""
    try:
        theirs = _arm("jax", name)
    except AttributeError as e:
        assert "handoff_bytes" in str(e) and name in ("replica_crash", "role_mix")
        theirs = _arm("jax", name, registry=False)
    ours = _arm("port", name)
    assert _decisions(ours) == _decisions(theirs)
    assert ours["vt"] == theirs["vt"] and ours["vt"]["total"] > 0
    if theirs["mon"] is not None:
        for r in ours["mon"].rules:
            assert (ours["mon"].alerts(r.name), ours["mon"].fired_ticks(r.name),
                    ours["mon"].cumulative(r.name)) == \
                (theirs["mon"].alerts(r.name), theirs["mon"].fired_ticks(r.name),
                 theirs["mon"].cumulative(r.name)), r.name
    assert fleet_summary(ours["reg"])["engine_kind"] == "sim"
    if name in ("replica_crash", "role_mix"):
        # The hand-offs JAX's twin cannot price under a registry.
        c = ours["reg"].get("handoff_bytes_total")
        assert c is not None and sum(c.value(**ls) for ls in c.label_sets()) > 0


@pytest.mark.parametrize("name", ["bulk_burst", "replica_crash"])
def test_twin_is_the_real_fleet_tick_for_tick(name):
    """The port's twin against the port's real fleet, a registry on both:
    the same decisions (tokens aside: the twin hashes them), SLO ledgers,
    router counters and hand-off bytes; two twin runs are the same."""
    real = _arm("port", name, sim=False)
    sim1, sim2 = _arm("port", name), _arm("port", name)
    assert _decisions(sim1, tokens=False) == _decisions(real, tokens=False)
    assert _decisions(sim2) == _decisions(sim1)
    if real["mon"] is not None:
        for r in real["mon"].rules:
            assert sim1["mon"].cumulative(r.name) == real["mon"].cumulative(r.name)

    def counters(reg, prefix):
        out = {}
        for m in reg.metrics():
            if m.kind == "counter" and m.name.startswith(prefix):
                out.update({(m.name, tuple(sorted(ls.items()))): m.value(**ls)
                            for ls in m.label_sets()})
        return out

    for prefix in ("router_", "fleet_", "scale_", "handoff_bytes_total"):
        assert counters(sim1["reg"], prefix) == counters(real["reg"], prefix), prefix
    if name == "replica_crash":
        assert real["ctrl"].crashes == 1 and real["stats"].replica[1] is None
        assert counters(real["reg"], "handoff_bytes_total")
    else:
        assert real["ctrl"].scale_outs >= 1
    assert (fleet_summary(sim1["reg"])["engine_kind"],
            fleet_summary(real["reg"])["engine_kind"]) == ("sim", "real")
    kinds = [f["kind"] for f in build_report(sim1["tracer"].records)["fleet_incidents"]]
    assert kinds == [f["kind"] for f in build_report(real["tracer"].records)["fleet_incidents"]]


def test_scenario_grammar_and_requests_match_jax():
    assert list(tscn.SCENARIOS) == list(jscn.SCENARIOS)
    for text in ("diurnal:horizon=128,rate_scale=2.5", "bulk_burst", "crash_storm:seed=3,"
                 "replicas=5", "role_mix:"):
        scn, over = tscn.parse_scenario(text)
        jscn_, jover = jscn.parse_scenario(text)
        assert (scn.name, over) == (jscn_.name, jover)
    for bad in ("rush_hour", "diurnal:frobs=2", "diurnal:horizon", "diurnal:seed=x",
                "bulk_burst:rate_scale=fast"):
        with pytest.raises(ValueError) as ours:
            tscn.parse_scenario(bad)
        with pytest.raises(ValueError) as theirs:
            jscn.parse_scenario(bad)
        assert str(ours.value) == str(theirs.value)
    for name, kw in (("replica_crash", dict(rate_scale=2.0)), ("diurnal", dict(rate_scale=0))):
        with pytest.raises(ValueError) as ours:
            tscn.SCENARIOS[name].build_traffic(32, **kw)
        with pytest.raises(ValueError) as theirs:
            jscn.SCENARIOS[name].build_traffic(32, **kw)
        assert str(ours.value) == str(theirs.value)
    for name in SCENARIOS:
        ours = tscn.SCENARIOS[name].build_traffic(TSPEC.vocab, **(
            {} if name == "replica_crash" else dict(horizon=12, rate_scale=1.5, seed=7)))
        theirs = jscn.SCENARIOS[name].build_traffic(JSPEC.vocab, **(
            {} if name == "replica_crash" else dict(horizon=12, rate_scale=1.5, seed=7)))
        assert [(r.id, r.arrival, r.max_new_tokens, r.traffic_class, np.asarray(r.prompt).tolist())
                for r in ours] == \
            [(r.id, r.arrival, r.max_new_tokens, r.traffic_class, np.asarray(r.prompt).tolist())
             for r in theirs], name
    rng = np.random.default_rng(0)
    for seed, rid, idx, vocab in rng.integers(0, 2**40, size=(64, 4)):
        args = (int(seed), int(rid), int(idx), int(vocab % 300) + 1)
        assert tsim._sim_token(*args) == jsim._sim_token(*args)


def test_cost_fit_round_trip_matches_jax(tmp_path):
    """``phase_cost_fit`` of a metrics file -> ``CostModel``, both packages
    on the same file (equal floats), and their errors."""
    reg = MetricRegistry()
    reg.gauge("time_in_seconds").set(0.6, phase="prefill")
    reg.gauge("time_in_seconds").set(0.4, phase="decode")
    reg.gauge("time_in_seconds").set(0.03, phase="handoff")
    reg.counter("serve_prefill_tokens_total").inc(500)
    reg.counter("handoff_pages_total").inc(12)
    for _ in range(100):
        reg.histogram("serve_decode_step_seconds").observe(0.004)
    path = tmp_path / "m.jsonl"
    path.write_text(json.dumps({"record": "manifest"}) + "\n"
                    + json.dumps({"record": "snapshot", "metrics": reg.snapshot()}) + "\n")
    for phases in (("prefill", "decode"), ("prefill", "decode", "handoff")):
        fit = phase_cost_fit(str(path), phases=phases)
        assert fit == jfit(str(path), phases=phases) == phase_cost_fit(reg, phases=phases)
        assert dataclasses.asdict(tsim.CostModel.from_phase_fit(fit)) == \
            dataclasses.asdict(jsim.CostModel.from_phase_fit(fit))
    assert tsim.CostModel.from_phase_fit(fit).handoff_s_per_page == 0.03 / 12
    for bad in ({"prefill_s_per_token": 1e-4}, {}):
        with pytest.raises(ValueError) as ours:
            tsim.CostModel.from_phase_fit(bad)
        with pytest.raises(ValueError) as theirs:
            jsim.CostModel.from_phase_fit(bad)
        assert str(ours.value) == str(theirs.value)


def test_sim_engine_drives_the_scheduler_and_hands_off():
    """The protocol, the real scheduler end to end (warm-up ladder, prefix
    pool), preempt/adopt with the hashed stream unchanged, the hand-off's
    virtual time and bytes (the real engine's formula), pools whole, and
    the refusal of speculation with JAX's text."""
    cfg = ServeConfig(spec=TSPEC, slots=2, capacity=32, page_size=8, num_pages=12,
                      prefix_slots=4)
    eng = tsim.CostModelEngine(cfg)
    assert isinstance(eng, ServeEngine) and engine_kind(eng) == "sim"
    rng = np.random.default_rng(30)
    reqs = [Request(id=i, prompt=rng.integers(1, TSPEC.vocab, size=6, dtype=np.int32),
                    max_new_tokens=4) for i in range(3)]
    sched = Scheduler(eng)
    sched.warmup(reqs)
    done, _ = sched.run(reqs)
    assert {c.status for c in done.values()} == {"ok"}
    vt = eng.virtual_time()
    assert vt["prefill"] > 0 and vt["decode"] > 0 and vt["handoff"] == 0
    assert eng.pages.free == eng.num_pages and eng.pages.reserved == 0
    from ddl_tpu_torch.serve import InferenceEngine

    real = InferenceEngine(cfg, device="cpu")
    assert eng.handoff_bytes(3) == real.handoff_bytes(3) > 0
    one = ServeConfig(spec=TSPEC, slots=1, capacity=32, page_size=8, num_pages=8)
    req = Request(id=0, prompt=reqs[0].prompt, max_new_tokens=6)
    oracle, _ = Scheduler(tsim.CostModelEngine(one)).run([req])
    ea, eb = tsim.CostModelEngine(one), tsim.CostModelEngine(one)
    sa, sb = Scheduler(ea, registry=MetricRegistry()), Scheduler(eb)
    sa.begin()
    sb.begin()
    sa.submit(req)
    for _ in range(3):
        sa.tick()
    pre = sa.preempt(0)
    assert pre.k.shape[1] == pre.pos.shape[0]
    sb.adopt(pre)
    while not sb.idle:
        sb.tick()
    assert sa.collect()[0] == {}
    done_b, _ = sb.collect()
    assert done_b[0].tokens == oracle[0].tokens and ea.virtual_time()["handoff"] > 0
    c = sa.registry.get("handoff_bytes_total")
    assert c.value(path="preempt") == ea.handoff_bytes(pre.pos.shape[0])
    for e in (ea, eb):
        assert e.pages.free == e.num_pages and e.pages.reserved == 0
    bad = dict(spec=TSPEC, slots=2, capacity=32, page_size=8, num_pages=16, speculate_k=2)
    with pytest.raises(ValueError) as ours:
        tsim.CostModelEngine(ServeConfig(**bad))
    with pytest.raises(ValueError) as theirs:
        from ddl_tpu.serve import ServeConfig as JConfig

        jsim.CostModelEngine(JConfig(**{**bad, "spec": JSPEC}))
    assert str(ours.value) == str(theirs.value)


def test_healthz_says_which_engine_served():
    """A twin run's router registry says ``sim`` on ``/healthz`` (a local
    port) and in ``fleet_summary``; a registry no router stamped says
    nothing."""
    assert "engine_kind" not in fleet_summary(MetricRegistry())
    arm = _arm("port", "crash_storm")
    with MetricsExporter(arm["reg"], 0) as exp:
        health = json.loads(urllib.request.urlopen(exp.url("/healthz"), timeout=10).read())
    assert health["engine_kind"] == "sim"
