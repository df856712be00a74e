"""Serve observability (the scheduler's and the router's telemetry, the
controller's burn rules, the engine's program hooks) against ``ddl_tpu`` on
the CPU, at a tiny width (vocab 32, d_model 32, 2 heads, 2 layers, d_ff 64)
and the same weights (JAX's init carried over as numpy).

Each JAX oracle runs once, in a module fixture:

- ``sched_runs``: one paged scheduler with a prefix cache, chunked prefill
  and a shed threshold over two prompt families, with every telemetry hook
  on (registry, metrics writer, a ``keep=True`` tracer, an SLO monitor, an
  anomaly detector, ``peak_flops``), run without a warm-up (so each
  program's build lands in the run's trace), in both packages; the port's
  run again with telemetry off.
- ``router_runs``: ``serve.scenarios.BULK_BURST``'s fleet on real engines
  under an autoscaler whose ``burn=`` rule names a TTFT rule that every
  bulk first token misses (target 1 ns: a count, not a wall-clock reading),
  with the router's SLO monitor and anomaly detector, in both packages.

Pinned against JAX (exact): every counter of the scheduler's registry
(``xla_compiles_total{kind=}`` among them) and its programs' collective
ledger labels; the ``compile`` trace events in order; each SLO rule's
``alerts``, ``fired_ticks`` and ``cumulative``; the anomaly
``fired_ticks`` of the host-state signals
(``queue_depth``, ``active_slots``, ``occupied_slots``, ``pages_free``;
the router's ``backlog`` and ``shed_rate``), the wall-clock signals only
present; the controller's events (a ``reason="burn"`` scale-out among
them) and the router's counters. Port-only: telemetry changes no token,
status or step; the goodput phases sum to ``time_observed_seconds`` within
1e-9 relative; ``obs.analyze``'s report of the run's trace gives TTFT and
ITL equal to ``derive_request_slo``'s.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from ddl_tpu import serve as js
from ddl_tpu.models import transformer as jt
from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu.obs import Tracer as JTracer
from ddl_tpu.obs.anomaly import AnomalyDetector as JDetector
from ddl_tpu.obs.anomaly import parse_anomaly_rules as jparse_anomaly
from ddl_tpu.obs.slo import SloMonitor as JMonitor
from ddl_tpu.obs.slo import parse_slo_rules as jparse_slo
from ddl_tpu.serve import scenarios as jscn
from ddl_tpu_torch import serve as ts
from ddl_tpu_torch.data import lm as tlm
from ddl_tpu_torch.models.transformer import LMSpec
from ddl_tpu_torch.obs import MetricRegistry, MetricsWriter, run_manifest
from ddl_tpu_torch.obs.analyze import build_report
from ddl_tpu_torch.obs.anomaly import AnomalyDetector, parse_anomaly_rules
from ddl_tpu_torch.obs.slo import SloMonitor, parse_slo_rules
from ddl_tpu_torch.obs.trace import Tracer
from ddl_tpu_torch.serve import scenarios as tscn

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)
SERVE_KW = dict(slots=2, capacity=64, page_size=8, prefix_slots=2, prefill_chunk=8)
# A 1 ns TTFT target: every first token is a miss, so the ledger counts
# samples and never reads a clock.
SCHED_SLO = ("ttft:metric=serve_ttft_seconds,target=1e-9,objective=0.5,fast=2,slow=4;"
             "shed:metric=serve_shed_total,total=serve_requests_completed_total,"
             "objective=0.5,fast=2,slow=4")
HOST = ("queue_depth", "active_slots", "occupied_slots", "pages_free")
WALL = ("step_time", "itl", "mfu")
SCHED_ANOMALY = ";".join([f"{s}:window=4,min=2,threshold=1" for s in HOST] + list(WALL))
ROUTER_SLO = ("bulk_ttft:metric=router_ttft_seconds,label.class=bulk,target=1e-9,"
              "objective=0.5,fast=2,slow=4;bulk_shed:metric=router_shed_total,"
              "total=router_requests_total,label.class=bulk,objective=0.5,fast=3,slow=6")
ROUTER_ANOMALY = "backlog:window=4,min=2,threshold=1;shed_rate:window=4,min=2,threshold=1"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), JSPEC))


def _prompts():
    return tlm.synthesize_shared_prefix_prompts(n_families=2, per_family=3, prefix_len=12,
                                                tail_min=1, tail_max=10, vocab=32, seed=1)


def _sched_run(pkg, weights, tmp, telemetry: bool):
    """One scheduler run, no warm-up; pkg "jax" or "port"."""
    if pkg == "jax":
        eng = js.InferenceEngine(js.ServeConfig(spec=JSPEC, **SERVE_KW), params=weights)
        R, Tr, M, D, slo, anom = (JRegistry, JTracer, JMonitor, JDetector, jparse_slo,
                                  jparse_anomaly)
        Sched, Req = js.Scheduler, js.Request
    else:
        eng = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, **SERVE_KW), params=weights,
                                 device="cpu")
        R, Tr, M, D, slo, anom = (MetricRegistry, Tracer, SloMonitor, AnomalyDetector,
                                  parse_slo_rules, parse_anomaly_rules)
        Sched, Req = ts.Scheduler, ts.Request
    reqs = [Req(id=i, prompt=np.asarray(p, np.int32), max_new_tokens=4, arrival=i // 2)
            for i, p in enumerate(_prompts())]
    kw = {}
    if telemetry:
        reg, tracer = R(), Tr(keep=True)
        kw = dict(registry=reg, tracer=tracer, slo_monitor=M(slo(SCHED_SLO), reg),
                  anomaly_detector=D(anom(SCHED_ANOMALY), reg), peak_flops=1e12)
        if pkg == "port":
            kw["metrics_writer"] = MetricsWriter(str(tmp / "m.jsonl"), reg, run_manifest())
    sched = Sched(eng, shed_threshold=3, **kw)
    done, stats = sched.run(reqs)
    if kw.get("metrics_writer") is not None:
        kw["metrics_writer"].close()
    return dict(done=done, stats=stats, sched=sched, **kw)


@pytest.fixture(scope="module")
def sched_runs(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_obs")
    return {"jax": _sched_run("jax", weights, tmp, True),
            "port": _sched_run("port", weights, tmp, True),
            "port_off": _sched_run("port", weights, tmp, False), "tmp": tmp}


def _counters(reg):
    out = {}
    for m in reg.metrics():
        if m.kind == "counter":
            for ls in m.label_sets():
                out[(m.name, tuple(sorted(ls.items())))] = m.value(**ls)
    return out


def _labels(reg, name):
    m = reg.get(name)
    return sorted(tuple(sorted(ls.items())) for ls in m.label_sets())


def test_scheduler_counters_and_compiles_match_jax(sched_runs):
    j, p = sched_runs["jax"], sched_runs["port"]
    assert _counters(p["registry"]) == _counters(j["registry"])
    kinds = {dict(k[1])["kind"] for k in _counters(p["registry"]) if k[0] == "xla_compiles_total"}
    assert kinds == {"prefill", "decode", "prefix_copy", "pages_reset"}
    # One ledger a program, the xla_compiles_total keys as its labels (0
    # bytes at tp 1).
    assert _labels(p["registry"], "collective_bytes_total") == \
        _labels(j["registry"], "collective_bytes_total")
    # Each program's build, where the run first needs it.
    compiles = [r["attrs"] for r in p["tracer"].records if r["name"] == "compile"]
    assert compiles == [r["attrs"] for r in j["tracer"].records if r["name"] == "compile"]
    assert len(compiles) == sum(v for k, v in _counters(p["registry"]).items()
                                if k[0] == "xla_compiles_total")
    assert {i: (c.tokens, c.status, c.admitted_step, c.finished_step)
            for i, c in p["done"].items()} == \
        {i: (c.tokens, c.status, c.admitted_step, c.finished_step)
         for i, c in j["done"].items()}
    assert {c.status for c in p["done"].values()} == {"ok", "shed"}


def test_scheduler_burn_ledger_and_anomaly_ticks_match_jax(sched_runs):
    j, p = sched_runs["jax"], sched_runs["port"]
    jm, pm = j["slo_monitor"], p["slo_monitor"]
    for rule in ("ttft", "shed"):
        assert (pm.alerts(rule), pm.fired_ticks(rule), pm.cumulative(rule)) == \
            (jm.alerts(rule), jm.fired_ticks(rule), jm.cumulative(rule)), rule
    assert pm.alerts("ttft") >= 1
    jd, pd = j["anomaly_detector"], p["anomaly_detector"]
    for signal in HOST:
        assert pd.fired_ticks(signal) == jd.fired_ticks(signal), signal
    assert sum(len(pd.fired_ticks(s)) for s in HOST) >= 3
    assert set(pd.summary()) == set(jd.summary()) == set(HOST + WALL)


def test_telemetry_changes_no_token(sched_runs):
    on, off = sched_runs["port"], sched_runs["port_off"]
    assert {i: (c.tokens, c.status, c.admitted_step, c.finished_step)
            for i, c in on["done"].items()} == \
        {i: (c.tokens, c.status, c.admitted_step, c.finished_step)
         for i, c in off["done"].items()}
    assert on["stats"].decode_steps == off["stats"].decode_steps
    assert on["stats"].prefill_tokens == off["stats"].prefill_tokens


def test_writer_goodput_mfu_and_analyze(sched_runs):
    p = sched_runs["port"]
    recs = [json.loads(x) for x in open(sched_runs["tmp"] / "m.jsonl")]
    assert recs[0]["record"] == "manifest" and recs[-1]["record"] == "snapshot"
    last = {(m["name"], tuple(sorted(m["labels"].items()))): m for m in recs[-1]["metrics"]}
    phases = sum(m["value"] for (name, _), m in last.items() if name == "time_in_seconds")
    observed = last[("time_observed_seconds", ())]["value"]
    assert math.isclose(phases, observed, rel_tol=1e-9) and observed > 0
    assert 0 < last[("serve_mfu", ())]["value"] <= 1
    # obs.analyze reads the run's trace through the scheduler's own
    # derivation: one definition of TTFT and ITL.
    records = p["tracer"].records
    rep = build_report(records)
    ttft, itl = ts.derive_request_slo(records, group_by=lambda rid: "default")["default"]
    row = rep["requests"]["per_class"]["default"]
    assert row["ttft_ms"] == {"p50": ttft.p50_ms, "p95": ttft.p95_ms, "p99": ttft.p99_ms}
    assert row["itl_ms"] == {"p50": itl.p50_ms, "p95": itl.p95_ms, "p99": itl.p99_ms}
    assert (row["requests"], row["shed"], rep["requests"]["served"]) == (6, 3, 3)


def _router_run(pkg, weights):
    if pkg == "jax":
        scn, spec, mods = jscn.BULK_BURST, JSPEC, js
        R, Tr, M, D, slo, anom = (JRegistry, JTracer, JMonitor, JDetector, jparse_slo,
                                  jparse_anomaly)
        where = {}
    else:
        scn, spec, mods = tscn.BULK_BURST, TSPEC, ts
        R, Tr, M, D, slo, anom = (MetricRegistry, Tracer, SloMonitor, AnomalyDetector,
                                  parse_slo_rules, parse_anomaly_rules)
        where = dict(device="cpu")
    reg, tracer = R(), Tr()
    mon, det = M(slo(ROUTER_SLO), reg, tracer=tracer), D(anom(ROUTER_ANOMALY), reg, tracer=tracer)
    ctrl = mods.FleetController(dataclasses.replace(scn.autoscale, burn_rules=("bulk_ttft",),
                                                    sustain_ticks=8))
    router = mods.Router(scn.router_config(spec), params=weights, registry=reg, tracer=tracer,
                         slo_monitor=mon, anomaly_detector=det, controller=ctrl,
                         peak_flops=1e12, **where)
    done, stats = router.run(scn.build_traffic(spec.vocab))
    return dict(done=done, stats=stats, reg=reg, mon=mon, det=det, ctrl=ctrl, router=router)


@pytest.fixture(scope="module")
def router_runs(weights):
    return {pkg: _router_run(pkg, weights) for pkg in ("jax", "port")}


def test_router_burn_rules_and_fleet_signals_match_jax(router_runs):
    j, p = router_runs["jax"], router_runs["port"]
    assert p["ctrl"].events == j["ctrl"].events
    assert ("scale_out", "burn") in [(e[1], dict(e[2]).get("reason")) for e in p["ctrl"].events]
    for rule in ("bulk_ttft", "bulk_shed"):
        assert (p["mon"].alerts(rule), p["mon"].fired_ticks(rule), p["mon"].cumulative(rule)) \
            == (j["mon"].alerts(rule), j["mon"].fired_ticks(rule), j["mon"].cumulative(rule))
    for signal in ("backlog", "shed_rate"):
        assert p["det"].fired_ticks(signal) == j["det"].fired_ticks(signal), signal
    assert p["det"].fired_ticks("backlog")
    router = lambda reg: {k: v for k, v in _counters(reg).items()  # noqa: E731
                          if k[0].startswith(("router_", "scale_", "fleet_"))}
    assert router(p["reg"]) == router(j["reg"])
    assert {i: (c.tokens, c.status, c.admitted_step) for i, c in p["done"].items()} == \
        {i: (c.tokens, c.status, c.admitted_step) for i, c in j["done"].items()}
    # Replica schedulers keep no monitor; peak_flops reaches each of them.
    for sched in p["router"].scheds:
        if sched is not None:
            assert sched.slo_monitor is None and sched.anomaly is None
            assert sched._resolve_peak() == 1e12
    assert p["reg"].get("fleet_engine_sim").value() == 0.0
