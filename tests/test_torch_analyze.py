"""The port's offline analysis CLI (ddl_tpu_torch/obs/analyze.py) against
``ddl_tpu.obs.analyze`` on the same input files: the same standard output
(text and ``--json``) and the same exit code, for every command.

The inputs are made once, in ``tmp_path``, by a module fixture: each
package's twin replays ``serve.scenarios.BULK_BURST`` with its SLO monitor
and an anomaly detector on the router, tracing to a host-trace JSONL and
snapshotting the router registry to a ``--metrics-out`` JSONL (the record
schemas are shared, so each CLI reads the other package's files too); a
doctored copy of the port's metrics file moves one value past the
threshold; a ``benchmarks/collective_bytes.py``-shaped artifact with a
precision-twin pair and no stored fit feeds ``comms``'s benchmark path.
"""

import contextlib
import io
import json

import pytest

from ddl_tpu.models.transformer import TINY_SPEC as JSPEC
from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu.obs import MetricsWriter as JWriter
from ddl_tpu.obs import Tracer as JTracer
from ddl_tpu.obs import analyze as janalyze
from ddl_tpu.obs.anomaly import AnomalyDetector as JDetector
from ddl_tpu.obs.anomaly import parse_anomaly_rules as jparse
from ddl_tpu.obs.slo import SloMonitor as JMonitor
from ddl_tpu.serve import FleetController as JController
from ddl_tpu.serve import Router as JRouter
from ddl_tpu.serve import scenarios as jscn
from ddl_tpu.serve import sim as jsim
from ddl_tpu_torch.models.transformer import TINY_SPEC as TSPEC
from ddl_tpu_torch.obs import MetricRegistry, MetricsWriter, Tracer, analyze
from ddl_tpu_torch.obs.anomaly import AnomalyDetector, parse_anomaly_rules
from ddl_tpu_torch.obs.slo import SloMonitor
from ddl_tpu_torch.serve import FleetController, Router
from ddl_tpu_torch.serve import scenarios as tscn
from ddl_tpu_torch.serve import sim as tsim

ANOMALY = "backlog:window=4,min=2,threshold=1;shed_rate:window=4,min=2,threshold=1"


def _twin_files(pkg, d):
    """Trace and metrics files of one package's twin run."""
    if pkg == "jax":
        scn, spec, R, W, Tr, M, D, parse, Ctrl, S, fac = (
            jscn.BULK_BURST, JSPEC, JRegistry, JWriter, JTracer, JMonitor, JDetector, jparse,
            JController, JRouter, jsim.sim_engine_factory)
    else:
        scn, spec, R, W, Tr, M, D, parse, Ctrl, S, fac = (
            tscn.BULK_BURST, TSPEC, MetricRegistry, MetricsWriter, Tracer, SloMonitor,
            AnomalyDetector, parse_anomaly_rules, FleetController, Router,
            tsim.sim_engine_factory)
    trace, metrics = d / f"{pkg}_trace.jsonl", d / f"{pkg}_metrics.jsonl"
    reg, tracer = R(), Tr(str(trace))
    writer = W(str(metrics), reg, {"variant": "sim"})
    router = S(scn.router_config(spec, engine_factory=fac()), registry=reg, tracer=tracer,
               slo_monitor=M(scn.slo_rules(), reg, tracer=tracer),
               anomaly_detector=D(parse(ANOMALY), reg, tracer=tracer),
               controller=Ctrl(scn.autoscale))
    router.run(scn.build_traffic(spec.vocab))
    tracer.close()
    writer.close()
    return str(trace), str(metrics)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("analyze")
    out = {}
    for pkg in ("jax", "port"):
        out[f"{pkg}_trace"], out[f"{pkg}_metrics"] = _twin_files(pkg, d)
    recs = [json.loads(x) for x in open(out["port_metrics"])]
    for m in recs[-1]["metrics"]:
        if m["name"] == "router_requests_total":
            m["value"] = m["value"] * 3 + 1
    doctored = d / "doctored.jsonl"
    doctored.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out["doctored"] = str(doctored)
    rows = [dict(mode=mode, mesh="dp2xsp2", precision=prec, devices=4,
                 collectives=[{"op": "all-reduce", "bytes": b}, {"op": "all-gather",
                                                                 "bytes": b // 2}],
                 reduce_bytes=b, wire_reduce_bytes=b if prec == "fp32" else b // 2,
                 comms_bytes_per_step=b + b // 2, flops_per_step=f, measured_step_s=t)
            for mode, prec, b, f, t in (("zero1", "fp32", 4096, 2e9, 0.012),
                                        ("zero1", "bf16", 4096, 2e9, 0.009),
                                        ("ring", "fp32", 16384, 4e9, 0.031))]
    bench = d / "bench.json"
    bench.write_text(json.dumps({"devices": 4, "lm": rows}))
    out["bench"] = str(bench)
    manifest_only = d / "manifest_only.jsonl"
    manifest_only.write_text(json.dumps({"record": "manifest"}) + "\n")
    out["manifest_only"] = str(manifest_only)
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


CASES = {
    "report-port-trace": ["report", "{port_trace}"],
    "report-jax-trace-json": ["report", "{jax_trace}", "--json", "--top", "3"],
    "report-port-trace-json": ["report", "{port_trace}", "--json"],
    "report-missing": ["report", "{port_trace}.absent"],
    "comms-port-metrics": ["comms", "{port_metrics}"],
    "comms-jax-metrics-json": ["comms", "{jax_metrics}", "--json"],
    "comms-bench": ["comms", "{bench}"],
    "comms-bench-json": ["comms", "{bench}", "--json"],
    "comms-manifest-only": ["comms", "{manifest_only}"],
    "compare-same": ["compare", "{port_metrics}", "{port_metrics}"],
    "compare-across-packages": ["compare", "{jax_metrics}", "{port_metrics}", "--json",
                                "--ignore", "seconds", "ttft"],
    "compare-doctored": ["compare", "{port_metrics}", "{doctored}", "--keys", "router_"],
    "compare-doctored-json": ["compare", "{port_metrics}", "{doctored}", "--json"],
    "compare-bad-threshold": ["compare", "{port_metrics}", "{doctored}", "--threshold", "0"],
    "compare-manifest-only": ["compare", "{manifest_only}", "{port_metrics}"],
}
RCS = {"report-missing": 2, "comms-manifest-only": 2, "compare-doctored": 1,
       "compare-doctored-json": 1, "compare-bad-threshold": 2, "compare-manifest-only": 2}


@pytest.mark.parametrize("name", list(CASES))
def test_analyze_matches_jax(files, name):
    argv = [a.format(**files) for a in CASES[name]]
    ours = _run(analyze.main, argv)
    theirs = _run(janalyze.main, argv)
    assert ours == theirs
    assert ours[0] == RCS.get(name, 0)
    if name == "report-port-trace-json":
        rep = json.loads(ours[1])
        assert rep["incidents"]["scale_out"] == 1 and rep["anomalies"]
        assert set(rep["requests"]["per_class"]) == {"bulk", "chat"}
        assert {f["kind"] for f in rep["fleet_incidents"]} == {"scale_out", "drain", "scale_in"}
    if name == "compare-across-packages":
        # The two twins' registries agree on every count.
        assert json.loads(ours[1])["regressions"] == []
