"""The port's observability plane (ddl_tpu_torch/obs/, utils/metrics.py's
profiler bracket, the trainers' telemetry and the CLI's flags) held to the
JAX package's (ddl_tpu/obs/) on the same seeded inputs.

- the registry: ``prometheus_text`` byte-equal and ``snapshot`` equal for
  one recorded sequence (label escaping and histograms included); the
  writer's manifest first;
- the tracer's Chrome conversion equal on one record stream (spans,
  incidents, flow chains), and ``python -m ddl_tpu_torch.obs.trace``;
  ``phase`` one shared null context outside a profiler session and a range
  inside one, and a ``Tracer.span`` under a session both its JSONL record
  and a profiler range of its name;
- the FLOP integers equal over CNN and LM configurations; ``mfu``, the peak
  table's fallbacks and its H100 rows; the roofline model and its fit;
- goodput, anomaly and SLO: the same streams give the same registry text
  and fire on the same ticks; their grammars' errors read alike;
- the exporter's ``/metrics`` equals ``prometheus_text``;
- ``SingleChipTrainer`` at the tiny CNN and ``SeqTrainer`` ``full`` at
  ``TINY_SPEC`` with metrics on: JAX's metric names and label sets, the
  health gauges within rtol 1e-5 / atol 1e-6, the same trace records, the
  collective ledger's bytes (one step's exactly; XLA merges 4 bytes of
  scalar all-reduce across a 2-step span, which the call-site tally counts
  as called), and parameters bitwise those of the run without metrics;
- the CLI's telemetry flags: JAX's hygiene texts, each serve telemetry flag
  served (``--profile`` refused, as JAX's), and end-to-end runs that write a
  manifest-first metrics file and a trace.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import jax

from ddl_tpu import cli as jcli
from ddl_tpu.data import load_mnist as j_load_mnist
from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.models import transformer as jt
from ddl_tpu.obs import MetricRegistry as JRegistry, Tracer as JTracer
from ddl_tpu.obs import anomaly as janomaly
from ddl_tpu.obs import comms as jcomms
from ddl_tpu.obs import cost as jcost
from ddl_tpu.obs import goodput as jgoodput
from ddl_tpu.obs import slo as jslo
from ddl_tpu.obs import trace as jtrace
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu.train import SingleChipTrainer as JSingle, TrainConfig as JTrainConfig
from ddl_tpu.utils.metrics import StepTimer as JStepTimer
from ddl_tpu_torch import cli
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.data.mnist import load_mnist
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.obs import MetricRegistry, MetricsWriter, Tracer
from ddl_tpu_torch.obs import anomaly, comms, cost, goodput, memory, slo
from ddl_tpu_torch.obs import trace as ttrace
from ddl_tpu_torch.obs.export import MetricsExporter
from ddl_tpu_torch.parallel.mesh import LOCAL, make_grid
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig
from ddl_tpu_torch.utils import tree
from ddl_tpu_torch.utils.metrics import StepTimer, trace

RTOL, ATOL = 1e-5, 1e-6
QUIET = lambda s: None  # noqa: E731
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn):
    """``fn(registry)`` on a fresh port registry and a fresh JAX one."""
    regs = MetricRegistry(), JRegistry()
    for reg in regs:
        fn(reg)
    return regs


# -- the registry --------------------------------------------------------------


def _record(reg):
    rng = np.random.default_rng(4)
    c = reg.counter("requests_total", "requests seen")
    g = reg.gauge("queue_depth")
    h = reg.histogram("latency_seconds", "latency")
    for i in range(40):
        c.inc(int(rng.integers(1, 4)), route=f"r{i % 3}")
        g.set(float(rng.random()), shard=str(i % 2))
        h.observe(float(rng.exponential()), kind=["a", "b"][i % 2])
    h.observe_many(rng.random(5).tolist(), kind="c")
    reg.gauge("escaped").set(1.5, label='quote"back\\slash\nnewline')
    reg.counter("empty_total")


def test_registry_text_and_snapshot_equal_jax():
    ours, theirs = _both(_record)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()
    h, jh = ours.histogram("latency_seconds"), theirs.histogram("latency_seconds")
    for q in (50, 95, 99):
        assert h.percentile(q, kind="a") == jh.percentile(q, kind="a")
    assert h.stats(kind="b").p95_ms == jh.stats(kind="b").p95_ms
    assert h.values_since(3, kind="c") == jh.values_since(3, kind="c")
    with pytest.raises(ValueError, match="already registered"):
        ours.gauge("requests_total")


def test_metrics_writer_manifest_first(tmp_path):
    reg = MetricRegistry()
    _record(reg)
    grid = make_grid(None, 1, 1)
    with MetricsWriter(tmp_path / "m.jsonl", reg, interval_s=3600.0) as w:
        assert w.maybe_flush() and not w.maybe_flush()
    recs = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    man = recs[0]
    assert man["record"] == "manifest" and man["schema"] == "ddl_tpu.metrics.v1"
    assert {"torch_version", "cuda_version", "device_name", "power_limit", "git_sha",
            "argv", "pid"} <= set(man)
    assert [r["record"] for r in recs[1:]] == ["snapshot", "snapshot"]
    assert recs[-1]["metrics"] == reg.snapshot()
    from ddl_tpu_torch.obs.registry import run_manifest

    shape = run_manifest(mesh=grid)["mesh_shape"]
    assert shape == {"dp": 1, "sp": 1}


# -- the tracer ----------------------------------------------------------------


def _trace_records():
    """A stream with spans, plain events and every incident kind that
    chains: guard skips into their rollback, anomalies by signal, a shed
    request into its completion."""
    recs, t = [], 10.0
    for i in range(4):
        recs.append({"type": "span", "name": "train/span", "t0": t, "t": t + 0.5,
                     "dur_s": 0.5, "depth": 0, "pid": 7, "process_index": 0,
                     "attrs": {"gstep": i, "k": 1}})
        t += 0.6
    for name, attrs in (("guard_skip", {"gstep": 2}), ("guard_skip", {"gstep": 3}),
                        ("guard_rollback", {"to_step": 1}), ("anomaly", {"signal": "mfu"}),
                        ("compile", {"kind": "eval"}), ("anomaly", {"signal": "mfu"}),
                        ("shed", {"req": 3}), ("complete", {"req": 3}),
                        ("complete", {"req": 4})):
        recs.append({"type": "event", "name": name, "t": t, "depth": 1, "pid": 7,
                     "process_index": 1, "attrs": attrs})
        t += 0.25
    return recs


def test_chrome_conversion_equals_jax(tmp_path):
    recs = _trace_records()
    assert ttrace.chrome_trace_events(recs) == jtrace.chrome_trace_events(recs)
    assert ttrace.FLEET_EVENTS == jtrace.FLEET_EVENTS
    assert ttrace.INCIDENT_EVENTS == jtrace.INCIDENT_EVENTS
    src = tmp_path / "in.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out = subprocess.run([sys.executable, "-m", "ddl_tpu_torch.obs.trace", str(src),
                          str(tmp_path / "out.json")], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    jtrace.convert(src, tmp_path / "want.json")
    assert json.load(open(tmp_path / "out.json")) == json.load(open(tmp_path / "want.json"))


def test_tracer_records_and_null_tracer(tmp_path):
    tr = Tracer()
    with tr.span("outer", a=1):
        with tr.span("inner"):
            tr.event("tick", t=5.0, n=2)
    assert [(r["name"], r["type"], r["depth"]) for r in tr.records] == [
        ("tick", "event", 2), ("inner", "span", 1), ("outer", "span", 0)]
    assert tr.records[0]["t"] == 5.0 and tr.records[0]["process_index"] == 0
    assert not ttrace.NULL_TRACER and list(ttrace.NULL_TRACER.records) == []
    path = ttrace.host_trace_file(tmp_path / "tr")
    assert path.endswith("host_trace_p0.jsonl")
    with ttrace.trace_context(tmp_path / "tr") as t2:
        t2.event("hello")
    assert os.path.exists(path) and os.path.exists(tmp_path / "tr" / "torch_profile_p0.json")


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_phase_is_one_null_context_outside_a_profiler_and_a_range_inside():
    null = ttrace.phase("step/forward")
    assert ttrace.phase("step/backward") is null
    assert ttrace.NULL_TRACER.span("x") is ttrace.NULL_TRACER.span("y")
    with ttrace.NULL_TRACER.span("x") as t:
        assert t is ttrace.NULL_TRACER
    with _cpu_profile() as prof:
        rng = ttrace.phase("step/forward")
        assert isinstance(rng, torch.profiler.record_function)
        with rng:
            torch.ones(2).add_(1)
    (fwd,) = [e for e in prof.events() if e.name == "step/forward"]
    (add,) = [e for e in prof.events() if e.name == "aten::add_"]
    assert fwd.time_range.start <= add.time_range.start <= add.time_range.end <= fwd.time_range.end


def test_tracer_span_under_a_profiler_keeps_its_record_and_adds_a_range():
    plain, profiled = Tracer(), Tracer()
    with plain.span("train/span", gstep=3, k=2):
        pass
    with _cpu_profile() as prof, profiled.span("train/span", gstep=3, k=2):
        pass
    (a,), (b,) = plain.records, profiled.records
    assert a.keys() == b.keys()
    assert [(r["type"], r["name"], r["depth"], r["attrs"]) for r in (a, b)] == [
        ("span", "train/span", 0, {"gstep": 3, "k": 2})] * 2
    assert [e.name for e in prof.events() if e.name == "train/span"] == ["train/span"]


def test_profiler_bracket_and_step_timer(tmp_path):
    with trace(str(tmp_path / "p")):
        torch.ones(4) @ torch.ones(4)
    assert os.listdir(tmp_path / "p") == ["torch_profile_p0.json"]
    with trace(None):
        pass
    ours, theirs = StepTimer(batch_size=4, warmup=1), JStepTimer(batch_size=4, warmup=1)
    for timer in (ours, theirs):
        for s, n in ((0.5, 3), (0.25, 4), (0.125, 8)):
            timer.add(s, n)
        with timer.step():
            pass
    assert ours.total_images == theirs.total_images == 19
    a, b = ours.stats(), theirs.stats()
    assert (a.steps, a.p50_ms) == (b.steps, b.p50_ms) == (3, 125.0)


# -- FLOPs, peaks, the roofline -------------------------------------------------


@pytest.mark.parametrize("conv,fc,batch", [((32, 64, 128, 256), (1024, 512), 100),
                                           ((4, 8, 8, 8), (32, 16), 7),
                                           ((8, 8, 16, 16), (64, 32), 1)])
def test_cnn_flops_equal_jax(conv, fc, batch):
    assert cost.cnn_forward_flops(conv, fc, 10, batch) == jcost.cnn_forward_flops(conv, fc, 10,
                                                                                 batch)
    assert cost.cnn_train_step_flops(batch, conv, fc) == jcost.cnn_train_step_flops(batch, conv,
                                                                                   fc)


@pytest.mark.parametrize("width", [dict(vocab=256, d_model=512, num_heads=8, num_layers=4,
                                        d_ff=2048),
                                   dict(vocab=16, d_model=32, num_heads=2, num_layers=2,
                                        d_ff=64)])
@pytest.mark.parametrize("batch,seq", [(4, 2048), (8, 32)])
def test_lm_and_serve_flops_equal_jax(width, batch, seq):
    ours, theirs = tt.LMSpec(**width), jt.LMSpec(**width)
    for remat in (False, True):
        assert (cost.lm_train_step_flops(ours, batch, seq, remat=remat)
                == jcost.lm_train_step_flops(theirs, batch, seq, remat=remat))
    assert cost.lm_forward_flops(ours, batch, seq) == jcost.lm_forward_flops(theirs, batch, seq)
    assert (cost.serve_decode_flops_per_token(ours, 512)
            == jcost.serve_decode_flops_per_token(theirs, 512))
    assert (cost.serve_prefill_flops(ours, seq, 2 * seq)
            == jcost.serve_prefill_flops(theirs, seq, 2 * seq))
    assert (cost.serve_speculate_verify_flops(ours, 9, 256)
            == jcost.serve_speculate_verify_flops(theirs, 9, 256))


def test_peaks_mfu_and_bandwidth(monkeypatch):
    assert cost.peak_flops_per_device("cpu") == jcost.CPU_NOMINAL_PEAK_FLOPS == 5e10
    assert cost.peak_flops_per_device("cpu", 3e12, precision="fp32") == 3e12
    for bad in (dict(override=0.0), dict(precision="fp8")):
        with pytest.raises(ValueError):
            cost.peak_flops_per_device("cpu", **bad)
        with pytest.raises(ValueError):
            jcost.peak_flops_per_device(None, **bad)
    assert cost.mfu(1e12, 2.0, 2, 5e11) == jcost.mfu(1e12, 2.0, 2, 5e11) == 0.5
    assert cost.mfu(1.0, 0.0, 1, 1.0) == 0.0
    monkeypatch.setattr(cost, "device_kind", lambda d: ("nvidia h100 80gb hbm3", "gpu"))
    assert cost.peak_flops_per_device("cuda") == 989.4e12
    assert cost.peak_flops_per_device("cuda", precision="fp32") == 66.9e12
    assert comms.ici_bw_per_device("cuda") == 9.0e11
    monkeypatch.setattr(cost, "device_kind", lambda d: ("nvidia a100", "gpu"))
    with pytest.warns(UserWarning, match="unknown accelerator"):
        assert cost.peak_flops_per_device("cuda") == cost.CPU_NOMINAL_PEAK_FLOPS
    with pytest.warns(UserWarning, match="unknown accelerator"):
        assert comms.ici_bw_per_device("cuda") == comms.CPU_NOMINAL_ICI_BW
    assert comms.ici_bw_per_device("cpu", 5e9) == 5e9
    with pytest.raises(ValueError):
        comms.ici_bw_per_device("cpu", -1.0)


def test_roofline_and_fit_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(5):
        args = (float(rng.random() * 1e12), float(rng.random() * 1e9), int(rng.integers(1, 5)),
                1e12, 1e10)
        assert comms.roofline(*args) == jcomms.roofline(*args)
    rows = [{"flops": float(f), "bytes": float(b), "measured_s": float(t)}
            for f, b, t in rng.random((6, 3)) * [1e12, 1e9, 1.0]]
    assert comms.fit_roofline(rows) == jcomms.fit_roofline(rows)
    assert comms.fit_roofline(rows[:1]) is None


def test_ledger_labels_axes_like_jax():
    """The call-site ledger: JAX's gauges and counters from the records,
    each (dp, sp) sum of a rank alone labelled ``dp`` (JAX's smallest
    subset of a mesh of ones), a world group by the axes over one."""
    grid = make_grid(None, 1, 1)
    recs = [{"op": "all-reduce", "bytes": 100, "group": LOCAL},
            {"op": "reduce-scatter", "bytes": 24, "group": LOCAL},
            {"op": "all-gather", "bytes": 96, "group": object()}]
    reg = MetricRegistry()
    led = comms.publish_program_ledger(reg, recs, program="train_span[2]", grid=grid, repeat=2)
    assert led == {"program": "train_span[2]", "total_bytes": 440, "ops": 6,
                   "by_kind": {"all-reduce": 200, "reduce-scatter": 48, "all-gather": 192},
                   "by_axis": {"dp": 248, "unknown": 192}}
    assert reg.counter("collective_ops_total").value(kind="all-reduce",
                                                     program="train_span[2]") == 2
    comms.publish_program_ledger(reg, [], program="eval[0]")
    assert reg.gauge("collective_bytes_total").value(program="eval[0]") == 0


# -- goodput, anomaly, SLO, export, memory ------------------------------------


def _goodput(reg, mod):
    gp = mod.GoodputTracker(reg, "train")
    for phase, s in (("staging", 0.5), ("compile", 1.25), ("eval", 0.125)):
        gp.add(phase, s)
    for span_s, comp, skip in ((1.0, 0.0, 0), (2.0, 0.5, 1), (0.75, 0.0, 2)):
        mod.attribute_train_span(gp, span_s, comp, skip, 4)
    reg.gauge("anomaly_last_tick").set(7, signal="mfu")
    reg.counter("anomaly_total").inc(2, signal="mfu")
    reg.counter("serve_prefill_tokens_total").inc(40)
    reg.histogram("serve_decode_step_seconds").observe_many([0.1, 0.2])
    gp.publish()
    s = mod.GoodputTracker(reg, "serve")
    s.add("prefill", 0.5)
    s.add("decode", 0.25)
    return gp.summary(), mod.goodput_summary(reg), mod.fleet_summary(reg)


def test_goodput_equals_jax():
    ours, theirs = MetricRegistry(), JRegistry()
    assert _goodput(ours, goodput) == _goodput(theirs, jgoodput)
    assert ours.prometheus_text() == theirs.prometheus_text()
    with pytest.raises(ValueError, match="kind must be"):
        goodput.GoodputTracker(ours, "bogus")


def _anomaly_stream(reg, mod, tracer):
    rules = mod.parse_anomaly_rules(
        "step_time:window=8,min=4,threshold=5,direction=high;mfu:direction=low,min=3;"
        "queue:window=4,min=2,scale=0.5")
    det = mod.AnomalyDetector(rules, reg, tracer)
    rng = np.random.default_rng(12)
    for tick in range(60):
        vals = {"step_time": 1.0 + 0.01 * rng.standard_normal(),
                "mfu": 0.4 + 0.001 * rng.standard_normal()}
        if tick in (20, 21, 40):
            vals["step_time"] *= 3
        if tick == 33:
            vals["mfu"] = 0.1
        if tick % 5:
            vals["queue"] = float(tick % 3)
        det.tick(vals)
    return det.summary(), [det.fired_ticks(r.signal) for r in rules]


def test_anomaly_fires_on_the_same_ticks_as_jax():
    ours, theirs = MetricRegistry(), JRegistry()
    tr, jtr = Tracer(), JTracer()
    got, want = _anomaly_stream(ours, anomaly, tr), _anomaly_stream(theirs, janomaly, jtr)
    assert got == want and any(want[1])
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ([(r["name"], r["attrs"]) for r in tr.records]
            == [(r["name"], r["attrs"]) for r in jtr.records])


@pytest.mark.parametrize("spec", ["", "x:window=1", "x:min=0", "x:direction=up", "x:bogus=1",
                                  "x:threshold", "x;x", "x:scale=0"])
def test_anomaly_grammar_errors_read_as_jax(spec):
    with pytest.raises(ValueError) as ours:
        anomaly.parse_anomaly_rules(spec)
    with pytest.raises(ValueError) as theirs:
        janomaly.parse_anomaly_rules(spec)
    assert str(ours.value) == str(theirs.value)


def _slo_stream(reg, mod, tracer):
    rules = mod.parse_slo_rules(
        "ttft:metric=ttft_seconds,target=0.5,objective=0.9,fast=3,slow=6,label.class=chat;"
        "shed:metric=shed_total,total=requests_total,objective=0.5,fast=2,slow=4")
    mon = mod.SloMonitor(rules, reg, tracer)
    rng = np.random.default_rng(21)
    burns = []
    for tick in range(40):
        slow = 10 <= tick < 18 or tick > 30
        reg.histogram("ttft_seconds").observe_many(
            (rng.random(3) * (1.5 if slow else 0.4)).tolist(), **{"class": "chat"})
        reg.counter("requests_total").inc(4)
        reg.counter("shed_total").inc(int(rng.integers(0, 4 if 20 < tick < 26 else 2)))
        mon.tick()
        burns.append((mon.burn_rate("ttft", "fast"), mon.burn_rate("shed", "slow")))
    return [mon.fired_ticks(r.name) for r in rules], mon.cumulative("ttft"), burns


def test_slo_fires_on_the_same_ticks_as_jax():
    ours, theirs = MetricRegistry(), JRegistry()
    tr, jtr = Tracer(), JTracer()
    got = _slo_stream(ours, slo, tr)
    assert got == _slo_stream(theirs, jslo, jtr) and any(got[0])
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ([(r["name"], r["attrs"]) for r in tr.records]
            == [(r["name"], r["attrs"]) for r in jtr.records])


@pytest.mark.parametrize("spec", ["", "r", "r:target=1", "r:metric=m,bogus=1",
                                  "r:metric=m,target=1;r:metric=m,target=1",
                                  "r:metric=m,target=1,objective=1"])
def test_slo_grammar_errors_read_as_jax(spec):
    with pytest.raises(ValueError) as ours:
        slo.parse_slo_rules(spec)
    with pytest.raises(ValueError) as theirs:
        jslo.parse_slo_rules(spec)
    assert str(ours.value) == str(theirs.value)


def test_exporter_serves_the_registry_text():
    reg = MetricRegistry()
    _record(reg)
    goodput.GoodputTracker(reg, "train").publish()
    with MetricsExporter(reg, 0) as exp:
        body = urllib.request.urlopen(exp.url("/metrics"), timeout=10).read().decode()
        assert body == reg.prometheus_text()
        health = json.loads(urllib.request.urlopen(exp.url("/healthz"), timeout=10).read())
        assert health == {"status": "ok", "goodput_fraction": 0.0}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(exp.url("/nope"), timeout=10)


def test_memory_sampler_latches_off_on_the_cpu_and_compiles_count():
    reg = MetricRegistry()
    assert memory.device_memory_stats("cpu") is None
    s = memory.MemorySampler(reg, [torch.device("cpu")])
    assert not s.sample() and s.supported is False and not s.sample()
    tr = Tracer()
    memory.record_compile(reg, tr, "train_span", t0=1.0, t1=1.5, k=4)
    memory.record_compile(reg, tr, "eval")
    assert reg.counter("xla_compiles_total").value(kind="train_span") == 1
    assert reg.histogram("xla_compile_seconds").values(kind="train_span") == [0.5]
    assert [(r["type"], r["attrs"]) for r in tr.records] == [
        ("span", {"kind": "train_span", "k": 4}), ("event", {"kind": "eval"})]


# -- the trainers against JAX's -------------------------------------------------


def _series(reg):
    return sorted((m["name"], tuple(sorted(m["labels"].items()))) for m in reg.snapshot())


def _values(reg):
    return {(m["name"], tuple(sorted(m["labels"].items()))): m.get("value")
            for m in reg.snapshot()}


HEALTH_GAUGES = ("train_grad_norm", "train_param_norm", "train_update_norm")


def _trace(tracer):
    """A run's trace records: the span and eval records in order, and the
    compile records as a sorted list (the port's eval warm-up is its first
    eval, JAX's compile precedes the loop; a span length past the first is
    a bracket in JAX, an instant in the port)."""
    recs = [(r["name"], r["attrs"]) for r in tracer.records]
    return ([x for x in recs if x[0] != "compile"],
            sorted((str(a) for n, a in recs if n == "compile")))


def _hold_health(got, want):
    n = 0
    for key, v in want.items():
        if key[0] in HEALTH_GAUGES:
            np.testing.assert_allclose(got[key], v, rtol=RTOL, atol=ATOL, err_msg=str(key))
            n += 1
    return n


@pytest.fixture(scope="module")
def cnn_runs():
    kw = dict(epochs=1, batch_size=50, eval_every=3, keep_prob=1.0, **TINY)
    jds = j_load_mnist(path=None, synthetic_train=400, synthetic_test=64, seed=7)
    ds = load_mnist(path=None, synthetic_train=400, synthetic_test=64, seed=7)
    jreg, jtr = JRegistry(), JTracer()
    jtrainer = JSingle(JTrainConfig(**kw), jds)
    init = jax.tree.map(np.asarray, jtrainer.params)
    jtrainer.train(log=QUIET, metrics=jreg, tracer=jtr, metrics_interval=3)
    cfg = TrainConfig(**kw)
    off = SingleChipTrainer(cfg, ds, init=init, device="cpu").train(log=QUIET)
    reg, tr = MetricRegistry(), Tracer()
    on = SingleChipTrainer(cfg, ds, init=init, device="cpu").train(
        log=QUIET, metrics=reg, tracer=tr, metrics_interval=3)
    return (jreg, jtr), (reg, tr), off, on


def test_single_trainer_records_what_jax_records(cnn_runs):
    (jreg, jtr), (reg, tr), off, on = cnn_runs
    assert _series(reg) == _series(jreg)
    got, want = _values(reg), _values(jreg)
    assert _hold_health(got, want) == 3 + 2 * len(off.params)
    for key in (("train_nonfinite_grads_total", ()), ("train_step", ()),
                ("train_eval_accuracy", ()), ("xla_compiles_total", (("kind", "train_span"),)),
                ("collective_bytes_total", (("program", "train_span[3]"),))):
        assert got[key] == want[key], key
    assert _trace(tr) == _trace(jtr)
    assert all(np.array_equal(off.params[k], on.params[k]) for k in off.params)
    phases = {k[1][0][1]: v for k, v in got.items() if k[0] == "time_in_seconds"}
    assert sum(phases.values()) == pytest.approx(got[("time_observed_seconds", ())], rel=1e-9)


@pytest.fixture(scope="module")
def lm_runs():
    spec = tt.TINY_SPEC
    kw = dict(epochs=1, eval_every=2, batch_size=8, num_workers=1, scheme="full", seed=3)
    data = dict(num_train=32, num_test=8, seq_len=16, vocab=spec.vocab, seed=1)
    jreg, jtr = JRegistry(), JTracer()
    jtrainer = JSeqTrainer(JSeqConfig(spec=jt.LMSpec(**vars(spec)), **kw),
                           j_synthesize_copy(**data))
    init = jax.tree.map(np.asarray, jtrainer.params)
    jtrainer.train(log=QUIET, metrics=jreg, tracer=jtr, metrics_interval=2)
    ds = synthesize_copy(**data)
    off = SeqTrainer(SeqConfig(spec=spec, **kw), ds, init=init, device="cpu").train(log=QUIET)
    reg, tr = MetricRegistry(), Tracer()
    on = SeqTrainer(SeqConfig(spec=spec, **kw), ds, init=init, device="cpu").train(
        log=QUIET, metrics=reg, tracer=tr, metrics_interval=2)
    return (jreg, jtr), (reg, tr), off, on


def test_seq_trainer_records_what_jax_records(lm_runs):
    (jreg, jtr), (reg, tr), off, on = lm_runs
    assert _series(reg) == _series(jreg)
    got, want = _values(reg), _values(jreg)
    assert _hold_health(got, want) == 3 + 2 * 5
    np.testing.assert_allclose(got[("train_loss", ())], want[("train_loss", ())], rtol=1e-5)
    for key in (("train_nonfinite_grads_total", ()), ("train_step", ()),
                ("xla_compiles_total", (("kind", "train_span"),)),
                ("xla_compiles_total", (("kind", "eval"),))):
        assert got[key] == want[key], key
    # One step's ledger is JAX's to the byte; a 2-step span reads 4 more
    # bytes than XLA's, which merges one scalar all-reduce over the scan.
    for prog, extra in (("train_span[1]", 0), ("eval[0]", 0), ("train_span[2]", 4)):
        for name in ("collective_bytes_total", "collective_bytes"):
            key = next(k for k in want if k[0] == name and ("program", prog) in k[1])
            assert got[key] == want[key] + extra, key
    assert got[("comms_bytes_per_step", ())] == want[("comms_bytes_per_step", ())]
    assert _trace(tr) == _trace(jtr)
    assert all(np.array_equal(a, b) for a, b in zip(tree.leaves(off.params),
                                                    tree.leaves(on.params)))


def test_anomaly_detector_must_share_the_registry():
    ds = synthesize_copy(num_train=16, num_test=8, seq_len=16, vocab=16, seed=1)
    tr = SeqTrainer(SeqConfig(spec=tt.TINY_SPEC, batch_size=8, num_workers=1, scheme="full"),
                    ds, device="cpu")
    det = anomaly.AnomalyDetector(anomaly.parse_anomaly_rules("mfu"), MetricRegistry())
    for metrics in (None, MetricRegistry()):
        with pytest.raises(ValueError, match="anomaly_detector must be built"):
            tr.train(log=QUIET, metrics=metrics, anomaly_detector=det)


# -- the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["single", "--metrics-interval", "0"],
    ["lm", "--metrics-interval", "5"],
    ["sync", "--anomaly-rules", "mfu"],
    ["async_sharding", "--metrics-out", "m.jsonl", "--anomaly-rules", "step_time"],
])
def test_obs_flag_hygiene_reads_as_jax(argv):
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv + ["--platform", "cpu"])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("flag,value", [("--metrics-out", "m.jsonl"), ("--trace-dir", "t"),
                                        ("--prom-port", "0"), ("--anomaly-rules", "itl"),
                                        ("--slo-rules", "a:metric=m,target=1"),
                                        ("--profile", "p"), ("--peak-flops", "1e12")])
def test_serve_telemetry_flags_name_their_item(flag, value, tmp_path, monkeypatch, capsys):
    """Serve's telemetry flags are ported: each serves a tiny prompt set
    and lands where JAX's does; --profile does not apply to serve, as in
    JAX's CLI (its training-only group holds it: serve profiles through
    --trace-dir). JAX's serve payloads are held in
    tests/test_torch_fleet_cli.py and tests/test_torch_serve_obs.py."""
    monkeypatch.chdir(tmp_path)
    argv = ["serve", "--device", "cpu", "--vocab", "16", "--d-model", "16", "--heads", "2",
            "--layers", "1", "--d-ff", "32", "--slots", "2", "--capacity", "32",
            "--max-new-tokens", "3", "--num-prompts", "3", "--prompt-max", "10", "--json",
            flag, value]
    if flag == "--profile":
        assert "profile" in jcli._TRAIN_ONLY_DESTS
        with pytest.raises(SystemExit, match="^--profile does not apply to the serve variant$"):
            cli.main(argv)
        return
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {c["status"] for c in out["completions"].values()} == {"ok"}
    assert (out["goodput"] is None) == (flag in ("--trace-dir", "--peak-flops"))
    if flag == "--metrics-out":
        recs = [json.loads(x) for x in open(value)]
        assert recs[0]["record"] == "manifest" and recs[-1]["record"] == "snapshot"
        names = {m["name"] for m in recs[-1]["metrics"]}
        assert {"serve_decode_tokens_total", "xla_compiles_total", "serve_mfu"} <= names
    elif flag == "--trace-dir":
        names = {json.loads(x)["name"] for x in open(tmp_path / value / "host_trace_p0.jsonl")}
        assert {"eligible", "first_token", "decode_tick", "complete"} <= names
    elif flag == "--anomaly-rules":
        assert set(out["anomaly_rules"]) == {"itl"}
    elif flag == "--slo-rules":
        assert set(out["slo_rules"]) == {"a"} and out["anomaly_rules"] is None


def test_single_cli_writes_metrics_and_trace(tmp_path, capsys):
    out, tdir = tmp_path / "m.jsonl", tmp_path / "tr"
    assert cli.main(["single", "--device", "cpu", "--tiny", "--synthetic-train", "300",
                     "--synthetic-test", "50", "--eval-every", "1", "--metrics-out", str(out),
                     "--metrics-interval", "1", "--trace-dir", str(tdir),
                     "--anomaly-rules", "step_time:min=2", "--json"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["anomaly_rules"]) == {"step_time"}
    recs = [json.loads(x) for x in open(out)]
    assert recs[0]["record"] == "manifest" and recs[0]["variant"] == "single"
    last = {(m["name"], tuple(sorted(m["labels"].items()))): m for m in recs[-1]["metrics"]}
    assert np.isfinite(last[("train_grad_norm", ())]["value"])
    assert last[("train_nonfinite_grads_total", ())]["value"] == 0
    assert last[("train_run_images_per_sec", ())]["value"] > 0
    names = [json.loads(x)["name"] for x in open(tdir / "host_trace_p0.jsonl")]
    assert names.count("train/span") == 3 and "train/eval" in names
    assert os.path.exists(tdir / "torch_profile_p0.json")


def test_sync_cli_reports_run_gauges_and_a_run_span(tmp_path):
    out, tdir = tmp_path / "m.jsonl", tmp_path / "tr"
    assert cli.main(["sync_sharding", "--device", "cpu", "--tiny", "--num-ps", "2", "--layout",
                     "flat", "--fused-adam", "--synthetic-train", "200", "--synthetic-test",
                     "50", "--metrics-out", str(out), "--trace-dir", str(tdir)]) == 0
    last = {m["name"]: m["value"] for m in
            [json.loads(x) for x in open(out)][-1]["metrics"]}
    assert set(last) == {"train_final_accuracy", "train_mfu", "train_run_images_per_sec"}
    assert all(np.isfinite(v) and v > 0 for k, v in last.items() if k != "train_final_accuracy")
    names = [json.loads(x)["name"] for x in open(tdir / "host_trace_p0.jsonl")]
    assert names == ["train/run"]
