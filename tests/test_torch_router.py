"""The port's router (ddl_tpu_torch/serve/router.py), its traffic and spec
grammars, the scheduler's tracer and registry hooks and the SLO derivation
from their records, against ``ddl_tpu`` on the CPU, at a tiny width (vocab
32, d_model 32, 2 heads, 2 layers, d_ff 64) and the same weights (JAX's
init carried over as numpy). The ``serve --replicas`` CLI is held to JAX's
in tests/test_torch_fleet_cli.py.

Pinned against JAX:

- ``synthesize_mixed_traffic`` byte-equal (families, bursts, a diurnal
  ramp, ``max_requests``, and the three fleet streams of the card's smoke
  at vocab 256), its error texts equal;
- ``parse_traffic_spec``, ``parse_slo_spec``, ``parse_roles_spec`` and
  ``parse_autoscale_spec``: equal results and error texts over one table of
  good and bad specs each;
- a 2-replica router on a three-class stream with a bulk burst, prefix
  affinity and a shed threshold: every request's tokens, status,
  ``admitted_step`` and ``finished_step``; the placement ledger, affinity
  and load placements, router sheds and per-class counts; the shared
  tracer's ``(name, attrs)`` sequence, ``compile`` events included
  (timestamps left out); the ``router_*`` counters and each replica's
  ``serve_*`` counters;
- ``request_slo_samples`` and ``derive_request_slo`` (global and grouped)
  on that run's records.

Port-only pins: a 1-replica router equals the bare scheduler on the same
stream (tokens and every decode step's logits, bitwise; contiguous and
paged); ``derive_request_slo`` of a run's records equals its
``ServeStats.ttft`` / ``.itl`` float for float; the router reruns to the
same tokens and placements; the router's, the scheduler's and the
controller's telemetry arguments are taken and checked with JAX's texts, and
speculation and the int8 pool run.

Greedy comparisons keep the top-2 margin gate (1e-5, the cached logits'
tolerance against JAX).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ddl_tpu import serve as js
from ddl_tpu.data import lm as jlm
from ddl_tpu.models import transformer as jt
from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu.obs import Tracer as JTracer
from ddl_tpu_torch import cli
from ddl_tpu_torch import serve as ts
from ddl_tpu_torch.data import lm as tlm
from ddl_tpu_torch.models.transformer import LMSpec
from ddl_tpu_torch.obs import MetricRegistry
from ddl_tpu_torch.obs.trace import Tracer

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)
MARGIN = 1e-5
ROUTER_TRAFFIC = dict(
    classes={"chat": dict(rate=0.7, prompt_min=8, prompt_max=16, max_new_tokens=6, families=2,
                          family_prefix_len=6),
             "longdoc": dict(rate=0.15, prompt_min=20, prompt_max=32, max_new_tokens=4),
             "bulk": dict(rate=0.5, prompt_min=8, prompt_max=16, max_new_tokens=8)},
    horizon=10, vocab=32, seed=6, burst=(2, 4, 3.0, "bulk"), max_requests=20,
)
TRAFFIC_SPECS = {
    "default": dict(),
    "families-burst": ROUTER_TRAFFIC,
    "diurnal": dict(horizon=24, seed=3, diurnal_amplitude=0.6, diurnal_period=8),
    "burst-all-max-requests": dict(horizon=12, seed=1, burst=(3, 4, 2.5), max_requests=7),
    # The card's fleet streams (chip_smoke.py: fleet_router, fleet_autoscale,
    # fleet_disagg), from benchmarks/serve_bench.py.
    "smoke-router": dict(
        classes={"chat": dict(rate=0.7, prompt_min=16, prompt_max=48, max_new_tokens=16,
                              families=4, family_prefix_len=12),
                 "longdoc": dict(rate=0.15, prompt_min=64, prompt_max=160, max_new_tokens=16),
                 "bulk": dict(rate=0.5, prompt_min=16, prompt_max=48, max_new_tokens=24)},
        horizon=20, vocab=256, seed=6, burst=(4, 8, 3.0, "bulk"), max_requests=36),
    "smoke-autoscale": dict(
        classes={"chat": dict(rate=0.4, prompt_min=8, prompt_max=24, max_new_tokens=8),
                 "bulk": dict(rate=0.5, prompt_min=8, prompt_max=24, max_new_tokens=8)},
        horizon=20, vocab=256, seed=8, burst=(4, 8, 5.0, "bulk"), max_requests=28),
    "smoke-disagg": dict(
        classes={"chat": dict(rate=0.4, prompt_min=8, prompt_max=16, max_new_tokens=32)},
        horizon=12, vocab=256, seed=5, max_requests=6),
}
BAD_TRAFFIC = (
    dict(classes={}), dict(horizon=0), dict(vocab=1), dict(max_requests=-1),
    dict(diurnal_amplitude=1.0), dict(diurnal_amplitude=0.5, diurnal_period=1),
    dict(burst=(1, 2)), dict(burst=(-1, 2, 2.0)), dict(burst=(1, 2, 2.0, "nope")),
    dict(classes={"c": dict(speed=1)}), dict(classes={"c": dict(rate=-1)}),
    dict(classes={"c": dict(prompt_min=1)}), dict(classes={"c": dict(max_new_tokens=0)}),
    dict(classes={"c": dict(families=2, family_prefix_len=4, prompt_min=4)}),
)
# parser -> (good inputs, bad inputs); each input is (args, kwargs).
SPEC_TABLES = {
    "parse_traffic_spec": (
        [(("horizon=48;chat:rate=0.6,pmin=8,pmax=24,new=8,families=4,fprefix=6;"
           "bulk:rate=0.3,pmin=8,pmax=32,new=16",), {}),
         (("burst=4:8:3.0:bulk;seed=2;chat:rate=1;bulk:new=3",), {}),
         (("diurnal=0.5:16;max_requests=9; c : rate=2 ,",), {}),
         (("burst=1:2:2.0;x:new=3",), {})],
        [(("",), {}), (("horizon=4",), {}), (("chat",), {}), (("chat:rate",), {}),
         (("chat:speed=1",), {}), (("foo=1;chat:rate=1",), {}), (("burst=1:2;c:rate=1",), {}),
         (("diurnal=0.5;c:rate=1",), {}), (("chat:rate=x",), {}), (("horizon=x;c:rate=1",), {})],
    ),
    "parse_slo_spec": (
        [(("chat:ttft=0.5,itl=0.1,priority=0;bulk:ttft=60,priority=2", {"chat", "bulk"}), {}),
         (("", {"chat", "longdoc", "bulk", "other"}), {}),
         (("other:margin=3,", {"other", "chat"}), {})],
        [(("chat", {"chat"}), {}), (("nope:ttft=1", {"chat"}), {}),
         (("chat:lat=1", {"chat"}), {}), (("chat:ttft", {"chat"}), {}),
         (("chat:priority=x", {"chat"}), {})],
    ),
    "parse_roles_spec": (
        [(("prefill=1,decode=2", 3), {}), (("decode=1,prefill=1", 2), {}),
         (("mixed=2", 2), {}), (("prefill=1, mixed=1", 2), {})],
        [(("prefill", 1), {}), (("gpu=1", 1), {}), (("prefill=1,prefill=1", 2), {}),
         (("prefill=x", 1), {}), (("prefill=-1", 1), {}), (("prefill=0", 1), {}),
         (("prefill=1,decode=1", 3), {}), (("prefill=2", 2), {}),
         (("decode=1,mixed=1", 2), {})],
    ),
    "parse_autoscale_spec": (
        [(("backlog=3,sustain=2,idle=6,burn=bulk_shed|chat_shed",), dict(max_replicas=3)),
         (("max=4,prefill.backlog=2,decode.backlog=4,decode.min=1",), {}),
         (("",), dict(max_replicas=2, replicas=2)),
         (("preempt=0,wait=3,gap=2,defer=0,min=1",), dict(max_replicas=4, replicas=3))],
        [(("",), {}), (("backlog",), dict(max_replicas=2)), (("speed=1",), dict(max_replicas=2)),
         (("gpu.max=1",), dict(max_replicas=2)), (("decode.wait=1",), dict(max_replicas=2)),
         (("backlog=x",), dict(max_replicas=2)), (("decode.max=x",), dict(max_replicas=2)),
         (("min=0",), dict(max_replicas=2)), (("max=1,min=2",), {}),
         (("backlog=0",), dict(max_replicas=2)), (("decode.min=0",), dict(max_replicas=2)),
         (("decode.backlog=-1",), dict(max_replicas=2))],
    ),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), JSPEC))


def _top2(rows):
    s = np.sort(np.asarray(rows), axis=-1)
    return s[..., -1] - s[..., -2]


def _record(engines):
    """Keep each engine's decode steps' active logits and every kept
    sample's top-2 margin."""
    out = {"steps": [], "margins": []}
    for eng in engines:
        prefill, decode = eng.prefill, eng.decode

        def rec_prefill(prompt, *, slot, request_id, base=0, _bucket=None, _f=prefill):
            tok, logits = _f(prompt, slot=slot, request_id=request_id, base=base, _bucket=_bucket)
            if request_id >= 0:
                out["margins"].append(float(_top2(logits[-1])))
            return tok, logits

        def rec_decode(last, lengths, rids, active, _f=decode, **kw):
            nxt, logits = _f(last, lengths, rids, active, **kw)
            act = np.asarray(active, bool)
            if act.any():
                out["steps"].append(logits[act].copy())
                out["margins"].extend(_top2(logits[act]).tolist())
            return nxt, logits

        eng.prefill, eng.decode = rec_prefill, rec_decode
    return out


# -- traffic and spec grammars ----------------------------------------------


@pytest.mark.parametrize("name", list(TRAFFIC_SPECS))
def test_mixed_traffic_is_byte_equal_to_jax(name):
    kw = TRAFFIC_SPECS[name]
    ours, theirs = tlm.synthesize_mixed_traffic(**kw), jlm.synthesize_mixed_traffic(**kw)
    assert ours and len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.id, a.arrival, a.traffic_class, a.max_new_tokens, a.family) == \
            (b.id, b.arrival, b.traffic_class, b.max_new_tokens, b.family)
        assert a.prompt.dtype == b.prompt.dtype and a.prompt.tobytes() == b.prompt.tobytes()
    if name == "default":
        assert tlm.DEFAULT_TRAFFIC_CLASSES == jlm.DEFAULT_TRAFFIC_CLASSES
        for bad in BAD_TRAFFIC:
            with pytest.raises(ValueError) as got:
                tlm.synthesize_mixed_traffic(**bad)
            with pytest.raises(ValueError) as want:
                jlm.synthesize_mixed_traffic(**bad)
            assert str(got.value) == str(want.value), bad


def _parser(name, side):
    mods = {"parse_traffic_spec": "router", "parse_slo_spec": "router",
            "parse_roles_spec": "disagg", "parse_autoscale_spec": "controller"}
    root = js if side == "jax" else ts
    return getattr(getattr(root, mods[name]), name)


def _plain(value):
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    return value


@pytest.mark.parametrize("name", list(SPEC_TABLES))
def test_spec_parsers_match_jax(name):
    good, bad = SPEC_TABLES[name]
    ours, theirs = _parser(name, "port"), _parser(name, "jax")
    for args, kw in good:
        assert _plain(ours(*args, **kw)) == _plain(theirs(*args, **kw)), args
    for args, kw in bad:
        with pytest.raises(ValueError) as got:
            ours(*args, **kw)
        with pytest.raises(ValueError) as want:
            theirs(*args, **kw)
        assert str(got.value) == str(want.value), args


# -- the router --------------------------------------------------------------


@pytest.mark.parametrize("page_size", [0, 8])
def test_one_replica_router_is_the_bare_scheduler(page_size, weights):
    """The router's idle ticks make no device call, so one replica behind
    it serves the bare scheduler's stream with the same tokens and the same
    logits at every decode step, bitwise; a rerun after reset repeats it."""
    cfg = ts.ServeConfig(spec=TSPEC, slots=2, capacity=48, page_size=page_size)
    prompts = tlm.synthesize_prompts(num=6, min_len=4, max_len=20, vocab=32, seed=2)
    reqs = [ts.Request(id=i, prompt=p, max_new_tokens=6, arrival=i) for i, p in enumerate(prompts)]
    bare_eng = ts.InferenceEngine(cfg, params=weights, device="cpu")
    bare_log = _record([bare_eng])
    done, _ = ts.Scheduler(bare_eng).run(reqs)
    router = ts.Router(ts.RouterConfig(serve=cfg, replicas=1, classes=(ts.ClassSpec("default"),)),
                       params=weights, device="cpu")
    log = _record(router.engines)
    rdone, stats = router.run(reqs)
    assert {i: c.tokens for i, c in rdone.items()} == {i: c.tokens for i, c in done.items()}
    assert len(log["steps"]) == len(bare_log["steps"])
    for a, b in zip(log["steps"], bare_log["steps"]):
        np.testing.assert_array_equal(a, b)
    router.reset()
    again, stats2 = router.run(reqs)
    assert {i: c.tokens for i, c in again.items()} == {i: c.tokens for i, c in rdone.items()}
    assert stats2.placements == stats.placements == {i: 0 for i in range(6)}


def _router(mod, weights, registry, tracer):
    kw = {} if mod is js else dict(device="cpu")
    classes = (mod.ClassSpec("chat", priority=0),
               mod.ClassSpec("longdoc", priority=1, shed_margin=2),
               mod.ClassSpec("bulk", priority=2, shed_margin=3))
    cfg = mod.RouterConfig(
        serve=mod.ServeConfig(spec=JSPEC if mod is js else TSPEC, slots=2, capacity=64,
                              page_size=8, prefix_slots=2),
        replicas=2, classes=classes, shed_threshold=5, affinity_window=6)
    return mod.Router(cfg, params=weights, registry=registry, tracer=tracer, **kw)


@pytest.fixture(scope="module")
def router_runs(weights):
    """The three-class burst stream through JAX's router and the port's,
    each with a registry and the shared in-memory tracer."""
    out = {}
    for mod, lm, Reg, Tr in ((js, jlm, JRegistry, JTracer), (ts, tlm, MetricRegistry, Tracer)):
        reg, tr = Reg(), Tr()
        router = _router(mod, weights, reg, tr)
        log = _record(router.engines) if mod is ts else None
        done, stats = router.run(lm.synthesize_mixed_traffic(**ROUTER_TRAFFIC))
        out["jax" if mod is js else "port"] = (done, stats, reg, tr, router, log)
    return out


def test_router_matches_jax(router_runs):
    jdone, jstats, *_ = router_runs["jax"]
    tdone, tstats, _, _, _, log = router_runs["port"]
    assert sorted(tdone) == sorted(jdone)
    for i in jdone:
        assert (tdone[i].tokens, tdone[i].status, tdone[i].admitted_step,
                tdone[i].finished_step) == (jdone[i].tokens, jdone[i].status,
                                            jdone[i].admitted_step, jdone[i].finished_step), i
    js_sum, ts_sum = jstats.summary(), tstats.summary()
    for key in ("per_replica_requests", "affinity_placements", "load_placements",
                "router_sheds", "ticks", "prefix_hit_rate", "replicas"):
        assert ts_sum[key] == js_sum[key], key
    assert tstats.placements == jstats.placements
    assert {k: (r.requests, r.ok, r.shed, r.deadline_exceeded)
            for k, r in tstats.per_class.items()} == \
        {k: (r.requests, r.ok, r.shed, r.deadline_exceeded) for k, r in jstats.per_class.items()}
    assert tstats.router_sheds > 0 and tstats.affinity_placements > 0
    assert {c.status for c in tdone.values()} == {"ok", "shed"}
    assert min(log["margins"]) > MARGIN


def _counters(reg, prefixes):
    out = {}
    for m in reg.metrics():
        if type(m).__name__ == "Counter" and m.name.startswith(prefixes):
            for ls in m.label_sets():
                out[(m.name, tuple(sorted(ls.items())))] = m.value(**ls)
    return out


def test_router_trace_and_counters_match_jax(router_runs):
    """The shared tracer's lifecycle, routing and ``compile`` events in
    order (the port's at each program key's first dispatch, JAX's at each
    build), and the router's and each replica's counters."""
    _, _, jreg, jtr, jrouter, _ = router_runs["jax"]
    _, _, treg, ttr, trouter, _ = router_runs["port"]
    events = lambda tr: [(r["name"], r["attrs"]) for r in tr.records]  # noqa: E731
    theirs = events(jtr)
    ours = events(ttr)
    assert ours == theirs
    assert {a["kind"] for n, a in ours if n == "compile"} >= {"prefill", "decode"}
    names = {n for n, _ in ours}
    assert {"submit", "route", "router_shed", "eligible", "admit", "prefix_map",
            "prefill_chunk", "first_token", "decode_tick", "complete"} <= names
    assert _counters(treg, "router_") == _counters(jreg, "router_")
    for a, b in zip(trouter.replica_registries, jrouter.replica_registries, strict=True):
        assert _counters(a, "serve_") == _counters(b, "serve_")
        assert a.gauge("serve_kv_pages_free").value() == b.gauge("serve_kv_pages_free").value()
        assert a.get("goodput_fraction") is not None


def test_request_slo_matches_jax_and_the_run_stats(router_runs, weights):
    """``request_slo_samples`` and ``derive_request_slo`` (global and by
    class) give JAX's numbers on the same records; on a bare scheduler's
    run the derivation equals its ``ServeStats`` float for float."""
    _, tstats, _, ttr, _, _ = router_runs["port"]
    recs = ttr.records
    cls_of = {r["attrs"]["req"]: r["attrs"]["cls"] for r in recs if r["name"] == "route"}
    assert ts.request_slo_samples(recs) == js.request_slo_samples(recs)
    for a, b in zip(ts.derive_request_slo(recs), js.derive_request_slo(recs), strict=True):
        assert vars(a) == vars(b) and a.steps > 0
    ours, theirs = ts.derive_request_slo(recs, cls_of), js.derive_request_slo(recs, cls_of.get)
    assert ours and sorted(ours) == sorted(theirs)
    for k in ours:
        assert [vars(s) for s in ours[k]] == [vars(s) for s in theirs[k]]
    for name, report in tstats.per_class.items():
        if name in ours:
            assert vars(report.ttft) == vars(ours[name][0])
    assert ts.derive_request_slo([], {}) == {} and ts.derive_request_slo([])[0].steps == 0
    tr = Tracer()
    eng = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, slots=2, capacity=48), params=weights,
                             device="cpu")
    prompts = tlm.synthesize_prompts(num=4, min_len=4, max_len=16, vocab=32, seed=1)
    _, stats = ts.Scheduler(eng, tracer=tr).run(
        [ts.Request(id=i, prompt=p, max_new_tokens=5, arrival=i) for i, p in enumerate(prompts)])
    ttft, itl = ts.derive_request_slo(tr.records)
    assert vars(ttft) == vars(stats.ttft) and vars(itl) == vars(stats.itl)
    assert stats.itl.steps > 0


def test_part_8_and_later_parts_stay_refused(weights):
    """Serve observability is ported: the router takes ``slo_monitor=``,
    ``anomaly_detector=`` and ``peak_flops=``, the scheduler also
    ``metrics_writer=``, and the controller its ``burn=`` rules, each
    misuse refused with JAX's text (the consumer on another registry or
    none, burn rules without a monitor or naming an unknown rule)."""
    from ddl_tpu.obs.anomaly import AnomalyDetector as JDetector, parse_anomaly_rules as jpar
    from ddl_tpu.obs.slo import SloMonitor as JMonitor, SloRule as JRule
    from ddl_tpu_torch.obs.anomaly import AnomalyDetector, parse_anomaly_rules
    from ddl_tpu_torch.obs.slo import SloMonitor, SloRule

    cfg = ts.RouterConfig(serve=ts.ServeConfig(spec=TSPEC, slots=1, capacity=32, page_size=8),
                          replicas=1, classes=(ts.ClassSpec("default"),))
    jcfg = js.RouterConfig(serve=js.ServeConfig(spec=JSPEC, slots=1, capacity=32, page_size=8),
                           replicas=1, classes=(js.ClassSpec("default"),))
    rule = dict(name="shed", metric="router_shed_total", total_metric="router_requests_total")
    reg, jreg = MetricRegistry(), JRegistry()
    mon, jmon = SloMonitor((SloRule(**rule),), reg), JMonitor((JRule(**rule),), jreg)
    det = AnomalyDetector(parse_anomaly_rules("backlog"), reg)
    jdet = JDetector(jpar("backlog"), jreg)
    for ours, theirs in ((dict(slo_monitor=mon), dict(slo_monitor=jmon)),
                         (dict(anomaly_detector=det), dict(anomaly_detector=jdet)),
                         (dict(slo_monitor=mon, registry=MetricRegistry()),
                          dict(slo_monitor=jmon, registry=JRegistry())),
                         (dict(anomaly_detector=det, registry=MetricRegistry()),
                          dict(anomaly_detector=jdet, registry=JRegistry()))):
        with pytest.raises(ValueError) as e_ours:
            ts.Router(cfg, params=weights, device="cpu", **ours)
        with pytest.raises(ValueError) as e_theirs:
            js.Router(jcfg, **theirs)
        assert str(e_ours.value) == str(e_theirs.value)
    router = ts.Router(cfg, params=weights, device="cpu", registry=reg, slo_monitor=mon,
                       anomaly_detector=det, peak_flops=1e12)
    assert router.slo_monitor is mon and router.anomaly is det
    assert router.scheds[0].slo_monitor is None and router.scheds[0]._peak_flops == 1e12
    assert reg.get("fleet_engine_sim").value() == 0.0
    texts = []
    for spec, monitor in (("burn=bulk_shed", None), ("burn=nope", mon)):
        ctrl = ts.FleetController(ts.parse_autoscale_spec(spec, max_replicas=2))
        with pytest.raises(ValueError) as e:
            ts.Router(cfg, params=weights, device="cpu", registry=reg, slo_monitor=monitor,
                      controller=ctrl)
        texts.append(str(e.value))
    assert texts == [
        "autoscale burn rules ['bulk_shed'] need an SLO monitor on the router (--slo-rules) "
        "— without one the burn trigger could never fire",
        "autoscale burn rules ['nope'] are not among the monitor's rules (['shed'])"]
    ts.Router(cfg, params=weights, device="cpu", registry=reg, slo_monitor=mon,
              controller=ts.FleetController(ts.parse_autoscale_spec("burn=shed",
                                                                    max_replicas=2)))
    eng = ts.InferenceEngine(cfg.serve, params=weights, device="cpu")
    for kw, text in ((dict(slo_monitor=mon), "slo_monitor was built on a different registry"),
                     (dict(anomaly_detector=det),
                      "anomaly_detector was built on a different registry")):
        with pytest.raises(ValueError, match=text):
            ts.Scheduler(eng, registry=MetricRegistry(), **kw)
    sched = ts.Scheduler(eng, registry=reg, slo_monitor=mon, anomaly_detector=det,
                         peak_flops=1e12)
    with pytest.raises(ValueError, match="attach_registry would strand the bound slo_monitor"):
        sched.attach_registry(MetricRegistry())
    # Parts 5 and 6 are ported (tests/test_torch_speculate.py,
    # tests/test_torch_int8.py): a draft lane aliases a slot's pages, and the
    # CLI takes --speculate and --kv-dtype, each needing the paged layout.
    eng.prefill(np.arange(1, 6, dtype=np.int32), slot=0, request_id=0)
    two = ts.InferenceEngine(dataclasses.replace(cfg.serve, slots=2), params=weights,
                             device="cpu")
    two.prefill(np.arange(1, 6, dtype=np.int32), slot=0, request_id=0)
    assert two.alias_slot_pages(1, 0, 4) == 1 and two.tables[1, 0] == two.tables[0, 0]
    two.release_slot(1)
    assert int(two.pages.refs[int(two.tables[0, 0])]) == 1
    for flags, text in ((["--speculate", "4"], "--speculate 4 requires --page-size > 0"),
                        (["--kv-dtype", "int8"], "kv_dtype='int8' needs the paged KV layout")):
        with pytest.raises(SystemExit, match=text):
            cli.main(["serve", "--device", "cpu", "--replicas", "2", *flags])
    # The CLI reads --slo-rules (a malformed spec exits before any engine).
    with pytest.raises(SystemExit, match="--slo-rules: "):
        cli.main(["serve", "--device", "cpu", "--replicas", "2", "--slo-rules", "a:metric=m"])
