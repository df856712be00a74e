"""The port's serving fleet (ddl_tpu_torch/serve/{controller,disagg}.py, the
page hand-off in serve/engine.py and serve/cache.py, ``Scheduler.preempt`` /
``adopt`` / ``abandon``) against ``ddl_tpu.serve`` on the CPU, at a tiny
width (vocab 32, d_model 32, 2 heads, 2 layers, d_ff 64) and the same
weights (JAX's init carried over as numpy). The CLI's crash and roles runs
are held to JAX's CLI in tests/test_torch_fleet_cli.py.

Pinned against JAX:

- the fleet controller on serve_bench's shed-vs-autoscale stream
  (benchmarks/serve_bench.py, fleet_compare) at this width: the event
  ledger (tick, kind, replica, reason), completions, placements and sheds;
- cross-replica preemption on JAX's own policy case (a chat request queued
  behind a long bulk occupant): events, placements, tokens, admission
  steps; and the request the controller preempts mid-decode, as a
  ``PreemptedRequest``: ``generated``, ``last_token``, ``lengths`` and
  ``admitted_at`` equal, its k/v pages within the cached forwards'
  tolerance (atol 1e-6 + rtol 1e-5, tests/test_torch_kv_cache.py) and its
  positions exact.

Port-only pins: dump -> load is bitwise (fp32 and the bf16 pool's raw
bits); a request preempted on one engine and adopted by another gives the
unpreempted run's tokens and every decode step's logits, bitwise;
``handoff_bytes_total`` equals ``handoff_bytes(pages)``; both pools are
whole after release.

Greedy comparisons against JAX keep the top-2 margin gate (1e-5, the
cached logits' tolerance): a near-tie fails loudly instead of passing by
luck.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from ddl_tpu import serve as js
from ddl_tpu.data import lm as jlm
from ddl_tpu.models import transformer as jt
from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu_torch import serve as ts
from ddl_tpu_torch.data import lm as tlm
from ddl_tpu_torch.models.transformer import LMSpec
from ddl_tpu_torch.obs import MetricRegistry
from ddl_tpu_torch.obs.trace import Tracer
from ddl_tpu_torch.serve.cache import host_paged_cache, write_page

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)
MARGIN = 1e-5
CACHE_ATOL, CACHE_RTOL = 1e-6, 1e-5
HANDOFF = dict(slots=1, capacity=32, page_size=8, num_pages=8)
# benchmarks/serve_bench.py's fleet_compare stream and fleet, at this width.
FLEET_TRAFFIC = dict(
    classes={"chat": dict(rate=0.4, prompt_min=8, prompt_max=24, max_new_tokens=8),
             "bulk": dict(rate=0.5, prompt_min=8, prompt_max=24, max_new_tokens=8)},
    horizon=20, vocab=32, seed=8, burst=(4, 8, 5.0, "bulk"), max_requests=28,
)
FLEET_AUTOSCALE = dict(max_replicas=3, min_replicas=1, backlog_per_replica=3.0, sustain_ticks=2,
                       idle_ticks=6)


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


@contextlib.contextmanager
def recording(cls=ts.InferenceEngine):
    """Patch the port engine class so every engine keeps its decode steps'
    active logits (``steps``) and the top-2 margin of every kept sample
    (``margins``)."""
    out = {"steps": [], "margins": []}
    prefill, decode = cls.prefill, cls.decode

    def rec_prefill(self, prompt, *, slot, request_id, base=0, _bucket=None):
        tok, logits = prefill(self, prompt, slot=slot, request_id=request_id, base=base,
                              _bucket=_bucket)
        if request_id >= 0:
            out["margins"].append(float(_top2(logits[-1])))
        return tok, logits

    def rec_decode(self, last, lengths, rids, active, **kw):
        nxt, logits = decode(self, last, lengths, rids, active, **kw)
        act = np.asarray(active, bool)
        if act.any():
            out["steps"].append(logits[act].copy())
            out["margins"].extend(_top2(logits[act]).tolist())
        return nxt, logits

    cls.prefill, cls.decode = rec_prefill, rec_decode
    try:
        yield out
    finally:
        cls.prefill, cls.decode = prefill, decode


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 32, size=n, dtype=np.int32)


# -- the page hand-off -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dump_and_load_round_trip_bitwise(dtype):
    """dump_slot_pages -> load_slot_pages into another engine moves the
    slot's pages bit for bit, in block-table order, onto freshly mapped
    pages (positions' PAD_POS tails included); write_page writes one page
    or n pages in one indexed write."""
    cfg = ts.ServeConfig(spec=TSPEC, slots=2, capacity=32, page_size=8,
                         compute_dtype=None if dtype == "float32" else dtype)
    src, dst = (ts.InferenceEngine(cfg, device="cpu") for _ in range(2))
    src.prefill(_prompt(5, 1), slot=1, request_id=0)  # page 0: slot 1's first page
    src.prefill(_prompt(11, 2), slot=0, request_id=1)  # pages 1, 2
    k, v, pos = src.dump_slot_pages(0)
    assert k.shape == (2, 2, 8, 2, 16) and pos.shape == (2, 8)
    assert k.dtype == (np.float32 if dtype == "float32" else np.int16)
    assert (pos[1, 3:] == 2**31 - 1).all() and (pos[0] == np.arange(8)).all()
    dst.prefill(_prompt(3, 3), slot=0, request_id=2)  # dst's page 0 is taken
    dst.reserve_pages(1, 2)
    mapped = dst.load_slot_pages(1, k, v, pos)
    assert mapped == [1, 2] and list(dst.tables[1, :2]) == mapped
    assert int(dst.reserved_for[1]) == 0 and dst.pages.reserved == 0
    for name in ("k", "v"):
        a = getattr(src.cache, name)[:, [1, 2]]
        b = getattr(dst.cache, name)[:, mapped]
        assert torch.equal(a.view(torch.int16) if dtype != "float32" else a,
                           b.view(torch.int16) if dtype != "float32" else b)
    assert torch.equal(src.cache.pos[[1, 2]], dst.cache.pos[mapped])
    with pytest.raises(ValueError, match="same pool dtype"):
        dst.load_slot_pages(0, k.astype(np.float64) if dtype == "float32" else k.view(np.uint8),
                            v, pos)
    # (payload, scale) pairs come from an int8 pool (tests/test_torch_int8.py).
    with pytest.raises(ValueError, match="full-precision pool"):
        dst.load_slot_pages(0, (k, k), (v, v), pos)
    pool = host_paged_cache(TSPEC, 4, 8)
    write_page(pool, dst_page=3, k_rows=torch.ones(2, 1, 8, 2, 16),
               v_rows=torch.ones(2, 1, 8, 2, 16), pos_rows=torch.arange(8)[None])
    assert pool.k[:, 3].eq(1).all() and pool.k[:, :3].eq(0).all()
    assert pool.pos[3].tolist() == list(range(8)) and pool.pos[4].eq(2**31 - 1).all()
    contiguous = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, slots=1, capacity=32),
                                    device="cpu")
    for call in (lambda: contiguous.dump_slot_pages(0),
                 lambda: contiguous.load_slot_pages(0, k, v, pos)):
        with pytest.raises(RuntimeError, match="paged KV layout"):
            call()


def _preempt_at(eng, tracer=None, registry=None, ticks=3):
    """Run request 0 for ``ticks`` ticks on ``eng`` and preempt it."""
    sched = ts.Scheduler(eng, tracer=tracer, registry=registry)
    sched.begin()
    sched.submit(ts.Request(id=0, prompt=_prompt(6, 3), max_new_tokens=6))
    for _ in range(ticks):
        sched.tick()
    return sched, sched.preempt(0)


def test_preempt_matches_jax_and_adopt_resumes_bitwise(fleet_runs, weights):
    """The request JAX's controller preempts mid-decode and the port's are
    the same ``PreemptedRequest``; the port's request preempted on one
    engine and adopted by another equals its unpreempted run in tokens and
    in every decode step's logits, bitwise; the move's bytes count once;
    both pools end whole."""
    (jpre,), (tpre,) = fleet_runs["jax/preempted"], fleet_runs["port/preempted"]
    assert (tpre.request.id, tpre.generated, tpre.last_token, tpre.lengths, tpre.admitted_at) \
        == (jpre.request.id, jpre.generated, jpre.last_token, jpre.lengths, jpre.admitted_at)
    assert len(tpre.generated) == 12 and tpre.pos.shape == (3, 8)
    np.testing.assert_array_equal(tpre.pos, np.asarray(jpre.pos))
    for ours, theirs in ((tpre.k, jpre.k), (tpre.v, jpre.v)):
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=CACHE_ATOL, rtol=CACHE_RTOL)
    cfg = ts.ServeConfig(spec=TSPEC, **HANDOFF)
    with recording() as oracle:
        want, _ = ts.Scheduler(ts.InferenceEngine(cfg, params=weights, device="cpu")).run(
            [ts.Request(id=0, prompt=_prompt(6, 3), max_new_tokens=6)])
    tr, reg = Tracer(), MetricRegistry()
    a, b = (ts.InferenceEngine(cfg, params=weights, device="cpu") for _ in range(2))
    with recording() as moved:
        sa, pre = _preempt_at(a, tracer=tr, registry=reg)
        sb = ts.Scheduler(b, tracer=tr)
        sb.begin()
        assert sb.adopt(pre) == 0
        while not sb.idle:
            sb.tick()
    assert len(pre.generated) == 4 and pre.pos.shape == (2, 8)
    done_a, _ = sa.collect()
    done_b, _ = sb.collect()
    assert done_a == {} and done_b[0].status == "ok" and done_b[0].tokens == want[0].tokens
    assert done_b[0].admitted_step == 0
    assert len(moved["steps"]) == len(oracle["steps"])
    for got, ref in zip(moved["steps"], oracle["steps"]):
        np.testing.assert_array_equal(got, ref)
    assert min(oracle["margins"]) > MARGIN
    assert reg.counter("handoff_bytes_total").value(path="preempt") == a.handoff_bytes(2)
    names = [r["name"] for r in tr.records]
    assert names.index("preempt") < names.index("resume") < names.index("complete")
    for eng in (a, b):
        assert eng.pages.free == eng.num_pages and eng.pages.reserved == 0
    # abandon hands back the ledger without touching the engine.
    sa.begin()
    sa.submit(ts.Request(id=5, prompt=_prompt(4, 0), max_new_tokens=4))
    sa.submit(ts.Request(id=6, prompt=_prompt(4, 1), max_new_tokens=2, arrival=9))
    sa.tick()
    done, inflight, queued = sa.abandon()
    assert done == {} and [r.id for r in inflight] == [5] and [r.id for r in queued] == [6]
    assert sa.idle and int(a.table_len[0]) > 0  # the engine is the caller's to drop


# -- the controller ----------------------------------------------------------


def _fleet_router(mod, weights, controller, registry=None):
    kw = {} if mod is js else dict(device="cpu")
    rc = mod.RouterConfig(
        serve=mod.ServeConfig(spec=JSPEC if mod is js else TSPEC, slots=2, capacity=64),
        replicas=1,
        classes=(mod.ClassSpec("chat", ttft_slo_s=5.0, itl_slo_s=0.5, priority=0),
                 mod.ClassSpec("bulk", ttft_slo_s=60.0, itl_slo_s=5.0, priority=2,
                               shed_margin=2)),
        shed_threshold=5,
    )
    return mod.Router(rc, params=weights, registry=registry, controller=controller, **kw)


def _policy_router(mod, weights):
    kw = {} if mod is js else dict(device="cpu")
    spec = JSPEC if mod is js else TSPEC
    classes = (mod.ClassSpec("chat", priority=0), mod.ClassSpec("bulk", priority=2))
    return mod.Router(mod.RouterConfig(serve=mod.ServeConfig(spec=spec, **HANDOFF), replicas=2,
                                       classes=classes), params=weights, **kw)


def _policy_requests(mod):
    return [mod.Request(id=0, prompt=_prompt(6, 0), max_new_tokens=16, traffic_class="bulk"),
            mod.Request(id=1, prompt=_prompt(6, 1), max_new_tokens=12, traffic_class="bulk"),
            mod.Request(id=2, prompt=_prompt(6, 2), max_new_tokens=2, arrival=2,
                        traffic_class="chat")]


@pytest.fixture(scope="module")
def fleet_runs(weights):
    """serve_bench's fleet stream under the autoscaler, and JAX's
    preemption case, through JAX's router and the port's."""
    out = {}
    for mod in (js, ts):
        side = "jax" if mod is js else "port"
        traffic = (jlm if mod is js else tlm).synthesize_mixed_traffic(**FLEET_TRAFFIC)
        ctrl = mod.FleetController(mod.AutoscaleConfig(**FLEET_AUTOSCALE))
        reg = JRegistry() if mod is js else MetricRegistry()
        with recording() if mod is ts else contextlib.nullcontext({"margins": [1.0]}) as rec:
            router = _fleet_router(mod, weights, ctrl, registry=reg)
            done, stats = router.run(traffic)
        out[f"{side}/autoscale"] = (done, stats, ctrl, reg, rec["margins"])
        ctrl = mod.FleetController(mod.AutoscaleConfig(max_replicas=2, min_replicas=2,
                                                       preempt_wait_ticks=2))
        preempt, lifted = mod.Scheduler.preempt, []

        def keep(self, *a, **kw):
            lifted.append(preempt(self, *a, **kw))
            return lifted[-1]

        mod.Scheduler.preempt = keep
        try:
            with recording() if mod is ts else contextlib.nullcontext({"margins": [1.0]}) as rec:
                router = _policy_router(mod, weights)
                router.controller = ctrl
                ctrl.bind(router)
                done, stats = router.run(_policy_requests(mod))
        finally:
            mod.Scheduler.preempt = preempt
        out[f"{side}/preempt"] = (done, stats, ctrl, router, rec["margins"])
        out[f"{side}/preempted"] = lifted
    return out


def _same_completions(a, b):
    assert sorted(a) == sorted(b)
    for i in a:
        assert (a[i].tokens, a[i].status, a[i].admitted_step, a[i].finished_step) == \
            (b[i].tokens, b[i].status, b[i].admitted_step, b[i].finished_step), i


@pytest.mark.parametrize("case", ["autoscale", "preempt"])
def test_controller_matches_jax(fleet_runs, case):
    """The controller's event ledger, every completion, the placement
    ledger, sheds and the fleet counters equal JAX's."""
    jdone, jstats, jctrl, _, _ = fleet_runs[f"jax/{case}"]
    tdone, tstats, tctrl, _, margins = fleet_runs[f"port/{case}"]
    _same_completions(tdone, jdone)
    assert tctrl.events == jctrl.events and tstats.fleet == jstats.fleet
    assert (tstats.placements, tstats.router_sheds, tstats.ticks) == \
        (jstats.placements, jstats.router_sheds, jstats.ticks)
    assert {k: (r.requests, r.ok, r.shed) for k, r in tstats.per_class.items()} == \
        {k: (r.requests, r.ok, r.shed) for k, r in jstats.per_class.items()}
    assert min(margins) > MARGIN
    if case == "autoscale":
        kinds = {kind for _, kind, _ in tctrl.events}
        assert {"scale_out", "drain", "scale_in"} <= kinds
        treg, jreg = fleet_runs["port/autoscale"][3], fleet_runs["jax/autoscale"][3]
        for kind in ("scale_out", "drain", "scale_in"):
            assert treg.counter("scale_events_total").value(kind=kind) == \
                jreg.counter("scale_events_total").value(kind=kind)
        assert len(tstats.replica) == 3 and tstats.replica[0] is not None
    else:
        assert tctrl.preemptions == 1 and tstats.placements[0] == 1
        names = [r["name"] for r in fleet_runs["port/preempt"][3].tracer.records]
        assert {"preempt", "resume", "preempt_move"} <= set(names)


def test_preemption_serves_earlier_with_the_same_tokens(fleet_runs, weights):
    """Against the port's own run without a controller: the moved bulk
    request's tokens are unchanged and chat admits earlier."""
    oracle, stats = _policy_router(ts, weights).run(_policy_requests(ts))
    done = fleet_runs["port/preempt"][0]
    assert stats.placements[2] == 0 and done[2].admitted_step < oracle[2].admitted_step
    assert {i: done[i].tokens for i in done} == {i: oracle[i].tokens for i in oracle}
    for eng in fleet_runs["port/preempt"][3].engines:
        assert eng.pages.free == eng.num_pages and eng.pages.reserved == 0
