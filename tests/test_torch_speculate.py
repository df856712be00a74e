"""The port's speculative decoding (ddl_tpu_torch/serve/speculate.py,
``Scheduler._speculate_decode``, ``InferenceEngine.alias_slot_pages``, the
``--speculate`` flag) against ``ddl_tpu.serve`` on the CPU, at a tiny width
(vocab 32, d_model 32, 2 heads, 2 layers, d_ff 64) and the same weights
(JAX's init carried over as numpy). JAX's side of every scheduler run is
computed once, in the module fixture ``jax_runs``.

Pinned against JAX:

- ``propose_draft`` on JAX's own cases and on 400 seeded contexts, for both
  methods; ``greedy_accept``; the error texts;
- speculative greedy decode at k 2 and 4 (4 slots, 2 requests, 12 new
  tokens): tokens equal the plain run's and JAX's, and ``decode_steps``,
  ``decode_tokens``, ``speculate_proposed_total`` and
  ``speculate_accepted_total`` equal JAX's; the looping stream (one request,
  16 new tokens, k 4) accepts drafts, with the same counters as JAX's
  (its ``decode_tick`` records carry ``spec_lanes`` and ``spec_emitted``);
- the engine's config checks and the CLI's ``--speculate`` checks, with
  JAX's texts.

Port-only pins: each decode logits row of the speculative run equals the
plain run's for the same (request, token index) bitwise while every row of
that request so far attended the plain run's page-count bucket, and within
``WIDTH_ATOL`` once a lane widened one (the port's ``attend`` reduces over
the attended width, so its rounding depends on it, and the K/V rows written
then carry it forward; ROADMAP queue 3 logs the difference); the pool
is whole after every run; at full occupancy speculation proposes nothing
and serves plain decode's tokens; with ``speculate_k == 0`` the draft is
never consulted; ``alias_slot_pages`` maps by reference and a lane's
release leaves the source whole; the router's ``speculate`` digest sums the
replicas' counters.

Greedy comparisons against JAX keep the top-2 margin gate (1e-5, the cached
logits' tolerance): a near-tie fails loudly instead of passing by luck.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ddl_tpu import cli as jcli
from ddl_tpu import serve as js
from ddl_tpu.models import transformer as jt
from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu.serve import speculate as jspec
from ddl_tpu_torch import cli
from ddl_tpu_torch import serve as ts
from ddl_tpu_torch.models.transformer import LMSpec
from ddl_tpu_torch.obs import MetricRegistry
from ddl_tpu_torch.obs.trace import Tracer
from ddl_tpu_torch.serve import scheduler as sched_mod
from ddl_tpu_torch.serve import speculate as tspec
from test_torch_fleet_cli import _jax_cli

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)
MARGIN = 1e-5
# A decode row whose request had a row attended at a wider page-count
# bucket than in the plain run (the lanes map the source's pages ahead, and
# the K/V rows written then carry that width's rounding): measured up to
# 9.5e-7 here. The paged ≡ contiguous tolerance of tests/test_torch_serve.py.
WIDTH_ATOL = 2e-6
CFG = dict(slots=4, capacity=64, page_size=8, num_pages=24)
NEW = 12
LOOP_NEW = 16
KS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), JSPEC))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 32, size=n, dtype=np.int32)


def _requests(mod):
    return [mod.Request(id=i, prompt=_prompt(8, i), max_new_tokens=NEW) for i in range(2)]


def _loop_requests(mod):
    return [mod.Request(id=0, prompt=_prompt(8, 0), max_new_tokens=LOOP_NEW)]


def _counters(reg):
    return [int(reg.counter(n).value()) for n in ("speculate_proposed_total",
                                                  "speculate_accepted_total")]


@pytest.fixture(scope="module")
def jax_runs(weights):
    """JAX's speculative scheduler at k 2 and 4 on the two requests, and at
    k 4 on the looping stream (the k-4 engine reused): completions, stats
    and the two speculation counters. (JAX's own tests pin its speculative
    tokens to its plain decode's.)"""
    out = {}
    for k in KS:
        eng = js.InferenceEngine(js.ServeConfig(spec=JSPEC, speculate_k=k, **CFG), params=weights)
        reg = JRegistry()
        done, stats = js.Scheduler(eng, registry=reg).run(_requests(js))
        out[k] = ({i: c.tokens for i, c in done.items()}, stats, _counters(reg))
        if k == 4:
            reg = JRegistry()
            done, stats = js.Scheduler(eng, registry=reg).run(_loop_requests(js))
            out["loop"] = ({i: c.tokens for i, c in done.items()}, stats, _counters(reg))
    return out


def _recorded(eng, rows):
    """Wrap ``eng.decode`` to keep every active slot's logits row and the
    attended width, keyed by (request id, lengths): the coordinate plain
    decode and the draft lanes share. Last write wins (a rejected lane's
    row is recomputed by the step that emits that position)."""
    decode = eng.decode

    def rec(last, lengths, rids, active, **kw):
        nxt, logits = decode(last, lengths, rids, active, **kw)
        for s in np.nonzero(np.asarray(active, bool))[0]:
            rows[(int(rids[s]), int(lengths[s]))] = (logits[s].copy(), eng.last_attend_width)
        return nxt, logits

    eng.decode = rec
    return eng


def _run(weights, requests, registry=None, tracer=None, **kw):
    eng = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, **{**CFG, **kw}), params=weights,
                             device="cpu")
    rows = {}
    done, stats = ts.Scheduler(_recorded(eng, rows), registry=registry,
                               tracer=tracer).run(requests)
    assert eng.pages.free == eng.num_pages and eng.pages.reserved == 0
    assert not eng.table_len.any()
    return {i: c.tokens for i, c in done.items()}, stats, rows


# -- the draft ----------------------------------------------------------------


JAX_DRAFT_CASES = [  # tests/test_serve_speculate.py's lookup cases
    ([1, 5, 6, 7, 9, 5, 6, 7], 4, {}), ([1, 5, 6, 7, 9, 5, 6, 7], 2, {}),
    ([2, 3, 4, 2, 3, 8, 2, 3], 2, {}), ([2, 3, 4, 2, 3, 8, 2, 3], 1, {}),
    ([4, 5, 9, 9, 4, 5], 2, dict(method="prompt", prompt_len=4)),
    (list(range(1, 7)), 3, {}), ([1, 5, 6, 7, 9, 5, 6, 7], 0, {}),
]


@pytest.mark.parametrize("method", tspec.SPECULATE_METHODS)
def test_propose_draft_matches_jax(method):
    """JAX's lookup cases, then 400 seeded contexts over a small alphabet
    (so n-grams recur), k 0-5, prompt windows of every length."""
    assert tspec.NGRAM_MAX == jspec.NGRAM_MAX
    assert tspec.SPECULATE_METHODS == jspec.SPECULATE_METHODS
    cases = [c for c in JAX_DRAFT_CASES if c[2].get("method", "ngram") == method]
    rng = np.random.default_rng(3 if method == "ngram" else 4)
    for _ in range(400):
        ctx = rng.integers(0, 4, size=int(rng.integers(1, 24))).astype(np.int32)
        kw = dict(method=method)
        if method == "prompt":
            kw["prompt_len"] = int(rng.integers(0, ctx.size + 1))
        cases.append((ctx, int(rng.integers(0, 6)), kw))
    hits = 0
    for ctx, k, kw in cases:
        ours = tspec.propose_draft(ctx, k, **kw)
        theirs = jspec.propose_draft(ctx, k, **kw)
        assert ours.dtype == np.int32 and ours.tolist() == theirs.tolist(), (ctx, k, kw)
        hits += bool(ours.size)
    assert hits > 100


def test_propose_draft_errors_and_greedy_accept_match_jax():
    ctx = np.asarray([1, 5, 6, 7, 9, 5, 6, 7], np.int32)
    for kw in (dict(method="beam"), dict(method="prompt")):
        with pytest.raises(ValueError) as ours:
            tspec.propose_draft(ctx, 2, **kw)
        with pytest.raises(ValueError) as theirs:
            jspec.propose_draft(ctx, 2, **kw)
        assert str(ours.value) == str(theirs.value)
    for drafts, verified in (([3, 4], [3, 4, 9]), ([3, 7], [3, 4, 9]), ([8], [3, 4]),
                             ([], [3]), ([1, 2, 3, 4], [1, 2, 3, 4, 5])):
        assert ts.greedy_accept(drafts, verified) == js.greedy_accept(drafts, verified)
    assert ts.propose_draft is tspec.propose_draft


# -- the speculative decode phase ---------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_speculative_decode_matches_plain_and_jax(k, weights, jax_runs):
    """Speculative ≡ plain ≡ JAX's tokens; JAX's step counts and counters;
    each decode row bitwise the plain run's where the attended widths match,
    within WIDTH_ATOL where the lanes widened the bucket."""
    plain, pstats, prows = _run(weights, _requests(ts))
    reg = MetricRegistry()
    spec, sstats, srows = _run(weights, _requests(ts), registry=reg, speculate_k=k)
    jspec_tokens, jstats, jcounters = jax_runs[k]
    assert spec == plain and jspec_tokens == plain
    assert all(len(t) == NEW for t in spec.values())
    assert (sstats.decode_steps, sstats.decode_tokens) == (jstats.decode_steps,
                                                           jstats.decode_tokens)
    assert sstats.decode_tokens == pstats.decode_tokens
    assert sstats.decode_steps < pstats.decode_steps
    assert _counters(reg) == jcounters and jcounters[0] > 0
    # A row is bitwise while every row of its request so far (each one
    # wrote the K/V the later rows attend) ran at the plain run's width.
    clean = {}
    counts = {True: 0, False: 0}
    for key in sorted(prows):
        (row, width), (srow, swidth) = prows[key], srows[key]
        same = clean[key[0]] = clean.get(key[0], True) and swidth == width
        if same:
            np.testing.assert_array_equal(srow, row, err_msg=str(key))
        else:
            np.testing.assert_allclose(srow, row, atol=WIDTH_ATOL, rtol=0, err_msg=str(key))
        counts[same] += 1
    assert counts[True] > 0
    margins = [np.diff(np.sort(r)[-2:])[0] for r, _ in prows.values()]
    assert min(margins) > MARGIN


def test_speculate_accepts_on_looping_stream(weights, jax_runs):
    """The tiny model's greedy stream settles into a loop that the n-gram
    draft nails: accepted drafts, more than one token a decode step, and
    JAX's tokens, steps and counters. Each ``decode_tick`` record carries
    its lanes and emitted tokens, and the records still give the run's
    TTFT and ITL."""
    reg, tr = MetricRegistry(), Tracer()
    tokens, stats, _ = _run(weights, _loop_requests(ts), registry=reg, tracer=tr, speculate_k=4)
    ticks = [r["attrs"] for r in tr.records if r["name"] == "decode_tick"]
    assert len(ticks) == stats.decode_steps and any(t["spec_lanes"] for t in ticks)
    assert sum(t["spec_emitted"] for t in ticks) == stats.decode_tokens
    ttft, itl = ts.derive_request_slo(tr.records)
    assert vars(ttft) == vars(stats.ttft) and vars(itl) == vars(stats.itl)
    jtokens, jstats, jcounters = jax_runs["loop"]
    assert tokens == jtokens and len(tokens[0]) == LOOP_NEW
    assert stats.decode_tokens == LOOP_NEW - 1 == jstats.decode_tokens
    assert stats.decode_steps == jstats.decode_steps
    assert stats.decode_tokens / stats.decode_steps > 1.0
    assert _counters(reg) == jcounters and jcounters[1] >= 1


def test_speculate_full_occupancy_degrades_to_plain(weights):
    """No free slot, no lane: plain decode's tokens and no proposal."""
    reqs = [ts.Request(id=i, prompt=_prompt(6, i), max_new_tokens=4) for i in range(2)]
    small = dict(slots=2, capacity=32, num_pages=12)
    plain, pstats, _ = _run(weights, reqs, **small)
    reg = MetricRegistry()
    spec, sstats, _ = _run(weights, reqs, registry=reg, speculate_k=2, **small)
    assert spec == plain and sstats.decode_steps == pstats.decode_steps
    assert reg.get("speculate_proposed_total") is None


def test_speculate_k0_never_consults_the_draft(weights, monkeypatch):
    """With speculate_k 0 the tick is the plain tick: a poisoned
    propose_draft is never called, and the decode calls and tokens equal
    the tick's without the speculation branch (method "prompt" at k 0)."""
    def boom(*a, **kw):
        raise AssertionError("propose_draft consulted with speculate_k=0")

    monkeypatch.setattr(sched_mod, "propose_draft", boom)
    calls = {}
    for method in ("ngram", "prompt"):
        eng = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, speculate_method=method, **CFG),
                                 params=weights, device="cpu")
        seen = calls[method] = []
        decode = eng.decode

        def rec(*a, _seen=seen, _decode=decode, **kw):
            _seen.append([np.array(x, copy=True) for x in a])
            return _decode(*a, **kw)

        eng.decode = rec
        done, _ = ts.Scheduler(eng).run(_requests(ts))
        assert all(c.status == "ok" for c in done.values())
    assert len(calls["ngram"]) == len(calls["prompt"]) == NEW - 1
    for a, b in zip(calls["ngram"], calls["prompt"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [
    dict(speculate_k=2), dict(page_size=8, capacity=32, speculate_k=2, temperature=0.7),
    dict(slots=1, page_size=8, capacity=32, speculate_k=2), dict(speculate_method="beam"),
    dict(speculate_k=-1),
], ids=["contiguous", "sampled", "one-slot", "method", "negative"])
def test_speculate_config_checks_match_jax(kw, weights):
    with pytest.raises(ValueError) as theirs:
        js.InferenceEngine(js.ServeConfig(spec=JSPEC, **kw), params=weights)
    with pytest.raises(ValueError) as ours:
        ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, **kw), params=weights, device="cpu")
    assert str(ours.value) == str(theirs.value)


def test_alias_slot_pages_maps_by_reference(weights):
    """A lane aliases the source's table (mapping the source's pages ahead
    first, from the source's reservation), holds a reference a page, and
    its release leaves every page live on the source's references."""
    eng = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, speculate_k=2, **CFG), params=weights,
                             device="cpu")
    eng.reserve_pages(0, 3)
    eng.prefill(_prompt(10, 1), slot=0, request_id=0)  # 2 pages
    assert eng.alias_slot_pages(2, 0, 17) == 3  # row 16 needs a third page
    assert eng.tables[2, :3].tolist() == eng.tables[0, :3].tolist()
    assert int(eng.reserved_for[0]) == 0 and int(eng.reserved_for[2]) == 0
    assert [int(eng.pages.refs[p]) for p in eng.tables[0, :3]] == [2, 2, 2]
    with pytest.raises(RuntimeError, match="non-empty slot 2"):
        eng.alias_slot_pages(2, 0, 17)
    eng.release_slot(2)
    assert [int(eng.pages.refs[p]) for p in eng.tables[0, :3]] == [1, 1, 1]
    assert eng.pages.free == eng.num_pages - 3
    eng.release_slot(0)
    assert eng.pages.free == eng.num_pages
    contiguous = ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, slots=2, capacity=32),
                                    params=weights, device="cpu")
    with pytest.raises(RuntimeError, match="paged KV layout"):
        contiguous.alias_slot_pages(1, 0, 4)


def test_router_speculate_digest_sums_the_replicas(weights):
    """Two speculating replicas behind the router: the CLI's ``speculate``
    digest sums the replicas' counters; without a registry there is none
    (as JAX's CLI without its telemetry flags)."""
    traffic = [ts.Request(id=i, prompt=_prompt(8, i), max_new_tokens=10, arrival=i)
               for i in range(4)]
    serve = ts.ServeConfig(spec=TSPEC, speculate_k=3, **CFG)
    rcfg = ts.RouterConfig(serve=serve, replicas=2, classes=(ts.ClassSpec("default"),))
    router = ts.Router(rcfg, params=weights, device="cpu", registry=MetricRegistry())
    done, _ = router.run(traffic)
    digest = cli._speculate_digest(serve, router)
    per = [_counters(r) for r in router.replica_registries]
    assert digest["proposed"] == sum(p for p, _ in per) > 0
    assert digest["accepted"] == sum(a for _, a in per)
    assert (digest["k"], digest["method"]) == (3, "ngram")
    plain = ts.Router(dataclasses.replace(rcfg, serve=dataclasses.replace(serve, speculate_k=0)),
                      params=weights, device="cpu")
    pdone, _ = plain.run(traffic)
    assert {i: c.tokens for i, c in done.items()} == {i: c.tokens for i, c in pdone.items()}
    assert cli._speculate_digest(serve, plain) is None


@pytest.mark.parametrize("flags", [
    ["--speculate", "4"], ["--replicas", "2", "--speculate", "4"],
    ["--replicas", "2", "--page-size", "8", "--speculate", "0"],
    ["--replicas", "2", "--page-size", "8", "--speculate", "4,beam"],
    ["--replicas", "2", "--page-size", "8", "--speculate", "x"],
    ["lm", "--speculate", "4"],
], ids=lambda f: " ".join(f))
def test_cli_speculate_flag_fails_as_jax(flags):
    argv = flags if flags[0] == "lm" else ["serve", "--vocab", "32", "--capacity", "64", *flags]
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with _jax_cli(), pytest.raises(SystemExit) as theirs:
        jcli.main(argv + ["--platform", "cpu"])
    assert str(ours.value) == str(theirs.value)
