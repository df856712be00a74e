"""The port's serving stack (ddl_tpu_torch/serve/, data/lm.py's prompt sets,
the ``serve`` CLI) against ``ddl_tpu.serve`` on the CPU, at a tiny width
(vocab 32, d_model 32, 2 heads, 2 layers, d_ff 64), the same weights (JAX's
init carried over as numpy) and the same prompts.

Pinned against JAX:

- the prompt sets byte-equal; ``fold_in`` and the random bits bit-equal to
  ``jax.random``; sampled tokens equal to the JAX engine's ``_sample`` at
  temperature 0.7, top_k 5;
- ``Scheduler.run`` on 6 prompts x 8 new tokens, contiguous and paged,
  greedy and sampled, with the prefix cache and chunked prefill, with
  shedding and deadlines: every request's tokens, ``admitted_step``,
  ``finished_step`` and ``status`` equal, and the ``ServeStats`` counters
  (``prefill_tokens``, ``decode_steps``, ``prefix_hits``) equal. Greedy
  cases also require every sampled step's top-2 logit margin to exceed
  1e-5 (the cached logits' tolerance against JAX,
  tests/test_torch_kv_cache.py), so a near-tie fails loudly instead of
  passing by luck;
- ``PrefixIndex`` and ``PagePool`` through one op sequence, ending in equal
  state; the bucket ladders; the config checks' messages.

Port-only pins: paged ≡ contiguous (tokens equal, decode logits within
atol 2e-6: not bitwise on the CPU, since the attention's reductions run
over another length; measured up to 1.04e-6), continuous batching ≡ each
request alone, chunked ≡ whole-prompt prefill (tokens, logits within
1e-5), prefix cache on ≡ off in both layouts, an aborted run returns the
pool whole, the CLI smoke, and the loud refusal of everything not ported.
"""

import contextlib
import io
import json
import types

import jax
import numpy as np
import pytest
import torch

from ddl_tpu.data import lm as jlm
from ddl_tpu.models import transformer as jt
from ddl_tpu.serve import InferenceEngine as JEngine
from ddl_tpu.serve import PrefixIndex as JPrefixIndex
from ddl_tpu.serve import Request as JRequest
from ddl_tpu.serve import Scheduler as JScheduler
from ddl_tpu.serve import ServeConfig as JConfig
from ddl_tpu.serve.cache import PagePool as JPagePool
from ddl_tpu_torch import cli
from ddl_tpu_torch.data import lm as tlm
from ddl_tpu_torch.models.transformer import LMSpec
from ddl_tpu_torch.serve import InferenceEngine, PagePool, PrefixIndex, Request, Scheduler
from ddl_tpu_torch.serve import ServeConfig, sampling

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)
MARGIN = 1e-5  # the cached logits' tolerance against JAX
PAGED_VS_CONTIGUOUS_ATOL = 2e-6
CHUNKED_ATOL = 1e-5
PROMPTS = dict(num=6, min_len=3, max_len=20, vocab=32, seed=0)
SHARED = dict(n_families=2, per_family=3, prefix_len=12, tail_min=1, tail_max=10, vocab=32,
              seed=1)
MAX_NEW = 8

# name -> (ServeConfig fields, prompt set, Scheduler options, warm up first)
CASES = {
    "contiguous-greedy": (dict(slots=3, capacity=64), "plain", {}, False),
    "paged-greedy": (dict(slots=3, capacity=64, page_size=8), "plain", {}, False),
    "contiguous-sampled-eos": (dict(slots=3, capacity=64, temperature=0.7, top_k=5), "plain",
                               dict(eos_id=7), False),
    # 5 pages of 8 rows for 3 slots: admission waits for pages.
    "paged-sampled-tight-pool": (dict(slots=3, capacity=64, page_size=8, num_pages=5,
                                      temperature=0.7, top_k=5), "plain", {}, False),
    "contiguous-prefix-chunked": (dict(slots=2, capacity=64, prefix_slots=2, prefill_chunk=8),
                                  "shared", {}, True),
    "paged-prefix-chunked": (dict(slots=2, capacity=64, page_size=8, prefix_slots=2,
                                  prefill_chunk=8, prefill_budget=16), "shared", {}, True),
    # Shed at first eligibility past 3 outstanding; a 1 ns total deadline
    # evicts every admitted request at its second tick (deterministic: the
    # check never fires in the tick that stamps eligibility).
    "shed-and-deadline": (dict(slots=2, capacity=64), "plain",
                          dict(shed_threshold=3, deadline_s=1e-9), False),
}


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), JSPEC))


def _prompts(kind):
    if kind == "plain":
        return jlm.synthesize_prompts(**PROMPTS)
    return jlm.synthesize_shared_prefix_prompts(**SHARED)


def _record(engine):
    """Wrap the port engine's prefill/decode to keep the top-2 margin of
    every logit row whose sample the scheduler keeps."""
    margins, prompt_len = [], {}
    prefill, decode = engine.prefill, engine.decode

    def top2(rows):
        s = np.sort(rows, axis=-1)
        return s[..., -1] - s[..., -2]

    def rec_prefill(prompt, *, slot, request_id, base=0, _bucket=None):
        tok, logits = prefill(prompt, slot=slot, request_id=request_id, base=base,
                              _bucket=_bucket)
        if base + len(prompt) == prompt_len.get(request_id):
            margins.append(float(top2(logits[-1])))
        return tok, logits

    def rec_decode(last, lengths, rids, active, **kw):
        nxt, logits = decode(last, lengths, rids, active, **kw)
        margins.extend(top2(logits[np.asarray(active, bool)]).tolist())
        return nxt, logits

    engine.prefill, engine.decode = rec_prefill, rec_decode
    return margins, prompt_len


@pytest.fixture(scope="module")
def runs(weights):
    """Each case run once through JAX's and the port's scheduler."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg_kw, kind, sched_kw, warm = CASES[name]
            prompts = _prompts(kind)
            out = {}
            for side, (Cfg, Eng, Sched, Req, spec) in {
                "jax": (JConfig, JEngine, JScheduler, JRequest, JSPEC),
                "port": (ServeConfig, InferenceEngine, Scheduler, Request, TSPEC),
            }.items():
                extra = {} if side == "jax" else dict(device="cpu")
                eng = Eng(Cfg(spec=spec, **cfg_kw), params=weights, **extra)
                if side == "port":
                    margins, lens = _record(eng)
                    lens.update({i: len(p) for i, p in enumerate(prompts)})
                sched = Sched(eng, **sched_kw)
                reqs = [Req(id=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
                if warm:
                    sched.warmup(reqs)
                out[side] = (*sched.run(reqs), eng)
            cache[name] = (out["jax"], out["port"], margins)
        return cache[name]

    return get


def test_step_stats_take_jax_signatures():
    """Serving builds latency-only stats (``from_times(times)``) and labels
    the throughput unit (``line(unit=...)``), as the JAX package does."""
    from ddl_tpu.utils.metrics import StepStats as JStats
    from ddl_tpu_torch.utils.metrics import StepStats

    times = [0.004, 0.001, 0.0025, 0.003]
    for args in ((times,), (times, [8, 8, 6, 8]), ([],)):
        ours, theirs = StepStats.from_times(*args), JStats.from_times(*args)
        assert ours == StepStats(**vars(theirs))
        assert ours.line(unit="tok/s") == theirs.line(unit="tok/s")
    assert StepStats.from_times(times).images_per_sec == 0.0


def test_prompt_sets_are_byte_equal_to_jax():
    for kw in (PROMPTS, dict(PROMPTS, num=16, min_len=16, max_len=128, vocab=256)):
        for a, b in zip(tlm.synthesize_prompts(**kw), jlm.synthesize_prompts(**kw), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tlm.synthesize_shared_prefix_prompts(**SHARED),
                    jlm.synthesize_shared_prefix_prompts(**SHARED), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="min_len"):
        tlm.synthesize_prompts(min_len=5, max_len=4)
    with pytest.raises(ValueError, match="prefix_len"):
        tlm.synthesize_shared_prefix_prompts(prefix_len=1)


@pytest.mark.parametrize("name", list(CASES))
def test_scheduler_matches_jax(runs, name):
    (jdone, jstats, jeng), (tdone, tstats, teng), margins = runs(name)
    assert sorted(tdone) == sorted(jdone)
    for i in jdone:
        j, t = jdone[i], tdone[i]
        assert (t.tokens, t.admitted_step, t.finished_step, t.status, t.prompt_len) == \
            (j.tokens, j.admitted_step, j.finished_step, j.status, j.prompt_len), i
    for field in ("prefill_tokens", "decode_steps", "decode_tokens", "prefix_lookups",
                  "prefix_hits", "prefill_tokens_saved"):
        assert getattr(tstats, field) == getattr(jstats, field), field
    if teng.paged:
        assert (teng.pages.free, teng.pages.reserved, teng.page_copies) == \
            (jeng.pages.free, jeng.pages.reserved, jeng.page_copies)
        np.testing.assert_array_equal(teng.pages.refs, jeng.pages.refs)
    if CASES[name][0].get("temperature", 0.0) == 0.0:
        assert margins and min(margins) > MARGIN, min(margins)
    statuses = {c.status for c in tdone.values()}
    if name == "shed-and-deadline":
        assert statuses == {"shed", "deadline_exceeded"}
    else:
        assert statuses == {"ok"}
    if "prefix" in name:
        assert tstats.prefix_hits > 0
    if "eos" in name:
        assert any(len(c.tokens) < MAX_NEW and c.tokens[-1] == 7 for c in tdone.values())


def test_fold_in_and_random_bits_are_bit_equal_to_jax():
    rids = np.array([0, 1, 5, -1, -7, 2**31 - 1], np.int32)
    tix = np.array([3, 0, 100, 9, 1, 17], np.int32)
    seed = 11
    keys = [jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), jax.numpy.int32(r)),
                               jax.numpy.int32(t)) for r, t in zip(rids, tix)]
    assert tuple(np.asarray(jax.random.PRNGKey(seed)).tolist()) == sampling.prng_key(seed)
    k = sampling.fold_in(sampling.prng_key(seed), torch.tensor(rids, dtype=torch.int64))
    k = sampling.fold_in(k, torch.tensor(tix, dtype=torch.int64))
    np.testing.assert_array_equal(np.stack([k[0].numpy(), k[1].numpy()], 1),
                                  np.stack([np.asarray(kk) for kk in keys]).astype(np.int64))
    bits = np.stack([np.asarray(jax.random.bits(kk, (37,), jax.numpy.uint32)) for kk in keys])
    np.testing.assert_array_equal(sampling.random_bits(k, 37).numpy(), bits.astype(np.int64))
    # The Gumbel noise through the two libraries' logs: a few ulps apart.
    g = np.stack([np.asarray(jax.random.gumbel(kk, (37,))) for kk in keys])
    np.testing.assert_allclose(sampling.gumbel(k, 37).numpy(), g, rtol=1e-6, atol=1e-6)


def test_sampled_tokens_equal_jax_engine_sample():
    cfg = JConfig(spec=JSPEC, temperature=0.7, top_k=5, seed=3)
    jsample = jax.jit(jax.vmap(lambda lg, r, t: JEngine._sample(
        types.SimpleNamespace(config=cfg), lg, r, t)))
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((64, JSPEC.vocab)) * 3).astype(np.float32)
    logits[5, :4] = logits[5].max() + 1  # a tie at the top
    rids = rng.integers(-3, 1000, 64).astype(np.int32)
    tix = rng.integers(1, 500, 64).astype(np.int32)
    want = np.asarray(jsample(logits, rids, tix))
    got = sampling.sample(torch.tensor(logits), torch.tensor(rids), torch.tensor(tix),
                          temperature=0.7, top_k=5, seed=3).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = sampling.sample(torch.tensor(logits), None, None, temperature=0.0, top_k=0, seed=0)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))  # first maximum
    assert int(greedy[5]) == 0


def test_top_k_keeps_ties_with_the_kth_logit():
    logits = torch.tensor([[3.0, 2.0, 2.0, 2.0, -1.0, 0.5]])
    for t in range(40):
        tok = int(sampling.sample(logits, torch.tensor([1]), torch.tensor([t]), temperature=1.0,
                                  top_k=2, seed=0))
        assert tok in (0, 1, 2, 3)


def test_prefix_index_and_page_pool_match_jax_op_sequences():
    evicted = {"jax": [], "port": []}
    idx = {"jax": JPrefixIndex(3, on_evict=lambda e: evicted["jax"].append(e.id)),
           "port": PrefixIndex(3, on_evict=lambda e: evicted["port"].append(e.id))}
    pools = {"jax": JPagePool(6), "port": PagePool(6)}
    rng = np.random.default_rng(5)
    for step in range(60):
        op = int(rng.integers(0, 5))
        toks = rng.integers(0, 4, int(rng.integers(2, 6)))
        out = {}
        for side in ("jax", "port"):
            ix, pool = idx[side], pools[side]
            if op == 0:
                got = ix.insert(toks, pages=[int(p) for p in toks])
            elif op == 1:
                got = ix.match(toks)
                if got[0] >= 0:
                    ix.touch(got[0])
                    ix.acquire(got[0])
            elif op == 2:
                live = [e for e in ix._entries.values() if e.refs]
                got = live[0].id if live else None
                if live:
                    ix.release(got)
            elif op == 3:
                got = pool.alloc() if pool.free else None
            else:
                held = np.nonzero(pool.refs)[0]
                got = pool.decref(int(held[0])) if held.size else None
            out[side] = got
        assert out["jax"] == out["port"], (step, op)
    for a, b in ((idx["jax"], idx["port"]),):
        assert (len(a), a.insertions, a.evictions, a.skipped_full) == \
            (len(b), b.insertions, b.evictions, b.skipped_full)
        assert {k: (e.tokens, e.refs, e.last_used, e.pages) for k, e in a._entries.items()} == \
            {k: (e.tokens, e.refs, e.last_used, e.pages) for k, e in b._entries.items()}
    assert evicted["jax"] == evicted["port"]
    np.testing.assert_array_equal(pools["jax"].refs, pools["port"].refs)
    assert (pools["jax"].free, pools["jax"]._free) == (pools["port"].free, pools["port"]._free)


def test_buckets_and_config_checks_match_jax(weights):
    jeng = JEngine(JConfig(spec=JSPEC, slots=2, capacity=96, page_size=16), params=weights)
    teng = InferenceEngine(ServeConfig(spec=TSPEC, slots=2, capacity=96, page_size=16),
                           params=weights, device="cpu")
    for n in (1, 7, 8, 9, 33, 64, 65, 96):
        assert teng.prefill_bucket(n) == jeng.prefill_bucket(n)
    for n in range(1, 8):
        assert teng.decode_page_bucket(n) == jeng.decode_page_bucket(n)
        assert teng.pages_needed(n * 5) == jeng.pages_needed(n * 5)
    for bad in (dict(prefill_chunk=12), dict(prefill_budget=8), dict(prefill_chunk=16,
                prefill_budget=8), dict(page_size=3), dict(page_size=16, capacity=40),
                dict(num_pages=4), dict(page_size=8, num_pages=1), dict(top_k=33),
                dict(slots=0), dict(prefix_slots=-1), dict(kv_dtype="fp8"),
                dict(kv_dtype="int8"), dict(speculate_method="beam")):
        with pytest.raises(ValueError) as want:
            JEngine(JConfig(spec=JSPEC, **bad), params=weights)
        with pytest.raises(ValueError) as got:
            InferenceEngine(ServeConfig(spec=TSPEC, **bad), params=weights, device="cpu")
        assert str(got.value) == str(want.value)


def _run_port(prompts, max_new=MAX_NEW, **cfg_kw):
    eng = InferenceEngine(ServeConfig(spec=TSPEC, **cfg_kw), device="cpu")
    logits = []
    decode = eng.decode

    def rec(last, lengths, rids, active, **kw):
        nxt, lg = decode(last, lengths, rids, active, **kw)
        logits.append(lg[np.asarray(active, bool)])
        return nxt, lg

    eng.decode = rec
    done, stats = Scheduler(eng).run(
        [Request(id=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)])
    return done, logits, stats, eng


def test_paged_equals_contiguous_and_batched_equals_alone():
    prompts = tlm.synthesize_prompts(**PROMPTS)
    a, la, _, _ = _run_port(prompts, slots=3, capacity=64)
    b, lb, _, eng = _run_port(prompts, slots=3, capacity=64, page_size=8)
    assert all(a[i].tokens == b[i].tokens for i in a)
    assert len(la) == len(lb)
    np.testing.assert_allclose(np.concatenate(lb), np.concatenate(la),
                               atol=PAGED_VS_CONTIGUOUS_ATOL)
    assert eng.pages.free == eng.num_pages and eng.pages.reserved == 0
    for i in (0, 3, 5):  # each request alone, in a batch of one
        alone, _, _, _ = _run_port([prompts[i]], slots=1, capacity=64)
        assert alone[0].tokens == a[i].tokens


@pytest.mark.parametrize("page_size", [0, 8])
def test_prefix_cache_and_chunking_do_not_change_tokens(page_size):
    prompts = tlm.synthesize_shared_prefix_prompts(**SHARED)
    off, l_off, _, _ = _run_port(prompts, slots=2, capacity=64, page_size=page_size)
    on, _, stats, _ = _run_port(prompts, slots=2, capacity=64, page_size=page_size,
                                prefix_slots=2)
    assert stats.prefix_hits > 0
    chunked, l_ch, _, _ = _run_port(prompts, slots=2, capacity=64, page_size=page_size,
                                    prefill_chunk=8)
    for i in off:
        assert on[i].tokens == off[i].tokens == chunked[i].tokens
    # Chunks interleave with decode ticks, so the ticks differ: hold each
    # request's first token's prefill logits instead (one engine, by hand).
    eng = InferenceEngine(ServeConfig(spec=TSPEC, slots=2, capacity=64, page_size=page_size),
                          device="cpu")
    p = prompts[1]
    _, whole = eng.prefill(p, slot=0, request_id=1)
    parts = [eng.prefill(p[b:b + 8], slot=1, request_id=1, base=b)[1] for b in range(0, len(p), 8)]
    np.testing.assert_allclose(np.concatenate(parts), whole, atol=CHUNKED_ATOL)


def test_an_aborted_run_returns_the_pool_whole():
    eng = InferenceEngine(ServeConfig(spec=TSPEC, slots=2, capacity=32, page_size=8),
                          device="cpu")
    sched = Scheduler(eng)
    sched.begin()
    for i, p in enumerate(tlm.synthesize_prompts(**dict(PROMPTS, num=3))):
        sched.submit(Request(id=i, prompt=p, max_new_tokens=4))
    sched.tick()
    sched.tick()
    assert eng.pages.free < eng.num_pages and sched.pressure().occupied_slots == 2
    sched.release()
    assert eng.pages.free == eng.num_pages and eng.pages.reserved == 0
    assert not eng.table_len.any() and sched.idle
    # Freed pages are PAD_POS again (the free-list invariant).
    assert bool((eng.cache.pos[: eng.num_pages] == 2**31 - 1).all())


@pytest.mark.parametrize("kw,what", [
    # Tensor parallelism is ported (these two ids are the cases' names from
    # when it still raised): tp 2 serves over a tp group of 2 ranks (held
    # against JAX in tests/test_torch_seq_parallel.py), so without one it
    # raises ValueError; tp 3 raises JAX's divisibility ValueError.
    pytest.param(dict(tensor_parallel=2), "serves over a grid of tp 2",
                 id="kw0-tensor_parallel"),
    pytest.param(dict(tensor_parallel=3), "tensor_parallel needs num_heads",
                 id="kw1-tensor_parallel"),
    (dict(page_size=8, kv_dtype="int8"), "int8"),
    (dict(page_size=8, speculate_k=2, slots=2), "speculate"),
    (dict(speculate_method="prompt"), "speculate_method"),
    # bf16 serving is ported (tests/test_torch_precision.py; the id is the
    # case's name from when it still raised): a dtype the engine does not
    # serve in is a ValueError.
    pytest.param(dict(compute_dtype="float16"), "unsupported compute_dtype", id="kw5-bfloat16"),
])
def test_engine_refuses_what_is_not_ported(kw, what):
    if "tensor_parallel" in kw:
        with pytest.raises(ValueError, match=what) as ours:
            InferenceEngine(ServeConfig(spec=TSPEC, capacity=64, **kw), device="cpu")
        if kw["tensor_parallel"] == 3:
            with pytest.raises(ValueError) as theirs:
                JEngine(JConfig(spec=JSPEC, capacity=64, **kw))
            assert str(ours.value) == str(theirs.value)
        return
    if "compute_dtype" in kw:
        with pytest.raises(ValueError, match=what):
            InferenceEngine(ServeConfig(spec=TSPEC, capacity=64, **kw), device="cpu")
        return
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP"):
        InferenceEngine(ServeConfig(spec=TSPEC, capacity=64, **kw), device="cpu")


def test_scheduler_and_engine_refuse_what_is_not_ported():
    eng = InferenceEngine(ServeConfig(spec=TSPEC, slots=2, capacity=32, page_size=8),
                          device="cpu")
    for kw in (dict(tracer=object()), dict(registry=object()), dict(metrics_writer=object()),
               dict(injector=object()), dict(slo_monitor=object()), dict(peak_flops=1.0),
               dict(anomaly_detector=object()), dict(role="prefill")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Scheduler(eng, **kw)
    sched = Scheduler(eng)
    for call in (lambda: sched.preempt(0), lambda: sched.adopt(None), sched.abandon,
                 lambda: eng.dump_slot_pages(0), lambda: eng.load_slot_pages(0, 0, 0, 0),
                 lambda: eng.alias_slot_pages(1, 0, 4), lambda: eng.load_params("x"),
                 lambda: InferenceEngine.from_checkpoint(eng.config, "x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(ValueError, match="allow_window"):
        Scheduler(eng, allow_window=True)
    with pytest.raises(ValueError, match="shed_threshold"):
        Scheduler(eng, shed_threshold=1)
    with pytest.raises(ValueError, match="deadline_s must be > 0"):
        Scheduler(eng, deadline_s=0.0)
    with pytest.raises(ValueError, match="exceeds the block-table reach"):
        sched.run([Request(id=0, prompt=np.zeros(30, np.int32), max_new_tokens=8)])
    assert eng.pages.free == eng.num_pages


SMOKE = ["serve", "--device", "cpu", "--vocab", "32", "--d-model", "32", "--heads", "2",
         "--layers", "2", "--d-ff", "64", "--slots", "3", "--capacity", "64",
         "--max-new-tokens", "8", "--num-prompts", "6", "--prompt-max", "20", "--json"]


def _cli_json(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_serve_cpu_smoke_paged_and_contiguous():
    paged = _cli_json(SMOKE + ["--page-size", "8"])
    flat = _cli_json(SMOKE)
    assert paged["device"] == "cpu" and len(paged["completions"]) == 6
    assert all(c["status"] == "ok" and len(c["tokens"]) == 8 for c in paged["completions"].values())
    assert paged["completions"] == flat["completions"]
    assert paged["decode_tokens_per_s"] > 0 and paged["decode_steps"] == flat["decode_steps"]
    assert paged["kv_pages_free"] == 24 and set(paged["ttft_ms"]) == {"p50", "p95"}


@pytest.mark.parametrize("flag,value", [
    ("--tensor-parallel", "2"), ("--kv-dtype", "int8"), ("--checkpoint-dir", "ck"),
    ("--replicas", "2"), ("--traffic", "chat"), ("--slo", "chat:ttft=1"),
    ("--autoscale", ""), ("--roles", "prefill:1"), ("--speculate", "4"), ("--bf16", None),
])
def test_cli_refuses_serve_flags_not_ported(flag, value, monkeypatch):
    """Each flag of a slice not ported names its ROADMAP item. Tensor
    parallelism is ported: tp 2 is a world of 2 ranks, which needs
    torchrun. bf16 serving is ported: --bf16 serves in bf16."""
    argv = SMOKE + [flag] + ([value] if value is not None else [])
    if flag == "--bf16":
        out = _cli_json(argv)
        assert out["config"]["compute_dtype"] == "bfloat16" and len(out["completions"]) == 6
        return
    if flag == "--tensor-parallel":
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
            cli.main(argv)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(argv)


@pytest.mark.parametrize("argv,message", [
    (SMOKE + ["--seq-len", "64"], "--seq-len does not apply to the serve variant"),
    (SMOKE + ["--num-ps", "3"], "--num-ps does not apply"),
    (SMOKE + ["--top-k", "3"], "--top-k requires --temperature > 0"),
    (SMOKE + ["--prompt-max", "60"], "exceeds --capacity"),
    (SMOKE + ["--prefill-chunk", "12"], "serve config error: prefill_chunk"),
    (["lm", "--device", "cpu", "--slots", "2"], "--slots does not apply to the lm variant"),
    (["single", "--device", "cpu", "--page-size", "8"], "--page-size does not apply"),
    (SMOKE + ["--tensor-parallel", "3"],
     r"serve config error: tensor_parallel needs num_heads \(2\) divisible by tp \(3\)"),
    (SMOKE + ["--tensor-parallel", "0"], "--tensor-parallel must be >= 1"),
])
def test_cli_flag_hygiene(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)


def test_serve_runs_on_cuda_by_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(ServeConfig(spec=TSPEC))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a for a in SMOKE if a not in ("--device", "cpu")])
