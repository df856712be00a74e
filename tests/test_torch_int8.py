"""The port's int8 KV pool (``ops/kv_cache.py::quantize_rows`` /
``dequantize_rows``, the scale planes of ``serve/cache.py``,
``apply_lm_paged``'s ``pool_k_scale``, ``ServeConfig.kv_dtype``, the
``(payload, scale)`` hand-off) and ``data/lm.py::synthesize_longtail_prompts``
against ``ddl_tpu`` on the CPU, at a tiny width (vocab 32, d_model 32, 2
heads, 2 layers, d_ff 64) and the same weights (JAX's init carried over as
numpy). JAX's scheduler run is computed once, in the module fixture
``jax_int8``.

Pinned against JAX:

- ``quantize_rows`` bitwise (payload and scale) on seeded rows, all-zero
  rows, exact ``.5`` ties (round half to even), bf16 input and extreme
  magnitudes; ``dequantize_rows`` bitwise in fp32 and bf16;
- ``kv_row_bytes`` (TINY and the card's serving width: 4,352 bytes a row
  against fp32's 16,384) and its error text; the fresh int8 pool; the
  config checks both ways and the hand-off refusals both ways, with JAX's
  texts;
- ``apply_lm_paged`` on an int8 pool: every layer's payloads within one
  int8 step of JAX's and scales within rtol 1e-6, since the fp32 rows they
  quantize differ from JAX's in the last bits (layer 0 by a few ulps, layer
  1 by up to 2.2e-6, ROADMAP queue 3), so a value at a rounding boundary
  may land one step apart (measured here: none does; scales 3.6e-7 apart);
  logits within ``INT8_LOGITS_ATOL``;
- ``copy_page`` with scales bitwise;
- int8 greedy tokens equal fp32's and JAX's int8 tokens (JAX's
  tests/test_precision.py case);
- ``synthesize_longtail_prompts`` element for element, and its error texts.

Port-only pins: layer 0's stored payloads and scales are
``quantize_rows`` of the fp32 pool's rows from the same calls, bitwise;
preempt -> adopt between two int8 engines moves the pairs bit for bit,
``handoff_bytes_total`` equals pages x page x ``kv_row_bytes(spec,
"int8")`` (and JAX's ``handoff_bytes``), and the adopted request finishes
with the unpreempted tokens; an int8 disaggregated fleet equals the int8
colocated fleet; a prefix hit's copy-on-write boundary page carries its
scales.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu import serve as js
from ddl_tpu.data import lm as jlm
from ddl_tpu.models import transformer as jt
from ddl_tpu.ops import kv_cache as jkv
from ddl_tpu.serve import cache as jcache
from ddl_tpu_torch import serve as ts
from ddl_tpu_torch.convert import kv_cache_from_numpy, kv_cache_to_numpy, lm_params_from_numpy
from ddl_tpu_torch.data import lm as tlm
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.obs import MetricRegistry
from ddl_tpu_torch.ops import kv_cache as tkv
from ddl_tpu_torch.serve import cache as tcache

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), tt.LMSpec(**SPEC_KW)
PAD = int(jkv.PAD_POS)
MARGIN = 1e-5
# The cached forwards' logits tolerance (tests/test_torch_kv_cache.py): with
# no stored value one int8 step apart, the int8 logits are JAX's within the
# fp32 rounding (measured 2.5e-6 here).
INT8_LOGITS_ATOL = 1e-5
CFG = dict(slots=2, capacity=32, page_size=8, num_pages=16)
PROMPT = (np.arange(1, 11) * 3) % 32  # JAX's tests/test_precision.py prompt
NEW = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), JSPEC))


@pytest.fixture(scope="module")
def jax_int8(weights):
    """JAX's int8 engine serving PROMPT greedily: its tokens."""
    eng = js.InferenceEngine(js.ServeConfig(spec=JSPEC, kv_dtype="int8", **CFG), params=weights)
    done, _ = js.Scheduler(eng).run([js.Request(id=1, prompt=PROMPT, max_new_tokens=NEW)])
    return done[1].tokens


def _engine(weights, **kw):
    return ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, **{**CFG, **kw}), params=weights,
                              device="cpu")


# -- the quantizer -----------------------------------------------------------


def _rows(case):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 3, 4, 16)) * 3.0).astype(np.float32)
    if case == "seeded":
        x[0, 0] = 0.0  # an all-zero head row
    elif case == "ties":
        # amax 127 makes the scale exactly 1.0: every x.5 is a tie, rounded
        # half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0, ...).
        ties = np.arange(-8, 8, dtype=np.float32) + 0.5
        x = np.broadcast_to(ties, x.shape).copy()
        x[..., 0] = 127.0
        x[1, 1, 1, 1:] = -126.5
    elif case == "extreme":
        x[0] *= 1e-30
        x[1] *= 1e30
        x[1, 2, 3] = -np.abs(x[1, 2, 3])  # amax from a negative value
    return x


@pytest.mark.parametrize("case", ["seeded", "ties", "extreme", "bf16"])
def test_quantize_and_dequantize_rows_match_jax(case):
    x = _rows(case)
    if case == "bf16":
        ours_in, theirs_in = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    else:
        ours_in, theirs_in = torch.from_numpy(x), jnp.asarray(x)
    q, scale = tkv.quantize_rows(ours_in)
    jq, jscale = jkv.quantize_rows(theirs_in)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert int(q.abs().max()) <= 127
    if case == "ties":
        assert q[0, 0, 0, :9].tolist() == [127, -6, -6, -4, -4, -2, -2, 0, 0]
        assert q[1, 1, 1, 1:4].tolist() == [-126] * 3
    if case == "seeded":
        assert scale[0, 0].eq(1.0).all() and q[0, 0].eq(0).all()
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = tkv.dequantize_rows(q, scale, dtype)
        jback = jkv.dequantize_rows(jq, jscale, jdtype)
        assert back.dtype == dtype
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback.astype(jnp.float32)))
    if case != "extreme":
        # Within half a step of the input, elementwise.
        err = (tkv.dequantize_rows(q, scale, torch.float32) - ours_in.float()).abs()
        assert (err <= scale[..., None] / 2 + 1e-6).all()


def test_kv_row_bytes_and_fresh_pool_match_jax():
    lm_kw = dict(vocab=256, d_model=512, num_heads=8, num_layers=4, d_ff=2048)  # lm_spec()
    for kw in (SPEC_KW, lm_kw):
        ours, theirs = tt.LMSpec(**kw), jt.LMSpec(**kw)
        for kv in (None, "int8"):
            assert tcache.kv_row_bytes(ours, kv) == jcache.kv_row_bytes(theirs, kv)
        assert tcache.kv_row_bytes(ours, None, torch.bfloat16) == \
            jcache.kv_row_bytes(theirs, None, jnp.bfloat16)
    big = tt.LMSpec(**lm_kw)
    assert (tcache.kv_row_bytes(big, "int8"), tcache.kv_row_bytes(big, None)) == (4352, 16384)
    for call in (lambda m, s: m.kv_row_bytes(s, "fp8"),
                 lambda m, s: m.host_paged_cache(s, 4, 8, kv_dtype="fp8")):
        with pytest.raises(ValueError) as ours:
            call(tcache, TSPEC)
        with pytest.raises(ValueError) as theirs:
            call(jcache, JSPEC)
        assert str(ours.value) == str(theirs.value)
    pool = tcache.host_paged_cache(TSPEC, 6, 8, kv_dtype="int8")
    want = jcache.host_paged_cache(JSPEC, 6, 8, kv_dtype="int8")
    got = kv_cache_to_numpy(pool)
    assert set(got) == {"k", "v", "pos", "k_scale", "v_scale"}
    for name, a in got.items():
        w = getattr(want, name)
        assert a.dtype == w.dtype, name
        np.testing.assert_array_equal(a, w)
    assert pool.k_scale[:, 6].eq(1.0).all()  # the drop page's scales too


@pytest.mark.parametrize("kw", [
    dict(page_size=8, kv_dtype="fp8"), dict(kv_dtype="int8"),
], ids=["unknown", "contiguous"])
def test_kv_dtype_config_checks_match_jax(kw, weights):
    with pytest.raises(ValueError) as theirs:
        js.InferenceEngine(js.ServeConfig(spec=JSPEC, slots=2, capacity=32, **kw),
                           params=weights)
    with pytest.raises(ValueError) as ours:
        ts.InferenceEngine(ts.ServeConfig(spec=TSPEC, slots=2, capacity=32, **kw),
                           params=weights, device="cpu")
    assert str(ours.value) == str(theirs.value)
    eng = _engine(weights, kv_dtype="int8")
    assert eng.quantized and eng.cache.k.dtype == torch.int8
    assert eng.cache.k_scale.dtype == torch.float32 and eng.cache.k_scale.eq(1.0).all()
    assert eng.handoff_bytes(3) == 3 * 8 * tcache.kv_row_bytes(TSPEC, "int8")


# -- the int8 paged forward and the page copy --------------------------------


def test_apply_lm_paged_int8_matches_jax():
    """A prefill through a block table (padded tail dropped), then a
    decode step with an inactive slot, on an int8 pool beside an fp32 pool:
    the stored rows (the rule above) and the logits."""
    rng = np.random.default_rng(8)
    p = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(2), JSPEC))
    w = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)
    tp = lm_params_from_numpy(w, TSPEC, "cpu")
    ps, num_pages, max_pages = 4, 7, 4
    pool = jcache.host_paged_cache(JSPEC, num_pages, ps, kv_dtype="int8")
    ours = tcache.host_paged_cache(TSPEC, num_pages, ps, kv_dtype="int8")
    state = (jnp.asarray(pool.k), jnp.asarray(pool.v), jnp.asarray(pool.pos))
    scales = dict(pool_k_scale=jnp.asarray(pool.k_scale), pool_v_scale=jnp.asarray(pool.v_scale))
    jfwd = jax.jit(functools.partial(jt.apply_lm_paged, spec=JSPEC))
    tables = np.array([[3, 1, -1, -1], [0, 5, 2, -1]], np.int32)
    calls = []
    for slot, real, bucket in ((0, 7, 8), (1, 9, 16)):
        t = np.arange(bucket)[None]
        calls.append((tables[slot:slot + 1],
                      rng.integers(1, 32, (1, bucket)).astype(np.int32),
                      np.where(t < real, t, PAD).astype(np.int32),
                      np.where(t < real, t, max_pages * ps).astype(np.int32), (0, slice(0, real))))
    lengths, active, pb = np.array([7, 9]), np.array([False, True]), 4
    calls.append((tables, rng.integers(1, 32, (2, 1)).astype(np.int32),
                  np.where(active, lengths, PAD).astype(np.int32)[:, None],
                  np.where(active, lengths, pb * ps).astype(np.int32)[:, None], (1, 0)))
    fp32 = tcache.host_paged_cache(TSPEC, num_pages, ps)
    one_step = 0
    for table, tok, positions, logical, valid in calls:
        flat = np.array(jkv.table_rows(jnp.asarray(table), jnp.asarray(logical), ps, num_pages))
        want = jfwd(w, tok, *state, table, positions=positions, flat_rows=flat, **scales)
        args = (torch.from_numpy(tok),)
        kw = dict(positions=torch.from_numpy(positions), flat_rows=torch.from_numpy(flat))
        got = tt.apply_lm_paged(tp, *args, ours.k, ours.v, ours.pos, torch.from_numpy(table),
                                TSPEC, pool_k_scale=ours.k_scale, pool_v_scale=ours.v_scale, **kw)
        tt.apply_lm_paged(tp, *args, fp32.k, fp32.v, fp32.pos, torch.from_numpy(table), TSPEC,
                          **kw)
        assert len(got) == 6 and got[4] is ours.k_scale
        np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid],
                                   atol=INT8_LOGITS_ATOL)
        mine = kv_cache_to_numpy(ours)
        np.testing.assert_array_equal(mine["pos"], np.asarray(want[3]))
        for name, payload, scale in (("k", want[1], want[4]), ("v", want[2], want[5])):
            # Layer 0: the stored rows are quantize_rows of the fp32 pool's
            # rows, bitwise (unwritten rows: payload 0, scale 1.0).
            q, sc = tkv.quantize_rows(getattr(fp32, name)[0, :num_pages])
            np.testing.assert_array_equal(mine[name][0], q.numpy())
            np.testing.assert_array_equal(mine[f"{name}_scale"][0], sc.numpy())
            step = np.abs(mine[name].astype(np.int32) - np.asarray(payload))
            assert step.max() <= 1, name
            one_step += int(step.sum())
            np.testing.assert_allclose(mine[f"{name}_scale"], np.asarray(scale), rtol=1e-6,
                                       atol=0)
        state = (want[1], want[2], want[3])
        scales = dict(pool_k_scale=want[4], pool_v_scale=want[5])
    assert one_step == 0  # measured here: no stored value one step apart
    with pytest.raises(ValueError) as ours_err:
        tt.apply_lm_paged(tp, torch.from_numpy(tok), ours.k, ours.v, ours.pos,
                          torch.from_numpy(table), TSPEC, positions=torch.from_numpy(positions),
                          flat_rows=torch.from_numpy(flat), pool_k_scale=ours.k_scale)
    with pytest.raises(ValueError) as theirs_err:
        jt.apply_lm_paged(w, tok, *state, table, JSPEC, positions=positions, flat_rows=flat,
                          pool_k_scale=scales["pool_k_scale"])
    assert str(ours_err.value) == str(theirs_err.value)


def test_copy_page_and_prefix_boundary_copy_carry_scales(weights):
    """``copy_page`` on an int8 pool equals JAX's bitwise (scales
    included); a prefix hit that is not page-aligned copies its boundary
    page's payloads AND scales into the new slot's page."""
    rng = np.random.default_rng(6)
    shape = (JSPEC.num_layers, 5, 4, JSPEC.num_heads, JSPEC.head_dim)
    pool = jcache.PagedKVCache(
        k=rng.integers(-127, 128, shape).astype(np.int8),
        v=rng.integers(-127, 128, shape).astype(np.int8),
        pos=rng.integers(0, 40, (5, 4)).astype(np.int32),
        k_scale=rng.random(shape[:4]).astype(np.float32),
        v_scale=rng.random(shape[:4]).astype(np.float32))
    want = jcache.copy_page(jax.tree.map(jnp.asarray, pool), src_page=jnp.int32(3),
                            dst_page=jnp.int32(1), n=jnp.int32(3))
    ours = kv_cache_from_numpy(pool, paged=True, device="cpu")
    ours = tcache.PagedKVCache(
        k=ours.k.to(torch.int8), v=ours.v.to(torch.int8), pos=ours.pos,
        k_scale=torch.from_numpy(np.concatenate([pool.k_scale, np.ones_like(pool.k_scale[:, :1])],
                                                axis=1)),
        v_scale=torch.from_numpy(np.concatenate([pool.v_scale, np.ones_like(pool.v_scale[:, :1])],
                                                axis=1)))
    tcache.copy_page(ours, src_page=3, dst_page=1, n=3)
    for name, a in kv_cache_to_numpy(ours).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)), err_msg=name)
    eng = _engine(weights, kv_dtype="int8", prefix_slots=2)
    prompt = np.arange(1, 14, dtype=np.int32)
    eng.reserve_pages(0, 2)
    eng.prefill(prompt, slot=0, request_id=0)
    assert eng.prefix_store(prompt, 0)
    entry, full = eng.prefix.match(prompt[:8])
    assert full == 8
    eng.reserve_pages(1, 1)
    assert eng.prefix_fetch(entry, 7, 1) == 7 and eng.page_copies == 1
    src, dst = int(eng.tables[0, 0]), int(eng.tables[1, 0])
    assert src != dst
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(eng.cache, name)
        assert torch.equal(t[:, dst, :7], t[:, src, :7]), name
    assert eng.cache.pos[dst, 7] == PAD


# -- serving on the int8 pool -------------------------------------------------


def test_int8_greedy_matches_fp32_and_jax(weights, jax_int8):
    def run(**kw):
        eng = _engine(weights, **kw)
        margins = []
        decode = eng.decode

        def rec(*a, **k):
            nxt, logits = decode(*a, **k)
            act = np.asarray(a[3], bool)
            margins.extend(np.diff(np.sort(logits[act], axis=-1)[:, -2:], axis=-1)[:, 0])
            return nxt, logits

        eng.decode = rec
        done, _ = ts.Scheduler(eng).run([ts.Request(id=1, prompt=PROMPT, max_new_tokens=NEW)])
        assert eng.pages.free == eng.num_pages
        return done[1].tokens, margins

    int8, margins = run(kv_dtype="int8")
    fp32, _ = run()
    assert int8 == fp32 == jax_int8 and len(int8) == NEW
    assert min(margins) > MARGIN


def _preempt_adopt(weights, registry):
    mk = lambda reg=None: ts.Scheduler(_engine(weights, kv_dtype="int8"),  # noqa: E731
                                       registry=reg)
    req = lambda: ts.Request(id=11, prompt=PROMPT, max_new_tokens=NEW)  # noqa: E731
    src, oracle, dst = mk(registry), mk(), mk()
    for s in (src, oracle, dst):
        s.begin()
    src.submit(req())
    oracle.submit(req())
    for _ in range(4):
        src.tick()
        oracle.tick()
    pre = src.preempt(11)
    slot = dst.adopt(pre)
    dumped = dst.engine.dump_slot_pages(slot)
    while not oracle.idle:
        oracle.tick()
    while not dst.idle:
        dst.tick()
    want, _ = oracle.collect()
    got, _ = dst.collect()
    src.collect()
    return pre, dumped, got[11].tokens, want[11].tokens, (src, dst, oracle)


def test_int8_preempt_adopt_round_trips_bitwise(weights, jax_int8):
    """The pairs travel end to end: the adopter's pages are the dumped
    bytes, the byte count is the int8 row's, and the continuation equals
    the unpreempted run's (and JAX's int8 tokens)."""
    reg = MetricRegistry()
    pre, dumped, got, want, scheds = _preempt_adopt(weights, reg)
    assert isinstance(pre.k, tuple) and isinstance(pre.v, tuple)
    assert pre.k[0].dtype == np.int8 and pre.k[1].dtype == np.float32
    assert pre.k[1].shape == pre.k[0].shape[:-1]
    (k2, ks2), (v2, vs2), pos2 = dumped
    for a, b in ((k2, pre.k[0]), (ks2, pre.k[1]), (v2, pre.v[0]), (vs2, pre.v[1]),
                 (pos2, pre.pos)):
        np.testing.assert_array_equal(a, b)
    pages = int(pre.pos.shape[0])
    assert pages == 2
    jeng = js.InferenceEngine(js.ServeConfig(spec=JSPEC, kv_dtype="int8", **CFG), params=weights)
    assert reg.counter("handoff_bytes_total").value(path="preempt") == \
        pages * 8 * tcache.kv_row_bytes(TSPEC, "int8") == jeng.handoff_bytes(pages)
    assert got == want == jax_int8
    for s in scheds:
        assert s.engine.pages.free == s.engine.num_pages and s.engine.pages.reserved == 0


def test_int8_handoff_refused_both_ways_as_jax(weights):
    """An int8 dump refuses a full-precision pool and a full-precision
    dump an int8 pool, with JAX's texts, before any page is mapped."""
    k = np.zeros((2, 1, 8, 2, 16), np.float32)
    pos = np.zeros((1, 8), np.int32)
    jfp = js.InferenceEngine(js.ServeConfig(spec=JSPEC, **CFG), params=weights)
    jq = js.InferenceEngine(js.ServeConfig(spec=JSPEC, kv_dtype="int8", **CFG), params=weights)
    fp, q = _engine(weights), _engine(weights, kv_dtype="int8")
    for ours_eng, theirs_eng, args in ((fp, jfp, ((k, k[..., 0]), (k, k[..., 0]), pos)),
                                       (q, jq, (k, k, pos))):
        with pytest.raises(ValueError) as ours:
            ours_eng.load_slot_pages(0, *args)
        with pytest.raises(ValueError) as theirs:
            theirs_eng.load_slot_pages(0, *args)
        assert str(ours.value) == str(theirs.value)
        assert ours_eng.pages.free == ours_eng.num_pages


def test_int8_disagg_equals_int8_colocated(weights):
    """JAX's int8 disaggregation case: a 1-prefill + 1-decode int8 fleet
    gives the int8 colocated fleet's tokens, every multi-token request
    crossing once, both int8 pools whole after."""
    traffic = tlm.synthesize_mixed_traffic(
        classes={"chat": dict(rate=0.6, prompt_min=6, prompt_max=10, max_new_tokens=4)},
        horizon=8, vocab=32, seed=1, max_requests=6)
    cfg = ts.ServeConfig(spec=TSPEC, slots=2, capacity=32, page_size=8, num_pages=12,
                         kv_dtype="int8")
    rc = ts.RouterConfig(serve=cfg, replicas=2, classes=(ts.ClassSpec("chat"),))
    done_c, _ = ts.Router(rc, params=weights, device="cpu").run(traffic)
    r_dis = ts.Router(dataclasses.replace(rc, roles=("prefill", "decode")), params=weights,
                      device="cpu")
    done_d, stats_d = r_dis.run(traffic)
    assert {i: c.tokens for i, c in done_d.items()} == {i: c.tokens for i, c in done_c.items()}
    multi = sum(1 for c in done_c.values() if len(c.tokens) > 1)
    assert stats_d.disagg["handoffs"] == multi > 0 and stats_d.disagg["handoff_pages"] > 0
    for eng in r_dis.engines:
        assert eng.quantized and eng.pages.free == eng.num_pages and eng.pages.reserved == 0


# -- the long-tail prompt mix -------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, dict(num_short=10, num_long=2, short_min=8, short_max=24, long_len=320, vocab=256,
             seed=4),
    dict(num_long=0, seed=2), dict(num_short=3, num_long=3, long_prefix_len=1, seed=5),
], ids=["defaults", "serve_bench", "shorts-only", "independent-longs"])
def test_synthesize_longtail_prompts_matches_jax(kw):
    ours, theirs = tlm.synthesize_longtail_prompts(**kw), jlm.synthesize_longtail_prompts(**kw)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for bad in (dict(num_short=0, num_long=0), dict(short_min=5, short_max=4),
                dict(long_len=12), dict(long_prefix_len=200), dict(vocab=1)):
        with pytest.raises(ValueError) as o:
            tlm.synthesize_longtail_prompts(**bad)
        with pytest.raises(ValueError) as t:
            jlm.synthesize_longtail_prompts(**bad)
        assert str(o.value) == str(t.value)
