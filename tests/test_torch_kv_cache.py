"""The port's KV-cache ops and cached forwards (ddl_tpu_torch/ops/kv_cache.py,
serve/cache.py, models/transformer.py::apply_lm_cached / apply_lm_paged)
against ``ddl_tpu.ops.kv_cache``, ``ddl_tpu.serve.cache`` and
``ddl_tpu.models.transformer`` on the same numpy inputs.

Tolerances: index ops, writes and copies are exact (the cache after the
op equals JAX's bit for bit, a write JAX drops leaves the port's cache
bit-unchanged); ``attend`` within atol 1e-6; the cached forwards' logits
within atol 1e-5, positions exact, and their caches: layer 0's k/v (a
function of the embedding alone) within atol 1e-6, every layer's within
atol 1e-6 + rtol 1e-5 (later layers carry the earlier layers' fp32
rounding, up to 2.2e-6 absolute at values near 0.2 on this CPU). The port
keeps one drop row per slot (contiguous) or a drop page (paged) that JAX
does not have: comparisons read the valid rows
(``convert.kv_cache_to_numpy``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.models import transformer as jt
from ddl_tpu.ops import kv_cache as jkv
from ddl_tpu.serve import cache as jcache
from ddl_tpu_torch.convert import kv_cache_from_numpy, kv_cache_to_numpy, lm_params_from_numpy
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.ops import kv_cache as tkv
from ddl_tpu_torch.parallel.ring import full_attention
from ddl_tpu_torch.serve import cache as tcache

SPEC_KW = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), tt.LMSpec(**SPEC_KW)
PAD = int(jkv.PAD_POS)
LOGITS_ATOL = 1e-5
CACHE_ATOL = 1e-6
CACHE_RTOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _with_drop(a, axis, fill=0):
    """``a`` with the port's drop row appended along ``axis``."""
    pad = list(a.shape)
    pad[axis] = 1
    return np.concatenate([a, np.full(pad, fill, a.dtype)], axis=axis)


def _weights(seed=0):
    p = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(seed), JSPEC))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)


def test_constants_match_jax():
    assert tkv.PAD_POS == PAD == 2**31 - 1
    assert tkv._MASKED == jkv._MASKED


def test_attend_matches_jax_and_masks_pad_rows():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 8)).astype(np.float32) for _ in range(2))
    q_pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, PAD, PAD]], np.int32)
    k_pos = np.where(np.arange(12) < 9, np.arange(12), PAD).astype(np.int32)[None].repeat(2, 0)
    k_pos[1, 4] = PAD  # a stale row inside the history
    want = np.asarray(jkv.attend(*(jnp.asarray(a) for a in (q, k, v, q_pos, k_pos))))
    got = tkv.attend(*(_t(a) for a in (q, k, v, q_pos, k_pos))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Rows at PAD_POS are invisible whatever their values (JAX's own pin).
    k2 = k.copy()
    k2[:, 9:] = 1e3
    got2 = tkv.attend(*(_t(a) for a in (q, k2, v, q_pos, k_pos))).numpy()
    np.testing.assert_array_equal(got2[0], got[0])
    # Positions 0..T-1 on both sides: the plain causal attention.
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0)
    qq = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tkv.attend(_t(qq), _t(k), _t(v), _t(pos), _t(pos)).numpy(),
        full_attention(_t(qq), _t(k), _t(v), causal=True).numpy(), atol=1e-6)


@pytest.mark.parametrize("rows", [
    [[3, 0, 1], [2, 4, 1]],  # wrapped ring rows, in bounds
    [[5, 5, 0], [3, -1, 5]],  # row C drops; -1 wraps to C - 1 as in JAX
    [[5, 5, 5], [7, 9, 6]],  # every write out of bounds: nothing moves
])
def test_append_rows_matches_jax_and_drops_out_of_bounds(rows):
    c = 5
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((2, c, 2, 3)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 3)).astype(np.float32)
    rows = np.asarray(rows, np.int32)
    want = np.asarray(jkv.append_rows(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(rows)))
    ours = _t(_with_drop(cache, 1))
    before = ours.clone()
    tkv.put_rows(ours, _t(new), tkv.drop_index(_t(rows), c))
    np.testing.assert_array_equal(ours[:, :c].numpy(), want)
    dropped = (rows >= c) | (rows < -c)
    if dropped.all():
        assert torch.equal(ours[:, :c], before[:, :c])


def test_copy_prefix_matches_jax():
    rng = np.random.default_rng(2)
    dst, src = (rng.standard_normal((1, 6, 2)).astype(np.float32) for _ in range(2))
    for n in (0, 3, 6):
        want = np.asarray(jkv.copy_prefix(jnp.asarray(dst), jnp.asarray(src), jnp.int32(n)))
        ours = _t(dst.copy())
        tkv.copy_prefix(ours, _t(src), n)
        np.testing.assert_array_equal(ours.numpy(), want)


def test_table_ops_match_jax():
    ps, num_pages = 4, 6
    table = np.array([[2, 0, -1], [5, -1, -1], [-1, -1, -1]], np.int32)
    logical = np.array([[0, 3, 4, 7, 8, 11, 12, -1], [0, 3, 4, 5, 9, 12, 2, 1],
                        [0, 1, 2, 3, 4, 5, 6, 7]], np.int32)
    want = np.asarray(jkv.table_rows(jnp.asarray(table), jnp.asarray(logical), ps, num_pages))
    got = tkv.table_rows(_t(table), _t(logical), ps, num_pages).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == num_pages * ps).any()  # unmapped / beyond-reach rows drop
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((num_pages, ps, 2, 3)).astype(np.float32)
    pos = rng.integers(0, 50, (num_pages, ps)).astype(np.int32)
    np.testing.assert_array_equal(
        tkv.gather_pages(_t(_with_drop(pool, 0)), _t(table)).numpy(),
        np.asarray(jkv.gather_pages(jnp.asarray(pool), jnp.asarray(table))))
    np.testing.assert_array_equal(
        tkv.table_positions(_t(_with_drop(pos, 0, PAD)), _t(table)).numpy(),
        np.asarray(jkv.table_positions(jnp.asarray(pos), jnp.asarray(table))))


@pytest.mark.parametrize("all_dropped", [False, True])
def test_write_rows_flat_matches_jax_and_drops(all_dropped):
    ps, num_pages = 4, 5
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((num_pages, ps, 2, 3)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 3)).astype(np.float32)
    flat = np.array([[1, 7, 20], [20, 13, 25]], np.int32)  # 20 = num_pages * ps drops
    if all_dropped:
        flat[:] = num_pages * ps
    want = np.asarray(jkv.write_rows_flat(jnp.asarray(pool), jnp.asarray(new), jnp.asarray(flat)))
    ours = _t(_with_drop(pool, 0))
    before = ours.clone()
    tkv.put_flat(ours, _t(new), tkv.flat_drop_index(ours, _t(flat)))
    np.testing.assert_array_equal(ours[:num_pages].numpy(), want)
    if all_dropped:
        assert torch.equal(ours[:num_pages], before[:num_pages])


def _np_cache(rng, slots, c):
    shape = (JSPEC.num_layers, slots, c, JSPEC.num_heads, JSPEC.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.where(rng.random((slots, c)) < 0.7, rng.integers(0, 90, (slots, c)), PAD)
    return jcache.KVCache(k=k, v=v, pos=pos.astype(np.int32))


def test_copy_slot_prefix_matches_jax_and_snapshots():
    rng = np.random.default_rng(5)
    cache, pool = _np_cache(rng, 3, 8), _np_cache(rng, 2, 8)
    jfn = jax.jit(lambda d, s, n: jcache.copy_slot_prefix(d, s, src_slot=jnp.int32(2),
                                                          dst_slot=jnp.int32(1), n=n))
    want = jax.tree.map(np.asarray, jfn(pool, cache, jnp.int32(5)))
    tc = kv_cache_from_numpy(cache, paged=False, device="cpu")
    tp = kv_cache_from_numpy(pool, paged=False, device="cpu")
    tcache.copy_slot_prefix(tp, tc, src_slot=2, dst_slot=1, n=5)
    got = kv_cache_to_numpy(tp)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name], getattr(want, name))
    # A real copy: writing the source afterwards leaves the pool as it was.
    tc.k.zero_()
    np.testing.assert_array_equal(kv_cache_to_numpy(tp)["k"], want.k)


def test_copy_page_matches_jax():
    rng = np.random.default_rng(6)
    shape = (JSPEC.num_layers, 5, 4, JSPEC.num_heads, JSPEC.head_dim)
    pool = jcache.PagedKVCache(
        k=rng.standard_normal(shape).astype(np.float32),
        v=rng.standard_normal(shape).astype(np.float32),
        pos=rng.integers(0, 40, (5, 4)).astype(np.int32))
    want = jax.tree.map(np.asarray, jcache.copy_page(
        jax.tree.map(jnp.asarray, pool), src_page=jnp.int32(3), dst_page=jnp.int32(1),
        n=jnp.int32(3)))
    ours = kv_cache_from_numpy(pool, paged=True, device="cpu")
    tcache.copy_page(ours, src_page=3, dst_page=1, n=3)
    got = kv_cache_to_numpy(ours)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name], getattr(want, name))


def test_fresh_caches_and_row_bytes_match_jax():
    for ours, theirs in (
        (tcache.host_cache(TSPEC, 3, 16), jcache.host_cache(JSPEC, 3, 16)),
        (tcache.host_paged_cache(TSPEC, 6, 8), jcache.host_paged_cache(JSPEC, 6, 8)),
    ):
        got = kv_cache_to_numpy(ours)
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(got[name], getattr(theirs, name))
    assert tcache.kv_row_bytes(TSPEC, None) == jcache.kv_row_bytes(JSPEC, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcache.kv_row_bytes(TSPEC, "int8")


def _cmp_cache(ours, want):
    got = kv_cache_to_numpy(ours)
    for name, w in zip(("k", "v"), want[:2]):
        np.testing.assert_allclose(got[name][0], np.asarray(w)[0], atol=CACHE_ATOL)
        np.testing.assert_allclose(got[name], np.asarray(w), atol=CACHE_ATOL, rtol=CACHE_RTOL)
    np.testing.assert_array_equal(got["pos"], np.asarray(want[2]))


def test_apply_lm_cached_matches_jax():
    """A padded prefill with JAX's offset overrides (tail positions
    PAD_POS, tail rows C: dropped), then two decode steps with one slot
    inactive (PAD_POS row at its cursor): logits, caches and positions."""
    w = _weights(1)
    tp = lm_params_from_numpy(w, TSPEC, "cpu")
    rng = np.random.default_rng(7)
    b, c, bucket, real = 2, 16, 8, np.array([6, 3])
    cache = _np_cache(rng, b, c)
    cache = jcache.KVCache(k=cache.k, v=cache.v, pos=np.full((b, c), PAD, np.int32))
    jfwd = jax.jit(functools.partial(jt.apply_lm_cached, spec=JSPEC))
    ours = kv_cache_from_numpy(cache, paged=False, device="cpu")
    state = (cache.k, cache.v, cache.pos)
    tok = rng.integers(1, JSPEC.vocab, (b, bucket)).astype(np.int32)
    t = np.arange(bucket)[None]
    base = np.array([[2], [0]])
    positions = np.where(t < real[:, None], base + t, PAD).astype(np.int32)
    rows = np.where(t < real[:, None], (base + t) % c, c).astype(np.int32)
    want = jfwd(w, tok, *state, start=jnp.zeros(b, jnp.int32), positions=positions, rows=rows)
    got = tt.apply_lm_cached(tp, _t(tok), ours.k, ours.v, ours.pos, TSPEC, start=None,
                             positions=_t(positions), rows=_t(rows))
    valid = t[0] < real[:, None]
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid],
                               atol=LOGITS_ATOL)
    _cmp_cache(ours, want[1:])
    state = want[1:]
    lengths = base[:, 0] + real
    for _ in range(2):
        active = np.array([True, False])
        last = rng.integers(1, JSPEC.vocab, (b, 1)).astype(np.int32)
        pos_d = np.where(active, lengths, PAD).astype(np.int32)[:, None]
        want = jfwd(w, last, *state, start=jnp.asarray(lengths, jnp.int32), positions=pos_d)
        got = tt.apply_lm_cached(tp, _t(last), ours.k, ours.v, ours.pos, TSPEC,
                                 start=_t(lengths.astype(np.int32)), positions=_t(pos_d))
        np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0])[0], atol=LOGITS_ATOL)
        _cmp_cache(ours, want[1:])
        state = want[1:]
        lengths = lengths + active


def test_apply_lm_paged_matches_jax():
    """A prefill through a block table (padded tail beyond the table's
    reach: dropped), then a decode step with an inactive slot (its write
    dropped) over a page-count bucket narrower than the table."""
    w = _weights(2)
    tp = lm_params_from_numpy(w, TSPEC, "cpu")
    rng = np.random.default_rng(8)
    ps, num_pages, max_pages = 4, 7, 4
    pool = jcache.host_paged_cache(JSPEC, num_pages, ps)
    ours = kv_cache_from_numpy(pool, paged=True, device="cpu")
    state = (pool.k, pool.v, pool.pos)
    jfwd = jax.jit(functools.partial(jt.apply_lm_paged, spec=JSPEC))
    tables = np.array([[3, 1, -1, -1], [0, 5, 2, -1]], np.int32)
    for slot, real, bucket in ((0, 7, 8), (1, 9, 16)):
        table = tables[slot:slot + 1]
        t = np.arange(bucket)[None]
        tok = rng.integers(1, JSPEC.vocab, (1, bucket)).astype(np.int32)
        positions = np.where(t < real, t, PAD).astype(np.int32)
        logical = np.where(t < real, t, max_pages * ps).astype(np.int32)
        flat = np.asarray(jkv.table_rows(jnp.asarray(table), jnp.asarray(logical), ps, num_pages))
        np.testing.assert_array_equal(
            tkv.table_rows(_t(table), _t(logical), ps, num_pages).numpy(), flat)
        want = jfwd(w, tok, *state, table, positions=positions, flat_rows=flat)
        got = tt.apply_lm_paged(tp, _t(tok), ours.k, ours.v, ours.pos, _t(table), TSPEC,
                                positions=_t(positions), flat_rows=_t(flat))
        np.testing.assert_allclose(got[0][0, :real].numpy(), np.asarray(want[0])[0, :real],
                                   atol=LOGITS_ATOL)
        _cmp_cache(ours, want[1:])
        state = want[1:]
    lengths, active, pb = np.array([7, 9]), np.array([False, True]), 4
    last = rng.integers(1, JSPEC.vocab, (2, 1)).astype(np.int32)
    positions = np.where(active, lengths, PAD).astype(np.int32)[:, None]
    logical = np.where(active, lengths, pb * ps).astype(np.int32)[:, None]
    flat = np.asarray(jkv.table_rows(jnp.asarray(tables), jnp.asarray(logical), ps, num_pages))
    want = jfwd(w, last, *state, tables, positions=positions, flat_rows=flat)
    got = tt.apply_lm_paged(tp, _t(last), ours.k, ours.v, ours.pos, _t(tables), TSPEC,
                            positions=_t(positions), flat_rows=_t(flat))
    np.testing.assert_allclose(got[0][1].numpy(), np.asarray(want[0])[1], atol=LOGITS_ATOL)
    _cmp_cache(ours, want[1:])


def test_cached_decode_reproduces_the_full_forward():
    """Prefill then one-token decode steps give the port's own full-forward
    ``apply_lm`` logits at every position (the serving pin)."""
    w = _weights(3)
    tp = lm_params_from_numpy(w, TSPEC, "cpu")
    rng = np.random.default_rng(9)
    tok = rng.integers(0, TSPEC.vocab, (2, 14)).astype(np.int32)
    full = tt.apply_lm(tp, _t(tok), TSPEC,
                       attn_fn=functools.partial(full_attention, causal=True)).numpy()
    cache = tcache.host_cache(TSPEC, 2, 16)
    n = 9
    start = torch.zeros(2, dtype=torch.int32)
    outs = [tt.apply_lm_cached(tp, _t(tok[:, :n]), cache.k, cache.v, cache.pos, TSPEC,
                               start=start)[0]]
    for i in range(n, 14):
        outs.append(tt.apply_lm_cached(tp, _t(tok[:, i:i + 1]), cache.k, cache.v, cache.pos,
                                       TSPEC, start=torch.full((2,), i, dtype=torch.int32))[0])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full, atol=LOGITS_ATOL)
