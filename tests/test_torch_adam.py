"""TF1 Adam in the port (ddl_tpu_torch/ops) against the JAX package.

- ``adam_update``: three steps against ``ddl_tpu.ops.adam_update``.
- ``adam_flat_reference`` and ``adam_flat_fused`` on the CPU (which runs
  the plain version) against the Pallas kernel
  ``ddl_tpu.ops.pallas_adam.adam_flat_fused(..., interpret=True)`` at the
  sizes of tests/test_pallas_adam.py, atol 2e-7 (both sides apply the same
  IEEE float32 operations; values are O(1)).
- The kernel's launch plan (``launch_plan``), on the CPU: the kernel's own
  index formula, emulated in numpy from the plan, covers every element of
  ``[0, n)`` exactly once on the float4 and the scalar path; the grid never
  exceeds one resident wave; the blocks' work differs by at most one tile.
- The CUDA kernel against its plain version: marked ``cuda``, skipped
  without a card (bit-equal at the plan's boundary sizes and on a repeat).
  It imports nothing of JAX, so on the card it runs with
  ``python -m pytest --noconftest -m cuda tests/test_torch_adam.py``.
"""

import types

import numpy as np
import pytest
import torch

from ddl_tpu_torch.ops import fused_adam
from ddl_tpu_torch.ops.optimizers import adam_init, adam_update
from ddl_tpu_torch.strategies.sync import resolve_layout
from ddl_tpu_torch.train.config import TrainConfig

ATOL = 2e-7
SIZES = [5, 1024, 512 * 128, 512 * 128 + 17]
FULL_N = 2_656_128  # the CNN's ZeRO-1 flat vector, one worker
# The flat shard of one rank of 4 workers, from the layout code.
SHARD4 = resolve_layout(TrainConfig(batch_size=100, num_workers=4, num_ps=4, layout="flat"),
                        4).max_shard
PLAN_SIZES = list(range(10)) + [127, 128, 129, 65_553, FULL_N, SHARD4]
# (SMs, resident blocks an SM): an H100 SXM at 6 and 3 blocks, a PCIe part,
# one SM.
CARDS = [(132, 6), (132, 3), (114, 8), (1, 1)]
THREADS = fused_adam.THREADS


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only test below needs
    no JAX."""
    import jax
    import jax.numpy as jnp

    from ddl_tpu.ops import adam_init as j_init, adam_update as j_update
    from ddl_tpu.ops.pallas_adam import adam_flat_fused as j_fused

    return types.SimpleNamespace(jax=jax, jnp=jnp, init=j_init, update=j_update, fused=j_fused)


def _flat_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(n)).astype(np.float32)
    return p, m, v, g


def test_adam_update_three_steps_match_jax(jx):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jp = {k: jx.jnp.asarray(v) for k, v in params.items()}
    jst = jx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = adam_init(tp)
    for g in grads:
        jp, jst = jx.update(jp, jst, {k: jx.jnp.asarray(v) for k, v in g.items()}, lr=1e-3)
        tp, tst = adam_update(tp, tst, {k: torch.from_numpy(v) for k, v in g.items()}, lr=1e-3)
    assert int(tst.step) == int(jst.step) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=ATOL, err_msg=k)
        np.testing.assert_allclose(tst.m[k].numpy(), np.asarray(jst.m[k]), atol=ATOL)
        np.testing.assert_allclose(tst.v[k].numpy(), np.asarray(jst.v[k]), atol=ATOL)


@pytest.mark.parametrize("n", SIZES)
def test_flat_reference_and_cpu_fused_match_pallas(n, jx):
    p, m, v, g = _flat_inputs(n)
    lr = np.float32(3e-4)
    want = jx.fused(*(jx.jnp.asarray(a) for a in (p, m, v, g)), jx.jnp.float32(lr),
                    interpret=True)
    want = [np.asarray(a) for a in want]
    t = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    lr_t = torch.tensor([lr])
    ref = fused_adam.adam_flat_reference(*t, lr_t)
    for a, b in zip(ref, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
    launches = fused_adam.launches
    out = fused_adam.adam_flat_fused(*t, lr_t)
    assert fused_adam.launches == launches  # the CPU path launches no kernel
    assert all(o is i for o, i in zip(out, t[:3]))  # in place
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
    np.testing.assert_array_equal(t[3].numpy(), g)  # g untouched


def test_tail_not_leaked():
    """Elements past n never reach the results: updating a prefix leaves
    the rest of the buffer alone and equals updating the prefix alone."""
    p, m, v, g = (torch.from_numpy(a) for a in _flat_inputs(300, seed=2))
    lr_t = torch.tensor([1e-3])
    full = [a.clone() for a in (p, m, v)]
    fused_adam.adam_flat_fused(full[0][:257], full[1][:257], full[2][:257], g[:257], lr_t)
    alone = fused_adam.adam_flat_reference(p[:257], m[:257], v[:257], g[:257], lr_t)
    for a, b, orig in zip(full, alone, (p, m, v)):
        assert a.shape == (300,)
        np.testing.assert_array_equal(a[:257].numpy(), b.numpy())
        np.testing.assert_array_equal(a[257:].numpy(), orig[257:].numpy())


def test_fused_rejects_bad_inputs():
    p, m, v, g = (torch.from_numpy(a) for a in _flat_inputs(16))
    lr_t = torch.tensor([1e-3])
    with pytest.raises(TypeError):
        fused_adam.adam_flat_fused(p.double(), m, v, g, lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p, m, v, g[:8], lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p.view(4, 4), m, v, g, lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p, m, v, g, torch.tensor([1e-3, 2e-3]))
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p, p, v, g, lr_t)
    with pytest.raises(ValueError):
        fused_adam.adam_flat_fused(p[::2], m[:8], v[:8], g[:8], lr_t)


def kernel_elements(plan: fused_adam.LaunchPlan, vec4: bool, n: int) -> np.ndarray:
    """Every element index the kernel touches under ``plan``, from its own
    loops: block b's thread t takes, in tile s, unit first + s * step + t
    below the bound, with (first, step, bound) = ``plan.block_span(b)``; on
    the float4 path unit u is elements 4u to 4u + 3, and block 0's threads
    t < n % 4 take element n // 4 * 4 + t."""
    units = []
    for b in range(plan.blocks):
        first, step, bound = plan.block_span(b)
        starts = np.arange(first, max(bound, first), step)
        u = (starts[:, None] + np.arange(THREADS)).ravel()
        units.append(u[u < bound])
    units = np.concatenate(units) if units else np.zeros(0, np.int64)
    if not vec4:
        return units
    elems = (units[:, None] * 4 + np.arange(4)).ravel()
    tail = n // 4 * 4 + np.arange(THREADS)
    return np.concatenate([elems, tail[tail < n]] if plan.blocks else [elems])


def _block_units(plan) -> np.ndarray:
    """Units each block updates under its span: every tile but the last a
    full one (a step is never shorter than a tile)."""
    if plan.blocks == 0:
        return np.zeros(0, np.int64)
    first, step, bound = np.array([plan.block_span(b) for b in range(plan.blocks)]).T
    tiles = np.maximum(0, -(-(bound - first) // step))
    last = np.minimum(THREADS, bound - first - (tiles - 1) * step)
    return np.where(tiles > 0, (tiles - 1) * THREADS + last, 0)


def _assert_covers_once(n, vec4, sms, per_sm):
    plan = fused_adam.launch_plan(n, vec4, sms, per_sm)
    got = kernel_elements(plan, vec4, n)
    assert got.size == n, (n, vec4, plan)
    assert np.array_equal(np.sort(got), np.arange(n)), (n, vec4, plan)
    assert plan.blocks <= sms * per_sm and (plan.blocks >= 1) == (n > 0)
    return plan


@pytest.mark.parametrize("vec4", [True, False], ids=["float4", "scalar"])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_launch_plan_covers_every_index_once(n, vec4):
    for sms, per_sm in CARDS if n < 100_000 else CARDS[:2]:
        _assert_covers_once(n, vec4, sms, per_sm)


@pytest.mark.parametrize("vec4", [True, False], ids=["float4", "scalar"])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 1), (16, 3), (1, 1)])
def test_launch_plan_one_float4_past_a_full_wave(sms, per_sm, vec4):
    """At a full wave every block takes one full tile; one float4 more
    gives block 0 one more unit and a float4 less leaves the last block one
    short; the grid stays one wave."""
    wave = fused_adam.full_wave_n(sms, per_sm)
    for n in (wave - 4, wave, wave + 4, wave + 7):
        plan = _assert_covers_once(n, vec4, sms, per_sm)
        if vec4:
            assert plan.blocks == sms * per_sm
    if not vec4:
        # The same boundary in floats: a full wave of scalar tiles.
        plan = _assert_covers_once(wave // 4, False, sms, per_sm)
        assert set(_block_units(plan).tolist()) == {THREADS}
        assert plan.blocks == sms * per_sm
        return
    assert set(_block_units(fused_adam.launch_plan(wave, True, sms, per_sm)).tolist()) == {THREADS}
    counts = _block_units(fused_adam.launch_plan(wave + 4, True, sms, per_sm))
    assert counts[0] == THREADS + 1 and set(counts[1:].tolist()) <= {THREADS}
    counts = _block_units(fused_adam.launch_plan(wave - 4, True, sms, per_sm))
    assert counts[-1] == THREADS - 1 and set(counts[:-1].tolist()) <= {THREADS}


@pytest.mark.parametrize("sms,per_sm", CARDS)
def test_launch_plan_one_wave_and_equal_work(sms, per_sm):
    """Over many n: never more than one resident wave of blocks, a block
    a tile below it (no block without work), and the blocks' work differs
    by at most one tile (one sweep)."""
    rng = np.random.default_rng(sms * 10 + per_sm)
    sizes = list(PLAN_SIZES) + [int(x) for x in rng.integers(1, 3_000_000, 24)]
    for n in sizes:
        for vec4 in (True, False):
            plan = fused_adam.launch_plan(n, vec4, sms, per_sm)
            assert plan.blocks <= sms * per_sm
            if n == 0:
                assert plan.blocks == 0
                continue
            assert plan.blocks == min(sms * per_sm, max(1, -(-plan.units // THREADS)))
            counts = _block_units(plan)
            assert counts.sum() == plan.units
            assert max(counts) - min(counts) <= THREADS
            assert plan.units == 0 or min(counts) > 0
            assert plan.units * (4 if vec4 else 1) + plan.tail == n
    for bad in ((-1, True, 132, 6), (10, True, 0, 6), (10, False, 132, 0)):
        with pytest.raises(ValueError):
            fused_adam.launch_plan(*bad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(n, 0) for n in SIZES] + [(65_553, 1)])
def test_cuda_kernel_matches_plain(n, offset, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    bufs = [torch.randn(n + offset, generator=gen, device=cuda_device) for _ in range(4)]
    bufs[2] = bufs[2].abs()
    lr_t = torch.tensor([3e-4], device=cuda_device)
    want = fused_adam.adam_flat_reference(*(b[offset:] for b in bufs), lr_t)
    p, m, v = (b.clone()[offset:] for b in bufs[:3])
    launches = fused_adam.launches
    fused_adam.adam_flat_fused(p, m, v, bufs[3][offset:], lr_t)
    torch.cuda.synchronize()
    assert fused_adam.launches == launches + 1
    for a, b in zip((p, m, v), want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def _card_case(n, offset, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    bufs = [torch.randn(n + offset, generator=gen, device=device) for _ in range(4)]
    bufs[2] = bufs[2].abs()
    return bufs, torch.tensor([3e-4], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["wave-4", "wave", "wave+4", "wave+7", "shard4", "shard4+1",
                                   "full"])
def test_cuda_kernel_bit_equal_at_plan_boundaries(where, cuda_device):
    """Bit-equal to the plain chain at the sizes where the launch plan on
    this card changes shape (a full wave and a float4 either side), at the
    4-worker flat shard (also misaligned: the scalar path) and at the main
    path's n."""
    wave = fused_adam.full_wave_n(*fused_adam.occupancy(cuda_device.index or 0, True))
    n, offset = {"wave-4": (wave - 4, 0), "wave": (wave, 0), "wave+4": (wave + 4, 0),
                 "wave+7": (wave + 7, 0), "shard4": (SHARD4, 0), "shard4+1": (SHARD4, 1),
                 "full": (FULL_N, 0)}[where]
    bufs, lr_t = _card_case(n, offset, cuda_device, n)
    want = fused_adam.adam_flat_reference(*(b[offset:] for b in bufs), lr_t)
    p, m, v = (b.clone()[offset:] for b in bufs[:3])
    fused_adam.adam_flat_fused(p, m, v, bufs[3][offset:], lr_t)
    torch.cuda.synchronize()
    for got, ref in zip((p, m, v), want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_kernel_bit_equal_on_a_repeat(cuda_device):
    bufs, lr_t = _card_case(FULL_N, 0, cuda_device, 7)
    runs = []
    for _ in range(2):
        p, m, v = (b.clone() for b in bufs[:3])
        runs.append(fused_adam.adam_flat_fused(p, m, v, bufs[3], lr_t))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
