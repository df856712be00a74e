"""The port's async parameter server (ddl_tpu_torch/strategies/async_ps.py)
against the JAX package's (ddl_tpu/strategies/async_ps.py) at W = 1, in a
world of one in this process, at ``keep_prob=1`` and the tiny model. The
W = 2 cases ride in the spawned world of tests/test_torch_sync.py.

Tolerances as in tests/test_torch_sync.py: parameters, moments and replicas
within 1e-6 after a few pushes (the two sides' conv and matmul libraries
differ in the last bits), losses within rtol 1e-5, accuracies to 6
decimals, the update counter exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.data import load_mnist as j_load_mnist
from ddl_tpu.parallel.mesh import make_mesh
from ddl_tpu.strategies import async_ps as jasync
from ddl_tpu.train import TrainConfig as JConfig
from ddl_tpu_torch.convert import async_state_from_numpy, async_state_to_numpy
from ddl_tpu_torch.data.mnist import load_mnist
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.ops import fused_adam
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.strategies.async_ps import AsyncTrainer, async_schedule
from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig

LR = 1e-4
STEP_ATOL = 1e-6
LOSS_RTOL = 1e-5
BS, ROUNDS, EVERY = 32, 4, 2
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)
QUIET = lambda s: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init_np(small_params):
    # Creation order (v0..v13): the JAX trainer lays its flat vector out in
    # its init dict's key order.
    return {k: np.asarray(v) for k, v in small_params.items()}


@pytest.fixture
def world1(tmp_path):
    world = init_world(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    yield world
    destroy_world()


@pytest.mark.parametrize("seed,workers,rounds", [(0, 1, 3), (11, 2, 2), (42, 8, 20), (7, 5, 9)])
def test_schedule_equals_jax(seed, workers, rounds):
    got = async_schedule(seed, workers, rounds)
    np.testing.assert_array_equal(got, jasync.async_schedule(seed, workers, rounds))
    assert got.dtype == np.int32 and got.shape == (rounds, workers)
    for row in got:
        assert sorted(row.tolist()) == list(range(workers))


def _datasets(seed):
    n = BS * ROUNDS
    return (j_load_mnist(None, synthetic_train=n, synthetic_test=64, seed=seed),
            load_mnist(None, synthetic_train=n, synthetic_test=64, seed=seed))


@pytest.mark.parametrize("num_ps", [1, 2], ids=["replicated", "sharded_block_folded"])
def test_async_trainer_matches_jax_at_one_worker(num_ps, init_np, world1):
    """4 rounds, an eval every 2: ps, m, v and the replica match JAX's
    AsyncTrainer on make_mesh(1) (compared through
    convert.async_state_to_numpy), t exactly; the PS and per-worker
    histories to 6 decimals; the span losses match JAX's round program
    over the same two spans."""
    kw = dict(num_workers=1, num_ps=num_ps, layout="block", batch_size=BS, keep_prob=1.0,
              eval_every=EVERY, seed=0, learning_rate=LR, **TINY)
    jds, tds = _datasets(8)
    jt = jasync.AsyncTrainer(JConfig(**kw), jds, mesh=make_mesh(1),
                             init={k: jnp.asarray(v) for k, v in init_np.items()})
    jres = jt.train(log=QUIET)
    tt = AsyncTrainer(TrainConfig(**kw), tds, world=world1, init=init_np)
    before = fused_adam.launches
    tres = tt.train(log=QUIET)
    assert fused_adam.launches == before  # the CPU runs the plain version
    sharded = num_ps > 1
    assert (tt.serve_layout is None) == (jt.serve_layout is None) == (not sharded)

    jstate = jax.tree.map(np.asarray, jt.state)
    got = async_state_to_numpy([tt.state], sharded=sharded)
    for k in ("ps", "m", "v", "workers"):
        assert got[k].shape == getattr(jstate, k).shape, k
        np.testing.assert_allclose(got[k], getattr(jstate, k), atol=STEP_ATOL, rtol=0, err_msg=k)
    assert int(got["t"]) == int(jstate.t) == ROUNDS
    assert [(e, r, round(a, 6)) for e, r, a in tres.history] == [
        (e, r, round(a, 6)) for e, r, a in jres.history]
    assert [(e, r, [round(a, 6) for a in accs]) for e, r, accs in tres.worker_history] == [
        (e, r, [round(a, 6) for a in accs]) for e, r, accs in jres.worker_history]
    assert [r for _, r, _ in tres.history] == [0, 2]
    for k in init_np:
        np.testing.assert_allclose(tres.params[k], jres.params[k], atol=STEP_ATOL, err_msg=k)

    # JAX's span losses (its trainer drops them): its round program over
    # the same two spans, from the same init.
    xs, ys, rounds = jt._batches()
    run = jasync.make_async_round(JConfig(**kw), jt.mesh, jt.serve_layout,
                                  {k: v.shape for k, v in init_np.items()})
    st = jasync.async_state_init(JConfig(**kw), jt.mesh, jt.serve_layout,
                                 {k: jnp.asarray(v) for k, v in init_np.items()})
    scheds = jasync.async_schedule(0, 1, rounds)
    jloss = []
    for lo in range(0, rounds, EVERY):
        st, _, loss = run(st, jnp.asarray(xs[lo:lo + EVERY]), jnp.asarray(ys[lo:lo + EVERY]),
                          jnp.zeros((EVERY, 2), jnp.uint32), jnp.asarray(scheds[lo:lo + EVERY]))
        jloss.append(float(loss))
    np.testing.assert_allclose(tres.span_losses, jloss, rtol=LOSS_RTOL)


def test_one_worker_async_is_sequential(init_np, world1):
    """At W = 1 the async PS is push, apply, pull every batch: the port's
    AsyncTrainer equals its SingleChipTrainer on the same batches."""
    _, tds = _datasets(9)
    kw = dict(batch_size=BS, keep_prob=1.0, eval_every=0, seed=0, learning_rate=LR, **TINY)
    single = SingleChipTrainer(TrainConfig(**kw), tds, init=init_np, device="cpu").train(log=QUIET)
    tt = AsyncTrainer(TrainConfig(num_workers=1, **kw), tds, world=world1, init=init_np)
    res = tt.train(log=QUIET)
    for k in init_np:
        np.testing.assert_allclose(res.params[k], single.params[k], atol=STEP_ATOL, err_msg=k)
    # The one worker pushed last: its replica is the PS, bit for bit.
    torch.testing.assert_close(tt.state.workers[0], tt.state.ps, atol=0, rtol=0)
    assert int(tt.state.t) == ROUNDS and res.worker_history == []


@pytest.mark.parametrize("sharded", [False, True])
def test_async_state_conversion_round_trips(sharded):
    """convert.async_state_from_numpy splits a global state into the ranks'
    (chunks and replica rows when sharded, everything when replicated);
    async_state_to_numpy puts them back together."""
    rng = np.random.default_rng(0)
    W, chunk, total = 2, 8, 13
    n = W * chunk if sharded else total
    glob = types.SimpleNamespace(
        ps=rng.standard_normal(n, dtype=np.float32), m=rng.standard_normal(n, dtype=np.float32),
        v=rng.random(n, dtype=np.float32), workers=rng.standard_normal((W, total), dtype=np.float32),
        t=np.int32(6))
    ranks = [async_state_from_numpy(glob, r, W, sharded=sharded, device="cpu") for r in range(W)]
    if sharded:
        assert ranks[1].ps.shape == (chunk,) and ranks[1].workers.shape == (1, total)
        np.testing.assert_array_equal(ranks[1].ps.numpy(), glob.ps[chunk:])
        np.testing.assert_array_equal(ranks[1].workers.numpy(), glob.workers[1:])
    else:
        np.testing.assert_array_equal(ranks[1].workers.numpy(), glob.workers)
    back = async_state_to_numpy(ranks, sharded=sharded)
    for k in ("ps", "m", "v", "workers"):
        np.testing.assert_array_equal(back[k], getattr(glob, k), err_msg=k)
    assert int(back["t"]) == 6 and ranks[0].t.dtype == torch.int32
    with pytest.raises(ValueError, match="rows"):
        async_state_from_numpy(glob, 0, 3, sharded=sharded, device="cpu")
