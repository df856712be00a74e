"""The port's trainers (ddl_tpu_torch/train, ddl_tpu_torch/strategies/sync.py,
and at W = 2 strategies/async_ps.py's round program, in the same spawned
world) against the JAX package's on the same converted init and the same
data, at
``keep_prob=1`` (jax.random and torch dropout masks cannot match) and the
tiny model (tests/conftest.py SMALL_SPECS).

Tolerances: the two sides run the same float32 math through different conv
and matmul libraries, so gradients differ in the last bits. An Adam step
moves a parameter by about lr whatever the gradient's size, so parameters
stay within a small fraction of one step (PARAMS_ATOL = lr/10 after 20
steps; 1e-6 after two), moments within 1e-6, losses within rtol 1e-5.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ddl_tpu.data import load_mnist as j_load_mnist
from ddl_tpu.ops import adam_init as j_adam_init
from ddl_tpu.parallel.mesh import DP_AXIS, make_mesh
from ddl_tpu.strategies import sync as jsync
from ddl_tpu.train import SingleChipTrainer as JSingle, TrainConfig as JConfig
from ddl_tpu.train.trainer import make_epoch_chunk as j_chunk
from ddl_tpu.strategies import async_ps as jasync
from ddl_tpu.strategies.async_ps import async_schedule as j_async_schedule
from ddl_tpu_torch.convert import (
    async_state_from_numpy,
    async_state_to_numpy,
    sharded_adam_from_numpy,
)
from ddl_tpu_torch.data.mnist import load_mnist
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.ops import fused_adam
from ddl_tpu_torch.parallel import collectives as tcoll
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.strategies.async_ps import AsyncState, _flat_spec as t_flat_spec
from ddl_tpu_torch.strategies.sync import SyncTrainer
from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig
from ddl_tpu_torch.train.trainer import correct_total

import _torch_world

LR = 1e-4
PARAMS_ATOL = LR / 10
STEP_ATOL = 1e-6
LOSS_RTOL = 1e-5
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init_np(small_params):
    return {k: np.asarray(v) for k, v in small_params.items()}


@pytest.fixture
def world1(tmp_path):
    world = init_world(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    yield world
    destroy_world()


def test_single_chip_trainer_matches_jax(init_np):
    """20 steps from the same init: per-step losses, the per-step eval
    accuracies and the final params match ddl_tpu's SingleChipTrainer."""
    kw = dict(batch_size=32, keep_prob=1.0, eval_every=1, seed=0, learning_rate=LR, **TINY)
    jds = j_load_mnist(None, synthetic_train=640, synthetic_test=128, seed=5)
    tds = load_mnist(None, synthetic_train=640, synthetic_test=128, seed=5)
    quiet = lambda s: None
    jres = JSingle(JConfig(**kw), jds, init=jax.tree.map(jnp.asarray, init_np)).train(log=quiet)
    tres = SingleChipTrainer(TrainConfig(**kw), tds, init=init_np, device="cpu").train(log=quiet)

    # The JAX side's per-step losses, from its span program (k=1).
    chunk = j_chunk(JConfig(**kw), 1)
    p = jax.tree.map(jnp.asarray, init_np)
    o = j_adam_init(p)
    xs = jnp.asarray(jds.x_train.reshape(20, 32, 784))
    ys = jnp.asarray(jds.train_onehot().reshape(20, 32, 10))
    jloss = []
    for i in range(20):
        p, o, loss = chunk(p, o, xs, ys, jnp.int32(i), jnp.int32(i), jax.random.PRNGKey(0))
        jloss.append(float(loss))

    assert len(tres.span_losses) == 20
    np.testing.assert_allclose(tres.span_losses, jloss, rtol=LOSS_RTOL)
    assert [b for _, b, _ in tres.history] == [b for _, b, _ in jres.history]
    np.testing.assert_allclose([a for *_, a in tres.history],
                               [a for *_, a in jres.history], atol=1 / 128 + 1e-9)
    for k in init_np:
        np.testing.assert_allclose(tres.params[k], jres.params[k], atol=PARAMS_ATOL, err_msg=k)
        np.testing.assert_allclose(tres.params[k], np.asarray(p[k]), atol=PARAMS_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_sync_trainer_zero1_flat_matches_jax(fused, init_np, world1):
    """W=1, num_ps=2, layout flat (re-split over the one rank): params, m
    and v after 4 steps match JAX's SyncTrainer on make_mesh(1), whose
    fused path runs the Pallas kernel in interpret mode."""
    kw = dict(num_workers=1, num_ps=2, layout="flat", batch_size=32, keep_prob=1.0,
              eval_every=1, seed=0, learning_rate=LR, fused_adam=fused, **TINY)
    jds = j_load_mnist(None, synthetic_train=128, synthetic_test=64, seed=6)
    tds = load_mnist(None, synthetic_train=128, synthetic_test=64, seed=6)
    # A dict comprehension keeps v0..v13 in creation order: the JAX
    # trainer lays the flat vector out in its init dict's key order, and
    # jax.tree.map would sort the keys (v0, v1, v10, ...).
    jt = jsync.SyncTrainer(JConfig(**kw), jds, mesh=make_mesh(1),
                           init={k: jnp.asarray(v) for k, v in init_np.items()})
    jres = jt.train(log=lambda s: None)
    tt = SyncTrainer(TrainConfig(**kw), tds, world=world1, init=init_np)
    before = fused_adam.launches
    tres = tt.train(log=lambda s: None)
    assert fused_adam.launches == before  # the CPU runs the plain version
    assert tt.layout.num_shards == 1 and tt.layout.max_shard == jt.layout.max_shard
    for k in init_np:
        np.testing.assert_allclose(tres.params[k], jres.params[k], atol=STEP_ATOL, err_msg=k)
    # The JAX state carried into the port's form (one rank: the whole
    # [1 * max_shard] vectors).
    jstate = sharded_adam_from_numpy(
        np.asarray(jt.opt_state.step), np.asarray(jt.opt_state.m), np.asarray(jt.opt_state.v), "cpu"
    )
    torch.testing.assert_close(tt.opt_state.m, jstate.m, atol=STEP_ATOL, rtol=0)
    torch.testing.assert_close(tt.opt_state.v, jstate.v, atol=STEP_ATOL, rtol=0)
    assert int(tt.opt_state.step) == int(jstate.step) == 4
    assert [round(a, 6) for *_, a in tres.history] == [round(a, 6) for *_, a in jres.history]


ASYNC_BS = 16


@pytest.fixture(scope="module")
def two_rank_world(init_np, small_dataset, tmp_path_factory):
    """ONE spawned 2-rank gloo world for every W = 2 case: the children run
    each sync case of ``_torch_world.SYNC_CASES`` for two steps, then each
    async case of ``ASYNC_CASES`` for two rounds; the JAX side runs the same
    configs on make_mesh(2) meanwhile. Returns (rank results, JAX sync
    results, JAX async results)."""
    tmp_path = tmp_path_factory.mktemp("world")
    steps, bs = 2, 32
    x = np.asarray(small_dataset.x_train[:bs])
    y = np.eye(10, dtype=np.float32)[np.asarray(small_dataset.y_train[:bs])]
    R, W = _torch_world.ASYNC_ROUNDS, 2
    n = R * ASYNC_BS * W
    ax = np.asarray(small_dataset.x_train[:n]).reshape(W, R, ASYNC_BS, -1).transpose(1, 0, 2, 3)
    ay = np.eye(10, dtype=np.float32)[np.asarray(small_dataset.y_train[:n])]
    ay = ay.reshape(W, R, ASYNC_BS, -1).transpose(1, 0, 2, 3)
    x_test = np.asarray(small_dataset.x_test[:64])
    y_test = np.eye(10, dtype=np.float32)[np.asarray(small_dataset.y_test[:64])]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, x=x, y=y, ax=np.ascontiguousarray(ax), ay=np.ascontiguousarray(ay),
             x_test=x_test, y_test=y_test, **init_np)

    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_torch_world.world_cases, args=(
            r, W, f"file://{tmp_path / 'store'}", str(inputs),
            str(tmp_path / f"rank{r}.npz"), steps))
        for r in range(W)
    ]
    for pr in procs:
        pr.start()

    # The JAX side, while the children run.
    mesh = make_mesh(W)
    shapes = {k: v.shape for k, v in init_np.items()}
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    data_sh = NamedSharding(mesh, P(DP_AXIS))
    xj, yj = jax.device_put(jnp.asarray(x), data_sh), jax.device_put(jnp.asarray(y), data_sh)
    want = {}
    replicated = NamedSharding(mesh, P())
    for name, (num_ps, layout, reduction) in _torch_world.SYNC_CASES.items():
        p = jax.device_put({k: jnp.asarray(v) for k, v in init_np.items()}, replicated)
        cfg = JConfig(num_workers=W, num_ps=num_ps, layout=layout, grad_reduction=reduction,
                      batch_size=bs, keep_prob=1.0, learning_rate=LR, **TINY)
        if num_ps == 1:
            step = jsync.make_dp_step(cfg, mesh)
            o = jax.device_put(j_adam_init(p), replicated)
            ms = None
        else:
            lay = jsync.resolve_layout(cfg, W, sizes)
            step = jsync.make_sharded_step(cfg, mesh, lay, shapes)
            o = jsync.sharded_adam_init(mesh, lay)
            ms = lay.max_shard
        losses = []
        for i in range(steps):
            p, o, loss = step(p, o, xj, yj, jax.random.PRNGKey(i))
            losses.append(float(loss))
        want[name] = (ms, {k: np.asarray(v) for k, v in p.items()},
                      jax.tree.map(np.asarray, o.m), jax.tree.map(np.asarray, o.v), losses)

    want_async = {}
    scheds = jnp.asarray(j_async_schedule(_torch_world.ASYNC_SCHEDULE_SEED, W, R))
    rngs = jnp.zeros((1, 2), jnp.uint32)
    for name, (num_ps, layout) in _torch_world.ASYNC_CASES.items():
        cfg = JConfig(num_workers=W, num_ps=num_ps, layout=layout, batch_size=ASYNC_BS,
                      keep_prob=1.0, learning_rate=LR, **TINY)
        lay = None if name == "replicated" else jsync.resolve_layout(cfg, W, sizes)
        st = jasync.async_state_init(cfg, mesh, lay, {k: jnp.asarray(v) for k, v in init_np.items()})
        run = jasync.make_async_round(cfg, mesh, lay, shapes)
        losses = []
        for r in range(R):
            st, ps_full, loss = run(st, jnp.asarray(ax[r : r + 1]), jnp.asarray(ay[r : r + 1]),
                                    rngs, scheds[r : r + 1])
            losses.append(float(loss))
        want_async[name] = (jax.tree.map(np.asarray, st), np.asarray(ps_full), losses)

    for pr in procs:
        pr.join(timeout=180)
        assert not pr.is_alive() and pr.exitcode == 0, f"rank exit code {pr.exitcode}"
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(W)]
    return got, want, want_async, (x_test, y_test)


def test_two_rank_gloo_world_matches_jax_sync_steps(init_np, two_rank_world):
    """Two steps of ZeRO-1 for layouts zigzag, flat, block and lpt
    (num_ps=2), a block layout of num_ps=3 folded onto the two ranks, flat
    with grad_reduction="sum", and unsharded DP, in the spawned 2-rank
    world; each rank's params, m/v (its shard, for ZeRO-1) and losses match
    JAX's make_sharded_step / make_dp_step on make_mesh(2)."""
    got, want, _, _ = two_rank_world
    for r, rank in enumerate(got):
        for name in _torch_world.SYNC_CASES:
            ms, params, m, v, losses = want[name]
            for k in init_np:
                np.testing.assert_allclose(rank[f"{name}/{k}"], params[k], atol=STEP_ATOL,
                                           err_msg=f"rank {r} {name} {k}")
            if ms is None:  # DP: replicated per-variable moments
                for k in init_np:
                    np.testing.assert_allclose(rank[f"{name}/m/{k}"], m[k], atol=STEP_ATOL)
                    np.testing.assert_allclose(rank[f"{name}/v/{k}"], v[k], atol=STEP_ATOL)
            else:
                np.testing.assert_allclose(rank[f"{name}/m"], m[r * ms:(r + 1) * ms],
                                           atol=STEP_ATOL, err_msg=f"rank {r} {name}")
                np.testing.assert_allclose(rank[f"{name}/v"], v[r * ms:(r + 1) * ms],
                                           atol=STEP_ATOL, err_msg=f"rank {r} {name}")
            np.testing.assert_allclose(rank[f"{name}/loss"], losses, rtol=LOSS_RTOL)
            assert int(rank[f"{name}/step"]) == 2


@pytest.mark.parametrize("name", list(_torch_world.ASYNC_CASES))
def test_two_rank_gloo_world_matches_jax_async_rounds(name, two_rank_world):
    """Two rounds of make_async_round at W = 2 (the replicated serve, zigzag
    at num_ps=2, block at num_ps=14 folded): each rank's ps/m/v and replica
    rows match JAX's state converted to that rank (convert.
    async_state_from_numpy), the logical ps matches JAX's, the losses match
    and t counts 2 * W pushes."""
    got, _, want_async, _ = two_rank_world
    jstate, jps_full, jlosses = want_async[name]
    sharded = name != "replicated"
    for r, rank in enumerate(got):
        want = async_state_from_numpy(jstate, r, 2, sharded=sharded, device="cpu")
        for k in ("ps", "m", "v", "workers"):
            np.testing.assert_allclose(rank[f"async/{name}/state/{k}"], getattr(want, k).numpy(),
                                       atol=STEP_ATOL, rtol=0, err_msg=f"rank {r} {name} {k}")
        assert int(rank[f"async/{name}/state/t"]) == int(want.t) == 2 * 2
        np.testing.assert_allclose(rank[f"async/{name}/ps_full"], jps_full, atol=STEP_ATOL, rtol=0)
        np.testing.assert_allclose(rank[f"async/{name}/loss"], jlosses, rtol=LOSS_RTOL)
    # Both ranks' states, put together (convert.async_state_to_numpy), are
    # JAX's global state.
    ranks = [AsyncState(**{k: torch.as_tensor(rank[f"async/{name}/state/{k}"])
                           for k in ("ps", "m", "v", "workers", "t")}) for rank in got]
    glob = async_state_to_numpy(ranks, sharded=sharded)
    for k in ("ps", "m", "v", "workers"):
        np.testing.assert_allclose(glob[k], getattr(jstate, k), atol=STEP_ATOL, rtol=0)
    assert int(glob["t"]) == int(jstate.t)


def test_two_rank_async_sharded_serve_equals_replicated_bitwise(init_np, two_rank_world):
    """In the port, the sharded serves (zigzag at num_ps=2, block at 14)
    leave ps, m and v bit-identical to the replicated serve's: Adam is
    elementwise, so shard placement cannot change a bit."""
    got, _, _, _ = two_rank_world
    for rank in got:
        for what in ("ps", "m", "v"):
            for k in init_np:
                ref = rank[f"async/replicated/logical/{what}/{k}"]
                for name in ("zigzag2", "block14"):
                    np.testing.assert_array_equal(rank[f"async/{name}/logical/{what}/{k}"], ref,
                                                  err_msg=f"{name} {what} {k}")


def test_two_rank_async_staleness_is_real(two_rank_world):
    """After the last round, the last-scheduled worker's replica is the PS
    exactly and the other worker's is stale, in every serve."""
    got, _, _, _ = two_rank_world
    sched = j_async_schedule(_torch_world.ASYNC_SCHEDULE_SEED, 2, _torch_world.ASYNC_ROUNDS)
    last = int(sched[-1, -1])
    for name in _torch_world.ASYNC_CASES:
        if name == "replicated":
            rows = got[0][f"async/{name}/state/workers"]
        else:
            rows = np.concatenate([rank[f"async/{name}/state/workers"] for rank in got])
        ps = got[0][f"async/{name}/ps_full"]
        np.testing.assert_array_equal(rows[last], ps, err_msg=name)
        assert np.abs(rows[1 - last] - ps).max() > 0, name


def test_two_rank_async_per_worker_eval(two_rank_world):
    """The per-worker eval returns W counts in rank order, the same on both
    ranks: worker w's is the count of its own replica on the test set."""
    got, _, _, (x_test, y_test) = two_rank_world
    specs = tcnn.make_param_specs(tcnn.TINY_CONV_CHANNELS, tcnn.TINY_FC_SIZES)
    for name in _torch_world.ASYNC_CASES:
        counts = [rank[f"async/{name}/worker_counts"] for rank in got]
        assert counts[0].shape == (2,)
        np.testing.assert_array_equal(counts[0], counts[1], err_msg=name)
        rows = (got[0][f"async/{name}/state/workers"] if name == "replicated" else
                np.concatenate([rank[f"async/{name}/state/workers"] for rank in got]))
        spec = t_flat_spec(_torch_world.async_layout(name, 2, tcnn.param_sizes(specs)),
                           dict(specs))
        want = [int(correct_total(tcoll.unflatten_params(torch.as_tensor(rows[w]), spec),
                                  torch.as_tensor(x_test), torch.as_tensor(y_test)))
                for w in range(2)]
        assert counts[0].tolist() == want, name
