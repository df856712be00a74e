"""The port's trainers (ddl_tpu_torch/train, ddl_tpu_torch/strategies/sync.py)
against the JAX package's on the same converted init and the same data, at
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
from ddl_tpu_torch.convert import sharded_adam_from_numpy
from ddl_tpu_torch.data.mnist import load_mnist
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.ops import fused_adam
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.strategies.sync import SyncTrainer
from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig

import _torch_world

LR = 1e-4
PARAMS_ATOL = LR / 10
STEP_ATOL = 1e-6
LOSS_RTOL = 1e-5
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)


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


def test_two_rank_gloo_world_matches_jax_sync_steps(init_np, small_dataset, tmp_path):
    """One spawned 2-rank gloo world runs two steps of ZeRO-1 for layouts
    zigzag and flat (num_ps=2) and of unsharded DP; each rank's params,
    m/v (its shard, for ZeRO-1) and losses match JAX's make_sharded_step
    / make_dp_step on make_mesh(2)."""
    layouts, steps, bs = ("zigzag", "flat", "dp"), 2, 32
    x = np.asarray(small_dataset.x_train[:bs])
    y = np.eye(10, dtype=np.float32)[np.asarray(small_dataset.y_train[:bs])]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, x=x, y=y, **init_np)

    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_torch_world.sharded_steps, args=(
            r, 2, f"file://{tmp_path / 'store'}", str(inputs),
            str(tmp_path / f"rank{r}.npz"), layouts, steps))
        for r in range(2)
    ]
    for pr in procs:
        pr.start()

    # The JAX side, while the children run.
    mesh = make_mesh(2)
    shapes = {k: v.shape for k, v in init_np.items()}
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    data_sh = NamedSharding(mesh, P(DP_AXIS))
    xj, yj = jax.device_put(jnp.asarray(x), data_sh), jax.device_put(jnp.asarray(y), data_sh)
    want = {}
    replicated = NamedSharding(mesh, P())
    for layout in layouts:
        p = jax.device_put({k: jnp.asarray(v) for k, v in init_np.items()}, replicated)
        if layout == "dp":
            cfg = JConfig(num_workers=2, num_ps=1, batch_size=bs, keep_prob=1.0,
                          learning_rate=LR, **TINY)
            step = jsync.make_dp_step(cfg, mesh)
            o = jax.device_put(j_adam_init(p), replicated)
            ms = None
        else:
            cfg = JConfig(num_workers=2, num_ps=2, layout=layout, batch_size=bs,
                          keep_prob=1.0, learning_rate=LR, **TINY)
            lay = jsync.resolve_layout(cfg, 2, sizes)
            step = jsync.make_sharded_step(cfg, mesh, lay, shapes)
            o = jsync.sharded_adam_init(mesh, lay)
            ms = lay.max_shard
        losses = []
        for i in range(steps):
            p, o, loss = step(p, o, xj, yj, jax.random.PRNGKey(i))
            losses.append(float(loss))
        want[layout] = (ms, {k: np.asarray(v) for k, v in p.items()},
                        jax.tree.map(np.asarray, o.m), jax.tree.map(np.asarray, o.v), losses)

    for pr in procs:
        pr.join(timeout=180)
        assert not pr.is_alive() and pr.exitcode == 0, f"rank exit code {pr.exitcode}"
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for layout in layouts:
            ms, params, m, v, losses = want[layout]
            for k in init_np:
                np.testing.assert_allclose(got[f"{layout}/{k}"], params[k], atol=STEP_ATOL,
                                           err_msg=f"rank {r} {layout} {k}")
            if ms is None:  # DP: replicated per-variable moments
                for k in init_np:
                    np.testing.assert_allclose(got[f"{layout}/m/{k}"], m[k], atol=STEP_ATOL)
                    np.testing.assert_allclose(got[f"{layout}/v/{k}"], v[k], atol=STEP_ATOL)
            else:
                np.testing.assert_allclose(got[f"{layout}/m"], m[r * ms:(r + 1) * ms],
                                           atol=STEP_ATOL)
                np.testing.assert_allclose(got[f"{layout}/v"], v[r * ms:(r + 1) * ms],
                                           atol=STEP_ATOL)
            np.testing.assert_allclose(got[f"{layout}/loss"], losses, rtol=LOSS_RTOL)
            assert int(got[f"{layout}/step"]) == steps
