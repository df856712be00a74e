"""Workers of the spawned gloo worlds: the 2-rank CNN world of
tests/test_torch_sync.py (:func:`world_cases`) and the 4-rank LM world of
tests/test_torch_seq_parallel.py (:func:`lm_world_cases`).

Kept apart from the test modules so the spawned children import only
``torch`` and ``ddl_tpu_torch`` (never JAX): ``multiprocessing`` imports this
module, not the test file, to find the target.
"""

import time

import numpy as np
import torch

from ddl_tpu_torch.convert import async_state_to_numpy, params_from_numpy, params_to_numpy
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.models import cnn
from ddl_tpu_torch.models import transformer
from ddl_tpu_torch.parallel.collectives import unflatten_params
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.ops.optimizers import adam_init
from ddl_tpu_torch.strategies import async_ps
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.strategies.sync import (
    make_dp_step,
    make_sharded_step,
    resolve_layout,
    sharded_adam_init,
)
from ddl_tpu_torch.train.config import TrainConfig
from ddl_tpu_torch.utils import tree

# Sync cases: name -> (num_ps, layout, grad_reduction). num_ps 1 is DP;
# num_ps 3 at W = 2 folds the block layout onto the two ranks.
SYNC_CASES = {
    "zigzag": (2, "zigzag", "mean"),
    "flat": (2, "flat", "mean"),
    "dp": (1, "block", "mean"),
    "block": (2, "block", "mean"),
    "lpt": (2, "lpt", "mean"),
    "fold3": (3, "block", "mean"),
    "flat_sum": (2, "flat", "sum"),
}
# Async cases: name -> (num_ps, layout). "replicated" is the replicated
# serve (layout None), the oracle of the sharded ones; num_ps 14 at W = 2
# folds the block layout.
ASYNC_CASES = {
    "replicated": (1, "block"),
    "zigzag2": (2, "zigzag"),
    "block14": (14, "block"),
}
ASYNC_ROUNDS = 2
ASYNC_SCHEDULE_SEED = 11
TINY = dict(conv_channels=cnn.TINY_CONV_CHANNELS, fc_sizes=cnn.TINY_FC_SIZES)


def async_layout(name: str, world_size: int, sizes):
    """The serve layout of an async case: None for the replicated serve."""
    num_ps, layout = ASYNC_CASES[name]
    if name == "replicated":
        return None
    cfg = TrainConfig(num_workers=world_size, num_ps=num_ps, layout=layout, **TINY)
    return resolve_layout(cfg, world_size, sizes)


def _sync_case(name, world, init, specs, xs, ys, steps, results):
    num_ps, layout, reduction = SYNC_CASES[name]
    dp = num_ps == 1
    cfg = TrainConfig(num_workers=world.size, num_ps=num_ps, layout=layout,
                      grad_reduction=reduction, batch_size=xs.shape[0] * world.size,
                      keep_prob=1.0, **TINY)
    params = params_from_numpy(init, "cpu", specs)
    if dp:
        step = make_dp_step(cfg, world)
        opt = adam_init(params)
    else:
        lay = resolve_layout(cfg, world.size, cnn.param_sizes(specs))
        step = make_sharded_step(cfg, world, lay, cnn.param_shapes(params))
        opt = sharded_adam_init(world, lay)
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, xs, ys, i)
        losses.append(float(loss))
    for k, v in params_to_numpy(params).items():
        results[f"{name}/{k}"] = v
    if dp:
        for k in params:
            results[f"{name}/m/{k}"] = opt.m[k].numpy()
            results[f"{name}/v/{k}"] = opt.v[k].numpy()
    else:
        results[f"{name}/m"] = opt.m.numpy()
        results[f"{name}/v"] = opt.v.numpy()
    results[f"{name}/step"] = np.asarray(int(opt.step))
    results[f"{name}/loss"] = np.asarray(losses)


def _async_case(name, world, init, specs, xs, ys, x_test, y_test, results):
    """ASYNC_ROUNDS rounds of ``make_async_round`` (one call a round, so
    each round's loss is kept), then this rank's state, the logical ps/m/v
    by variable and the per-worker eval counts."""
    num_ps, layout = ASYNC_CASES[name]
    cfg = TrainConfig(num_workers=world.size, num_ps=num_ps, layout=layout,
                      batch_size=xs.shape[1], keep_prob=1.0, **TINY)
    params = params_from_numpy(init, "cpu", specs)
    shapes = cnn.param_shapes(params)
    lay = async_layout(name, world.size, cnn.param_sizes(specs))
    state = async_ps.async_state_init(cfg, world, lay, params)
    run = async_ps.make_async_round(cfg, world, lay, shapes)
    scheds = async_ps.async_schedule(ASYNC_SCHEDULE_SEED, world.size, ASYNC_ROUNDS)
    losses = []
    for r in range(ASYNC_ROUNDS):
        state, ps_full, loss = run(state, xs[r : r + 1], ys[r : r + 1], scheds[r : r + 1], r)
        losses.append(float(loss))
    for k, v in async_state_to_numpy([state], sharded=lay is not None).items():
        results[f"async/{name}/state/{k}"] = v
    results[f"async/{name}/ps_full"] = ps_full.numpy()
    results[f"async/{name}/loss"] = np.asarray(losses)
    spec = async_ps._flat_spec(lay, shapes)
    reassembly = async_ps._reassembly(lay, world.device)
    for what in ("ps", "m", "v"):
        full = async_ps._gather_full(getattr(state, what), world, reassembly)
        for k, t in unflatten_params(full, spec).items():
            results[f"async/{name}/logical/{what}/{k}"] = t.numpy()
    counts = async_ps.make_worker_eval(world, spec)(state.replica(world.rank), x_test, y_test)
    results[f"async/{name}/worker_counts"] = counts.numpy()


def world_cases(rank: int, world_size: int, store: str, inputs: str, out: str,
                steps: int) -> None:
    """Every sync case for ``steps`` steps on this rank's slice of the
    batch, then every async case for ASYNC_ROUNDS rounds on this worker's
    batches; saves params, optimizer moments, serve state and losses."""
    torch.set_num_threads(1)
    data = np.load(inputs)
    specs = cnn.make_param_specs(cnn.TINY_CONV_CHANNELS, cnn.TINY_FC_SIZES)
    init = {name: data[name] for name, _ in specs}
    x, y = data["x"], data["y"]
    pb = x.shape[0] // world_size
    xs = torch.from_numpy(x[rank * pb:(rank + 1) * pb])
    ys = torch.from_numpy(y[rank * pb:(rank + 1) * pb])
    # Async: [rounds, W, bs, ...], this worker's [rounds, bs, ...].
    axs = torch.from_numpy(np.ascontiguousarray(data["ax"][:, rank]))
    ays = torch.from_numpy(np.ascontiguousarray(data["ay"][:, rank]))
    x_test, y_test = torch.from_numpy(data["x_test"]), torch.from_numpy(data["y_test"])
    world = init_world(world_size, rank, store, "cpu")
    results = {}
    try:
        for name in SYNC_CASES:
            _sync_case(name, world, init, specs, xs, ys, steps, results)
        for name in ASYNC_CASES:
            _async_case(name, world, init, specs, axs, ays, x_test, y_test, results)
    finally:
        destroy_world()
    np.savez(out, **results)


# LM cases of the 4-rank world: name -> SeqConfig fields (num_workers x
# data_parallel = 4 ranks).
LM_CASES = {
    "ring": dict(scheme="ring", num_workers=4),
    "ring_zigzag": dict(scheme="ring", seq_layout="zigzag", num_workers=4),
    "ulysses": dict(scheme="ulysses", num_workers=4),
    "ulysses_flash": dict(scheme="ulysses", attn_impl="flash", num_workers=4),
    "ring_zigzag_2x2": dict(scheme="ring", seq_layout="zigzag", num_workers=2,
                            data_parallel=2),
    "full_dp4": dict(scheme="full", num_workers=1, data_parallel=4),
    "zero1_ring": dict(scheme="ring", zero1=True, num_workers=4),
    "zero1_ulysses_2x2": dict(scheme="ulysses", zero1=True, num_workers=2, data_parallel=2),
    # Recomputed blocks re-run the ring's shifts inside the backward pass.
    "ring_zigzag_remat": dict(scheme="ring", seq_layout="zigzag", num_workers=4, remat=True),
}
LM_SPEC = transformer.LMSpec(vocab=16, d_model=32, num_heads=4, num_layers=2, d_ff=64)
LM_DATA = dict(num_train=16, num_test=8, seq_len=32, vocab=16, seed=5)
# 2 steps of batch 8, one span (and one eval) a step.
LM_BASE = dict(epochs=1, batch_size=8, learning_rate=1e-3, eval_every=1, seed=2, spec=LM_SPEC)


def lm_world_cases(rank: int, world_size: int, store: str, inputs: str, out: str) -> None:
    """Every case of LM_CASES from the init in ``inputs`` (its leaves in
    ``utils.tree.leaves`` order): params, span losses, the final loss and
    accuracy, this rank's Adam state (moments by leaf, or its ZeRO-1
    chunk) and the rank's wall time in seconds."""
    start = time.perf_counter()
    torch.set_num_threads(1)
    data = np.load(inputs)
    like = transformer.init_lm_params(torch.Generator().manual_seed(0), LM_SPEC)
    init = tree.unflatten(like, [data[f"init/{i}"] for i in range(len(tree.leaves(like)))])
    ds = synthesize_copy(**LM_DATA)
    world = init_world(world_size, rank, store, "cpu")
    results = {}
    try:
        for name, kw in LM_CASES.items():
            trainer = SeqTrainer(SeqConfig(**LM_BASE, **kw), ds, init=init, world=world)
            res = trainer.train(log=lambda s: None)
            for i, leaf in enumerate(tree.leaves(res.params)):
                results[f"{name}/p/{i}"] = leaf
            results[f"{name}/span_losses"] = np.asarray(res.span_losses)
            results[f"{name}/final"] = np.asarray([res.final_loss, res.final_accuracy])
            opt = trainer.opt_state
            results[f"{name}/step"] = np.asarray(int(opt.step))
            for k in ("m", "v"):
                for i, leaf in enumerate(tree.leaves(getattr(opt, k))):
                    results[f"{name}/{k}/{i}"] = leaf.numpy()
    finally:
        destroy_world()
    results["seconds"] = np.asarray(time.perf_counter() - start)
    np.savez(out, **results)
