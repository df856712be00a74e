"""Worker of the spawned 2-rank gloo world in tests/test_torch_sync.py.

Kept apart from the test module so the spawned children import only
``torch`` and ``ddl_tpu_torch`` (never JAX): ``multiprocessing`` imports this
module, not the test file, to find the target.
"""

import numpy as np
import torch

from ddl_tpu_torch.convert import params_from_numpy, params_to_numpy
from ddl_tpu_torch.models import cnn
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.ops.optimizers import adam_init
from ddl_tpu_torch.strategies.sync import (
    make_dp_step,
    make_sharded_step,
    resolve_layout,
    sharded_adam_init,
)
from ddl_tpu_torch.train.config import TrainConfig


def sharded_steps(rank: int, world_size: int, store: str, inputs: str, out: str,
                  layouts: tuple[str, ...], steps: int) -> None:
    """Run ``steps`` sync steps per layout on this rank's slice of the
    batch and save params, the optimizer moments and the losses. Layout
    ``"dp"`` is the unsharded data-parallel step (m/v per variable); the
    others are ZeRO-1 with ``num_ps=2`` (this rank's flat m/v shard)."""
    torch.set_num_threads(1)
    data = np.load(inputs)
    specs = cnn.make_param_specs(cnn.TINY_CONV_CHANNELS, cnn.TINY_FC_SIZES)
    init = {name: data[name] for name, _ in specs}
    x, y = data["x"], data["y"]
    pb = x.shape[0] // world_size
    xs = torch.from_numpy(x[rank * pb:(rank + 1) * pb])
    ys = torch.from_numpy(y[rank * pb:(rank + 1) * pb])
    world = init_world(world_size, rank, store, "cpu")
    results = {}
    try:
        for layout in layouts:
            dp = layout == "dp"
            cfg = TrainConfig(num_workers=world_size, num_ps=1 if dp else 2,
                              layout="block" if dp else layout,
                              batch_size=x.shape[0], keep_prob=1.0,
                              conv_channels=cnn.TINY_CONV_CHANNELS, fc_sizes=cnn.TINY_FC_SIZES)
            params = params_from_numpy(init, "cpu", specs)
            if dp:
                step = make_dp_step(cfg, world)
                opt = adam_init(params)
            else:
                lay = resolve_layout(cfg, world_size, cnn.param_sizes(specs))
                step = make_sharded_step(cfg, world, lay, cnn.param_shapes(params))
                opt = sharded_adam_init(world, lay)
            losses = []
            for i in range(steps):
                params, opt, loss = step(params, opt, xs, ys, i)
                losses.append(float(loss))
            for k, v in params_to_numpy(params).items():
                results[f"{layout}/{k}"] = v
            if dp:
                for k in params:
                    results[f"{layout}/m/{k}"] = opt.m[k].numpy()
                    results[f"{layout}/v/{k}"] = opt.v[k].numpy()
            else:
                results[f"{layout}/m"] = opt.m.numpy()
                results[f"{layout}/v"] = opt.v.numpy()
            results[f"{layout}/step"] = np.asarray(int(opt.step))
            results[f"{layout}/loss"] = np.asarray(losses)
    finally:
        destroy_world()
    np.savez(out, **results)
