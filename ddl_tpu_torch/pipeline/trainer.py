"""Pipeline program builders — the port of ``ddl_tpu/pipeline/trainer.py``:
the wiring between the train step (``pipeline/step.py``) and its
consumers, ``SeqTrainer`` (``SeqConfig.pipeline_parallel`` /
``microbatches``) and :func:`make_pipeline_program`, the standalone
builder that bypasses ``validate_topology`` (so a ``microbatches=1`` step,
which the trainer refuses, can still be built and timed). One builder, so
every consumer runs the same step. (JAX's eval builder wraps its body in
``shard_map``; the port's trainer calls ``step.make_pipeline_eval_body``
itself.)"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import lm_params_from_numpy, lm_params_to_numpy
from ..models import transformer
from ..ops.optimizers import adam_init
from ..parallel.mesh import Grid, World, default_device, make_grid
from .schedule import schedule_tables
from .step import PipelineRecord, make_pipeline_step_body


def pipeline_step(config, grid: Grid, positions: torch.Tensor,
                  record: PipelineRecord | None = None, groups: list | None = None,
                  guard: bool = False):
    """This config's pipeline train step on this rank of ``grid``:
    ``(params, opt, tokens, targets, weights[, health]) -> (params', opt',
    loss[, health dict][, skipped])`` over this dp row's batch, the stage's
    params and their Adam state; ``groups`` (``strategies.seq.guard_groups``)
    are the leaves' partition groups of the guard (``guard``) and health
    sums."""
    tables = schedule_tables(config.pipeline_schedule, grid.pipeline_parallel,
                             config.microbatches)
    return make_pipeline_step_body(config, grid, tables, positions,
                                   lr=config.learning_rate, record=record,
                                   groups=groups, guard=guard)


def make_pipeline_program(config, tokens, targets, weights, *, world: World | None = None,
                          device: str | torch.device | None = None, init: dict | None = None):
    """A standalone pipeline step on this rank of the ``dp x 1 x tp x pp``
    grid over ``world`` (the benchmark entry point: it bypasses
    ``SeqTrainer`` and its topology checks). The params are this rank's
    stage of ``init`` (the full numpy tree; by default the glorot init of
    ``config.seed``). Returns ``(fn, (params,
    opt, tokens, targets, weights))``, the batch's global ``[B, T]`` arrays
    cut to this dp row's rows on the device; callers time ``fn(*state)``
    behind a device barrier."""
    grid = make_grid(world, config.data_parallel, config.num_workers,
                     config.tensor_parallel, config.pipeline_parallel)
    dev = world.device if world is not None else default_device(device)
    if init is None:
        init = lm_params_to_numpy(transformer.init_lm_params(
            torch.Generator().manual_seed(config.seed), config.spec))
    params = lm_params_from_numpy(init, config.spec, dev,
                                  tensor_parallel=config.tensor_parallel,
                                  tp_index=grid.tp_index,
                                  pipeline_parallel=config.pipeline_parallel,
                                  pp_index=grid.pp_index)
    rows = np.asarray(tokens).shape[0] // config.data_parallel
    mine = slice(grid.dp_index * rows, (grid.dp_index + 1) * rows)

    def put(a):
        out = torch.as_tensor(np.ascontiguousarray(np.asarray(a)[mine]))
        return (out if out.is_floating_point() else out.long()).to(dev)

    positions = torch.arange(np.asarray(tokens).shape[1], device=dev)
    fn = pipeline_step(config, grid, positions)
    return fn, (params, adam_init(params), put(tokens), put(targets), put(weights))
