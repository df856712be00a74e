"""Synchronous strategies: data-parallel and parameter-sharded (ZeRO-1) —
the port of ``ddl_tpu/strategies/sync.py``.

One process per worker, joined by a ``torch.distributed`` world (NCCL on
the card; a world of one is a real group, so even one card runs every
collective call). Per step, the collective schedule is the JAX package's:

- **DP** (``mnist_sync``): per-rank grads, all-reduce (mean by default,
  sum under ``grad_reduction="sum"``), replicated Adam.
- **ZeRO-1** (``mnist_sync_sharding[_greedy]``): flatten in layout order,
  reduce-scatter the grads so each rank owns one slice, shard-local TF1
  Adam (m/v live only on the owner), all-gather the updated slices and
  reassemble with the static index. ``fused_adam`` runs the shard-local
  update through the hand-written CUDA kernel (``ops/fused_adam.py``).

With ``grad_reduction="mean"`` and no dropout every sync strategy is
step-equivalent to the single-device trainer on the same global batch.

The compute dtype (the precision policy's) and the patches-matmul stages
are the single-device step's (``train.trainer.model_kwargs``). As in JAX,
the CNN's sums cast no gradient: the in-loss cast's backward upcasts, so
the flat gradient that reaches Adam (and the fused kernel, which takes
float32 only) is fp32 under every policy.

Checkpoints (``train.trainer.run_spans``'s hooks, JAX's ``SyncTrainer.train``)
hold the ZeRO-1 moments params-shaped (:meth:`SyncTrainer._opt_for_save`),
the layout-free form, so a save at one topology or layout resumes at any
other, and into the single-device trainer (elastic resume). A resume lays
them back into this rank's padded flat chunk (``coll.from_logical``) as a
fresh contiguous buffer, the layout the fused kernel's launch plan was
built for. As in JAX, the sync steps have no non-finite guard.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping

import numpy as np
import torch

from ..data.mnist import Dataset, one_hot
from ..models import cnn
from ..ops.fused_adam import adam_flat_fused, adam_flat_reference, load_kernel
from ..ops.optimizers import (
    AdamState,
    ShardedAdam,
    adam_init,
    adam_update,
    bias_corrected_lr,
)
from ..parallel import collectives as coll
from ..parallel.layout import LayoutAssignment, assign_layout, fold_shards
from ..parallel.mesh import World
from ..train.config import TrainConfig
from ..convert import params_to_numpy, sharded_adam_from_numpy
from ..train.trainer import (
    StateIO,
    TrainResult,
    check_injector,
    initial_params,
    model_kwargs,
    put_array,
    run_spans,
    staging_dtype,
    steps_span,
    value_and_grad,
)

__all__ = [
    "ShardedAdam",
    "SyncTrainer",
    "make_dp_step",
    "make_sharded_step",
    "make_sync_epoch",
    "resolve_layout",
    "sharded_adam_init",
]


def _adam_flat(p, state: ShardedAdam, g, *, lr, b1=0.9, b2=0.999, eps=1e-8,
               fused=False) -> tuple[torch.Tensor, ShardedAdam]:
    """TF1-semantics Adam on flat slices. ``fused=True`` runs the CUDA
    kernel on a card (its plain version on the CPU) and updates ``p`` and
    the state's ``m``/``v`` buffers in place; the default is the plain
    PyTorch chain, which allocates new ones."""
    step = state.step + 1
    lr_t = bias_corrected_lr(step, lr, b1, b2)
    if fused:
        p, m, v = adam_flat_fused(
            p, state.m, state.v, g, lr_t.reshape(1), b1=b1, b2=b2, eps=eps
        )
    else:
        p, m, v = adam_flat_reference(p, state.m, state.v, g, lr_t, b1=b1, b2=b2, eps=eps)
    return p, ShardedAdam(step=step, m=m, v=v)


def _local_grads(config: TrainConfig, params, x, y, gstep: int, world: World):
    """Per-rank loss and grads, with a rank-distinct dropout stream
    (reference workers use independent masks)."""
    gen = (
        cnn.dropout_generator(config.seed, gstep, world.rank, x.device)
        if config.keep_prob < 1.0 else None
    )
    return value_and_grad(params, x, y, gen, config.keep_prob, **model_kwargs(config))


def make_dp_step(config: TrainConfig, world: World) -> Callable:
    """Pure sync DP: ``step(params, opt, x, y, gstep) -> (params, opt,
    loss)`` with ``x``/``y`` this rank's slice of the global batch."""
    W = world.size
    mean = config.grad_reduction == "mean"

    def step(params, opt_state: AdamState, x, y, gstep: int):
        loss, grads = _local_grads(config, params, x, y, gstep, world)
        with torch.no_grad():
            names = list(grads)
            # One all-reduce over the concatenated grads and the loss.
            flat = coll.all_reduce_sum(
                torch.cat([grads[n].reshape(-1) for n in names] + [loss.reshape(1)]), world
            )
            loss = flat[-1] / W
            if mean:
                flat = flat / W
            sizes = [grads[n].numel() for n in names]
            parts = torch.split(flat[:-1], sizes)
            grads = {n: t.view(grads[n].shape) for n, t in zip(names, parts)}
            params, opt_state = adam_update(
                params, opt_state, grads, lr=config.learning_rate
            )
        return params, opt_state, loss

    return step


def make_sharded_step(
    config: TrainConfig,
    world: World,
    layout: LayoutAssignment,
    shapes: Mapping[str, tuple[int, ...]] | None = None,
) -> Callable:
    """ZeRO-1 sharded sync step: ``step(params, opt, x, y, gstep)``.

      flat grads --reduce_scatter--> owner slice --local Adam-->
      updated slice --all_gather--> full flat params

    "flat" reshapes the padded vector into equal contiguous rows;
    variable-aligned layouts (block/zigzag/lpt) first gather it into
    owner-major padded rows ``[W, max_shard]`` so the row scatter lands
    each rank exactly its owned range."""
    W, rank, dev = world.size, world.rank, world.device
    spec = coll.FlatSpec.from_layout(layout, shapes or dict(cnn.PARAM_SPECS))
    mean = config.grad_reduction == "mean"
    equal_chunks = layout.policy == "flat" and layout.num_shards == W
    chunk = layout.max_shard
    sl = coll.owner_slices(layout, W)
    if equal_chunks:
        my_start = rank * chunk
    else:
        # Static gather maps, placed on the device once.
        rows_index = torch.as_tensor(sl.slice_idx, dtype=torch.long, device=dev)
        reassembly = torch.as_tensor(coll.reassembly_index(layout), dtype=torch.long, device=dev)
        my_start = int(sl.starts[rank])

    def step(params, opt: ShardedAdam, x, y, gstep: int):
        loss, grads = _local_grads(config, params, x, y, gstep, world)
        with torch.no_grad():
            loss = coll.all_reduce_sum(loss.reshape(1), world)[0] / W
            g_flat = coll.flatten_params(grads, spec)
            p_flat = coll.flatten_params(params, spec)
            if equal_chunks:
                g_own = coll.reduce_scatter_flat(g_flat, world, mean=mean, chunk=chunk)
            else:
                g_own = coll.reduce_scatter_rows(g_flat, sl, world, mean=mean, index=rows_index)
            p_own = coll.pad_to(p_flat, sl.pad_len)[my_start : my_start + chunk]
            p_new, opt = _adam_flat(
                p_own, opt, g_own, lr=config.learning_rate, fused=config.fused_adam
            )
            gathered = coll.all_gather_flat(p_new, world)  # [W * chunk]
            full = gathered[: layout.total] if equal_chunks else gathered[reassembly]
        return coll.unflatten_params(full, spec), opt, loss

    return step


def make_sync_epoch(
    config: TrainConfig,
    world: World,
    layout: LayoutAssignment | None,
    shapes: Mapping[str, tuple[int, ...]] | None,
    k: int,
) -> Callable:
    """``k`` consecutive sync steps over this rank's staged batches:
    ``run(params, opt, xs, ys, first, goff) -> (params, opt, mean_loss)``
    (``layout=None`` is DP)."""
    if layout is None:
        step = make_dp_step(config, world)
    else:
        step = make_sharded_step(config, world, layout, shapes)
    return steps_span(step, k)


def sharded_adam_init(world: World, layout: LayoutAssignment) -> ShardedAdam:
    """Zero-initialized ZeRO-1 Adam state: this rank's ``[max_shard]``."""
    z = torch.zeros(layout.max_shard, dtype=torch.float32, device=world.device)
    return ShardedAdam(
        step=torch.zeros((), dtype=torch.int32, device=world.device),
        m=z,
        v=z.clone(),
    )


def resolve_layout(
    config: TrainConfig,
    num_devices: int,
    sizes: dict[str, int] | None = None,
) -> LayoutAssignment | None:
    """Map config topology to a layout: ``num_ps <= 1`` is pure DP (None);
    otherwise the policy over the model's variable table. Shards co-locate
    with the workers (ZeRO), so ``num_ps`` beyond the world size folds
    round-robin onto the ranks (``flat`` re-splits over the world), and
    var-granular policies clamp to one shard per variable."""
    if config.num_ps <= 1:
        return None
    if sizes is None:
        sizes = cnn.param_sizes()
    num_ps = config.num_ps
    if config.layout != "flat":
        num_ps = min(num_ps, len(sizes))
    if num_ps > num_devices:
        if config.layout == "flat":
            return assign_layout("flat", num_devices, list(sizes), sizes)
        base = assign_layout(config.layout, num_ps, list(sizes), sizes)
        return fold_shards(base, num_devices, sizes)
    return assign_layout(config.layout, num_ps, list(sizes), sizes)


class SyncTrainer:
    """Drives any sync strategy on this rank's device: the rank's slice of
    every batch is staged once, and each eval span runs as one host loop
    of steps (``make_sync_epoch``), with the reference's eval-every-10
    cadence. ``world`` is this process's rank of an initialized world
    (``parallel.mesh.init_world``, a world of one included); ``init`` is
    numpy parameters in the JAX layout (``convert``)."""

    def __init__(
        self,
        config: TrainConfig,
        dataset: Dataset,
        world: World,
        init: dict | None = None,
    ):
        self.config = config
        self.dataset = dataset
        self.world = world
        W = self.world.size
        if W != config.num_workers:
            raise ValueError(f"world has {W} ranks, config.num_workers={config.num_workers}")
        self.params = initial_params(config, init, self.world.device)
        self._shapes = cnn.param_shapes(self.params)
        sizes = {k: int(np.prod(s)) if s else 1 for k, s in self._shapes.items()}
        self.layout = resolve_layout(config, W, sizes)
        if self.layout is None:
            self.opt_state: AdamState | ShardedAdam = adam_init(self.params)
        else:
            self.opt_state = sharded_adam_init(self.world, self.layout)
        if config.fused_adam and self.world.device.type == "cuda":
            load_kernel()  # build before any clock starts

    def _stage_epoch(self, batch_num: int) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's batches, ``[B, bs/W, ...]`` (sharded data) or the
        whole ``[B, bs, ...]`` (replicated compat stream)."""
        cfg, ds, world = self.config, self.dataset, self.world
        W, bs = world.size, cfg.batch_size
        n = batch_num * bs
        x = np.asarray(ds.x_train, np.float32)[:n]
        y = one_hot(ds.y_train)[:n]
        fx, fy = x.shape[-1], y.shape[-1]
        if cfg.shard_data:
            pb = cfg.per_worker_batch()
            xs = x.reshape(batch_num, W, pb, fx)[:, world.rank]
            ys = y.reshape(batch_num, W, pb, fy)[:, world.rank]
        else:
            xs = x.reshape(batch_num, bs, fx)
            ys = y.reshape(batch_num, bs, fy)
        dev = world.device
        return (torch.as_tensor(np.ascontiguousarray(xs)).to(dev, staging_dtype(cfg)),
                torch.as_tensor(np.ascontiguousarray(ys)).to(dev))

    def _ckpt_spec(self) -> coll.FlatSpec:
        return coll.FlatSpec.from_layout(self.layout, self._shapes)

    def _opt_like(self):
        """Host template of the checkpointed optimizer state: replicated
        Adam as it is (DP); ZeRO-1 m/v as PARAMS-SHAPED trees, the
        layout-independent form (a flat vector would not be elastic: each
        layout orders the variables differently)."""
        if self.layout is None:
            return self.opt_state
        zeros = {n: np.zeros(s, np.float32) for n, s in self._shapes.items()}
        return ShardedAdam(step=np.zeros((), np.int32), m=zeros,
                           v={n: z.copy() for n, z in zeros.items()})

    def _opt_for_save(self, opt_state):
        """The checkpoint form of the optimizer state (:meth:`_opt_like`):
        every rank's ZeRO-1 chunk all-gathered (a collective: every rank
        calls it), put in logical order (``coll.to_logical``) and
        unflattened."""
        if self.layout is None:
            return opt_state
        spec = self._ckpt_spec()

        def unflat(chunk):
            padded = coll.all_gather_flat(chunk, self.world).cpu().numpy()
            logical = torch.from_numpy(coll.to_logical(padded, self.layout))
            return params_to_numpy(coll.unflatten_params(logical, spec))

        return ShardedAdam(step=np.asarray(int(opt_state.step), np.int32),
                           m=unflat(opt_state.m), v=unflat(opt_state.v))

    def _place_state(self, params, opt_state):
        """Host (checkpoint) state onto this rank: params replicated; Adam
        replicated (DP), or the params-shaped m/v re-flattened in THIS
        layout's order, scattered into the padded owner-major vector
        (``coll.from_logical``) and cut to this rank's chunk, fresh and
        contiguous (``convert.sharded_adam_from_numpy``)."""
        dev = self.world.device
        params = {k: put_array(v, dev) for k, v in params.items()}
        if self.layout is None:
            return params, AdamState(
                step=put_array(opt_state.step, dev),
                m={k: put_array(v, dev) for k, v in opt_state.m.items()},
                v={k: put_array(v, dev) for k, v in opt_state.v.items()})
        spec = self._ckpt_spec()
        chunk = self.layout.max_shard
        mine = slice(self.world.rank * chunk, (self.world.rank + 1) * chunk)

        def refit(tree):
            logical = np.concatenate([np.asarray(tree[n], np.float32).reshape(-1)
                                      for n in spec.order])
            return coll.from_logical(logical, self.layout, self.world.size * chunk)[mine]

        return params, sharded_adam_from_numpy(opt_state.step, refit(opt_state.m),
                                               refit(opt_state.v), dev)

    def state_io(self) -> StateIO:
        """The checkpoint form, JAX's ``{"params", "opt"}`` with
        :meth:`_opt_like`'s optimizer state; rank 0 writes."""
        like = {"params": {k: np.zeros(s, np.float32) for k, s in self._shapes.items()},
                "opt": self._opt_like()}
        return StateIO(
            like=like,
            for_save=lambda p, o: {"params": p, "opt": self._opt_for_save(o)},
            place=lambda tree: self._place_state(tree["params"], tree["opt"]),
            world=self.world,
        )

    def train(
        self,
        log: Callable[[str], None] = print,
        *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume=False,
        should_stop: Callable[[], bool] | None = None,
        dispatch_timeout: float = 0.0,
        fault_injector=None,
        profile_dir: str | None = None,
    ) -> TrainResult:
        """Train ``config.epochs`` epochs; only rank 0 logs. The hooks are
        JAX's ``SyncTrainer.train``'s (``train.trainer.run_spans``), with
        the single-device trainer's retention of the last saves and a
        ``fault_injector`` for the kinds that need no guard (``sigterm``);
        as in JAX, the only telemetry hook is ``profile_dir``, the
        ``torch.profiler`` bracket around the span loop."""
        check_injector(fault_injector, "sync")
        cfg, ds, world = self.config, self.dataset, self.world
        batch_num = ds.num_train // cfg.batch_size
        xs, ys = self._stage_epoch(batch_num)
        dev = world.device
        x_test = torch.as_tensor(np.asarray(ds.x_test, np.float32)).to(dev)
        y_test = torch.as_tensor(one_hot(ds.y_test)).to(dev)
        params = {k: v.clone() for k, v in self.params.items()}
        # The first collective sets up the communicator: do it before the
        # clock starts.
        coll.all_reduce_sum(torch.zeros(1, device=dev), world)
        self.params, self.opt_state, result = run_spans(
            cfg,
            lambda k, guard: make_sync_epoch(cfg, world, self.layout, self._shapes, k),
            params, copy.deepcopy(self.opt_state), xs, ys, x_test, y_test, dev,
            log if world.lead else (lambda s: None), self.state_io(),
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
            should_stop=should_stop, dispatch_timeout=dispatch_timeout,
            fault_injector=fault_injector, profile_dir=profile_dir,
        )
        return result
