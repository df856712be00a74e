"""Asynchronous parameter-server strategies (Hogwild-style staleness) — the
port of ``ddl_tpu/strategies/async_ps.py``.

Reference semantics (mnist_async*, SURVEY.md §3.4): each worker pushes its
gradient when it finishes a batch; the PS applies one Adam step per push,
with no barrier across workers, and replies with fresh parameters to that
worker only. Workers therefore compute gradients against stale parameters.
The arrival order is an explicit **seeded schedule** (:func:`async_schedule`,
the JAX package's, array for array), so async training is deterministic.

One process per worker, joined by a ``torch.distributed`` world (NCCL on
the card, gloo in the CPU test worlds). A **round** is:

1. *island*: every rank computes its loss and gradient against its own
   stale replica;
2. *serve*: the W pushes in schedule order, each one TF1 Adam step
   (:func:`_adam_push`) through ``ops/fused_adam.py::adam_flat_fused``: the
   hand-written CUDA kernel on the card, its plain version on the CPU.
   Worker ``w``'s replica refreshes right after its own push
   (mnist_async/parameter_server.py:67-69).

Two serve placements, as in the JAX package:

- **replicated** (``layout=None``; the one-worker path and the oracle of
  the tests): every rank holds the full ``ps``/``m``/``v`` and the ``[W,
  total]`` replica matrix, all-gathers the W gradients and runs the same W
  pushes on the full vector.
- **sharded** (``mnist_async_sharding[_greedy]``): every rank holds its own
  ``[chunk]`` of ``ps``/``m``/``v`` (owner-major, as ``OwnerSlices`` lays it
  out) and its own replica row ``[total]``. One ``all_to_all`` sends every
  worker's gradient slices to their owners, each rank serves the schedule
  on its chunk, and a second ``all_to_all`` returns each worker its
  refreshed replica pieces. Adam is elementwise, so the sharded serve is
  bit-identical to the replicated one.

The kernel updates ``ps``, ``m`` and ``v`` in place, so every value the JAX
package keeps across pushes is a copy here: a replica row, the chunk after
each push. The schedule is read on the host; the serve is a Python loop of
W pushes. The island's compute dtype and patches-matmul stages are the
single-device step's (``train.trainer.model_kwargs``); its gradients, and
so every push, stay fp32 under every precision policy.

Resilience (JAX's ``AsyncTrainer.train`` hooks): a checkpoint at every
epoch end and every ``checkpoint_every`` rounds holds JAX's ``AsyncState``
in its device layout (``ps``/``m``/``v`` as the serve lays them out,
``workers`` ``[W, total]``, ``t``), moved through
``convert.async_state_to_numpy``/``from_numpy``; a resume realigns onto
this run's chunk grid; preemption and saves fall at round-chunk
boundaries; the dispatch watchdog covers each chunk. The restored serve
vectors are fresh contiguous buffers, which the fused kernel updates in
place. As in JAX, the async trainer has no non-finite guard, and its one
telemetry hook is the profiler bracket (``profile_dir``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Mapping

import numpy as np
import torch

from ..convert import async_state_from_numpy, async_state_to_numpy, params_to_numpy
from ..data.mnist import Dataset, one_hot
from ..models import cnn
from ..ops.fused_adam import adam_flat_fused, load_kernel
from ..ops.optimizers import bias_corrected_lr
from ..parallel import collectives as coll
from ..parallel.layout import LayoutAssignment, assign_layout
from ..parallel.mesh import World
from ..train.config import TrainConfig
from ..train.trainer import (
    TrainResult,
    check_injector,
    CHECKPOINT_KEEP,
    check_preempt,
    checkpoint_file,
    correct_total,
    evaluate,
    guarded,
    hit_target,
    initial_params,
    model_kwargs,
    save_crossed,
    staging_dtype,
    try_resume,
    value_and_grad,
)
from ..utils.checkpoint import save_checkpoint_world
from ..utils.metrics import StepTimer, barrier, trace
from .sync import resolve_layout

__all__ = [
    "AsyncState",
    "AsyncTrainer",
    "async_schedule",
    "async_state_init",
    "make_async_round",
    "make_worker_eval",
    "serve_layout_for",
]


def _flat_spec(
    layout: LayoutAssignment | None,
    shapes: Mapping[str, tuple[int, ...]] | None = None,
) -> coll.FlatSpec:
    """FlatSpec in the layout's order, or creation order when unsharded.
    ``shapes`` defaults to the flagship CNN's variable table."""
    if shapes is None:
        shapes = dict(cnn.PARAM_SPECS)
    if layout is None:
        sizes = {k: math.prod(s) for k, s in shapes.items()}
        layout = assign_layout("flat", 1, list(shapes), sizes)
    return coll.FlatSpec.from_layout(layout, shapes)


def async_schedule(seed: int, num_workers: int, rounds: int) -> np.ndarray:
    """Deterministic arrival order: ``[rounds, W]`` int32, each row a seeded
    permutation of worker ids — the schedule that replaces the reference's
    ANY_SOURCE arrival race (mnist_async/parameter_server.py:57-58)."""
    rng = np.random.default_rng(np.random.PCG64(seed))
    return np.stack(
        [rng.permutation(num_workers).astype(np.int32) for _ in range(rounds)]
    )


def _adam_push(p, m, v, t, g, *, lr, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """One per-push TF1 Adam step on flat float32 vectors, in place: ``t``
    (the int32 update counter) goes up by one first, then ``p``, ``m`` and
    ``v`` take the step (the async PS applies each worker's raw gradient as
    its own step, mnist_async/parameter_server.py:34-35)."""
    t += 1
    lr_t = bias_corrected_lr(t, lr, b1, b2).reshape(1)
    adam_flat_fused(p, m, v, g, lr_t, b1=b1, b2=b2, eps=eps)


@dataclasses.dataclass
class AsyncState:
    """This rank's serve state. ``ps``/``m``/``v`` are the full flat vectors
    (replicated serve) or this rank's ``[chunk]`` (sharded serve);
    ``workers`` is the ``[W, total]`` replica matrix (replicated) or this
    worker's own row as ``[1, total]`` (sharded); ``t`` is the global update
    counter, an int32 scalar."""

    ps: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    workers: torch.Tensor
    t: torch.Tensor

    def clone(self) -> "AsyncState":
        return AsyncState(*(x.clone() for x in dataclasses.astuple(self)))

    def replica(self, rank: int) -> torch.Tensor:
        """This rank's stale replica ``[total]``."""
        return self.workers[rank if self.workers.shape[0] > 1 else 0]


def _gather_full(flat: torch.Tensor, world: World, reassembly: torch.Tensor | None):
    """A serve vector as the full logical ``[total]`` vector: this rank's
    chunks all-gathered and reassembled (sharded), or a copy (replicated)."""
    if reassembly is None:
        return flat.clone()
    return coll.all_gather_flat(flat, world)[reassembly]


def _reassembly(layout: LayoutAssignment | None, device) -> torch.Tensor | None:
    if layout is None:
        return None
    return torch.as_tensor(coll.reassembly_index(layout), dtype=torch.long, device=device)


def make_async_round(
    config: TrainConfig,
    world: World,
    layout: LayoutAssignment | None,
    shapes: Mapping[str, tuple[int, ...]] | None = None,
) -> Callable:
    """The multi-round async program of this rank:
    ``run(state, xs, ys, scheds, round0) -> (state, ps_full, mean_loss)``
    with ``xs``/``ys`` this rank's ``[R, bs, ...]`` batches of R rounds,
    ``scheds`` the ``[R, W]`` arrival orders (numpy) and ``round0`` the
    global index of the first round (the dropout stream's position).
    ``state`` is updated in place and returned; ``ps_full`` is the logical
    flat parameter vector after the last round (for eval)."""
    W, rank, dev = world.size, world.rank, world.device
    spec = _flat_spec(layout, shapes)
    lr = config.learning_rate
    sharded = layout is not None
    reassembly = _reassembly(layout, dev)
    model_kw = model_kwargs(config)
    if sharded:
        sl = coll.owner_slices(layout, W)
        rows_index = torch.as_tensor(sl.slice_idx, dtype=torch.long, device=dev)

    def grad_one(replica, x, y, ground: int):
        # A copy of each variable: its alignment, and with it the conv
        # library's choice of algorithm, must not depend on where the
        # layout puts it (the sharded serve is bit-identical to the
        # replicated one).
        params = {k: p.clone() for k, p in coll.unflatten_params(replica, spec).items()}
        gen = (
            cnn.dropout_generator(config.seed, ground, rank, dev)
            if config.keep_prob < 1.0 else None
        )
        loss, grads = value_and_grad(params, x, y, gen, config.keep_prob, **model_kw)
        loss = coll.all_reduce_sum(loss.reshape(1), world)[0] / W
        return loss, coll.flatten_params(grads, spec)

    def replicated_round(state: AsyncState, x, y, sched, ground: int):
        loss, g = grad_one(state.replica(rank), x, y, ground)
        G = coll.all_gather_rows(g, world)  # [W, total]
        for w in sched:
            _adam_push(state.ps, state.m, state.v, state.t, G[w], lr=lr)
            state.workers[w].copy_(state.ps)
        return loss

    def sharded_round(state: AsyncState, x, y, sched, ground: int):
        loss, g = grad_one(state.replica(rank), x, y, ground)
        # Every worker's gradient slice for MY shard: [W(workers), chunk].
        G = coll.all_to_all_rows(coll.owner_rows(g, sl, rows_index), world)
        per_worker = torch.empty_like(G)  # my chunk right after w's push
        for w in sched:
            _adam_push(state.ps, state.m, state.v, state.t, G[w], lr=lr)
            per_worker[w].copy_(state.ps)
        # My replica's pieces from every shard: [W(shards), chunk].
        pieces = coll.all_to_all_rows(per_worker, world)
        state.workers[0].copy_(pieces.reshape(-1)[reassembly])
        return loss

    round_fn = sharded_round if sharded else replicated_round

    def run(state: AsyncState, xs, ys, scheds, round0: int):
        losses = [
            round_fn(state, xs[i], ys[i], [int(w) for w in scheds[i]], round0 + i)
            for i in range(len(scheds))
        ]
        ps_full = _gather_full(state.ps, world, reassembly)
        return state, ps_full, torch.stack(losses).mean()

    return run


def serve_layout_for(
    config: TrainConfig, num_devices: int, sizes: dict[str, int] | None = None
) -> LayoutAssignment | None:
    """Serve placement: the user's resolved layout, or — for the
    ``num_ps <= 1`` "one PS" on a world of several ranks — an equal-chunk
    flat layout that routes the serve through the sharded ``all_to_all``
    machinery (O(total) work and memory a rank instead of O(W * total);
    bit-identical, since Adam is elementwise). W = 1 keeps the replicated
    path."""
    layout = resolve_layout(config, num_devices, sizes)
    if layout is None and num_devices > 1:
        if sizes is None:
            sizes = cnn.param_sizes()
        layout = assign_layout("flat", num_devices, list(sizes), sizes)
    return layout


def make_worker_eval(world: World, spec: coll.FlatSpec) -> Callable:
    """Per-worker stale-replica accuracy: each rank scores its own replica
    on the test set (the reference's async workers each print accuracy
    from their own stale parameters, mnist_async/worker.py:71-75).

    Returns ``(replica, x_test, y_test) -> [W]`` int64 correct counts, one
    a worker in rank order, the same on every rank (an all-gather of W
    scalars)."""

    def counts(replica, x_test, y_test, batch: int = 2000) -> torch.Tensor:
        c = correct_total(coll.unflatten_params(replica, spec), x_test, y_test, batch)
        return coll.all_gather_rows(c.reshape(1), world).reshape(-1)

    return counts


def async_state_init(
    config: TrainConfig,
    world: World,
    layout: LayoutAssignment | None,
    params: Mapping[str, torch.Tensor],
) -> AsyncState:
    """Initial async state of this rank: PS params = worker replicas =
    ``params``, zero moments, ``t = 0``."""
    W, dev = world.size, world.device
    spec = _flat_spec(layout, cnn.param_shapes(params))
    flat = coll.flatten_params(params, spec).to(device=dev, dtype=torch.float32)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    if layout is None:
        ps, workers = flat.clone(), flat.repeat(W, 1)
    else:
        sl = coll.owner_slices(layout, W)
        index = torch.as_tensor(sl.slice_idx[world.rank], dtype=torch.long, device=dev)
        ps, workers = coll.pad_to(flat, sl.pad_len)[index], flat[None].clone()
    return AsyncState(ps=ps, m=torch.zeros_like(ps), v=torch.zeros_like(ps),
                      workers=workers, t=t)


class AsyncTrainer:
    """Drives the async strategies (``mnist_async*`` parity) with the
    deterministic seeded schedule, on this rank's device. ``world`` is this
    process's rank of an initialized world (``parallel.mesh.init_world``, a
    world of one included); ``init`` is numpy parameters in the JAX layout.

    Push-count accounting: with ``shard_data=False`` (the
    ``--reference-compat`` stream) an epoch is ``num_train // batch_size``
    rounds of W pushes — the reference's one-epoch push count, every worker
    iterating the full train set (mnist_async/worker.py:27-30,41). The
    default ``shard_data=True`` consumes each example once an epoch:
    ``num_train // (batch_size * W)`` rounds."""

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
        W = world.size
        if W != config.num_workers:
            raise ValueError(f"world has {W} ranks, config.num_workers={config.num_workers}")
        params = initial_params(config, init, world.device)
        shapes = cnn.param_shapes(params)
        sizes = {k: math.prod(s) for k, s in shapes.items()}
        self.serve_layout = serve_layout_for(config, W, sizes)
        self.state = async_state_init(config, world, self.serve_layout, params)
        self.spec = _flat_spec(self.serve_layout, shapes)
        self._reassembly = _reassembly(self.serve_layout, world.device)
        self._run = make_async_round(config, world, self.serve_layout, shapes)
        self._worker_eval = make_worker_eval(world, self.spec)

    def logical(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """A serve vector of this rank (``ps``, ``m`` or ``v``) as the full
        variable dict; on a world of several ranks with a sharded serve it
        is a collective: every rank calls it."""
        return coll.unflatten_params(_gather_full(flat, self.world, self._reassembly), self.spec)

    def _eval_workers(self, state: AsyncState, x_test, y_test) -> list[float]:
        """Accuracy of every worker's stale replica, in rank order."""
        counts = self._worker_eval(state.replica(self.world.rank), x_test, y_test)
        return [int(c) / x_test.shape[0] for c in counts.tolist()]

    def _batches(self) -> tuple[np.ndarray, np.ndarray, int]:
        """This rank's train batches, ``[rounds, bs, ...]``: its contiguous
        1/W slice of the train set (sharded data), or every batch (the
        replicated compat stream)."""
        cfg, ds, rank = self.config, self.dataset, self.world.rank
        W, bs = cfg.num_workers, cfg.batch_size
        x = np.asarray(ds.x_train, np.float32)
        y = one_hot(ds.y_train)
        need = bs * W if cfg.shard_data else bs  # examples a round
        rounds = ds.num_train // need
        if rounds < 1:
            raise ValueError(
                f"dataset too small for async training: {ds.num_train} train "
                f"examples < one round ({need} = batch_size"
                f"{' * num_workers' if cfg.shard_data else ''})"
            )
        if cfg.shard_data:
            n = rounds * bs * W
            xs = x[:n].reshape(W, rounds, bs, x.shape[-1])[rank]
            ys = y[:n].reshape(W, rounds, bs, y.shape[-1])[rank]
        else:
            n = rounds * bs
            xs = x[:n].reshape(rounds, bs, x.shape[-1])
            ys = y[:n].reshape(rounds, bs, y.shape[-1])
        return np.ascontiguousarray(xs), np.ascontiguousarray(ys), rounds

    def _state_for_save(self, state: AsyncState) -> AsyncState:
        """The checkpoint form: JAX's global ``AsyncState`` as numpy (every
        rank's chunks and replica rows gathered: a collective at W > 1,
        which every rank calls)."""
        W, sharded = self.world.size, self.serve_layout is not None
        if sharded and W > 1:
            ranks = [AsyncState(*parts, t=state.t) for parts in zip(
                *(coll.all_gather_flat(x, self.world).view(W, -1)
                  for x in (state.ps, state.m, state.v)),
                coll.all_gather_flat(state.workers.reshape(-1), self.world).view(W, 1, -1))]
        else:
            ranks = [state]
        return AsyncState(**async_state_to_numpy(ranks, sharded=sharded))

    def _state_like(self) -> AsyncState:
        """Template of the checkpoint form: the global shapes, ``t`` int32."""
        W, s = self.world.size, self.state
        rows = W if self.serve_layout is not None else 1
        z = lambda t: np.zeros((t.shape[0] * rows,), np.float32)  # noqa: E731
        return AsyncState(ps=z(s.ps), m=z(s.m), v=z(s.v),
                          workers=np.zeros((W, s.workers.shape[1]), np.float32),
                          t=np.zeros((), np.int32))

    def _place_state(self, host: AsyncState) -> AsyncState:
        """Host (checkpoint) state onto this rank: its chunk and replica
        row (sharded serve) or everything (replicated), fresh buffers."""
        return async_state_from_numpy(host, self.world.rank, self.world.size,
                                      sharded=self.serve_layout is not None,
                                      device=self.world.device)

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
        """Train ``config.epochs`` epochs in round chunks of ``eval_every``
        rounds, each followed by the PS eval and the per-worker eval; only
        rank 0 logs. Checkpoints count rounds (``checkpoint_every``); a
        resume lands on the chunk grid (module docstring);
        ``fault_injector`` takes the kinds that need no guard
        (``sigterm``); ``profile_dir`` runs the rounds, after the warm-up,
        under ``torch.profiler`` (``utils.metrics.trace``), as JAX's
        ``AsyncTrainer.train`` (its only telemetry hook)."""
        check_injector(fault_injector, "async")
        cfg, world = self.config, self.world
        W, dev = world.size, world.device
        log = log if world.lead else (lambda s: None)
        xs_np, ys_np, rounds = self._batches()
        xs = torch.as_tensor(xs_np).to(dev, staging_dtype(cfg))
        ys = torch.as_tensor(ys_np).to(dev)
        x_test = torch.as_tensor(np.asarray(self.dataset.x_test, np.float32)).to(dev)
        y_test = torch.as_tensor(one_hot(self.dataset.y_test)).to(dev)
        state = self.state.clone()
        ckpt = checkpoint_file(checkpoint_dir)
        tree, start_round = try_resume(ckpt, resume, {"state": self._state_like()}, log)
        if tree is not None:
            state = self._place_state(tree["state"])
        chunk_rounds = cfg.eval_every or rounds

        def chunks_from(start: int) -> list[tuple[int, int]]:
            """Round chunks from ``start``, realigned to this run's grid
            (multiples of ``chunk_rounds``): a resume may land mid-chunk
            when the saving run used another cadence; every remaining
            round runs, none is skipped."""
            out, lo = [], start
            while lo < rounds:
                hi = min(rounds, (lo // chunk_rounds + 1) * chunk_rounds)
                out.append((lo, hi))
                lo = hi
            return out

        chunks = chunks_from(0)
        resume_epoch, resume_lo = divmod(start_round, rounds) if rounds else (0, 0)
        resume_chunks = chunks_from(resume_lo) if resume_lo else chunks

        # Warm-up outside the clock: the first collective (sets up the
        # communicator), the kernel build, one discarded forward/backward
        # with the rounds' dropout (a throwaway generator) and one eval of
        # each kind; the state is not touched.
        t0 = time.perf_counter()
        coll.all_reduce_sum(torch.zeros(1, device=dev), world)
        if dev.type == "cuda":
            load_kernel()
        gen = (cnn.dropout_generator(cfg.seed, 0, world.rank, dev)
               if cfg.keep_prob < 1.0 else None)
        value_and_grad(coll.unflatten_params(state.replica(world.rank), self.spec),
                       xs[0], ys[0], gen, cfg.keep_prob, **model_kwargs(cfg))
        if x_test.shape[0]:
            evaluate(self.logical(state.ps), x_test, y_test)
            if cfg.eval_every:
                self._eval_workers(state, x_test, y_test)
        barrier(dev)
        warmup = time.perf_counter() - t0

        history: list[tuple[int, int, float]] = []
        worker_history: list[tuple[int, int, list[float]]] = []
        losses = []  # device tensors, fetched after the loop
        timer = StepTimer()
        stopped = preempted = False
        span_idx = 0
        ps_full = None

        def dispatch(lo, hi, sched, ground):
            out = self._run(state, xs[lo:hi], ys[lo:hi], sched, ground)
            barrier(dev)
            return out

        start = time.perf_counter()
        with trace(profile_dir, dev):
            for epoch in range(cfg.epochs):
                scheds = async_schedule(cfg.staleness_seed + epoch, W, rounds)
                for lo, hi in (resume_chunks if epoch == resume_epoch else chunks):
                    ground = epoch * rounds + lo
                    if ground < start_round:
                        continue  # already done by the resumed run
                    span_idx += 1
                    with timer.step(images=cfg.batch_size * W * (hi - lo)):
                        state, ps_full, loss = guarded(
                            lambda: dispatch(lo, hi, scheds[lo:hi], ground), dispatch_timeout,
                            f"round dispatch at global round {ground}")
                    losses.append(loss)
                    if cfg.eval_every:
                        acc = guarded(
                            lambda: evaluate(coll.unflatten_params(ps_full, self.spec), x_test,
                                             y_test),
                            dispatch_timeout, f"eval after round {lo}")
                        history.append((epoch, lo, acc))
                        log(f"epoch: {epoch} round: {lo} accuracy: {acc}")
                        # Each worker's stale-replica accuracy: the spread shows
                        # the staleness.
                        waccs = guarded(lambda: self._eval_workers(state, x_test, y_test),
                                        dispatch_timeout, f"worker eval after round {lo}")
                        worker_history.append((epoch, lo, waccs))
                        log("worker accuracies: " + " ".join(f"{a:.4f}" for a in waccs))
                        stopped = hit_target(cfg, acc)
                    if fault_injector is not None:
                        fault_injector.maybe_sigterm(epoch * rounds + hi)
                    preempted = preempted or check_preempt(should_stop, log, ckpt is not None,
                                                           span_idx)
                    if ckpt and save_crossed(ground, hi - lo, checkpoint_every,
                                             hi == rounds or stopped or preempted):
                        save_checkpoint_world(ckpt, {"state": self._state_for_save(state)},
                                              world=world, step=epoch * rounds + hi,
                                              extra={"epoch": epoch}, keep=CHECKPOINT_KEEP)
                    if stopped or preempted:
                        break
                if stopped:
                    log(f"target accuracy {cfg.target_accuracy} reached")
                if stopped or preempted:
                    break
        end = time.perf_counter()
        params = (coll.unflatten_params(ps_full, self.spec) if ps_full is not None
                  else self.logical(state.ps))  # a fully resumed run runs no round
        final_acc = guarded(lambda: evaluate(params, x_test, y_test), dispatch_timeout,
                            "final eval")
        log(f"final accuracy: {final_acc}")
        self.state = state
        train_time = timer.total_s
        return TrainResult(
            params=params_to_numpy(params),
            final_accuracy=final_acc,
            wall_time_s=end - start,
            train_time_s=train_time,
            history=history,
            images_per_sec=timer.total_images / train_time if train_time > 0 else 0.0,
            compile_time_s=warmup,
            step_stats=timer.stats(),
            resumed_from_step=start_round,
            preempted=preempted,
            span_losses=[float(x) for x in losses],
            worker_history=worker_history,
        )
