"""Single-device trainer — the port of ``ddl_tpu/train/trainer.py``.

Reproduces the reference's ``single.py`` loop (mnist_sync/single.py:10-21):
sequential mini-batches, full-test-set accuracy every ``eval_every``
batches and at exit. The epoch is staged on the device once; each eval
span of ``k`` steps runs as one host loop over the staged batches (the
JAX package compiles a span into one ``lax.scan``; a CUDA graph is the
port's later counterpart) and closes with a device barrier, which is what
the step timer measures.

The dropout stream is a pure function of ``(seed, global step, worker)``
(``cnn.dropout_generator``), so span chunking never changes the masks.
Checkpoint, guard, health, goodput and profile hooks are not ported yet
(ROADMAP queue 1, items 5 and 7).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..convert import params_from_numpy, params_to_numpy
from ..data.mnist import Dataset, one_hot
from ..models import cnn
from ..ops.optimizers import AdamState, adam_init, adam_update
from ..parallel.mesh import default_device
from ..utils.metrics import StepStats, StepTimer, barrier
from .config import TrainConfig

# A train step: (params, opt_state, x, y_onehot, global_step) ->
# (params', opt_state', loss).
Step = Callable[[dict, object, torch.Tensor, torch.Tensor, int], tuple]


@dataclasses.dataclass
class TrainResult:
    params: dict  # numpy arrays, JAX storage layout
    final_accuracy: float
    wall_time_s: float  # total, including periodic evals
    train_time_s: float  # span time only; evals and warm-up excluded
    history: list[tuple[int, int, float]]  # (epoch, batch, accuracy)
    images_per_sec: float  # images / train_time_s
    compile_time_s: float = 0.0  # warm-up before the clock (no compiler here)
    step_stats: StepStats | None = None  # per-span time percentiles
    span_losses: list[float] = dataclasses.field(default_factory=list)  # mean loss per span
    # Async only: (epoch, round, [accuracy of each worker's stale replica])
    # per eval point. None for the sync and single trainers.
    worker_history: list[tuple[int, int, list[float]]] | None = None


def value_and_grad(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    y: torch.Tensor,
    gen: torch.Generator | None,
    keep_prob: float,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Loss and the gradient of every parameter (``jax.value_and_grad`` of
    ``cnn.loss_fn``)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = cnn.loss_fn(leaves, x, y, dropout_gen=gen, keep_prob=keep_prob)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(config: TrainConfig) -> Step:
    """The single-device train step: forward/backward, then TF1 Adam."""

    def step(params, opt_state: AdamState, x, y, gstep: int):
        gen = (
            cnn.dropout_generator(config.seed, gstep, 0, x.device)
            if config.keep_prob < 1.0 else None
        )
        loss, grads = value_and_grad(params, x, y, gen, config.keep_prob)
        with torch.no_grad():
            params, opt_state = adam_update(
                params, opt_state, grads, lr=config.learning_rate
            )
        return params, opt_state, loss

    return step


def steps_span(step: Step, k: int) -> Callable:
    """``k`` consecutive steps over device-resident batches:
    ``(params, opt, xs, ys, first, goff) -> (params, opt, mean_loss)``,
    with ``xs``/``ys`` ``[B, bs, ...]``, ``first`` the span's first batch
    and ``goff`` its first global step (the dropout stream's position)."""

    def run(params, opt_state, xs, ys, first: int, goff: int):
        losses = []
        for i in range(k):
            params, opt_state, loss = step(
                params, opt_state, xs[first + i], ys[first + i], goff + i
            )
            losses.append(loss)
        return params, opt_state, torch.stack(losses).mean()

    return run


def make_epoch_chunk(config: TrainConfig, k: int) -> Callable:
    """The single-device ``k``-step span program (see :func:`steps_span`)."""
    return steps_span(make_train_step(config), k)


def eval_spans(batch_num: int, eval_every: int) -> list[tuple[int, int, bool]]:
    """Chunk an epoch into ``(first_batch, num_batches, eval_after)`` spans
    ending at the reference's eval points: after batches 0, 10, 20, ...
    (mnist_sync/worker.py:71-72), plus a no-eval tail."""
    if batch_num <= 0:
        return []
    if not eval_every:
        return [(0, batch_num, False)]
    spans = []
    first = 0
    while first < batch_num:
        if first == 0:
            last = 0
        else:
            last = min(
                ((first - 1) // eval_every + 1) * eval_every, batch_num - 1
            )
        spans.append((first, last - first + 1, last % eval_every == 0))
        first = last + 1
    return spans


def eval_chunks(x, y, batch: int):
    """``(whole, tail)``: whole ``[C, batch, ...]`` chunks (None when the
    set is smaller than one chunk) and the ragged remainder (None when it
    divides evenly)."""
    n = x.shape[0]
    C, rem = divmod(n, batch)
    whole = (
        x[: C * batch].reshape(C, batch, *x.shape[1:]),
        y[: C * batch].reshape(C, batch, *y.shape[1:]),
    ) if C else None
    tail = (x[C * batch :], y[C * batch :]) if rem else None
    return whole, tail


@torch.no_grad()
def correct_total(
    params: dict, x_test: torch.Tensor, y_test_onehot: torch.Tensor, batch: int = 2000
) -> torch.Tensor:
    """Top-1 hits on the test set in chunks of ``batch`` (bounds activation
    memory), summed on the device: an int64 scalar tensor."""
    whole, tail = eval_chunks(x_test, y_test_onehot, batch)
    correct = torch.zeros((), dtype=torch.int64, device=x_test.device)
    if whole is not None:
        for x, y in zip(*whole):
            correct += cnn.correct_count(params, x, y)
    if tail is not None:
        correct += cnn.correct_count(params, *tail)
    return correct


def evaluate(
    params: dict, x_test: torch.Tensor, y_test_onehot: torch.Tensor, batch: int = 2000
) -> float:
    """Full-test-set accuracy; the count reaches the host in ONE fetch."""
    return int(correct_total(params, x_test, y_test_onehot, batch)) / x_test.shape[0]


def hit_target(config: TrainConfig, accuracy: float) -> bool:
    return config.target_accuracy is not None and accuracy >= config.target_accuracy


def initial_params(config: TrainConfig, init, device: torch.device) -> dict:
    """``init`` (numpy arrays in the JAX layout, e.g. a JAX run's params)
    placed through ``convert``, or a fresh glorot init from ``config.seed``."""
    specs = config.model_specs()
    if init is not None:
        return params_from_numpy(init, device, specs)
    gen = torch.Generator().manual_seed(config.seed)
    return cnn.init_params(gen, device, specs)


def run_spans(
    config: TrainConfig,
    span_fn: Callable[[int], Callable],
    params,
    opt_state,
    xs: torch.Tensor,
    ys: torch.Tensor,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    device: torch.device,
    log: Callable[[str], None],
):
    """The span loop every trainer shares: warm up, then run each epoch's
    eval spans, timing each one to a device barrier, with the reference's
    eval cadence and the early-stop target. ``span_fn(k)`` gives the
    ``k``-step span program. Returns ``(params, opt_state, TrainResult)``
    with ``params`` still on the device (``result.params`` is numpy)."""
    batch_num = xs.shape[0]
    spans = eval_spans(batch_num, config.eval_every)
    fns = {k: span_fn(k) for k in {k for _, k, _ in spans}}
    # Warm-up outside the clock (the JAX package compiles here): one
    # forward/backward on the first batch (discarded) and one eval load the
    # library handles and kernels; the state is not touched.
    t0 = time.perf_counter()
    if batch_num:
        value_and_grad(params, xs[0], ys[0], None, 1.0)
    if x_test.shape[0]:
        evaluate(params, x_test, y_test)
    barrier(device)
    warmup = time.perf_counter() - t0
    history: list[tuple[int, int, float]] = []
    losses = []  # device tensors, fetched after the loop
    timer = StepTimer()
    stopped = False
    start = time.perf_counter()
    for epoch in range(config.epochs):
        for first, k, eval_after in spans:
            gstep = epoch * batch_num + first
            with timer.step(images=k * config.batch_size):
                params, opt_state, loss = fns[k](params, opt_state, xs, ys, first, gstep)
                barrier(device)
            losses.append(loss)
            if eval_after:
                cnt = first + k - 1
                acc = evaluate(params, x_test, y_test)
                history.append((epoch, cnt, acc))
                log(f"epoch: {epoch} batch: {cnt} accuracy: {acc}")
                stopped = hit_target(config, acc)
            if stopped:
                break
        if stopped:
            log(f"target accuracy {config.target_accuracy} reached")
            break
    end = time.perf_counter()
    final_acc = evaluate(params, x_test, y_test)
    log(f"final accuracy: {final_acc}")
    train_time = timer.total_s
    return params, opt_state, TrainResult(
        params=params_to_numpy(params),
        final_accuracy=final_acc,
        wall_time_s=end - start,
        train_time_s=train_time,
        history=history,
        images_per_sec=timer.total_images / train_time if train_time > 0 else 0.0,
        compile_time_s=warmup,
        step_stats=timer.stats(),
        span_losses=[float(x) for x in losses],
    )


class SingleChipTrainer:
    """``single.py``-equivalent training on one device (``cuda`` unless
    ``device="cpu"``), device-resident: the train set is staged once and
    each eval span runs as one host loop of steps (see module docstring)."""

    def __init__(
        self,
        config: TrainConfig,
        dataset: Dataset,
        init: dict | None = None,
        device: str | torch.device | None = None,
    ):
        self.config = config
        self.dataset = dataset
        self.device = default_device(device)
        self.params = initial_params(config, init, self.device)
        self.opt_state = adam_init(self.params)

    def train(self, log: Callable[[str], None] = print) -> TrainResult:
        cfg, ds, dev = self.config, self.dataset, self.device
        bs = cfg.batch_size
        batch_num = ds.num_train // bs
        n = batch_num * bs
        # Sequential batching, no shuffle (single.py:14-15).
        # Explicit feature dims: batch_num may be 0 (dataset < one batch).
        x = np.asarray(ds.x_train, np.float32)[:n]
        y = one_hot(ds.y_train)[:n]
        xs = torch.as_tensor(x.reshape(batch_num, bs, x.shape[-1])).to(dev)
        ys = torch.as_tensor(y.reshape(batch_num, bs, y.shape[-1])).to(dev)
        x_test = torch.as_tensor(np.asarray(ds.x_test, np.float32)).to(dev)
        y_test = torch.as_tensor(one_hot(ds.y_test)).to(dev)
        params = {k: v.clone() for k, v in self.params.items()}
        self.params, self.opt_state, result = run_spans(
            cfg, lambda k: make_epoch_chunk(cfg, k), params, copy.deepcopy(self.opt_state),
            xs, ys, x_test, y_test, dev, log,
        )
        return result
