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
The compute dtype and the conv stages run as patches-matmuls come from the
config (``TrainConfig.policy()``, ``conv_matmul_mode()``); under bf16
compute the train images are staged in bf16 (:func:`staging_dtype`).

The span loop (:func:`run_spans`, shared by ``SingleChipTrainer`` and
``SyncTrainer``) carries JAX's resilience hooks: a checkpoint at every epoch
end and every ``checkpoint_every`` steps (``utils/checkpoint.py``, the
format both packages read), resume (``"auto"`` skips corrupt saves) realigned
onto this run's span grid (:func:`resume_plan`), graceful preemption
(:func:`check_preempt`, agreed over the world), the dispatch watchdog
(:func:`guarded`), and on the single-device step, as in JAX, the non-finite
guard with rollback (``resilience/guard.py``) and the fault injector.

Telemetry, as JAX's span loop records it (``obs/``), only while a metric
registry is passed (``metrics``): the non-finite gradient count of every
step and the health norms of the last step of each span that crosses
``metrics_interval`` (``obs.health``), ``train_mfu`` against the device's
peak (``obs.cost``), the comms roofline from the per-program collective
ledger (``obs.comms``), the goodput phases (``obs.goodput``), memory
watermarks, the anomaly feed, and ``train/span`` / ``train/eval`` spans
on a ``tracer``. ``profile_dir`` brackets the span loop, after the warm-up,
with ``torch.profiler`` (``utils.metrics.trace``). With ``metrics=None`` a
step does exactly its work: no health op, no tally, no clock read.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..convert import params_from_numpy, params_to_numpy
from ..data.mnist import Dataset, one_hot
from ..models import cnn
from ..ops.optimizers import AdamState, adam_init, adam_update
from ..parallel import collectives as coll
from ..parallel import multihost
from ..parallel.mesh import AcceleratorTimeout, World, default_device, run_within
from ..utils.checkpoint import load_checkpoint, save_checkpoint_world
from ..obs import health as hlt
from ..obs.health import HEALTH_COUNT, HEALTH_FULL, HEALTH_OFF
from ..utils.metrics import StepStats, StepTimer, barrier, trace
from .config import TrainConfig

# A train step: (params, opt_state, x, y_onehot, global_step[, health]) ->
# (params', opt_state', loss[, health dict][, skipped]).
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
    resumed_from_step: int = 0  # global step restored from a checkpoint (0 = fresh)
    preempted: bool = False  # stopped early by should_stop (e.g. SIGTERM)
    skipped_steps: int = 0  # updates skipped by the non-finite guard
    rollbacks: int = 0  # guard escalations to the last good checkpoint
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
    **model_kw,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Loss and the gradient of every parameter (``jax.value_and_grad`` of
    ``cnn.loss_fn``); ``model_kw`` are ``loss_fn``'s ``compute_dtype`` and
    ``conv_matmul`` (:func:`model_kwargs`). The gradients have the
    parameters' dtype whatever the compute dtype (the cast's backward
    upcasts them)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = cnn.loss_fn(leaves, x, y, dropout_gen=gen, keep_prob=keep_prob, **model_kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def model_kwargs(config: TrainConfig) -> dict:
    """``cnn.loss_fn``'s compute dtype (from the precision policy) and
    patches-matmul stages (``conv_matmul_mode``) under ``config``; an
    unknown mode raises (a bad policy or dtype raised in ``TrainConfig``)."""
    mode = config.conv_matmul_mode()
    if mode not in cnn.CONV_MATMUL_MODES:
        raise ValueError(f"unknown conv_matmul mode {mode!r} "
                         f"(choices: {', '.join(cnn.CONV_MATMUL_MODES)})")
    return dict(compute_dtype=config.policy().compute_dtype, conv_matmul=mode)


def staging_dtype(config: TrainConfig) -> torch.dtype:
    """The dtype the TRAIN images are staged in on the device: bf16 under
    bf16 compute (the per-step cast disappears and the staged epoch
    halves), float32 otherwise, as JAX's ``staging_dtype``. Labels and the
    test set stay fp32."""
    return torch.bfloat16 if config.policy().compute_dtype is not None else torch.float32


def make_train_step(config: TrainConfig, guard: bool = False) -> Step:
    """The single-device train step: forward/backward, then TF1 Adam.
    ``guard=True`` applies the identity instead of the update whenever the
    gradients hold a non-finite element (``resilience.guard.apply_guard``,
    on the device) and returns the step's int32 skip flag LAST.
    ``health`` (``obs.health``'s level: off, the non-finite count, or the
    whole signal dict of the APPLIED update) appends the health dict
    after the loss. With both off it is the plain step, op for op."""
    model_kw = model_kwargs(config)

    def step(params, opt_state: AdamState, x, y, gstep: int, health: int = HEALTH_OFF):
        gen = (
            cnn.dropout_generator(config.seed, gstep, 0, x.device)
            if config.keep_prob < 1.0 else None
        )
        loss, grads = value_and_grad(params, x, y, gen, config.keep_prob, **model_kw)
        with torch.no_grad():
            new_params, new_opt = adam_update(
                params, opt_state, grads, lr=config.learning_rate
            )
        return hlt.finish_step(
            guard, health, lambda: hlt.nonfinite_count(grads),
            lambda new, nf: hlt.health_signals(grads, params, new, nonfinite=nf),
            params, opt_state, new_params, new_opt, loss)

    return step


def span_health(health: int, i: int, k: int) -> int:
    """Step ``i``'s health level in a span of ``k`` run at ``health``: the
    whole dict only on the last step (the one ``record_health`` reads),
    the non-finite count on every other."""
    return HEALTH_COUNT if health == HEALTH_FULL and i < k - 1 else health


def steps_span(step: Step, k: int) -> Callable:
    """``k`` consecutive steps over device-resident batches:
    ``(params, opt, xs, ys, first, goff[, health]) -> (params, opt,
    mean_loss[, healths][, skipped])``, with ``xs``/``ys`` ``[B, bs,
    ...]``, ``first`` the span's first batch and ``goff`` its first global
    step (the dropout stream's position). ``health`` (a level of
    ``obs.health``, :func:`span_health`) returns the steps' health dicts
    as a list; a guarded step's flags come back stacked, ``[k]`` int32 on
    the device."""

    def run(params, opt_state, xs, ys, first: int, goff: int, health: int = HEALTH_OFF):
        losses, flags, hs = [], [], []
        for i in range(k):
            lvl = span_health(health, i, k)
            args = (params, opt_state, xs[first + i], ys[first + i], goff + i)
            out = step(*args, health=lvl) if lvl else step(*args)
            params, opt_state = out[0], out[1]
            losses.append(out[2])
            if lvl:
                hs.append(out[3])
            flags.extend(out[3 + bool(lvl):])
        done = (params, opt_state, torch.stack(losses).mean())
        return done + ((hs,) if hs else ()) + ((torch.stack(flags),) if flags else ())

    return run


def make_epoch_chunk(config: TrainConfig, k: int, guard: bool = False) -> Callable:
    """The single-device ``k``-step span program (see :func:`steps_span`)."""
    return steps_span(make_train_step(config, guard=guard), k)


def eval_spans(
    batch_num: int, eval_every: int, start: int = 0
) -> list[tuple[int, int, bool]]:
    """Chunk an epoch into ``(first_batch, num_batches, eval_after)`` spans
    ending at the reference's eval points: after batches 0, 10, 20, ...
    (mnist_sync/worker.py:71-72), plus a no-eval tail.

    ``start`` begins the stream mid-epoch at that batch (a resume from a
    checkpoint whose saving run used another cadence): the first span is
    shortened so that its end realigns with this run's eval grid, and
    every batch from ``start`` on is trained."""
    if batch_num <= 0 or start >= batch_num or start < 0:
        return []
    if not eval_every:
        return [(start, batch_num - start, False)]
    spans = []
    first = start
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


def resume_plan(
    start_step: int, batch_num: int, eval_every: int,
    spans: list[tuple[int, int, bool]],
) -> tuple[int, list[tuple[int, int, bool]]]:
    """``(resume_epoch, resume_spans)``: ``resume_spans`` replaces
    ``spans`` for the resume epoch only. A checkpoint written under another
    eval or checkpoint cadence can land ``start_step`` mid-span of this
    run's grid; the realigned stream starts exactly there, so every
    remaining batch trains."""
    resume_epoch, resume_first = (
        divmod(start_step, batch_num) if batch_num else (0, 0)
    )
    resume_spans = (
        eval_spans(batch_num, eval_every, resume_first)
        if resume_first else spans
    )
    return resume_epoch, resume_spans


def checkpoint_file(checkpoint_dir: str | os.PathLike | None) -> str | None:
    """The rolling checkpoint path inside ``checkpoint_dir`` (its atomic
    ``os.replace`` makes one rolling file crash-safe, utils/checkpoint.py)."""
    if checkpoint_dir is None:
        return None
    return os.path.join(os.fspath(checkpoint_dir), "ckpt.npz")


def try_resume(ckpt_path: str | None, resume, like, log: Callable[[str], None]):
    """Load the rolling checkpoint if resuming. Returns ``(tree | None,
    step)``, ``step`` the global steps already completed (0 = fresh).

    ``resume`` is falsy (a fresh run), truthy (load ``ckpt_path``
    exactly) or ``"auto"``: the newest VALID checkpoint in the directory
    (``utils.checkpoint.find_latest_valid``), corrupt or truncated saves
    verified out and logged, so a torn latest file resumes from the
    previous retained one. A missing file starts fresh; the caller places
    the arrays."""
    if not resume:
        return None, 0
    if ckpt_path is None:
        raise ValueError("resume requires a checkpoint directory")
    if resume == "auto":
        from ..utils.checkpoint import find_latest_valid

        found = find_latest_valid(os.path.dirname(ckpt_path) or ".", log=log)
        if found is None:
            log(f"[resume] no valid checkpoint near {ckpt_path}; "
                "starting fresh")
            return None, 0
        ckpt_path = found[0]
    elif not os.path.exists(ckpt_path):
        log(f"[resume] no checkpoint at {ckpt_path}; starting fresh")
        return None, 0
    try:
        tree, step, _extra = load_checkpoint(ckpt_path, like)
    except (KeyError, ValueError) as e:
        raise RuntimeError(
            f"checkpoint {ckpt_path} is incompatible with this trainer's "
            f"state (different strategy family, model width, or an older "
            f"checkpoint format): {e}. Delete the checkpoint to start "
            "fresh, or resume with the original configuration."
        ) from e
    step = int(step or 0)
    log(f"[resume] restored global step {step} from {ckpt_path}")
    return tree, step


# Step-stamped saves kept beside the rolling file: the previous one is the
# fallback when the newest is damaged (JAX's default).
CHECKPOINT_KEEP = 2

# Spans between two preemption agreements in a world of several ranks:
# each agreement is one collective, so polling it every span taxes the
# steady state. Agreeing at spans 1, 1 + 4, 1 + 8, ... bounds the
# SIGTERM-to-stop latency at 4 spans. A world of one checks every span.
PREEMPT_AGREE_EVERY = 4


def check_preempt(
    should_stop: Callable[[], bool] | None,
    log: Callable[[str], None],
    has_checkpoint: bool,
    span_idx: int = 1,
) -> bool:
    """Graceful-preemption probe, polled once a span: when ``should_stop``
    (e.g. the CLI's SIGTERM flag) turns true, the trainer saves its rolling
    checkpoint and returns cleanly instead of dying mid-epoch.

    In a world of several ranks the local flag goes through
    ``multihost.agree_flag``, so every rank stops at the SAME span (one
    rank saving, a collective, while another starts the next span's
    collectives would deadlock). So ``should_stop`` must be passed on every
    rank or on none, and the agreement runs only at spans 1, 1 + N, ...
    (N = ``PREEMPT_AGREE_EVERY``; ``span_idx`` is the trainer's 1-based
    span counter, the same on every rank)."""
    if should_stop is None:
        return False
    if (dist.is_initialized() and dist.get_world_size() > 1
            and (span_idx - 1) % PREEMPT_AGREE_EVERY):
        return False  # off-cadence span: no collective
    if not multihost.agree_flag(should_stop()):
        return False
    log("preempted: saving checkpoint and stopping after this span"
        if has_checkpoint else
        "preempted: stopping after this span (no checkpoint dir — "
        "progress is NOT saved)")
    return True


def save_crossed(gstep: int, k: int, every: int, epoch_end: bool) -> bool:
    """Checkpoint cadence: save at every epoch end, and whenever the span
    ``[gstep, gstep + k)`` crosses a multiple of ``every`` (0 = epoch ends
    only). Spans are the save boundaries."""
    if epoch_end:
        return True
    return bool(every) and (gstep + k) // every > gstep // every


def guarded(fn, timeout_s: float, what: str):
    """Run ``fn`` under the watchdog (``mesh.run_within``): a dead card or
    peer leaves a synchronize or a collective blocked forever, and a
    timeout turns that into :class:`~ddl_tpu_torch.parallel.mesh.
    AcceleratorTimeout` with the recovery route. ``timeout_s <= 0`` is a
    plain call (no thread)."""
    if timeout_s <= 0:
        return fn()
    try:
        return run_within(fn, timeout_s, what=what)
    except AcceleratorTimeout as e:
        raise AcceleratorTimeout(
            f"{e} — accelerator backend presumed unreachable. Training "
            "state up to the last checkpoint is safe; rerun with --resume "
            "once the backend is back."
        ) from None


@dataclasses.dataclass
class StateIO:
    """How a trainer's live state crosses a checkpoint: ``like`` is the
    template of the checkpoint form (shapes and dtypes), ``for_save(params,
    opt)`` that form on the host (a collective in a world of several ranks:
    every rank calls it), ``place(tree) -> (params, opt)`` its inverse onto
    this rank's devices and shards; ``world`` says who writes."""

    like: Any
    for_save: Callable[[Any, Any], Any]
    place: Callable[[Any], tuple]
    world: World | None = None


def put_array(a, device) -> torch.Tensor:
    """A host array as a FRESH tensor on ``device`` (its own contiguous
    storage, dtype kept): what a restored buffer must be."""
    return torch.tensor(np.asarray(a), device=device)


def check_injector(fault_injector, family: str) -> None:
    """The sync and async strategies have no non-finite guard (as in JAX):
    a fault that poisons the data would train through NaNs there."""
    if fault_injector is not None and fault_injector.spec.kind in ("nan_grads", "inf_grads"):
        raise ValueError(
            f"fault {fault_injector.spec.kind} needs the non-finite guard, which the "
            f"{family} trainer does not have (the single and lm trainers do)"
        )


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


class SpanMetrics:
    """The telemetry of a span loop (JAX's per-span metrics block, shared
    here by every trainer): built only when a registry is live.
    ``step_flops`` are one train step's analytic FLOPs over ``n_dev``
    devices of ``device``'s kind at the policy's ``precision`` row;
    ``items`` names the throughput gauge (``images`` or ``tokens``);
    ``grid`` labels the ledger's process groups with mesh axes."""

    def __init__(self, metrics, tracer, *, step_flops: int, n_dev: int, device,
                 precision: str, items: str, interval: int, writer=None,
                 peak_flops: float | None = None, ici_bw: float | None = None,
                 anomaly_detector=None, grid=None):
        from ..obs import comms, cost
        from ..obs.goodput import GoodputTracker
        from ..obs.memory import MemorySampler

        self.metrics, self.tracer, self.writer = metrics, tracer, writer
        self.detector, self.grid = anomaly_detector, grid
        self.step_flops, self.n_dev, self.items = step_flops, n_dev, items
        self.interval = interval
        self.gp = GoodputTracker(metrics, "train")
        self.peak = cost.peak_flops_per_device(device, peak_flops, precision=precision)
        self.bw = comms.ici_bw_per_device(device, ici_bw)
        self.mem = MemorySampler(metrics, [device])
        self.span_bytes: dict[int, int] = {}

    def level(self, gstep: int, k: int, epoch_end: bool) -> int:
        """The health level of the span ``[gstep, gstep + k)``: the whole
        dict when it crosses the metrics interval (or ends the epoch), the
        non-finite count otherwise."""
        return HEALTH_FULL if save_crossed(gstep, k, self.interval, epoch_end) else HEALTH_COUNT

    def compiled(self, kind: str, records, ks=(0,), t0=None, t1=None,
                 attribute: bool = True) -> None:
        """One warm-up call of the span (``kind="train_span"``, one per
        distinct span length ``ks``) or eval program: JAX's compile
        counter and span (the bracket ``t0..t1`` goes to the first length,
        the others count as instants), the goodput ``compile`` phase, and
        each program's collective ledger from the warm-up's tallied
        ``records``, one step's worth times the span length (None: no
        ledger, as JAX's CNN trainer publishes none for its eval).
        ``attribute=False`` leaves the bracket out of goodput (a warm-up
        call that is also a run's own work, attributed there)."""
        from ..obs.comms import publish_program_ledger
        from ..obs.memory import record_compile

        for i, k in enumerate(sorted(ks)):
            br = dict(t0=t0, t1=t1) if i == 0 else {}
            record_compile(self.metrics, self.tracer, kind, **br,
                           **({"k": k} if kind == "train_span" else {}))
            if records is not None:
                led = publish_program_ledger(self.metrics, records, program=f"{kind}[{k}]",
                                             grid=self.grid, repeat=max(k, 1))
                self.span_bytes[k] = led["total_bytes"]
        if t0 is not None and attribute:
            self.gp.add("compile", t1 - t0)

    def span(self, gstep: int, k: int, items: int, span_s: float, compile_in_span: float,
             n_skip: int, health: dict, full: bool, loss: float | None = None) -> None:
        """Record one dispatched span (JAX's order): loss, step, span
        seconds, throughput, MFU, the comms roofline, the goodput split,
        the anomaly feed, the non-finite counts of every step, and on a
        ``full`` span the health gauges and memory watermarks; then the
        writer's rate-limited flush."""
        from ..obs import comms
        from ..obs import health as hlt
        from ..obs.cost import mfu
        from ..obs.goodput import attribute_train_span

        m = self.metrics
        if loss is not None:
            m.gauge("train_loss").set(loss)
        m.gauge("train_step").set(gstep + k)
        m.histogram("train_span_seconds",
                    "wall seconds per dispatched span program").observe(span_s)
        m.gauge(f"train_{self.items}_per_sec").set(items / span_s if span_s else 0.0)
        mfu_val = mfu(self.step_flops * k, span_s, self.n_dev, self.peak)
        m.gauge("train_mfu").set(mfu_val)
        cb = self.span_bytes.get(k, 0) / k
        rl = comms.roofline(self.step_flops, cb, self.n_dev, self.peak, self.bw)
        m.gauge("comms_bytes_per_step").set(cb)
        for key in ("comms_time_model_s", "compute_time_model_s", "step_time_model_s",
                    "comms_fraction"):
            m.gauge(key).set(rl[key])
        sb = m.gauge("step_bound")
        sb.set(float(rl["bound"] == "compute"), bound="compute")
        sb.set(float(rl["bound"] == "comms"), bound="comms")
        attribute_train_span(self.gp, span_s, compile_in_span, n_skip, k)
        if self.detector is not None:
            self.detector.tick({"step_time": span_s / k, "mfu": mfu_val})
        hlt.record_nonfinite(m, health["nonfinite_grads"])
        if full:
            hlt.record_health(m, health, include_nonfinite=False)
            self.mem.sample()
        if self.writer is not None:
            self.writer.maybe_flush()



@contextlib.contextmanager
def attributed(sm: SpanMetrics | None, phase: str):
    """Attribute the block's wall time to the goodput ``phase`` of ``sm``;
    without telemetry (``sm`` None), no clock read at all."""
    if sm is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    sm.gp.add(phase, time.perf_counter() - t0)


def check_detector(metrics, anomaly_detector) -> None:
    """JAX's refusal of an anomaly detector built on another registry than
    the trainer's ``metrics`` (or with no registry at all)."""
    if anomaly_detector is not None and (metrics is None
                                         or anomaly_detector.registry is not metrics):
        raise ValueError(
            "anomaly_detector must be built on the registry passed "
            "as metrics= (its anomaly_* metrics would otherwise land "
            "where nothing reads them)"
        )


def run_spans(
    config: TrainConfig,
    span_fn: Callable[[int, bool], Callable],
    params,
    opt_state,
    xs: torch.Tensor,
    ys: torch.Tensor,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    device: torch.device,
    log: Callable[[str], None],
    io: StateIO | None = None,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume=False,
    profile_dir: str | None = None,
    should_stop: Callable[[], bool] | None = None,
    dispatch_timeout: float = 0.0,
    metrics=None,
    metrics_interval: int = 10,
    metrics_writer=None,
    tracer=None,
    guard: bool = False,
    max_bad_steps: int = 0,
    max_rollbacks: int = 3,
    fault_injector=None,
    checkpoint_keep: int = CHECKPOINT_KEEP,
    peak_flops: float | None = None,
    ici_bw: float | None = None,
    anomaly_detector=None,
    stage_xs: Callable[[], torch.Tensor] | None = None,
    staging_s: float = 0.0,
):
    """The span loop every CNN trainer shares: resume, warm up, then run
    each epoch's eval spans, timing each one to a device barrier, with the
    reference's eval cadence, the early-stop target, the resilience hooks
    and the telemetry of the JAX trainers' loops (module docstring).
    ``span_fn(k, guard)`` gives the ``k``-step span program; ``io`` moves
    the state across checkpoints (needed with ``checkpoint_dir``);
    ``stage_xs`` restages the train images after a guard rollback heals an
    injected fault; ``staging_s`` is the caller's staging time (goodput's
    ``staging``). Returns ``(params, opt_state, TrainResult)`` with
    ``params`` still on the device (``result.params`` is numpy)."""
    from ..obs.trace import NULL_TRACER

    tracer = tracer if tracer is not None else NULL_TRACER
    check_detector(metrics, anomaly_detector)
    guard_on = bool(guard) or max_bad_steps > 0
    inj = fault_injector
    monitor = None
    if guard_on:
        from ..resilience.guard import GuardMonitor

        monitor = GuardMonitor(max_bad_steps, max_rollbacks=max_rollbacks,
                               registry=metrics, tracer=tracer)
    sm = None
    if metrics is not None:
        from ..obs.cost import cnn_train_step_flops

        sm = SpanMetrics(metrics, tracer, device=device, n_dev=1,
                         step_flops=cnn_train_step_flops(config.batch_size,
                                                         config.conv_channels,
                                                         config.fc_sizes),
                         precision=config.policy().mfu_kind, items="images",
                         interval=metrics_interval, writer=metrics_writer,
                         peak_flops=peak_flops, ici_bw=ici_bw,
                         anomaly_detector=anomaly_detector)
        sm.gp.add("staging", staging_s)
    world = io.world if io is not None else None
    ckpt = checkpoint_file(checkpoint_dir)
    if ckpt is not None and io is None:
        raise ValueError("checkpoint_dir needs the trainer's StateIO")
    tree, start_step = try_resume(ckpt, resume, io.like if io else None, log)
    if tree is not None:
        params, opt_state = io.place(tree)
    batch_num = xs.shape[0]
    spans = eval_spans(batch_num, config.eval_every)
    fns: dict[int, Callable] = {}

    def fn_for(k: int) -> Callable:
        # On demand: a rollback can realign the spans onto new lengths.
        if k not in fns:
            fns[k] = span_fn(k, guard_on)
        return fns[k]

    # Warm-up outside the clock (the JAX package compiles here): one
    # forward/backward on the first batch (discarded) and one eval load the
    # library handles and kernels; the state is not touched. Under
    # telemetry, each is one "compile" (obs.memory) whose collectives the
    # tally records (obs.comms).
    t0 = time.perf_counter()
    with (coll.tally() if sm is not None else contextlib.nullcontext([])) as records:
        if batch_num:
            value_and_grad(params, xs[0], ys[0], None, 1.0, **model_kwargs(config))
        if sm is not None:
            barrier(device)
            t1 = time.perf_counter()
        if x_test.shape[0]:
            evaluate(params, x_test, y_test)
        barrier(device)
    warmup = time.perf_counter() - t0
    if sm is not None:
        _, resume_spans0 = resume_plan(start_step, batch_num, config.eval_every, spans)
        sm.compiled("train_span", list(records), {k for _, k, _ in spans + resume_spans0},
                    t0=t0, t1=t1)
        if x_test.shape[0]:
            sm.compiled("eval", None, t0=t1, t1=t0 + warmup)
    resumed_from = start_step

    def rollback() -> int:
        """Guard escalation: restore the newest valid checkpoint at or
        before the streak's first bad step (``rollback_state`` prunes the
        abandoned newer saves), heal a transient injected fault
        (restaging clean data), and return the step to re-enter at."""
        nonlocal params, opt_state, xs
        from ..resilience.guard import rollback_state

        rtree, rstep = rollback_state(checkpoint_dir, monitor, io.like, log, world)
        params, opt_state = io.place(rtree)
        if inj is not None and inj.heal():
            xs = stage_xs()
        barrier(device)
        return rstep

    def dispatch(k: int, first: int, gstep: int, health: int):
        args = (params, opt_state, xs, ys, first, gstep)
        out = fn_for(k)(*args, health=health) if health else fn_for(k)(*args)
        barrier(device)
        return out

    history: list[tuple[int, int, float]] = []
    losses = []  # device tensors, fetched after the loop
    timer = StepTimer()
    stopped = preempted = False
    span_idx = 0
    start = time.perf_counter()
    with trace(profile_dir, device):
        while True:
            rolled = False
            resume_epoch, resume_spans = resume_plan(start_step, batch_num, config.eval_every,
                                                     spans)
            for epoch in range(config.epochs):
                for first, k, eval_after in (resume_spans if epoch == resume_epoch else spans):
                    gstep = epoch * batch_num + first
                    if gstep < start_step:
                        continue  # already done by the resumed run
                    span_idx += 1
                    lvl = sm.level(gstep, k, first + k == batch_num) if sm else HEALTH_OFF
                    with timer.step(images=k * config.batch_size), \
                            tracer.span("train/span", gstep=gstep, k=k):
                        out = guarded(lambda: dispatch(k, first, gstep, lvl), dispatch_timeout,
                                      f"span dispatch at global step {gstep}")
                    params, opt_state = out[0], out[1]
                    losses.append(out[2])
                    skipped = out[-1].cpu().numpy() if guard_on else None
                    if sm is not None:
                        from ..obs.health import fetch_span

                        sm.span(gstep, k, k * config.batch_size, timer._times[-1], 0.0,
                                int(skipped.sum()) if guard_on else 0, fetch_span(out[3]),
                                lvl == HEALTH_FULL)
                    if guard_on and monitor.observe(skipped, gstep):
                        with attributed(sm, "stall"):
                            start_step = rollback()
                            monitor.rolled_back(start_step)
                        rolled = True
                        break
                    if eval_after:
                        cnt = first + k - 1
                        with attributed(sm, "eval"), tracer.span("train/eval", gstep=gstep + k):
                            acc = guarded(lambda: evaluate(params, x_test, y_test),
                                          dispatch_timeout, f"eval after batch {cnt}")
                        if metrics is not None:
                            metrics.gauge("train_eval_accuracy").set(acc)
                        history.append((epoch, cnt, acc))
                        log(f"epoch: {epoch} batch: {cnt} accuracy: {acc}")
                        stopped = hit_target(config, acc)
                    if inj is not None:
                        inj.maybe_sigterm(gstep + k)
                    preempted = preempted or check_preempt(should_stop, log, ckpt is not None,
                                                           span_idx)
                    if ckpt and save_crossed(gstep, k, checkpoint_every,
                                             first + k == batch_num or stopped or preempted):
                        with attributed(sm, "checkpoint_io"):
                            save_checkpoint_world(ckpt, io.for_save(params, opt_state),
                                                  world=world, step=gstep + k,
                                                  extra={"epoch": epoch}, keep=checkpoint_keep)
                    if stopped or preempted:
                        break
                if stopped:
                    log(f"target accuracy {config.target_accuracy} reached")
                if rolled or stopped or preempted:
                    break
            if not rolled:
                break
    end = time.perf_counter()
    with attributed(sm, "eval"):
        final_acc = guarded(lambda: evaluate(params, x_test, y_test), dispatch_timeout,
                            "final eval")
    if sm is not None:
        # Final publish: the tail brackets land in the gauges.
        sm.gp.publish()
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
        resumed_from_step=resumed_from,
        preempted=preempted,
        skipped_steps=monitor.skipped_steps if monitor else 0,
        rollbacks=monitor.rollbacks if monitor else 0,
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

    def state_io(self) -> StateIO:
        """The checkpoint form, JAX's ``{"params": params, "opt":
        AdamState}``: the live tensors are their own template."""
        dev = self.device

        def place(tree):
            opt = tree["opt"]
            return ({k: put_array(v, dev) for k, v in tree["params"].items()},
                    AdamState(step=put_array(opt.step, dev),
                              m={k: put_array(v, dev) for k, v in opt.m.items()},
                              v={k: put_array(v, dev) for k, v in opt.v.items()}))

        return StateIO(like={"params": self.params, "opt": self.opt_state},
                       for_save=lambda p, o: {"params": p, "opt": o}, place=place)

    def train(
        self,
        log: Callable[[str], None] = print,
        *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume=False,
        profile_dir: str | None = None,
        should_stop: Callable[[], bool] | None = None,
        dispatch_timeout: float = 0.0,
        metrics=None,
        metrics_interval: int = 10,
        metrics_writer=None,
        tracer=None,
        guard: bool = False,
        max_bad_steps: int = 0,
        max_rollbacks: int = 3,
        fault_injector=None,
        checkpoint_keep: int = CHECKPOINT_KEEP,
        peak_flops: float | None = None,
        ici_bw: float | None = None,
        anomaly_detector=None,
    ) -> TrainResult:
        """Train ``config.epochs`` epochs (:func:`run_spans`). Resilience,
        as JAX's: ``resume`` accepts ``"auto"`` (the newest VALID
        checkpoint); saves keep the last ``checkpoint_keep`` step-stamped
        files; ``guard=True`` (implied by ``max_bad_steps > 0``) runs the
        non-finite guarded step, and ``max_bad_steps`` consecutive skips
        roll back to the last good checkpoint (a checkpoint dir is needed)
        and replay from there, at most ``max_rollbacks`` times;
        ``fault_injector`` is the deterministic chaos hook
        (``resilience.faults``). Telemetry, as JAX's: ``metrics`` (an
        ``obs.MetricRegistry``) turns on the health signals, fetched with
        the span barrier and recorded on spans crossing
        ``metrics_interval`` steps, ``train_mfu`` against ``peak_flops``
        (default: the device's row of ``obs.cost``), the comms roofline
        against ``ici_bw``, the goodput phases, memory watermarks and
        ``anomaly_detector`` (built on the same registry); ``tracer``
        (``obs.Tracer``) spans every dispatch and eval; ``metrics_writer``
        flushes on its own interval; ``profile_dir`` runs the span loop
        under ``torch.profiler``."""
        cfg, ds, dev = self.config, self.dataset, self.device
        bs = cfg.batch_size
        batch_num = ds.num_train // bs
        n = batch_num * bs
        t_stage0 = time.perf_counter() if metrics is not None else 0.0
        # Sequential batching, no shuffle (single.py:14-15).
        # Explicit feature dims: batch_num may be 0 (dataset < one batch).
        x = np.asarray(ds.x_train, np.float32)[:n]
        y = one_hot(ds.y_train)[:n]

        def stage_xs() -> torch.Tensor:
            # The grad-fault injection point: a poisoned image pixel makes
            # the loss, and so every gradient, non-finite through the real
            # forward.
            arr = x
            if fault_injector is not None and fault_injector.poisons_data():
                arr = fault_injector.poison_batches(arr, batch_num, bs)
            return torch.as_tensor(arr.reshape(batch_num, bs, x.shape[-1])).to(
                dev, staging_dtype(cfg))

        xs = stage_xs()
        ys = torch.as_tensor(y.reshape(batch_num, bs, y.shape[-1])).to(dev)
        x_test = torch.as_tensor(np.asarray(ds.x_test, np.float32)).to(dev)
        y_test = torch.as_tensor(one_hot(ds.y_test)).to(dev)
        params = {k: v.clone() for k, v in self.params.items()}
        staging_s = 0.0
        if metrics is not None:
            barrier(dev)  # the host-to-device copies land before the clock reads
            staging_s = time.perf_counter() - t_stage0
        self.params, self.opt_state, result = run_spans(
            cfg, lambda k, g: make_epoch_chunk(cfg, k, guard=g), params,
            copy.deepcopy(self.opt_state), xs, ys, x_test, y_test, dev, log, self.state_io(),
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every, resume=resume,
            profile_dir=profile_dir, should_stop=should_stop, dispatch_timeout=dispatch_timeout,
            metrics=metrics, metrics_interval=metrics_interval, metrics_writer=metrics_writer,
            tracer=tracer, guard=guard, max_bad_steps=max_bad_steps,
            max_rollbacks=max_rollbacks, fault_injector=fault_injector,
            checkpoint_keep=checkpoint_keep, peak_flops=peak_flops, ici_bw=ici_bw,
            anomaly_detector=anomaly_detector, stage_xs=stage_xs, staging_s=staging_s,
        )
        return result
