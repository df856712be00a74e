"""Training cells (traffic kind ``lm_train``): the port's LM step,
``SeqTrainer(config, dataset).step_fn()``, on one device under the bf16
mixed-precision policy (bf16 compute, float32 masters and Adam moments),
``scheme="full"``, ``attn_impl="flash"``, TF32 off.

One run:

1. set-up: the batches and the initial parameters from the seed (drawn on
   the device), the trainer, the batches staged on the device, and the
   checked steps, which are also the warm-up: they go through the step the
   window drives, each on its own batch, and leave the readings the
   comparison needs (each loss, the first gradient's norms from Adam's
   first moment, the parameters' change after the last);
2. the window: the same trainer's state stepped for ``seconds``, one step
   kept in flight, closed by a device barrier; ``train_tokens_per_s`` is
   the tokens of every step over the window's wall time;
3. with ``trace``, a profiled session of a few more steps after a warm-up
   session, for the per-layer metrics;
4. the peak memory, then the program's state freed, then the reference
   follows the checked steps from the same parameters and batches and the
   comparison decides ``correct``.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from ..harness import traffic, verdict, weights
from ..harness.trace import WINDOW_TAG, reduce
from ..reference import lm as reference

REF_TOKENS = 2048  # tokens of one block of rows in the reference
PROFILED_STEPS = 3


@dataclasses.dataclass
class Program:
    trainer: object
    step: object
    params: dict
    opt: object
    xs: torch.Tensor
    ys: torch.Tensor
    ws: torch.Tensor
    done: int = 0  # steps taken

    def advance(self) -> torch.Tensor:
        i = self.done % self.xs.shape[0]
        self.params, self.opt, loss = self.step(self.params, self.opt, self.xs[i], self.ys[i],
                                                self.ws[i])[:3]
        self.done += 1
        return loss


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(cell, seed: int, device, data: traffic.Batches, step_wrap=None,
          precision: str = "bf16") -> Program:
    """The trainer on ``device`` with its batches staged, before any step
    (``precision``: the port's policy; the cells run ``bf16``)."""
    from ddl_tpu_torch.data.lm import LMDataset
    from ddl_tpu_torch.models.transformer import LMSpec
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer

    d, b = cell.dims(), cell.batch
    nb = cell.traffic["distinct_batches"]
    spec = LMSpec(vocab=d.vocab, d_model=d.d_model, num_heads=d.num_heads,
                  num_layers=d.num_layers, d_ff=d.d_ff, rope_base=d.rope_base)
    config = SeqConfig(batch_size=b, learning_rate=cell.learning_rate, eval_every=0,
                       scheme="full", attn_impl="flash", precision=precision, spec=spec)
    dataset = LMDataset(tokens=data.tokens, targets=data.targets, weights=data.weights,
                        test_tokens=data.tokens[:1], test_targets=data.targets[:1],
                        test_weights=data.weights[:1])
    init = weights.numpy_tree(d, seed % 2**63, device)
    trainer = SeqTrainer(config, dataset, init=init, device=device)
    del init
    step = trainer.step_fn()
    return Program(trainer=trainer, step=step_wrap(step) if step_wrap else step,
                   params=trainer.params, opt=trainer.opt_state,
                   xs=trainer.stage_batches(data.tokens, nb, b),
                   ys=trainer.stage_batches(data.targets, nb, b),
                   ws=trainer.stage_batches(data.weights, nb, b))


def checked_steps(prog: Program, cell, seed: int, device) -> reference.Follow:
    """The first steps, with what the comparison reads of them."""
    d = cell.dims()
    paths = list(reference.leaf_shapes(d))
    losses, grad_norms = [], None
    for _ in range(cell.traffic["checked_steps"]):
        losses.append(prog.advance())
        if grad_norms is None:
            grad_norms = torch.stack([
                torch.linalg.vector_norm(weights.leaf(prog.opt.m, p), dtype=torch.float64)
                for p in paths]) / (1.0 - reference.B1)
    p0 = weights.device_leaves(d, seed % 2**63, device)
    change = torch.stack([
        torch.linalg.vector_norm(weights.leaf(prog.params, p) - p0[p], dtype=torch.float64)
        for p in paths])
    del p0
    return reference.Follow(losses=torch.stack(losses).double().cpu().tolist(),
                            grad_norms=dict(zip(paths, grad_norms.cpu().tolist())),
                            change_norms=dict(zip(paths, change.cpu().tolist())))


def window(prog: Program, seconds: float, device) -> tuple[int, float]:
    """Steps for ``seconds`` of wall time, one step in flight: ``(steps,
    seconds elapsed)`` up to the barrier after the last."""
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    t0 = time.perf_counter()
    steps, prev = 0, None
    while True:
        prog.advance()
        steps += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return steps, time.perf_counter() - t0


def profiled(prog: Program, device):
    """``PROFILED_STEPS`` steps in a profiler session, after one session
    over a single step that warms the tracer and one untimed step inside
    the session (the tracer can lose the device records that follow its
    start)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        prog.advance()
        _sync(device)
    with profile(activities=acts) as prof:
        prog.advance()
        _sync(device)
        with record_function(WINDOW_TAG):
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                prog.advance()
            _sync(device)
            window_s = time.perf_counter() - t0
    return reduce(prof.events(), PROFILED_STEPS, window_s)


def reference_follow(cell, seed: int, device, data: traffic.Batches,
                     quant: bool = False) -> reference.Follow:
    """The reference over the checked steps, from the same parameters and
    batches as the program."""
    d, b, n = cell.dims(), cell.batch, cell.traffic["checked_steps"]
    to = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)  # noqa: E731
    batches = [(to(data.tokens[i * b:(i + 1) * b], torch.long),
                to(data.targets[i * b:(i + 1) * b], torch.long),
                to(data.weights[i * b:(i + 1) * b], torch.float32)) for i in range(n)]
    p0 = weights.device_leaves(d, seed % 2**63, device)
    rows = max(1, REF_TOKENS // cell.traffic["seq_len"])
    return reference.follow(p0, batches, d, cell.learning_rate, rows_per_block=rows,
                            quant=quant)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets."""

    dims: reference.Dims
    batch: int
    seq_len: int
    kind: str  # the device's name
    step_s: float  # wall seconds a step in the unprofiled window
    trace: object  # harness.trace.Trace


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        readers: dict) -> tuple[dict, dict]:
    """One run of a training cell: ``(result, checks)``. ``readers`` maps
    each per-layer metric this cell reports to its reader."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    d, b, t = cell.dims(), cell.batch, cell.traffic["seq_len"]
    marks = [("start", t0), ("imports", time.perf_counter())]
    data = traffic.generate(cell.traffic, b, d.vocab, seed)
    prog = build(cell, seed, device, data)
    _sync(device)
    marks.append(("build", time.perf_counter()))
    readings = checked_steps(prog, cell, seed, device)
    _sync(device)
    marks.append(("checked_steps", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("setup " + " ".join(f"{name} {t - marks[i][1]!r}" for i, (name, t)
                              in enumerate(marks[1:])), file=sys.stderr)
    steps, elapsed = window(prog, seconds, device)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    metrics = {}
    if trace:
        tr = profiled(prog, device)
        reading = Reading(dims=d, batch=b, seq_len=t, kind=kind, step_s=elapsed / steps, trace=tr)
        for name, (unit, read) in readers.items():
            value = read(reading)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics["train_tokens_per_s"] = {"value": steps * b * t / elapsed, "unit": "tokens/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del prog
    free(device)
    ref = reference_follow(cell, seed, device, data)
    correct, checks = verdict.judge(verdict.gaps(readings, ref), cell.limits)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    result = {"correct": correct, "attempted": cell.traffic["checked_steps"] + steps,
              "failed": verdict.failed_count(checks), "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    return result, checks

