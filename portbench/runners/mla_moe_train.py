"""Training cells of the latent-attention and expert block (traffic kind
``mla_moe_train``): the port's LM step, ``SeqTrainer(config,
dataset).step_fn()`` with ``spec`` an ``MLAMoESpec``, on one device under
the bf16 policy, ``scheme="full"``, ``attn_impl="flash"``, TF32 off: the
same step, policy and Adam as ``lm_train.py``'s cells, and the same run:

1. set-up: the batches (``traffic.generate``, the mix read as a training
   mix) and the initial parameters from the seed (``moe_weights``), the
   trainer, the staged batches, and the checked steps, which record the
   program's chosen experts;
2. the window, one step in flight (``lm_train.window``); the held experts'
   assignments over it, read from the program's counter after it, go to
   standard error (max / mean a layer);
3. with ``trace``, ``lm_train.profiled``'s sessions, and the device time
   inside the expert layer's spans (``harness/moe_spans.py``) and the
   assignments over the profiled steps;
4. the peak memory, the program's state freed, then the reference
   (``reference/mla_moe.py``) follows the checked steps from the same
   parameters and batches, taking the program's recorded choices of
   experts; ``correct`` holds the three gaps of ``verdict.py`` to the
   cell's ``limits``, ``route_agreement`` to the cell's
   ``route_agreement_min``: the share of the program's choices, over every
   expert layer, that the reference's own top-k also makes, and
   ``route_replay`` to ``route_replay_min``: the smallest share, over the
   expert layers, of the first step's choices that the reference's router
   makes again from the rows the program's router scored (each layer's
   shares go to standard error). bf16 drift flips a few choices in every
   layer, so the first cannot tell a router that drops the bias; the
   second, which no drift enters, can.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from ..harness import moe_spans, moe_weights, traffic, verdict
from ..harness.trace import WINDOW_TAG, reduce
from ..reference import mla_moe as reference
from ..reference.lm import B1
from .lm_train import PROFILED_STEPS, Program, _sync, free, window


def dims(cell) -> reference.MoEDims:
    return reference.dims_from_config(cell.config)


def bias_seed(seed: int) -> int:
    return seed % 2**63


def spec_for(cell, seed: int):
    """The port's ``MLAMoESpec`` for the cell's configuration."""
    from ddl_tpu_torch.models.mla_moe import MLAMoESpec

    d = dims(cell)
    return MLAMoESpec(vocab=d.vocab, d_model=d.d_model, num_heads=d.num_heads,
                      num_layers=d.num_layers, qk_nope_dim=d.qk_nope_dim,
                      qk_rope_dim=d.qk_rope_dim, v_head_dim=d.v_head_dim,
                      kv_lora_rank=d.kv_lora_rank, d_ff=d.d_ff, first_dense=d.first_dense,
                      n_experts=d.n_experts, experts_held=d.held, top_k=d.top_k,
                      d_expert=d.d_expert, n_shared=d.n_shared, routed_scale=d.routed_scale,
                      rope_base=d.rope_base, norm_eps=d.norm_eps, bias_seed=bias_seed(seed),
                      bias_range=float(cell.config["assumed"]["bias_range"]))


def generate(cell, seed: int) -> traffic.Batches:
    return traffic.generate(dict(cell.traffic, kind="lm_train"), cell.batch, dims(cell).vocab,
                            seed)


def build(cell, seed: int, device, data: traffic.Batches, step_wrap=None,
          spec=None) -> Program:
    """The trainer's step and state on ``device`` with its batches staged,
    before any step; the trainer keeps no state of its own."""
    from ddl_tpu_torch.data.lm import LMDataset
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer

    b, nb = cell.batch, cell.traffic["distinct_batches"]
    config = SeqConfig(batch_size=b, learning_rate=cell.learning_rate, eval_every=0,
                       scheme="full", attn_impl="flash", precision="bf16",
                       spec=spec or spec_for(cell, seed))
    dataset = LMDataset(tokens=data.tokens, targets=data.targets, weights=data.weights,
                        test_tokens=data.tokens[:1], test_targets=data.targets[:1],
                        test_weights=data.weights[:1])
    init = moe_weights.numpy_tree(dims(cell), seed % 2**63, device)
    trainer = SeqTrainer(config, dataset, init=init, device=device)
    del init
    step = trainer.step_fn()
    prog = Program(trainer=None, step=step_wrap(step) if step_wrap else step,
                   params=trainer.params, opt=trainer.opt_state,
                   xs=trainer.stage_batches(data.tokens, nb, b),
                   ys=trainer.stage_batches(data.targets, nb, b),
                   ws=trainer.stage_batches(data.weights, nb, b))
    trainer.params = trainer.opt_state = None  # one live state: the program's
    return prog


def _leaf(params: dict, path: str):
    parts = path.split(".")
    return params["blocks"][int(parts[1])][parts[2]] if parts[0] == "blocks" else params[path]


def checked_steps(prog: Program, cell, seed: int, device):
    """The first steps, with what the comparison reads of them, the
    program's chosen experts of each (``[expert layers, B T, k]``), and the
    rows its routers scored in the first (a list an expert layer, on the
    host)."""
    from ddl_tpu_torch.models import mla_moe

    d = dims(cell)
    paths = list(reference.leaf_shapes(d))
    losses, grad_norms, routes, rows = [], None, [], []
    for i in range(cell.traffic["checked_steps"]):
        with mla_moe.recording_routes(rows if i == 0 else None) as chosen:
            losses.append(prog.advance())
        routes.append(torch.stack(chosen))
        if grad_norms is None:
            grad_norms = torch.stack([
                torch.linalg.vector_norm(_leaf(prog.opt.m, p), dtype=torch.float64)
                for p in paths]) / (1.0 - B1)
    p0 = moe_weights.device_leaves(d, seed % 2**63, device)
    change = torch.stack([
        torch.linalg.vector_norm(_leaf(prog.params, p) - p0[p], dtype=torch.float64)
        for p in paths])
    del p0
    follow = reference.Follow(losses=torch.stack(losses).double().cpu().tolist(),
                              grad_norms=dict(zip(paths, grad_norms.cpu().tolist())),
                              change_norms=dict(zip(paths, change.cpu().tolist())))
    return follow, routes, rows


def profiled(prog: Program, device, counter):
    """``lm_train.profiled``'s sessions, and besides the reduced trace the
    device seconds inside the expert spans and the assignments to the held
    experts over the profiled steps (summed over layers and experts)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        prog.advance()
        _sync(device)
    with profile(activities=acts) as prof:
        prog.advance()
        _sync(device)
        before = counter.sum()
        with record_function(WINDOW_TAG):
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                prog.advance()
            _sync(device)
            window_s = time.perf_counter() - t0
        assigned = float(counter.sum() - before)
    events = prof.events()
    return reduce(events, PROFILED_STEPS, window_s), moe_spans.device_seconds(events), assigned


def _bias(cell, seed: int, device) -> torch.Tensor:
    d = dims(cell)
    return torch.from_numpy(reference.router_bias(
        d, bias_seed(seed), float(cell.config["assumed"]["bias_range"]))).to(device)


def router_replay(cell, seed: int, device, rows, chosen, quant: bool = False) -> list[float]:
    """``reference.router_replay`` of the first checked step: the program's
    router rows and choices of that step, the initial routers."""
    d = dims(cell)
    p0 = moe_weights.device_leaves(d, seed % 2**63, device)
    routers = [p0[f"blocks.{i}.router"].clone() for i in range(d.first_dense, d.num_layers)]
    del p0
    return reference.router_replay(rows, routers, _bias(cell, seed, device), chosen, d, quant)


def reference_follow(cell, seed: int, device, data: traffic.Batches, routes=None,
                     quant: bool = False):
    """The reference over the checked steps from the same parameters and
    batches as the program: ``(Follow, each expert layer's route agreement,
    or None)``."""
    d, b, n = dims(cell), cell.batch, cell.traffic["checked_steps"]
    to = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)  # noqa: E731
    batches = [(to(data.tokens[i * b:(i + 1) * b], torch.long),
                to(data.targets[i * b:(i + 1) * b], torch.long),
                to(data.weights[i * b:(i + 1) * b], torch.float32)) for i in range(n)]
    return reference.follow(lambda: moe_weights.device_leaves(d, seed % 2**63, device), batches,
                            d, cell.learning_rate, _bias(cell, seed, device), routes=routes,
                            quant=quant)


def judge(cell, prog_follow, ref_follow, shares: list[float] | None,
          replay: list[float] | None) -> tuple[bool, dict, int]:
    """``(correct, checks, failed)``: the three gaps against ``limits``, and
    two numbers that must not fall below their limits: ``route_agreement``,
    the mean of each expert layer's ``shares``, against
    ``route_agreement_min``; ``route_replay``, the smallest of each expert
    layer's ``replay``, against ``route_replay_min``. None: the choices
    covered nothing, and agree with nothing."""
    correct, checks = verdict.judge(verdict.gaps(prog_follow, ref_follow), cell.limits)
    failed = verdict.failed_count(checks)
    for name, value in (("route_agreement", sum(shares) / len(shares) if shares else 0.0),
                        ("route_replay", min(replay) if replay else 0.0)):
        lim = float(cell.workload[f"{name}_min"])
        routed = math.isfinite(value) and value >= lim
        checks[name] = {"value": value, "limit": lim}
        correct, failed = correct and routed, failed + (not routed)
    return correct, checks, failed


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets (``lm_train.Reading``'s
    fields, the block's sizes, and what the expert layer measured)."""

    dims: reference.MoEDims
    batch: int
    seq_len: int
    kind: str  # the device's name
    step_s: float  # wall seconds a step in the unprofiled window
    trace: object  # harness.trace.Trace
    moe_spans: dict | None  # span -> device seconds over the profiled steps
    assignments: float  # to the held experts a profiled step, all expert layers


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        readers: dict) -> tuple[dict, dict]:
    """One run of the cell: ``(result, checks)``."""
    from ddl_tpu_torch.models import mla_moe  # a program without the block stops here

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    d, b, t = dims(cell), cell.batch, cell.traffic["seq_len"]
    marks = [("start", t0), ("imports", time.perf_counter())]
    data = generate(cell, seed)
    spec = spec_for(cell, seed)
    prog = build(cell, seed, device, data, spec=spec)
    _sync(device)
    marks.append(("build", time.perf_counter()))
    readings, routes, rows = checked_steps(prog, cell, seed, device)
    _sync(device)
    marks.append(("checked_steps", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("setup " + " ".join(f"{name} {t - marks[i][1]!r}" for i, (name, t)
                              in enumerate(marks[1:])), file=sys.stderr)
    counter = mla_moe.assignment_counter(spec, device)
    counter.zero_()
    steps, elapsed = window(prog, seconds, device)
    load = counter.double() / steps  # [expert layers, held] a step
    print("expert_load max/mean by layer " + " ".join(
        f"{x:.3f}" for x in (load.max(1).values / load.mean(1)).tolist()), file=sys.stderr)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    metrics = {}
    if trace:
        tr, spans, assigned = profiled(prog, device, counter)
        reading = Reading(dims=d, batch=b, seq_len=t, kind=kind, step_s=elapsed / steps,
                          trace=tr, moe_spans=spans, assignments=assigned / PROFILED_STEPS)
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
    # Choices that do not cover the cell's batch (a fault in the step) agree
    # with nothing; the reference then routes on its own.
    whole = all(tuple(r.shape) == (d.moe_layers, b * t, d.top_k) for r in routes)
    replay = router_replay(cell, seed, device, rows, routes[0]) if whole else None
    del rows
    ref, shares = reference_follow(cell, seed, device, data, routes=routes if whole else None)
    if whole:
        for name, values in (("route_agreement", shares), ("route_replay", replay)):
            print(f"{name} by expert layer " + " ".join(f"{x:.5f}" for x in values),
                  file=sys.stderr)
    correct, checks, failed = judge(cell, readings, ref, shares if whole else None, replay)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    result = {"correct": correct, "attempted": cell.traffic["checked_steps"] + steps,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    return result, checks
