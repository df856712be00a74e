"""Where a train step's time goes on the card, for the port's main paths.

    python -m ddl_tpu_torch.tools.step_anatomy [--variant cnn|lm|async|serve] [--batch-size N] [--steps N] [--out FILE]
        [--seq-scheme full|ring|ulysses] [--seq-layout contiguous|zigzag] [--zero1]

``--variant cnn`` (the default) runs the ZeRO-1 sync step
(``make_sharded_step``: one worker, ``num_ps=2``, layout ``flat``) at full
width over an NCCL world of one, batch 100 by default. ``--variant lm``
runs the decoder-LM train step (``SeqTrainer.step_fn``) at the widest LM
width the repo defines (benchmarks/lm_bench.py: vocab 256, d_model 512, 8
heads, 4 layers, d_ff 2048), T = 2048, batch 4 by default, fp32, over an
NCCL world of one: scheme full in xla and flash by default, or with
``--seq-scheme ring|ulysses`` (``--seq-layout``, ``--zero1``) that scheme
against full on the same local attention (ring: xla, ulysses: flash). ``--variant async`` runs the async parameter server's round
(``strategies/async_ps.py::make_async_round``, one worker, batch 100 a push
by default) at the CNN's full width over the same world: ``async_sharding``
(``num_ps=2``, block, folded onto the rank) and ``async`` (the replicated
serve), beside the ZeRO-1 sync step with fused Adam, in spans of up to 10
rounds (the trainer's eval cadence; each span ends with the PS all-gather).
``--variant serve`` runs single-engine serving (``serve/``) at
``chip_smoke.py`` serve_main's configuration: the LM at
benchmarks/serve_bench.py's width (the lm variant's), 8 slots, capacity 512,
greedy, 16 prompts of 16-128 tokens from seed 0, 64 new tokens each, in the
contiguous layout and the paged one (page 64). Each reports, as one JSON
line:

- ``steady``: host-clock ms per step over ``--steps`` steps after a
  warm-up, closed by ``torch.cuda.synchronize``, for the versions in
  turns, forward then back (plain, kernel, kernel_bf16, kernel_bf16,
  kernel, plain): plain, fused and fused_bf16 Adam for the CNN,
  ``attn_impl`` xla, flash and flash_bf16 for the LM (or full and the
  scheme), sync and the two async serves for async; and
  images/s or tokens/s (the LM also gives each version's peak allocated
  memory over its own runs). Serve: one ``Scheduler.run`` of the whole
  traffic a turn (contiguous, paged, paged_bf16, and back, each after
  ``warmup``): decode tokens/s, host ms a decode tick, TTFT and ITL;
- ``anatomy``: a ``torch.profiler`` trace of a few steps of each kernel
  version (async: of each serve): device time per step by kernel family
  (CNN and async: conv, matmul, pool, fused Adam, NCCL, other; LM: the
  flash kernels, cuBLAS matmuls,
  elementwise, other; serve: matmul, softmax, index, reduce, elementwise,
  copy, other), the device's busy and idle share of the wall time, and the
  ten costliest kernels. Serve profiles ``--steps`` decode ticks with all 8
  slots active (each layout's first 8 prompts prefilled), after the same
  ticks unprofiled (``host_ms_per_tick``), beside the bytes a tick must
  move over the HBM rate (``bytes_bound_ms``: the weights once but only
  the looked-up embedding rows, each slot's resident K/V rows, the new
  rows and the logits) and the bytes the tick's gather reads
  (``gather_bytes_ms``: the whole embedding table, every slot's attended
  width).
  Where the profiler records no device time, the breakdown reads "not
  measured". The profiler slows the host, so the LM also gives the idle
  share of its unprofiled steady step (``device_idle_share_of_steady``).

The cnn, lm (``full``, no ZeRO-1) and serve variants also time and
profile their kernel path under the bf16 precision policy, in turns with
the others: ``fused_bf16`` (bf16-staged images), ``flash_bf16`` and
``paged_bf16`` (``compute_dtype`` bfloat16, a bf16 pool).

Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import tempfile
import time

import torch

from ..convert import params_to_numpy
from ..data.mnist import load_mnist, one_hot
from ..models import cnn
from ..models.transformer import LMSpec
from ..ops.optimizers import ShardedAdam
from ..parallel.mesh import default_device, destroy_world, init_world
from ..strategies.sync import make_sharded_step, resolve_layout, sharded_adam_init
from ..train.config import TrainConfig
from ..train.trainer import staging_dtype

# cuBLAS's matrix products; on Hopper most are its ``nvjet_*`` kernels.
MATMUL = re.compile(r"gemm|cutlass|cublas|xmma|sgemm|splitK|nvjet", re.I)
CNN_FAMILIES = (
    ("fused_adam", re.compile(r"adam_flat_\w*kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("conv", re.compile(r"conv|cudnn|implicit|dgrad|wgrad|fprop|winograd|fft", re.I)),
    ("matmul", MATMUL),
    ("pool", re.compile(r"max_pool|MaxPool", re.I)),
)
LM_FAMILIES = (
    ("flash", re.compile(r"flash_(fwd|bwd_dkv|bwd_dq)_kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("matmul", MATMUL),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)
SERVE_FAMILIES = (
    ("matmul", MATMUL),
    ("softmax", re.compile(r"softmax", re.I)),
    ("index", re.compile(r"index|scatter|gather", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)
# The widest LM the repo defines (benchmarks/lm_bench.py) at its T; also
# benchmarks/serve_bench.py's serving width.
LM_SPEC = LMSpec(vocab=256, d_model=512, num_heads=8, num_layers=4, d_ff=2048)
LM_SEQ_LEN = 2048


def family(name: str, families=CNN_FAMILIES) -> str:
    for fam, pat in families:
        if pat.search(name):
            return fam
    return "other"


def _run(step, params, opt, xs, ys, steps, first_step):
    for i in range(steps):
        params, opt, _ = step(params, opt, xs[i % xs.shape[0]], ys[i % ys.shape[0]],
                              first_step + i)
    return params, opt


def steady_ms(run, order, steps: int) -> dict:
    """Host-clock ms per step of ``run(version, steps)`` for each version in
    ``order``, each run closed by a device barrier."""
    ms = {v: [] for v in order}
    for version in order:
        t0 = time.perf_counter()
        run(version, steps)
        torch.cuda.synchronize()
        ms[version].append((time.perf_counter() - t0) / steps * 1e3)
    return ms


def anatomy(run, n: int, families) -> dict:
    """``torch.profiler`` over ``run(n)``: device ms per step by family,
    busy and idle share of the wall time, and the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + t
    busy = sum(kernels.values())
    if busy <= 0:
        return {"device_time": "not measured", "wall_ms_per_step": wall_us / n / 1e3}
    fams = {}
    for name, t in kernels.items():
        fam = family(name, families)
        fams[fam] = fams.get(fam, 0.0) + t
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": n,
        "wall_ms_per_step": wall_us / n / 1e3,
        "device_busy_ms_per_step": busy / n / 1e3,
        "device_busy_share": busy / wall_us,
        "device_idle_share": 1.0 - busy / wall_us,
        "family_ms_per_step": {k: v / n / 1e3 for k, v in
                               sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[k[:90], v / n / 1e3] for k, v in top],
    }


def cnn_variant(args, emit) -> None:
    dev = default_device("cuda")
    bs = args.batch_size or 100
    ds = load_mnist(None, synthetic_train=10 * bs, synthetic_test=10, seed=0)
    xs = torch.as_tensor(ds.x_train.reshape(10, bs, 784)).to(dev)
    ys = torch.as_tensor(one_hot(ds.y_train).reshape(10, bs, 10)).to(dev)
    init = params_to_numpy(cnn.init_params(torch.Generator().manual_seed(0), "cpu"))
    # version -> config fields; the fused ones are profiled.
    fields = {"plain": dict(fused_adam=False), "fused": dict(fused_adam=True),
              "fused_bf16": dict(fused_adam=True, precision="bf16")}
    names, profiled = tuple(fields), ("fused", "fused_bf16")
    with tempfile.TemporaryDirectory() as store:
        world = init_world(1, 0, f"file://{os.path.join(store, 'store')}", "cuda")
        try:
            steps = {}
            for v in names:
                cfg = TrainConfig(batch_size=bs, num_workers=1, num_ps=2, layout="flat",
                                  keep_prob=0.5, **fields[v])
                layout = resolve_layout(cfg, 1)
                steps[v] = (make_sharded_step(cfg, world, layout), layout,
                            xs.to(staging_dtype(cfg)))
            state = {"params": {k: torch.tensor(v, device=dev) for k, v in init.items()},
                     "opt": sharded_adam_init(world, steps["fused"][1]), "step": 0}

            def run(version, n):
                step, _, xv = steps[version]
                state["params"], state["opt"] = _run(step, state["params"], state["opt"], xv,
                                                     ys, n, state["step"])
                state["step"] += n

            for v in names:  # warm-up
                run(v, 5)
            torch.cuda.synchronize()
            ms = steady_ms(run, (*names, *reversed(names)), args.steps)
            emit({"phase": "steady", "variant": "cnn", "batch_size": bs, "steps": args.steps,
                  **{f"{v}_ms_per_step": ms[v] for v in names},
                  **{f"{v}_images_per_sec": [bs / (t * 1e-3) for t in ms[v]] for v in names}})
            for v in profiled:
                emit({"phase": "anatomy", "variant": "cnn", "version": v, "batch_size": bs,
                      **anatomy(lambda n: run(v, n), 10, CNN_FAMILIES)})
            if not isinstance(state["opt"], ShardedAdam) or not torch.isfinite(
                    state["opt"].m).all():
                raise AssertionError("non-finite optimizer state")
        finally:
            destroy_world()


def async_variant(args, emit) -> None:
    from ..strategies import async_ps

    dev = default_device("cuda")
    bs = args.batch_size or 100
    span = 10  # rounds a span: the trainer's eval cadence
    ds = load_mnist(None, synthetic_train=span * bs, synthetic_test=10, seed=0)
    xs = torch.as_tensor(ds.x_train.reshape(span, bs, 784)).to(dev)
    ys = torch.as_tensor(one_hot(ds.y_train).reshape(span, bs, 10)).to(dev)
    init = params_to_numpy(cnn.init_params(torch.Generator().manual_seed(0), "cpu"))
    with tempfile.TemporaryDirectory() as store:
        world = init_world(1, 0, f"file://{os.path.join(store, 'store')}", "cuda")
        try:
            params = {k: torch.tensor(v, device=dev) for k, v in init.items()}
            cfg = TrainConfig(batch_size=bs, num_workers=1, num_ps=2, layout="flat",
                              fused_adam=True, keep_prob=0.5)
            layout = resolve_layout(cfg, 1)
            sync = {"step": make_sharded_step(cfg, world, layout), "params": params,
                    "opt": sharded_adam_init(world, layout)}
            serves = {}
            for name, num_ps in (("async_sharding", 2), ("async", 1)):
                acfg = TrainConfig(batch_size=bs, num_workers=1, num_ps=num_ps, layout="block",
                                   keep_prob=0.5)
                lay = async_ps.serve_layout_for(acfg, 1)
                serves[name] = {"run": async_ps.make_async_round(acfg, world, lay),
                                "state": async_ps.async_state_init(acfg, world, lay, params)}
            sched = async_ps.async_schedule(0, 1, span)
            done = {"sync": 0, "async_sharding": 0, "async": 0}

            def run(version, n):
                for lo in range(0, n, span):
                    k = min(span, n - lo)
                    if version == "sync":
                        sync["params"], sync["opt"] = _run(sync["step"], sync["params"],
                                                           sync["opt"], xs, ys, k, done["sync"])
                    else:
                        sv = serves[version]
                        sv["state"], _, _ = sv["run"](sv["state"], xs[:k], ys[:k], sched[:k],
                                                      done[version])
                    done[version] += k

            order = ("sync", "async_sharding", "async", "async", "async_sharding", "sync")
            for version in ("sync", "async_sharding", "async"):
                run(version, 5)  # warm-up
            torch.cuda.synchronize()
            ms = steady_ms(run, order, args.steps)
            emit({"phase": "steady", "variant": "async", "batch_size": bs, "steps": args.steps,
                  "span_rounds": span, "order": list(order),
                  **{f"{v}_ms_per_step": ms[v] for v in ("sync", "async_sharding", "async")},
                  **{f"{v}_images_per_sec": [bs / (t * 1e-3) for t in ms[v]]
                     for v in ("sync", "async_sharding", "async")}})
            for name in ("async_sharding", "async"):
                st = serves[name]["state"]
                emit({"phase": "anatomy", "variant": name, "batch_size": bs,
                      "n": int(st.ps.numel()),
                      **anatomy(lambda n: run(name, n), span, CNN_FAMILIES)})
                if not all(bool(torch.isfinite(t).all()) for t in (st.ps, st.m, st.v)):
                    raise AssertionError(f"non-finite {name} serve state")
        finally:
            destroy_world()


def lm_variant(args, emit) -> None:
    from ..data.lm import synthesize_copy
    from ..ops import flash_attention
    from ..strategies.seq import SeqConfig, SeqTrainer
    from ..utils import tree

    bs = args.batch_size or 4
    ds = synthesize_copy(num_train=4 * bs, num_test=0, seq_len=LM_SEQ_LEN, vocab=LM_SPEC.vocab,
                         seed=0)
    base = SeqConfig(scheme="full", batch_size=bs, learning_rate=1e-3, seed=0, spec=LM_SPEC)
    if args.seq_scheme == "full" and not args.zero1:
        versions = {impl: dataclasses.replace(base, attn_impl=impl) for impl in ("xla", "flash")}
        versions["flash_bf16"] = dataclasses.replace(base, attn_impl="flash", precision="bf16")
        subjects = ("flash", "flash_bf16")
    else:
        # The scheme against full on the same local attention.
        impl = "xla" if args.seq_scheme == "ring" else "flash"
        versions = {"full": dataclasses.replace(base, attn_impl=impl),
                    "seq": dataclasses.replace(base, attn_impl=impl, scheme=args.seq_scheme,
                                               seq_layout=args.seq_layout, zero1=args.zero1)}
        subjects = ("seq",)
    flash_attention.load_kernel()
    with tempfile.TemporaryDirectory() as store:
        world = init_world(1, 0, f"file://{os.path.join(store, 'store')}", "cuda")
        try:
            trainers = {v: SeqTrainer(c, ds, world=world) for v, c in versions.items()}
            steps = {v: t.step_fn() for v, t in trainers.items()}
            batches = {v: [t.stage_batches(a, 4, bs) for a in (ds.tokens, ds.targets, ds.weights)]
                       for v, t in trainers.items()}
            state = {v: [t.params, t.opt_state] for v, t in trainers.items()}
            peak = dict.fromkeys(versions, 0)  # bytes allocated at most during a version's runs
            count = {"i": 0}

            def run(version, n):
                torch.cuda.reset_peak_memory_stats()
                xs, ys, ws = batches[version]
                for _ in range(n):
                    i = count["i"] % xs.shape[0]
                    state[version][0], state[version][1], _ = steps[version](
                        *state[version], xs[i], ys[i], ws[i])
                    count["i"] += 1
                peak[version] = max(peak[version], torch.cuda.max_memory_allocated())

            for v in versions:  # warm-up
                run(v, 3)
            torch.cuda.synchronize()
            ms = steady_ms(run, (*versions, *reversed(versions)), args.steps)
            tokens = bs * LM_SEQ_LEN
            config = {"seq_scheme": args.seq_scheme, "seq_layout": args.seq_layout,
                      "zero1": args.zero1}
            emit({"phase": "steady", "variant": "lm", **config, "batch_size": bs,
                  "seq_len": LM_SEQ_LEN, "steps": args.steps,
                  **{f"{v}_ms_per_step": ms[v] for v in versions},
                  **{f"{v}_tokens_per_sec": [tokens / (t * 1e-3) for t in ms[v]]
                     for v in versions},
                  "peak_memory_gb": {v: b / 1e9 for v, b in peak.items()}})
            for v in subjects:
                anat = anatomy(lambda n: run(v, n), 5, LM_FAMILIES)
                if "device_busy_ms_per_step" in anat:
                    # The profiler slows the host: the idle share of the
                    # unprofiled steady step (the median of its turns)
                    # beside the traced one.
                    steady = statistics.median(ms[v])
                    anat["steady_ms_per_step"] = steady
                    anat["device_idle_share_of_steady"] = (
                        1.0 - anat["device_busy_ms_per_step"] / steady)
                emit({"phase": "anatomy", "variant": "lm", **config, "version": v,
                      "attn_impl": versions[v].attn_impl, "precision": versions[v].precision,
                      "batch_size": bs, "seq_len": LM_SEQ_LEN, **anat})
        finally:
            destroy_world()
    for v in subjects:
        if not all(bool(torch.isfinite(t).all()) for t in tree.leaves(state[v][1].m)):
            raise AssertionError(f"{v}: non-finite optimizer state")


def serve_variant(args, emit) -> None:
    import numpy as np

    from ..data.lm import synthesize_prompts
    from ..models.transformer import init_lm_params
    from ..serve import InferenceEngine, Request, Scheduler, ServeConfig
    from .devtime import hbm_bytes_per_s

    dev = default_device("cuda")
    slots, capacity, new = 8, 512, 64
    prompts = synthesize_prompts(num=16, min_len=16, max_len=128, vocab=LM_SPEC.vocab, seed=0)
    requests = [Request(id=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    params = init_lm_params(torch.Generator().manual_seed(0), LM_SPEC, dev)
    # version -> (page size, compute dtype): the two layouts, and the paged
    # one in bf16.
    layouts = {"contiguous": (0, None), "paged": (64, None), "paged_bf16": (64, "bfloat16")}
    scheds = {name: Scheduler(InferenceEngine(
        ServeConfig(spec=LM_SPEC, slots=slots, capacity=capacity, page_size=ps,
                    compute_dtype=dtype),
        placed_params=params, device=dev)) for name, (ps, dtype) in layouts.items()}
    order = (*layouts, *reversed(layouts))
    runs = {name: [] for name in layouts}
    for name in order:
        sched = scheds[name]
        sched.warmup(requests)
        done, st = sched.run(requests)
        if any(c.status != "ok" or len(c.tokens) != new for c in done.values()):
            raise AssertionError(f"{name}: a request did not finish ok")
        runs[name].append({
            "decode_tokens_per_s": st.decode_tokens_per_s, "decode_ticks": st.decode_steps,
            "decode_tick_ms": {"mean": st.latency.mean_ms, "p50": st.latency.p50_ms,
                               "p95": st.latency.p95_ms},
            "ttft_ms": {"p50": st.ttft.p50_ms, "p95": st.ttft.p95_ms},
            "itl_ms": {"p50": st.itl.p50_ms, "p95": st.itl.p95_ms},
            "last_attend_width": sched.engine.last_attend_width})
    emit({"phase": "steady", "variant": "serve", "slots": slots, "capacity": capacity,
          "requests": len(requests), "new_tokens": new, "order": list(order), "runs": runs})
    e, vocab = LM_SPEC.d_model, LM_SPEC.vocab
    weight_bytes = 4 * LM_SPEC.num_params()  # the fp32 weights, cast at use under bf16
    for name, sched in scheds.items():
        eng = sched.engine
        kv_row = 2 * LM_SPEC.num_layers * e * eng.cache.k.element_size()  # K and V, every layer
        eng.reset()
        lengths = np.array([len(p) for p in prompts[:slots]], np.int32)
        last = np.array([eng.prefill(p, slot=s, request_id=s)[0]
                         for s, p in enumerate(prompts[:slots])], np.int32)
        rids = np.arange(slots, dtype=np.int32)
        active = np.ones(slots, bool)
        resident = []  # rows already cached, summed over the slots, a tick

        def ticks(n):
            nonlocal last, lengths
            for _ in range(n):
                resident.append(int(lengths.sum()))
                last, _ = eng.decode(last, lengths, rids, active)
                lengths = lengths + 1

        ticks(3)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ticks(args.steps)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / args.steps * 1e3
        breakdown = anatomy(ticks, args.steps, SERVE_FAMILIES)
        rows = float(np.mean(resident[-args.steps:]))  # the profiled ticks'
        # The least a tick moves, each input read once and each output
        # written once: every weight but the embedding table, the slots'
        # embedding rows, each slot's cached K/V rows and positions, its new
        # row, and the logits. Beside it, what the gather reads: the whole
        # table and every slot's attended width.
        nbytes = (weight_bytes - 4 * vocab * e + 4 * slots * e
                  + (rows + slots) * (kv_row + 4) + 4 * slots * vocab)
        width = eng.last_attend_width
        gather = weight_bytes + slots * width * kv_row
        hbm = hbm_bytes_per_s(torch.cuda.get_device_name(0))
        emit({"phase": "anatomy", "variant": f"serve_{name}", "slots": slots,
              "attend_width": width, "resident_rows_per_slot": rows / slots,
              "host_ms_per_tick": host_ms, "bytes_per_tick": nbytes,
              "bytes_bound_ms": nbytes / hbm * 1e3, "gather_bytes_per_tick": gather,
              "gather_bytes_ms": gather / hbm * 1e3, **breakdown})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ddl_tpu_torch.tools.step_anatomy")
    ap.add_argument("--variant", default="cnn", choices=["cnn", "lm", "async", "serve"])
    ap.add_argument("--batch-size", type=int, default=None,
                    help="images (cnn, default 100) or sequences (lm, default 4)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-scheme", default="full", choices=["full", "ring", "ulysses"],
                    help="lm: the scheme timed against full (ring on xla attention, "
                         "ulysses on flash)")
    ap.add_argument("--seq-layout", default="contiguous", choices=["contiguous", "zigzag"],
                    help="lm: the ring's layout")
    ap.add_argument("--zero1", action="store_true", help="lm: the ZeRO-1 update")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    default_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(rec):
        rec = {"card": torch.cuda.get_device_name(0), **rec}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    {"cnn": cnn_variant, "lm": lm_variant, "async": async_variant,
     "serve": serve_variant}[args.variant](args, emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
