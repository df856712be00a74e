"""Where a train step's time goes on the card, for the port's main paths.

    python -m ddl_tpu_torch.tools.step_anatomy [--variant cnn|lm|async] [--batch-size N] [--steps N] [--out FILE]

``--variant cnn`` (the default) runs the ZeRO-1 sync step
(``make_sharded_step``: one worker, ``num_ps=2``, layout ``flat``) at full
width over an NCCL world of one, batch 100 by default. ``--variant lm``
runs the decoder-LM train step (``strategies/seq.py::_step_body``, scheme
full) at the widest LM width the repo defines (benchmarks/lm_bench.py:
vocab 256, d_model 512, 8 heads, 4 layers, d_ff 2048), T = 2048, batch 4 by
default, fp32. ``--variant async`` runs the async parameter server's round
(``strategies/async_ps.py::make_async_round``, one worker, batch 100 a push
by default) at the CNN's full width over the same world: ``async_sharding``
(``num_ps=2``, block, folded onto the rank) and ``async`` (the replicated
serve), beside the ZeRO-1 sync step with fused Adam, in spans of up to 10
rounds (the trainer's eval cadence; each span ends with the PS all-gather).
Each reports, as one JSON line:

- ``steady``: host-clock ms per step over ``--steps`` steps after a
  warm-up, closed by ``torch.cuda.synchronize``, for the two versions in
  turns (plain, kernel, kernel, plain): plain and fused Adam for the CNN,
  ``attn_impl`` xla and flash for the LM, sync and the two async serves
  (sync, async_sharding, async, async, async_sharding, sync) for async; and
  images/s or tokens/s (the LM also gives each impl's peak allocated
  memory over its own runs);
- ``anatomy``: a ``torch.profiler`` trace of a few steps of the kernel
  version (async: of each serve): device time per step by kernel family
  (CNN and async: conv, matmul, pool, fused Adam, NCCL, other; LM: the
  flash kernels, cuBLAS matmuls,
  elementwise, other), the device's busy and idle share of the wall time,
  and the ten costliest kernels. Where the profiler records no device
  time, the breakdown reads "not measured".

Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
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

CNN_FAMILIES = (
    ("fused_adam", re.compile(r"adam_flat_\w*kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("conv", re.compile(r"conv|cudnn|implicit|dgrad|wgrad|fprop|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|cublas|xmma|sgemm|splitK", re.I)),
    ("pool", re.compile(r"max_pool|MaxPool", re.I)),
)
LM_FAMILIES = (
    ("flash", re.compile(r"flash_(fwd|bwd_dkv|bwd_dq)_kernel")),
    ("matmul", re.compile(r"gemm|cutlass|cublas|xmma|sgemm|splitK", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)
# The widest LM the repo defines (benchmarks/lm_bench.py) at its T.
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
    with tempfile.TemporaryDirectory() as store:
        world = init_world(1, 0, f"file://{os.path.join(store, 'store')}", "cuda")
        try:
            steps = {}
            for fused in (False, True):
                cfg = TrainConfig(batch_size=bs, num_workers=1, num_ps=2, layout="flat",
                                  fused_adam=fused, keep_prob=0.5)
                layout = resolve_layout(cfg, 1)
                steps[fused] = (make_sharded_step(cfg, world, layout), layout)
            state = {"params": {k: torch.tensor(v, device=dev) for k, v in init.items()},
                     "opt": sharded_adam_init(world, steps[True][1]), "step": 0}

            def run(fused, n):
                state["params"], state["opt"] = _run(steps[fused][0], state["params"],
                                                     state["opt"], xs, ys, n, state["step"])
                state["step"] += n

            run(True, 5)  # warm-up
            run(False, 5)
            torch.cuda.synchronize()
            ms = steady_ms(run, (False, True, True, False), args.steps)
            emit({"phase": "steady", "variant": "cnn", "batch_size": bs, "steps": args.steps,
                  "plain_ms_per_step": ms[False], "fused_ms_per_step": ms[True],
                  "fused_images_per_sec": [bs / (t * 1e-3) for t in ms[True]]})
            emit({"phase": "anatomy", "variant": "cnn", "batch_size": bs,
                  **anatomy(lambda n: run(True, n), 10, CNN_FAMILIES)})
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
    from ..models.transformer import init_lm_params
    from ..ops import flash_attention
    from ..ops.optimizers import adam_init
    from ..strategies.seq import SeqConfig, _step_body
    from ..utils import tree

    dev = default_device("cuda")
    bs = args.batch_size or 4
    ds = synthesize_copy(num_train=4 * bs, num_test=0, seq_len=LM_SEQ_LEN, vocab=LM_SPEC.vocab,
                         seed=0)
    stage = lambda a, dtype: torch.as_tensor(  # noqa: E731
        a.reshape(4, bs, LM_SEQ_LEN)).to(dtype).to(dev)
    xs, ys, ws = stage(ds.tokens, torch.long), stage(ds.targets, torch.long), stage(
        ds.weights, torch.float32)
    base = SeqConfig(scheme="full", batch_size=bs, learning_rate=1e-3, spec=LM_SPEC)
    steps = {impl: _step_body(dataclasses.replace(base, attn_impl=impl))
             for impl in ("xla", "flash")}
    params = init_lm_params(torch.Generator().manual_seed(0), LM_SPEC, dev)
    state = {"params": params, "opt": adam_init(params), "i": 0}
    flash_attention.load_kernel()
    peak = {"xla": 0, "flash": 0}  # bytes allocated at most during one impl's runs

    def run(impl, n):
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(n):
            i = state["i"] % xs.shape[0]
            state["params"], state["opt"], _ = steps[impl](state["params"], state["opt"],
                                                           xs[i], ys[i], ws[i])
            state["i"] += 1
        peak[impl] = max(peak[impl], torch.cuda.max_memory_allocated(dev))

    run("flash", 3)  # warm-up
    run("xla", 3)
    torch.cuda.synchronize()
    ms = steady_ms(run, ("xla", "flash", "flash", "xla"), args.steps)
    tokens = bs * LM_SEQ_LEN
    emit({"phase": "steady", "variant": "lm", "batch_size": bs, "seq_len": LM_SEQ_LEN,
          "steps": args.steps, "xla_ms_per_step": ms["xla"], "flash_ms_per_step": ms["flash"],
          "flash_tokens_per_sec": [tokens / (t * 1e-3) for t in ms["flash"]],
          "xla_tokens_per_sec": [tokens / (t * 1e-3) for t in ms["xla"]],
          "peak_memory_gb": {impl: b / 1e9 for impl, b in peak.items()}})
    emit({"phase": "anatomy", "variant": "lm", "attn_impl": "flash", "batch_size": bs,
          "seq_len": LM_SEQ_LEN, **anatomy(lambda n: run("flash", n), 5, LM_FAMILIES)})
    if not all(bool(torch.isfinite(t).all()) for t in tree.leaves(state["opt"].m)):
        raise AssertionError("non-finite optimizer state")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ddl_tpu_torch.tools.step_anatomy")
    ap.add_argument("--variant", default="cnn", choices=["cnn", "lm", "async"])
    ap.add_argument("--batch-size", type=int, default=None,
                    help="images (cnn, default 100) or sequences (lm, default 4)")
    ap.add_argument("--steps", type=int, default=20)
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

    {"cnn": cnn_variant, "lm": lm_variant, "async": async_variant}[args.variant](args, emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
