"""Where a train step's time goes on the card, for the port's main path.

    python -m ddl_tpu_torch.tools.step_anatomy [--batch-size 100] [--steps 20] [--out FILE]

Runs the ZeRO-1 sync step (``make_sharded_step``: one worker, ``num_ps=2``,
layout ``flat``) at full width over an NCCL world of one, and reports, each
as one JSON line:

- ``steady``: host-clock ms per step over ``--steps`` steps after a
  warm-up, closed by ``torch.cuda.synchronize``, for fused and plain Adam
  in turns (plain, fused, fused, plain), and images/s;
- ``anatomy``: a ``torch.profiler`` trace of 10 fused steps: device time
  per step by kernel family (conv, matmul, pool, fused Adam, NCCL, other
  elementwise), the device's busy and idle share of the wall time, and the
  ten costliest kernels. Where the profiler records no device time, the
  breakdown reads "not measured".

Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time

import torch

from ..convert import params_to_numpy
from ..data.mnist import load_mnist, one_hot
from ..models import cnn
from ..ops.optimizers import ShardedAdam
from ..parallel.mesh import default_device, destroy_world, init_world
from ..strategies.sync import make_sharded_step, resolve_layout, sharded_adam_init
from ..train.config import TrainConfig

FAMILIES = (
    ("fused_adam", re.compile(r"adam_flat_kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("conv", re.compile(r"conv|cudnn|implicit|dgrad|wgrad|fprop|winograd|fft", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|cublas|xmma|sgemm|splitK", re.I)),
    ("pool", re.compile(r"max_pool|MaxPool", re.I)),
)


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other"


def _run(step, params, opt, xs, ys, steps, first_step):
    for i in range(steps):
        params, opt, _ = step(params, opt, xs[i % xs.shape[0]], ys[i % ys.shape[0]],
                              first_step + i)
    return params, opt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ddl_tpu_torch.tools.step_anatomy")
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    dev = default_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(rec):
        rec = {"card": torch.cuda.get_device_name(0), **rec}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    bs = args.batch_size
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
            params = {k: torch.tensor(v, device=dev) for k, v in init.items()}
            opt = sharded_adam_init(world, steps[True][1])
            params, opt = _run(steps[True][0], params, opt, xs, ys, 5, 0)  # warm-up
            params, opt = _run(steps[False][0], params, opt, xs, ys, 5, 5)
            torch.cuda.synchronize()
            ms = {False: [], True: []}
            for fused in (False, True, True, False):
                t0 = time.perf_counter()
                params, opt = _run(steps[fused][0], params, opt, xs, ys, args.steps, 10)
                torch.cuda.synchronize()
                ms[fused].append((time.perf_counter() - t0) / args.steps * 1e3)
            emit({"phase": "steady", "batch_size": bs, "steps": args.steps,
                  "plain_ms_per_step": ms[False], "fused_ms_per_step": ms[True],
                  "fused_images_per_sec": [bs / (t * 1e-3) for t in ms[True]]})

            from torch.profiler import ProfilerActivity, profile

            n_prof = 10
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt = _run(steps[True][0], params, opt, xs, ys, n_prof, 100)
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
                emit({"phase": "anatomy", "device_time": "not measured",
                      "wall_ms_per_step": wall_us / n_prof / 1e3})
            else:
                fams = {}
                for name, t in kernels.items():
                    fams[family(name)] = fams.get(family(name), 0.0) + t
                top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
                emit({
                    "phase": "anatomy", "batch_size": bs, "steps": n_prof,
                    "wall_ms_per_step": wall_us / n_prof / 1e3,
                    "device_busy_ms_per_step": busy / n_prof / 1e3,
                    "device_busy_share": busy / wall_us,
                    "device_idle_share": 1.0 - busy / wall_us,
                    "family_ms_per_step": {k: v / n_prof / 1e3 for k, v in
                                           sorted(fams.items(), key=lambda kv: -kv[1])},
                    "top_kernels_ms_per_step": [[k[:90], v / n_prof / 1e3] for k, v in top],
                })
            if not isinstance(opt, ShardedAdam) or not torch.isfinite(opt.m).all():
                raise AssertionError("non-finite optimizer state")
        finally:
            destroy_world()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
