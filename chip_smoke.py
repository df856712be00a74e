#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ddl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``) and the torch/CUDA versions; turns TF32 off
   for cuDNN convs and cuBLAS matmuls (fp32 parity).
2. build   — builds every CUDA kernel from ``ddl_tpu_torch/csrc`` with nvcc
   (one nvcc per source, all started together).
3. kernel  — the fused-Adam kernel against its plain PyTorch version on the
   card, at n = 5, 1024, 65,536, 65,553, 2,656,128 and on a slice at an
   offset of one element (the scalar path); atol 2e-7 on p, m and v.
4. main    — the port's main path: ``SyncTrainer`` at full width (conv
   32/64/128/256, FC 1024/512), batch 100, one worker, ``num_ps=2``, layout
   ``flat``, ``fused_adam``, keep_prob 0.5, 2,000 synthetic images (20
   steps, evals after steps 1, 11 and at the end) over an NCCL world of one.
   The kernel's launch count is set to 0 just before and must read 20
   just after; losses, parameters and moments must be finite.
5. fused_vs_plain — the same trainer from one init at keep_prob 1 for 2
   steps, fused and plain Adam: params, m and v agree to atol 1e-6.
6. timing  — the kernel at n = 2,656,128 (the main path's flat vector):
   median of 200 launches timed with CUDA events, against its bound (28
   bytes an element over the card's HBM rate), the plain chain, and
   ``torch._fused_adam_`` driven to the same function (eps rescaled by
   1/sqrt(1-b2^t)) as the library yardstick; never on the port's path.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no ``ok`` line. It needs no network and one card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# n of the main path's flat vector: 2,656,010 parameters, lane-padded.
FULL_N = 2_656_128
KERNEL_SIZES = (5, 1024, 65_536, 65_553, FULL_N)
ATOL_KERNEL = 2e-7
ATOL_FUSED_VS_PLAIN = 1e-6
MAIN_STEPS = 20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM rate of the card (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (80GB HBM3)


FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def adam_inputs(torch, n: int, gen, device):
    p, m, g = (torch.randn(n, generator=gen, device=device) for _ in range(3))
    v = torch.randn(n, generator=gen, device=device).abs()
    return p, m, v, g


def check_kernel(torch, fused_adam) -> float:
    """Kernel vs plain on the card; returns the largest abs error."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lr_t = torch.tensor([3e-4], device=dev)
    worst = 0.0
    cases = [(n, 0) for n in KERNEL_SIZES] + [(65_553, 1)]
    for n, offset in cases:
        bufs = adam_inputs(torch, n + offset, gen, dev)
        want = fused_adam.adam_flat_reference(*(b[offset:] for b in bufs), lr_t)
        # The kernel updates its copies in place, at the same offset (an
        # offset of one float leaves the 16-byte alignment: scalar path).
        p, m, v = (b.clone()[offset:] for b in bufs[:3])
        g = bufs[3][offset:]
        vec4 = all(t.data_ptr() % 16 == 0 for t in (p, m, v, g))
        got = fused_adam.adam_flat_fused(p, m, v, g, lr_t)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        emit("kernel", n=n, offset=offset, vec4=vec4,
             max_abs_err={"p": errs[0], "m": errs[1], "v": errs[2]})
        if not all(e <= ATOL_KERNEL for e in errs):
            raise AssertionError(f"kernel != plain at n={n} offset={offset}: {errs}")
        worst = max(worst, *errs)
    return worst


def main_path(torch, world, fused_adam) -> dict:
    from ddl_tpu_torch.data.mnist import load_mnist
    from ddl_tpu_torch.models import cnn
    from ddl_tpu_torch.strategies.sync import SyncTrainer
    from ddl_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig(
        batch_size=100, num_workers=1, num_ps=2, layout="flat", fused_adam=True,
        keep_prob=0.5, eval_every=10, seed=0,
    )
    ds = load_mnist(path=None, synthetic_train=MAIN_STEPS * 100, synthetic_test=1000, seed=0)
    trainer = SyncTrainer(cfg, ds, world=world)
    if trainer.layout.max_shard != FULL_N:
        raise AssertionError(f"flat shard is {trainer.layout.max_shard}, want {FULL_N}")
    fused_adam.launches = 0
    result = trainer.train(log=lambda s: None)
    launches = fused_adam.launches
    if launches != MAIN_STEPS:
        raise AssertionError(f"fused-Adam kernel launched {launches} times, want {MAIN_STEPS}")
    finite = all(math.isfinite(x) for x in result.span_losses)
    finite &= all(bool(torch.isfinite(t).all()) for t in trainer.params.values())
    finite &= bool(torch.isfinite(trainer.opt_state.m).all())
    finite &= bool(torch.isfinite(trainer.opt_state.v).all())
    if not finite:
        raise AssertionError("non-finite loss, parameter or moment on the main path")
    if cnn.param_shapes(trainer.params) != dict(cnn.PARAM_SPECS):
        raise AssertionError(f"parameter shapes {cnn.param_shapes(trainer.params)}")
    if int(trainer.opt_state.step) != MAIN_STEPS:
        raise AssertionError(f"Adam step {int(trainer.opt_state.step)}, want {MAIN_STEPS}")
    if len(result.history) != 2 or not 0.0 <= result.final_accuracy <= 1.0:
        raise AssertionError(f"unexpected evals {result.history} / {result.final_accuracy}")
    stats = result.step_stats
    out = dict(
        steps=MAIN_STEPS, launches=launches, images_per_sec=result.images_per_sec,
        train_time_s=result.train_time_s, warmup_s=result.compile_time_s,
        span_losses=result.span_losses, history=result.history,
        final_accuracy=result.final_accuracy,
        span_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "p99": stats.p99_ms,
                 "mean": stats.mean_ms, "spans": stats.steps},
    )
    emit("main", **out)
    return out


def fused_vs_plain(torch, world) -> float:
    from ddl_tpu_torch.convert import params_to_numpy
    from ddl_tpu_torch.data.mnist import load_mnist
    from ddl_tpu_torch.models import cnn
    from ddl_tpu_torch.strategies.sync import SyncTrainer
    from ddl_tpu_torch.train.config import TrainConfig

    init = params_to_numpy(cnn.init_params(torch.Generator().manual_seed(1), "cpu"))
    ds = load_mnist(path=None, synthetic_train=200, synthetic_test=100, seed=1)
    runs = {}
    for fused in (True, False):
        cfg = TrainConfig(batch_size=100, num_workers=1, num_ps=2, layout="flat",
                          fused_adam=fused, keep_prob=1.0, eval_every=0, seed=1)
        t = SyncTrainer(cfg, ds, world=world, init=init)
        t.train(log=lambda s: None)
        runs[fused] = t
    a, b = runs[True], runs[False]
    errs = {k: float((a.params[k] - b.params[k]).abs().max()) for k in a.params}
    errs["m"] = float((a.opt_state.m - b.opt_state.m).abs().max())
    errs["v"] = float((a.opt_state.v - b.opt_state.v).abs().max())
    worst = max(errs.values())
    emit("fused_vs_plain", steps=2, max_abs_err=worst, atol=ATOL_FUSED_VS_PLAIN)
    if worst > ATOL_FUSED_VS_PLAIN or int(a.opt_state.step) != 2:
        raise AssertionError(f"fused != plain after 2 steps: {errs}")
    return worst


def median_ms(torch, fn, reps: int = 200, warm: int = 10) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def timing(torch, fused_adam, card: str) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    n = FULL_N
    b1, b2, eps, lr, t = 0.9, 0.999, 1e-8, 1e-4, 10
    lr_t_val = lr * math.sqrt(1 - b2**t) / (1 - b1**t)
    lr_t = torch.tensor([lr_t_val], device=dev)
    p, m, v, g = adam_inputs(torch, n, gen, dev)
    # The library call's formula is lr/(1-b1^t) * m / (sqrt(v)/sqrt(1-b2^t) + eps'),
    # which is TF1's with eps' = eps / sqrt(1-b2^t).
    step_t = torch.tensor(float(t), device=dev)

    def library(pp, mm, vv):
        torch._fused_adam_(
            [pp], [g], [mm], [vv], [], [step_t], lr=lr, beta1=b1, beta2=b2,
            weight_decay=0.0, eps=eps / math.sqrt(1 - b2**t), amsgrad=False,
            maximize=False,
        )

    want = fused_adam.adam_flat_reference(p, m, v, g, lr_t)
    lib_out = (p.clone(), m.clone(), v.clone())
    library(*lib_out)
    torch.cuda.synchronize()
    library_err = max(float((a - b).abs().max()) for a, b in zip(lib_out, want))

    # Timed on the same buffers, updated in place over and over: the work
    # per call does not depend on the values.
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ms = median_ms(torch, lambda: fused_adam.adam_flat_fused(kp, km, kv, g, lr_t))
    plain_ms = median_ms(torch, lambda: fused_adam.adam_flat_reference(p, m, v, g, lr_t))
    lp, lm, lv = p.clone(), m.clone(), v.clone()
    library_ms = median_ms(torch, lambda: library(lp, lm, lv))
    nbytes = 28 * n  # read g, m, v, p; write p', m', v'
    ops = 12 * n  # 7 mul, 3 add/sub, 1 sqrt, 1 div per element
    bytes_ms = nbytes / hbm_bytes_per_s(card) * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    out = dict(
        n=n, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        library_max_abs_err=library_err,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        gb_per_s=nbytes / (ms * 1e-3) / 1e9,
        share_of_bound=max(bytes_ms, ops_ms) / ms,
        hbm_bytes_per_s=hbm_bytes_per_s(card),
    )
    emit("timing", **out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ddl_tpu_torch.ops import build, fused_adam
    from ddl_tpu_torch.parallel.mesh import destroy_world, init_world

    card = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=list(build.KERNEL_SOURCES))

    max_err = check_kernel(torch, fused_adam)

    with tempfile.TemporaryDirectory() as store:
        world = init_world(1, 0, f"file://{os.path.join(store, 'store')}", "cuda")
        try:
            main_out = main_path(torch, world, fused_adam)
            fused_vs_plain(torch, world)
        finally:
            destroy_world()

    tim = timing(torch, fused_adam, card)
    print(json.dumps({"kernels": [{
        "name": "adam_flat_fused",
        "route": "cuda",
        "source": "ddl_tpu_torch/csrc/fused_adam.cu",
        "replaces": "ddl_tpu/ops/pallas_adam.py:54",
        "launches": main_out["launches"],
        "max_abs_err": max_err,
        "ms": tim["ms"],
        "plain_ms": tim["plain_ms"],
        "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"],
        "library_ms": tim["library_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
