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
   card, at n = 5, 1024, 65,536, 65,553, 2,656,128, at sizes from the
   kernel's launch plan on this card (a full wave: every block of one
   resident wave one full tile; a full wave + 1 float4), at sizes from the
   layout code (the ZeRO-1 flat shard of one rank of 4 workers; the async
   serve's vectors: the ``async`` full vector of 2,656,010, whose last 2
   take the scalar tail, and the folded chunk of ``async_sharding``) and on
   a slice at an offset of one element (the scalar path): p, m and v must
   be bit-equal, and so must a repeat at n = 2,656,128.
4. main    — the port's main path: ``SyncTrainer`` at full width (conv
   32/64/128/256, FC 1024/512), batch 100, one worker, ``num_ps=2``, layout
   ``flat``, ``fused_adam``, keep_prob 0.5, 2,000 synthetic images (20
   steps, evals after steps 1, 11 and at the end) over an NCCL world of one.
   The kernel's launch count is set to 0 just before and must read 20
   just after; losses, parameters and moments must be finite.
5. fused_vs_plain — the same trainer from one init at keep_prob 1 for 2
   steps, fused and plain Adam: params, m and v agree to atol 1e-6.
5a. async_main — the async parameter server's path: ``AsyncTrainer`` at
   the same full width over the same NCCL world of one, ``async_sharding``
   (``num_ps=2``, layout block, folded onto the rank: the serve's two
   ``all_to_all_single`` calls are real NCCL calls), batch 100 a push,
   keep_prob 0.5, 2,000 synthetic images (20 rounds), an eval of the PS and
   of every worker's replica after rounds 0 and 10. The kernel's launch
   count is set to 0 just before and must read 20 (W x rounds, one a push)
   just after; t must read 20; losses, ps, m, v and the replica finite;
   one per-worker accuracy for each PS eval; the replica equal to the PS
   bit for bit (W = 1: the one worker pushed last).
5b. async_equivalence — from one init at keep_prob 1, 4 rounds of
   ``async`` (replicated serve, n = 2,656,010), ``async_sharding`` (block)
   and ``async_sharding_greedy`` (zigzag), cuDNN in its deterministic
   algorithms: the logical ps, m and v must be bit-equal across the three
   (Adam is elementwise), and the ``async`` parameters must equal
   ``SingleChipTrainer``'s over the same 4 batches within atol 1e-6.
6. timing  — the kernel at n = 2,656,128 (the main path's flat vector)
   by its device time (``ddl_tpu_torch/tools/devtime.py``): ``ms`` cold
   (the median of 100 launches, each after a 256 MB write that flushes the
   L2, read from the profiler by the kernel's name), ``hot_ms`` (no flush)
   and ``call_ms`` (CUDA events around each Python call, the host's time
   to reach the launch included); against its bound (28 bytes an element
   over the card's HBM rate, from the cold reading only), the plain chain
   and ``torch._fused_adam_`` driven to the same function (eps rescaled by
   1/sqrt(1-b2^t)) as the library yardstick, both by the same timer (the
   sum of their device events a call); never on the port's path.

7. flash_kernel — the flash-attention kernels (forward, dK/dV, dQ through
   ``flash_attention_bthd``'s autograd) against ``flash_attention_reference``
   (materialised fp32 scores, autograd gradients) for a loss ``sum(O * R)``
   with a seeded R, at [B, T, H, D] = [1, 64, 2, 16], [2, 200, 4, 32]
   (ragged), [4, 2048, 8, 64] (the LM path's) and [1, 512, 2, 128], causal
   and not. fp32: O within atol 1e-5 / rtol 1e-4, gradients within atol
   1e-4 / rtol 1e-3; bf16 inputs (and R) against the reference in fp32 on
   the same bf16 values: O within atol 2e-3 / rtol 1e-2, gradients within
   atol 1e-2 / rtol 1e-2.
8. flash_determinism — the forward, dK/dV and dQ twice on the same inputs
   at [4, 2048, 8, 64], causal, fp32 and bf16: o, lse, dk, dv and dq must
   be bit-equal.
9. lm_main — the port's ``SeqTrainer`` at the widest LM width the repo
   defines (benchmarks/lm_bench.py: vocab 256, d_model 512, 8 heads, 4
   layers, d_ff 2048; 12,864,512 parameters), scheme full, attn_impl flash,
   fp32, lr 1e-3, T = 2048, batch 4, 32 train sequences (8 steps), 8 test
   sequences, eval_every 4. The flash counts are set to 0 just before and
   must read fwd = 4 * (8 + 1) + 4 * (eval batches), dK/dV = dQ = 4 * (8 +
   1) just after (the + 1 is the trainer's discarded warm-up step);
   losses, parameters and moments must be finite.
10. lm_flash_vs_xla — the same width from one init, 2 steps at T = 512,
   batch 4, attn_impl flash and xla: parameters within atol 2e-5 / rtol
   1e-3 (the largest error's share of its tolerance printed), final losses
   within rtol 1e-4 (tests/test_lm.py's tolerances).
11. lm_bf16 — 2 full-width steps with compute_dtype bfloat16: the bf16
   kernels launched (counted), losses finite.
12. flash_timing — each flash kernel at [4, 2048, 8, 64], causal, fp32 and
   bf16, by the same timer as phase 6 (50 launches cold, 50 hot, 50 calls),
   beside its bound (the causal half's products over the card's rate for
   fp32-accurate products, the TF32 tensor cores' in 3 passes, or over the
   bf16 tensor-core rate for bf16, or bytes over the HBM rate, whichever is
   larger; the fp32 CUDA-core figure beside it as ``cuda_core_bound_ms``),
   its plain version (the
   kernel's outputs held to it at the flash_kernel tolerances), and
   ``scaled_dot_product_attention(is_causal=True)`` at the same shape in
   [B, H, T, D] as the library yardstick (forward, and its backward beside
   the two backward kernels and their sum; ``flash_timing_library`` gives
   the forward's and the backward pair's ratio to it), never on the port's
   path; the plain versions and SDPA by the sum of their device events a
   call.

If the profiler records no device time for a kernel or a call, the phase
fails; nothing falls back to CUDA events. Then one ``{"kernels": [...]}``
line (each kernel's cold ``ms``, ``hot_ms``, ``call_ms`` and ``timer``; the
Adam row's ``launches`` from phase 4 and ``async_launches`` from 5a), the
``nvidia-smi`` line, and as the last
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
ATOL_FUSED_VS_PLAIN = 1e-6
MAIN_STEPS = 20
ASYNC_ROUNDS = 20
ASYNC_EQ_ROUNDS = 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# fp32-accurate products on the TF32 tensor cores take 3 passes (3xTF32).
TF32X3_OPS_PER_S = TF32_OPS_PER_S / 3

# The flash-attention phases.
FLASH_SHAPES = ((1, 64, 2, 16), (2, 200, 4, 32), (4, 2048, 8, 64), (1, 512, 2, 128))
FLASH_MAIN = (4, 2048, 8, 64)  # the LM path's [B, T, H, D]
# dtype name -> ((atol, rtol) of O, (atol, rtol) of the gradients). bf16: O
# differs from the fp32 reference by its own rounding (2^-9 relative); the
# gradients also carry O's rounding through delta = rowsum(dO * O), an
# absolute error of up to about 1e-2 at these shapes.
FLASH_TOL = {
    "float32": ((1e-5, 1e-4), (1e-4, 1e-3)),
    "bfloat16": ((2e-3, 1e-2), (1e-2, 1e-2)),
}
LM_STEPS = 8
ADAM_KERNEL = r"adam_flat_\w*kernel"  # the device names the profiler reads
FLASH_KERNELS = {  # counter key -> (name, the TPU kernel it replaces)
    "fwd": ("flash_fwd", "jax/experimental/pallas/ops/tpu/flash_attention.py:589"),
    "bwd_dkv": ("flash_bwd_dkv", "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "bwd_dq": ("flash_bwd_dq", "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}


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


def kernel_sizes(fused_adam) -> list[tuple[int, int]]:
    """(n, offset) of the kernel phase: the fixed sizes, the launch plan's
    boundaries on this card and the 4-worker flat shard, then the scalar
    path (an offset of one float)."""
    from ddl_tpu_torch.models import cnn
    from ddl_tpu_torch.strategies.async_ps import serve_layout_for
    from ddl_tpu_torch.strategies.sync import resolve_layout
    from ddl_tpu_torch.train.config import TrainConfig

    wave = fused_adam.full_wave_n(*fused_adam.occupancy(0, True))
    shard4 = resolve_layout(TrainConfig(batch_size=100, num_workers=4, num_ps=4,
                                        layout="flat"), 4).max_shard
    # The async serve at W = 1: the replicated serve pushes into the full
    # (unpadded) vector; async_sharding into its folded chunk.
    if serve_layout_for(TrainConfig(num_ps=1), 1) is not None:
        raise AssertionError("async at W = 1 is not the replicated serve")
    async_full = sum(cnn.param_sizes().values())
    async_chunk = serve_layout_for(TrainConfig(num_ps=2, layout="block"), 1).max_shard
    sizes = dict.fromkeys(list(KERNEL_SIZES) + [wave, wave + 4, shard4, async_full, async_chunk])
    return [(n, 0) for n in sizes] + [(65_553, 1)]


def check_kernel(torch, fused_adam) -> float:
    """Kernel vs plain on the card: bit-equal, and bit-equal on a repeat;
    returns the largest abs error (0.0)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lr_t = torch.tensor([3e-4], device=dev)
    worst = 0.0
    for n, offset in kernel_sizes(fused_adam):
        bufs = adam_inputs(torch, n + offset, gen, dev)
        want = fused_adam.adam_flat_reference(*(b[offset:] for b in bufs), lr_t)
        g = bufs[3][offset:]
        # The kernel updates its copies in place, at the same offset (an
        # offset of one float leaves the 16-byte alignment: scalar path).
        runs = []
        for _ in range(2 if n == FULL_N else 1):
            p, m, v = (b.clone()[offset:] for b in bufs[:3])
            runs.append(fused_adam.adam_flat_fused(p, m, v, g, lr_t))
        torch.cuda.synchronize()
        vec4 = all(t.data_ptr() % 16 == 0 for t in (*runs[0], g))
        got = runs[0]
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, runs[-1]))
        emit("kernel", n=n, offset=offset, vec4=vec4, bit_equal=equal,
             repeat_bit_equal=repeat if len(runs) > 1 else None,
             max_abs_err={"p": errs[0], "m": errs[1], "v": errs[2]})
        if not (equal and repeat):
            raise AssertionError(f"kernel != plain (or a repeat) at n={n} offset={offset}: "
                                 f"{errs}, repeat bit-equal {repeat}")
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


def async_main(torch, world, fused_adam) -> dict:
    from ddl_tpu_torch.data.mnist import load_mnist
    from ddl_tpu_torch.parallel import collectives as coll
    from ddl_tpu_torch.strategies.async_ps import AsyncTrainer
    from ddl_tpu_torch.train.config import TrainConfig

    cfg = TrainConfig(
        batch_size=100, num_workers=1, num_ps=2, layout="block", keep_prob=0.5,
        eval_every=10, seed=0,
    )
    ds = load_mnist(path=None, synthetic_train=ASYNC_ROUNDS * 100, synthetic_test=1000, seed=0)
    trainer = AsyncTrainer(cfg, ds, world=world)
    layout = trainer.serve_layout
    if layout is None or layout.num_shards != 1 or layout.max_shard != FULL_N:
        raise AssertionError(f"async_sharding at W = 1 is not one folded chunk of {FULL_N}")
    fused_adam.launches = 0
    result = trainer.train(log=lambda s: None)
    launches = fused_adam.launches
    if launches != ASYNC_ROUNDS:
        raise AssertionError(f"fused-Adam kernel launched {launches} times in the async "
                             f"serve, want {ASYNC_ROUNDS}")
    st = trainer.state
    if int(st.t) != ASYNC_ROUNDS:
        raise AssertionError(f"async update counter {int(st.t)}, want {ASYNC_ROUNDS}")
    finite = all(math.isfinite(x) for x in result.span_losses)
    finite &= all(bool(torch.isfinite(t).all()) for t in (st.ps, st.m, st.v, st.workers))
    if not finite:
        raise AssertionError("non-finite loss, ps, moment or replica on the async path")
    if (len(result.worker_history) != len(result.history) or len(result.history) != 2
            or any(len(accs) != 1 for _, _, accs in result.worker_history)):
        raise AssertionError(f"evals {result.history} / worker evals {result.worker_history}")
    ps = trainer.logical(st.ps)
    replica = coll.unflatten_params(st.replica(0), trainer.spec)
    if not all(bool(torch.equal(ps[k], replica[k])) for k in ps):
        raise AssertionError("the one worker's replica is not the PS after its last push")
    stats = result.step_stats
    out = dict(
        variant="async_sharding", rounds=ASYNC_ROUNDS, launches=launches, t=int(st.t),
        n=int(st.ps.numel()), images_per_sec=result.images_per_sec,
        train_time_s=result.train_time_s, warmup_s=result.compile_time_s,
        span_losses=result.span_losses, history=result.history,
        worker_history=result.worker_history, final_accuracy=result.final_accuracy,
        span_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "mean": stats.mean_ms,
                 "spans": stats.steps},
    )
    emit("async_main", **out)
    return out


def async_equivalence(torch, world) -> dict:
    import numpy as np

    from ddl_tpu_torch.convert import params_to_numpy
    from ddl_tpu_torch.data.mnist import load_mnist
    from ddl_tpu_torch.models import cnn
    from ddl_tpu_torch.strategies.async_ps import AsyncTrainer
    from ddl_tpu_torch.train import SingleChipTrainer
    from ddl_tpu_torch.train.config import TrainConfig

    init = params_to_numpy(cnn.init_params(torch.Generator().manual_seed(3), "cpu"))
    ds = load_mnist(path=None, synthetic_train=ASYNC_EQ_ROUNDS * 100, synthetic_test=100, seed=3)
    quiet = lambda s: None  # noqa: E731
    trainers = {}
    # Bit-equality across serve placements needs a conv library that gives
    # the same bits for the same inputs: cuDNN's deterministic algorithms.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for variant, num_ps, layout in (("async", 1, "block"), ("async_sharding", 2, "block"),
                                        ("async_sharding_greedy", 2, "zigzag")):
            cfg = TrainConfig(batch_size=100, num_workers=1, num_ps=num_ps, layout=layout,
                              keep_prob=1.0, eval_every=0, seed=3)
            t = AsyncTrainer(cfg, ds, world=world, init=init)
            trainers[variant] = (t, t.train(log=quiet))
        single = SingleChipTrainer(TrainConfig(batch_size=100, keep_prob=1.0, eval_every=0, seed=3),
                                   ds, init=init, device=world.device).train(log=quiet)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref = trainers["async"][0]
    want = {what: ref.logical(getattr(ref.state, what)) for what in ("ps", "m", "v")}
    bit_equal = {}
    for variant in ("async_sharding", "async_sharding_greedy"):
        t = trainers[variant][0]
        bit_equal[variant] = {what: all(bool(torch.equal(a, want[what][k]))
                                        for k, a in t.logical(getattr(t.state, what)).items())
                              for what in ("ps", "m", "v")}
    counters = {v: int(t.state.t) for v, (t, _) in trainers.items()}
    async_params = trainers["async"][1].params
    vs_single = max(float(np.abs(async_params[k] - single.params[k]).max()) for k in single.params)
    out = dict(rounds=ASYNC_EQ_ROUNDS, n={v: int(t.state.ps.numel()) for v, (t, _) in
                                          trainers.items()},
               bit_equal=bit_equal, t=counters, async_vs_single_max_abs=vs_single,
               atol=ATOL_FUSED_VS_PLAIN)
    emit("async_equivalence", **out)
    if not all(all(d.values()) for d in bit_equal.values()):
        raise AssertionError(f"the async serves differ: {bit_equal}")
    if set(counters.values()) != {ASYNC_EQ_ROUNDS} or vs_single > ATOL_FUSED_VS_PLAIN:
        raise AssertionError(f"async t {counters}, vs single-chip {vs_single}")
    return out


def timing(torch, fused_adam, devtime, flush, card: str) -> dict:
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
    kern = devtime.timings(lambda: fused_adam.adam_flat_fused(kp, km, kv, g, lr_t), flush,
                           kernel=ADAM_KERNEL, reps=100, call_reps=200)
    plain = devtime.timings(lambda: fused_adam.adam_flat_reference(p, m, v, g, lr_t), flush)
    lp, lm, lv = p.clone(), m.clone(), v.clone()
    lib = devtime.timings(lambda: library(lp, lm, lv), flush, reps=100, call_reps=200)
    nbytes = 28 * n  # read g, m, v, p; write p', m', v'
    ops = 12 * n  # 7 mul, 3 add/sub, 1 sqrt, 1 div per element
    bytes_ms = nbytes / devtime.hbm_bytes_per_s(card) * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    ms = kern["ms"]
    out = dict(
        n=n, ms=ms, hot_ms=kern["hot_ms"], call_ms=kern["call_ms"], timer=kern["timer"],
        cold_min_max_ms=kern["cold_min_max_ms"], hot_min_max_ms=kern["hot_min_max_ms"],
        device_minus_launch_ms=kern["device_minus_launch_ms"],
        plain_ms=plain["ms"], plain_hot_ms=plain["hot_ms"], plain_call_ms=plain["call_ms"],
        library_ms=lib["ms"], library_hot_ms=lib["hot_ms"], library_call_ms=lib["call_ms"],
        library_device_events=lib["device_events"], library_max_abs_err=library_err,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        gb_per_s=nbytes / (ms * 1e-3) / 1e9,
        share_of_bound=max(bytes_ms, ops_ms) / ms,
        hbm_bytes_per_s=devtime.hbm_bytes_per_s(card),
    )
    emit("timing", **out)
    return out


def _close(a, b, atol: float, rtol: float) -> tuple[bool, float, float]:
    """(within ``atol + rtol * |b|`` everywhere, the largest abs error, the
    largest error as a share of its element's tolerance)."""
    a, b = a.detach().float(), b.detach().float()
    err = (a - b).abs()
    share = float((err / (atol + rtol * b.abs())).max())
    return share <= 1.0, float(err.max()), share


def check_flash(torch, fa) -> dict:
    """Kernels (through autograd) vs the plain attention on the card;
    returns the largest fp32 abs error per kernel."""
    dev = torch.device("cuda")
    worst = {key: 0.0 for key in FLASH_KERNELS}
    for shape in FLASH_SHAPES:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=dev).manual_seed(sum(shape) + causal)
                q, k, v, r = (torch.randn(shape, generator=gen, device=dev).to(dtype).float()
                              for _ in range(4))
                # Both sides get the same values: the kernels see dO = R in
                # the inputs' type, the reference all of them in fp32.
                # Separate leaves for each side (``.to`` of the same dtype
                # returns the tensor itself).
                got = [t.to(dtype).clone().requires_grad_(True) for t in (q, k, v)]
                out = fa.flash_attention_bthd(*got, causal=causal)
                (out.float() * r).sum().backward()
                ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
                want = fa.flash_attention_reference(*ref, causal=causal)
                (want * r).sum().backward()
                torch.cuda.synchronize()
                name = str(dtype).split(".")[-1]
                (oa, orl), (ga, grl) = FLASH_TOL[name]
                checks = {"o": _close(out, want, oa, orl)}
                for n, a, b in zip("qkv", got, ref):
                    checks[f"d{n}"] = _close(a.grad, b.grad, ga, grl)
                errs = {n: e for n, (_, e, _) in checks.items()}
                emit("flash_kernel", shape=list(shape), causal=causal, dtype=name,
                     max_abs_err=errs,
                     share_of_tolerance={n: s for n, (_, _, s) in checks.items()})
                if out.dtype != dtype or not all(ok for ok, _, _ in checks.values()):
                    raise AssertionError(f"flash kernels != plain at {shape} causal={causal} "
                                         f"{name}: {errs}")
                if dtype == torch.float32:
                    worst["fwd"] = max(worst["fwd"], errs["o"])
                    worst["bwd_dkv"] = max(worst["bwd_dkv"], errs["dk"], errs["dv"])
                    worst["bwd_dq"] = max(worst["bwd_dq"], errs["dq"])
                del q, k, v, r, got, out, ref, want
    torch.cuda.empty_cache()
    return worst


def flash_determinism(torch, fa) -> dict:
    """The forward, dK/dV and dQ twice on the same inputs at the LM path's
    shape, causal, fp32 and bf16: O, LSE and the gradients must be
    bit-equal (no atomics)."""
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(4)
        q, k, v, do = (torch.randn(FLASH_MAIN, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(FLASH_MAIN[-1])
        fwd = [fa.flash_fwd(q, k, v, True, scale) for _ in range(2)]
        o, lse = fwd[0]
        delta = fa.attention_delta(o, do)
        runs = [(*fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
                 fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)) for _ in range(2)]
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        equal = {g: bool(torch.equal(a, b)) for g, a, b in zip(("o", "lse"), *fwd)}
        equal.update({g: bool(torch.equal(a, b)) for g, a, b in zip(("dk", "dv", "dq"), *runs)})
        emit("flash_determinism", shape=list(FLASH_MAIN), causal=True, dtype=name,
             bit_equal=equal)
        if not all(equal.values()):
            raise AssertionError(f"flash kernels differ on a repeat ({name}): {equal}")
        out[name] = equal
        del q, k, v, do, fwd, o, lse, delta, runs
    torch.cuda.empty_cache()
    return out


def lm_spec():
    from ddl_tpu_torch.models.transformer import LMSpec

    return LMSpec(vocab=256, d_model=512, num_heads=8, num_layers=4, d_ff=2048)


def _finite_state(torch, trainer) -> bool:
    from ddl_tpu_torch.utils import tree

    state = [trainer.params, trainer.opt_state.m, trainer.opt_state.v]
    return all(bool(torch.isfinite(t).all()) for t in tree.leaves(state))


def lm_main(torch, fa) -> dict:
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer

    spec = lm_spec()
    if spec.num_params() != 12_864_512 or spec.head_dim != 64:
        raise AssertionError(f"unexpected LM width {spec}")
    bs, seq_len = 4, 2048
    cfg = SeqConfig(scheme="full", attn_impl="flash", batch_size=bs, learning_rate=1e-3,
                    eval_every=4, seed=0, spec=spec)
    ds = synthesize_copy(num_train=LM_STEPS * bs, num_test=8, seq_len=seq_len,
                         vocab=spec.vocab, seed=0)
    trainer = SeqTrainer(cfg, ds)
    for key in fa.launches:
        fa.launches[key] = 0
    result = trainer.train(log=lambda s: None)
    launches = dict(fa.launches)
    eval_batches = len(result.history) * -(-ds.test_tokens.shape[0] // bs)
    # The warm-up's discarded step launches each kernel once a layer too.
    steps = LM_STEPS + 1
    want = {"fwd": spec.num_layers * (steps + eval_batches),
            "bwd_dkv": spec.num_layers * steps, "bwd_dq": spec.num_layers * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, want {want}")
    if not (all(math.isfinite(x) for x in result.span_losses) and _finite_state(torch, trainer)):
        raise AssertionError("non-finite loss, parameter or moment on the LM path")
    if int(trainer.opt_state.step) != LM_STEPS or not 0.0 <= result.final_accuracy <= 1.0:
        raise AssertionError(f"Adam step {int(trainer.opt_state.step)}, "
                             f"accuracy {result.final_accuracy}")
    stats = result.step_stats
    out = dict(
        steps=LM_STEPS, batch_size=bs, seq_len=seq_len, num_params=spec.num_params(),
        launches=launches, eval_batches=eval_batches, tokens_per_sec=result.tokens_per_sec,
        train_time_s=result.train_time_s, warmup_s=result.compile_time_s,
        span_losses=result.span_losses, history=result.history,
        final_loss=result.final_loss, final_accuracy=result.final_accuracy,
        span_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "mean": stats.mean_ms,
                 "spans": stats.steps},
    )
    emit("lm_main", **out)
    return out


def lm_flash_vs_xla(torch) -> dict:
    import numpy as np

    from ddl_tpu_torch.convert import lm_params_to_numpy
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.models.transformer import init_lm_params
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
    from ddl_tpu_torch.utils import tree

    spec = lm_spec()
    init = lm_params_to_numpy(init_lm_params(torch.Generator().manual_seed(1), spec))
    ds = synthesize_copy(num_train=8, num_test=4, seq_len=512, vocab=spec.vocab, seed=1)
    res = {}
    for impl in ("flash", "xla"):
        cfg = SeqConfig(scheme="full", attn_impl=impl, batch_size=4, learning_rate=1e-3,
                        eval_every=0, seed=1, spec=spec)
        res[impl] = SeqTrainer(cfg, ds, init=init).train(log=lambda s: None)
    worst, share, bad = 0.0, 0.0, []
    for i, (a, b) in enumerate(zip(tree.leaves(res["flash"].params),
                                   tree.leaves(res["xla"].params))):
        err = np.abs(a - b)
        tol = 2e-5 + 1e-3 * np.abs(b)
        worst = max(worst, float(err.max()))
        share = max(share, float((err / tol).max()))
        if not (err <= tol).all():
            bad.append(i)
    lf, lx = res["flash"].final_loss, res["xla"].final_loss
    out = dict(steps=2, seq_len=512, loss_flash=lf, loss_xla=lx,
               loss_rel_diff=abs(lf - lx) / abs(lx), params_max_abs_diff=worst,
               params_share_of_tolerance=share)
    emit("lm_flash_vs_xla", **out)
    if bad or abs(lf - lx) > 1e-4 * abs(lx):
        raise AssertionError(f"flash != xla training: leaves {bad}, losses {lf} vs {lx}")
    return out


def lm_bf16(torch, fa) -> dict:
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer

    spec = lm_spec()
    cfg = SeqConfig(scheme="full", attn_impl="flash", compute_dtype="bfloat16", batch_size=4,
                    learning_rate=1e-3, eval_every=0, seed=2, spec=spec)
    ds = synthesize_copy(num_train=8, num_test=4, seq_len=2048, vocab=spec.vocab, seed=2)
    trainer = SeqTrainer(cfg, ds)
    for key in fa.launches:
        fa.launches[key] = 0
    result = trainer.train(log=lambda s: None)
    launches = dict(fa.launches)
    # 2 steps, the warm-up's discarded step and one eval batch.
    want = {"fwd": spec.num_layers * 4, "bwd_dkv": spec.num_layers * 3,
            "bwd_dq": spec.num_layers * 3}
    out = dict(steps=2, launches=launches, span_losses=result.span_losses,
               final_loss=result.final_loss, tokens_per_sec=result.tokens_per_sec)
    emit("lm_bf16", **out)
    if launches != want:
        raise AssertionError(f"bf16 flash launches {launches}, want {want}")
    if not (all(math.isfinite(x) for x in result.span_losses) and _finite_state(torch, trainer)):
        raise AssertionError("non-finite loss, parameter or moment on the bf16 LM path")
    return out


def flash_bound_ms(shape, kind: str, elem_bytes: int, ops_per_s: float, hbm: float):
    """(bound ms, what bounds it) of one kernel at ``shape``, causal: the
    products on the causal half (pairs with key <= query; exps and the
    softmax's adds are not counted) over ``ops_per_s``, or each input read
    once and each output written once over the HBM rate ``hbm``."""
    b, t, h, d = shape
    pairs = b * h * t * (t + 1) // 2
    tensor = b * t * h * d * elem_bytes
    rows = b * h * t * 4  # lse or delta, fp32
    products, tensors, row_arrays = {
        "fwd": (2, 4, 1),  # reads q, k, v; writes o, lse
        "bwd_dkv": (4, 6, 2),  # reads q, k, v, dO, lse, delta; writes dk, dv
        "bwd_dq": (3, 5, 2),  # reads q, k, v, dO, lse, delta; writes dq
    }[kind]
    ops_ms = products * 2 * d * pairs / ops_per_s * 1e3
    bytes_ms = (tensors * tensor + row_arrays * rows) / hbm * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def flash_timing(torch, fa, devtime, flush, card: str) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    hbm = devtime.hbm_bytes_per_s(card)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(3)
        q, k, v, do = (torch.randn(FLASH_MAIN, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(FLASH_MAIN[-1])
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = fa.attention_delta(o, do)
        name = str(dtype).split(".")[-1]
        fp32 = dtype == torch.float32
        # The library yardstick in its own layout, [B, H, T, D], copied
        # outside the clock.
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        lq, lk, lv = (x.clone().requires_grad_(True) for x in (qt, kt, vt))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        lib_fwd = devtime.timings(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         is_causal=True), flush)
        lib_bwd = devtime.timings(lambda: torch.autograd.grad(lo, (lq, lk, lv), dot,
                                                              retain_graph=True), flush)
        lib_err = float((lo.detach().transpose(1, 2).float() - o.float()).abs().max())
        runs = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, True, scale),
                    lambda: fa.flash_fwd_reference(q, k, v, True, scale), lib_fwd),
            "bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
                        lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True, scale),
                        lib_bwd),
            "bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
                       lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True, scale),
                       lib_bwd),
        }
        for key, (kernel, plain, lib) in runs.items():
            # Kernel vs its own plain version on the same residuals, at the
            # flash_kernel phase's tolerance (O's for the forward's O and
            # LSE, the gradients' for the backward kernels).
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            atol, rtol = FLASH_TOL[name][0 if key == "fwd" else 1]
            checks = [_close(a, b, atol, rtol) for a, b in zip(got, want)]
            plain_err = max(e for _, e, _ in checks)
            if not all(ok for ok, _, _ in checks):
                raise AssertionError(f"{key} kernel != its plain version ({name}): "
                                     f"{[(e, s) for _, e, s in checks]}")
            del got, want
            kern = devtime.timings(kernel, flush, kernel=f"{FLASH_KERNELS[key][0]}_kernel")
            plain_t = devtime.timings(plain, flush, reps=20)
            # The least time: fp32 products to fp32 accuracy on the TF32
            # tensor cores (3 passes), bf16 products at the bf16 rate; the
            # fp32 CUDA-core figure beside it.
            bound, by = flash_bound_ms(FLASH_MAIN, key, 4 if fp32 else 2,
                                       TF32X3_OPS_PER_S if fp32 else BF16_OPS_PER_S, hbm)
            cuda_core, _ = flash_bound_ms(FLASH_MAIN, key, 4 if fp32 else 2, FP32_OPS_PER_S,
                                          hbm)
            row = dict(kernel=key, dtype=name, shape=list(FLASH_MAIN), causal=True,
                       ms=kern["ms"], hot_ms=kern["hot_ms"], call_ms=kern["call_ms"],
                       timer=kern["timer"], cold_min_max_ms=kern["cold_min_max_ms"],
                       device_minus_launch_ms=kern["device_minus_launch_ms"],
                       plain_ms=plain_t["ms"], plain_hot_ms=plain_t["hot_ms"],
                       bound_ms=bound, bound_by=by,
                       bound_rate="tf32 tensor cores, 3 passes" if fp32 else
                       "bf16 tensor cores",
                       cuda_core_bound_ms=cuda_core, library_ms=lib["ms"],
                       library_hot_ms=lib["hot_ms"], library_call_ms=lib["call_ms"],
                       library="sdpa forward" if key == "fwd" else
                       "sdpa backward (dq, dk and dv in one call)",
                       share_of_bound=bound / kern["ms"], kernel_vs_plain_max_abs=plain_err)
            emit("flash_timing", **row)
            out[(key, name)] = row
        fwd_ms = out[("fwd", name)]["ms"]
        pair = out[("bwd_dkv", name)]["ms"] + out[("bwd_dq", name)]["ms"]
        emit("flash_timing_library", dtype=name, timer=lib_fwd["timer"],
             sdpa_fwd_ms=lib_fwd["ms"], sdpa_fwd_hot_ms=lib_fwd["hot_ms"],
             sdpa_fwd_call_ms=lib_fwd["call_ms"], sdpa_fwd_device_events=lib_fwd["device_events"],
             sdpa_bwd_ms=lib_bwd["ms"], sdpa_bwd_hot_ms=lib_bwd["hot_ms"],
             sdpa_bwd_call_ms=lib_bwd["call_ms"], sdpa_bwd_device_events=lib_bwd["device_events"],
             sdpa_fwd_plus_bwd_ms=lib_fwd["ms"] + lib_bwd["ms"], sdpa_vs_kernel_o_max_abs=lib_err,
             fwd_ms=fwd_ms, fwd_over_sdpa_fwd=fwd_ms / lib_fwd["ms"],
             bwd_pair_ms=pair, bwd_pair_over_sdpa_bwd=pair / lib_bwd["ms"])
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, lq, lk, lv, lo
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ddl_tpu_torch.ops import build, flash_attention, fused_adam
    from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
    from ddl_tpu_torch.tools import devtime

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
            async_out = async_main(torch, world, fused_adam)
            async_equivalence(torch, world)
        finally:
            destroy_world()

    flush = devtime.L2Flush(torch.device("cuda"))
    tim = timing(torch, fused_adam, devtime, flush, card)

    flash_err = check_flash(torch, flash_attention)
    flash_determinism(torch, flash_attention)
    lm_out = lm_main(torch, flash_attention)
    lm_flash_vs_xla(torch)
    lm_bf16(torch, flash_attention)
    flash_tim = flash_timing(torch, flash_attention, devtime, flush, card)

    kernels = [{
        "name": "adam_flat_fused",
        "route": "cuda",
        "source": "ddl_tpu_torch/csrc/fused_adam.cu",
        "replaces": "ddl_tpu/ops/pallas_adam.py:54",
        "launches": main_out["launches"],
        "async_launches": async_out["launches"],
        "max_abs_err": max_err,
        "ms": tim["ms"],
        "hot_ms": tim["hot_ms"],
        "call_ms": tim["call_ms"],
        "timer": tim["timer"],
        "plain_ms": tim["plain_ms"],
        "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"],
        "library_ms": tim["library_ms"],
    }]
    for key, (name, replaces) in FLASH_KERNELS.items():
        row = flash_tim[(key, "float32")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ddl_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "reached_from": "ddl_tpu/ops/attention.py:38",
            "launches": lm_out["launches"][key],
            "max_abs_err": flash_err[key],
            "ms": row["ms"],
            "hot_ms": row["hot_ms"],
            "call_ms": row["call_ms"],
            "timer": row["timer"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "bound_rate": row["bound_rate"],
            "cuda_core_bound_ms": row["cuda_core_bound_ms"],
            "library_ms": row["library_ms"],
            "library": row["library"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
