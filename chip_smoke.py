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
   (ragged), [4, 2048, 8, 64] (the LM path's), [1, 512, 2, 128], [4,
   2048, 4, 64] (lm_tp's: a tp-2 rank's half of the heads) and [1, 2048, 8,
   64] (lm_pp's: one microbatch of 4), causal and not; the forward kernel's LSE against the plain log-sum-exp, within
   O's tolerance. fp32: O within atol 1e-5 / rtol 1e-4, gradients within atol
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
11s. lm_seq — the sequence-parallel schemes at lm_main's width, fp32, batch 4,
   over an NCCL world of one (the all-to-alls, the world's gradient sum, the
   ZeRO-1 reduce-scatter and all-gather are real NCCL calls). At T = 2048,
   4 steps (plus the warm-up, an eval after each) each of Ulysses + flash,
   ring + zigzag (nsub 2: the causal skip drops one sub-tile of four) and
   Ulysses + flash + zero1: the flash counts, set to 0 just before each run,
   must read lm_main's formula for the Ulysses runs and 0 for the ring;
   prints each run's step ms (p50, p95) and peak memory. Then at T = 512,
   2 steps from one init: Ulysses + flash against full + flash (atol 1e-6;
   whether it is bitwise printed), ring contiguous and ring zigzag against
   full + xla (atol 2e-5 / rtol 1e-3) and Ulysses + flash + zero1 against
   Ulysses + flash (atol 1e-5 / rtol 1e-4, tests/test_lm.py:335-341), each
   with its losses within rtol 1e-4 and the largest error's share of its
   tolerance printed.
11t. lm_tp — tensor parallelism at tp 2 on the one card: two processes
   spawned (the ``spawn`` start method: a fork after CUDA init is fatal),
   each ``init_world(2, r, <file store>, "cuda", backend="gloo")`` on cuda:0
   (NCCL takes one rank a card; gloo copies CUDA tensors through the host),
   loading the build phase's libraries. On each rank, at lm_main's width,
   fp32, T = 2048, batch 4, full + flash, 4 steps (plus the warm-up, an eval
   after each): ``tensor_parallel=2``, then the same with ``zero1`` (the
   hybrid). Each rank's flash counts, set to 0 just before each run, must
   read lm_main's formula, every launch at [4, 2048, 4, 64] (its half of
   the heads); losses, parameters and moments finite. Each rank prints its
   step ms, its device idle share (its own kernels, profiled steady steps)
   and peak memory, labelled "two processes on one card over gloo: not a
   tp scaling figure". Then at T = 512, 2 steps from one init: tp 2 +
   flash against this process's tp 1 + flash in the NCCL world of one
   (atol 2e-5 / rtol 1e-3, final loss rtol 1e-4), the hybrid against tp-2
   replicated (1e-5 / 1e-4), the two ranks' gathered params bitwise equal.
   Last, serve_main's traffic (paged, greedy) at tp 2 on each rank, no
   kernel launched, its tokens equal to a tp 1 serve's (a difference
   printed with its top-2 margins). A rank that fails or outlives the
   timeout fails the phase, its traceback printed.
11p. lm_pp — pipeline parallelism at pp 2 on the one card, spawned as
   lm_tp's pair is (each rank one stage of 2 layers). On each rank, at
   lm_main's width, fp32, T = 2048, batch 4, full + flash, 4 microbatches
   (of 1 sequence), 4 steps (plus the warm-up, an eval after each): GPipe,
   then 1F1B. Each rank's flash counts, set to 0 just before each run, must
   read fwd = (L/pp) * (2M * (steps + 1) + eval batches) and dK/dV = dQ =
   (L/pp) * M * (steps + 1) (the forward slot, then the backward slot's
   recompute and backward), every training launch at [1, 2048, 8, 64] and
   the eval's at [4, 2048, 8, 64]; each rank's peak of saved stage inputs
   must equal what its row of the tick tables implies, the larger of the
   two ``max_in_flight`` (4 for GPipe, 2 for 1F1B); losses, parameters and
   moments finite. Each rank prints its step ms, its device idle share,
   peak memory and its hop bytes a step (sent and received, and the
   device-host copies gloo needs), labelled "two processes on one card
   over gloo: not a pipeline scaling figure". Then at T = 512, 2 steps from
   one init: GPipe against this process's pp 1 + flash in the NCCL world of
   one and 1F1B against GPipe (atol 2e-5 / rtol 1e-3, final loss rtol 1e-4;
   whether bitwise printed), and the two ranks' own shared leaves (embed,
   head, the final LayerNorm) bitwise equal.
11a. serve_main — the port's serving path (``serve/``) at the width of
   benchmarks/serve_bench.py (the same LM, vocab 256, d_model 512, 8 heads,
   4 layers, d_ff 2048, the port's seeded init), ``ServeConfig(slots=8,
   capacity=512, page_size=64)``, greedy: 16 prompts from
   ``synthesize_prompts(num=16, min_len=16, max_len=128, vocab=256,
   seed=0)``, 64 new tokens each, after ``Scheduler.warmup`` (outside the
   clock). All 16 must finish ``ok`` with 64 tokens and the page pool must
   be whole again after the run; prints decode tokens/s, TTFT and ITL
   p50/p95, decode ticks, ``last_attend_width`` and peak memory. No kernel
   of ``csrc/`` lies on this path (serving's attention is plain torch ops,
   as JAX's is plain jnp): every kernel's launch count is set to 0 before
   this phase, 11b and the serving half of 11c, read after each (before
   11c's flash oracle) and printed as ``kernel_launches``; a count above 0
   fails the phase.
11b. serve_equivalence — at the same width, tokens equal in each case: paged
   ≡ contiguous; 3 requests continuously batched ≡ each one alone; prefix
   cache on (shared-prefix prompts, hits > 0) ≡ off, contiguous and paged;
   ``prefill_chunk=64`` ≡ whole-prompt prefill; temperature 0.8 with top_k
   20, batched ≡ alone. A mismatch reports the first differing step's top-2
   logit margin.
11c. serve_vs_full_forward — one request's prefill logits and 32 decode
   steps' logits, contiguous and paged, against ``apply_lm`` over the same
   tokens with the flash forward kernel as ``attn_fn``: within atol 1e-4 /
   rtol 1e-3 (the largest error's share of that tolerance printed).
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

Precision phases (the bf16 policy, ``precision="bf16"``: bf16 compute and
bf16 gradient sums, fp32 masters and moments; and the CNN's conv_matmul
modes), each raising on failure, at the main paths' widths. bf16 is held
to fp32 within JAX's bound (tests/test_precision.py: |got - ref| <= 0.1
|ref| + 0.05), and bf16 to bf16 (another grid, the same policy) with
losses within rtol 1e-2 and the parameter updates from one init within
0.2 of the update in norm (``BF16_UPDATE_REL``), or bit for bit where the
two runs make the same sums in another order only:

a. precision_cnn_bf16 (after 5b) — phase 4's run under the policy (images
   staged in bf16): 20 fused-Adam launches, finite, fp32 masters and
   moments; then 20 steps at keep_prob 1 from one init, fp32 and bf16, a
   loss a step, within JAX's bound.
b. precision_conv_matmul — the four patches-matmul modes against the conv
   lowering, fp32, cuDNN deterministic: logits of a batch of 100 at atol
   1e-5, logits and the 14 gradients of JAX's test batch (8 images) at
   atol 1e-5 and 2e-5 / rtol 1e-4 (tests/test_model.py); each lowering's
   gradients against an fp64 run printed.
c. precision_lm (after 11) — lm_main's run under the policy: lm_main's
   launch counts, every span loss within JAX's bound of lm_main's, fp32
   masters and moments; tokens/s beside lm_main's.
d. precision_lm_seq — Ulysses + flash + ZeRO-1 over the NCCL world of one,
   fp32 then bf16, 2 steps at T = 2048: the reduce-scatter's input dtype
   and bytes at every call (51,458,048 fp32, 25,729,024 bf16), the flash
   launches, the losses within JAX's bound.
e. in 11t, ``tp2_full_flash_bf16`` and ``hybrid_full_flash_bf16`` (T =
   2048, launches and shapes as the fp32 runs'; T = 512: tp 2 against this
   process's tp 1 under the policy, the hybrid against tp 2 at the fp32
   hybrid pair's 1e-5 / rtol 1e-4).
f. in 11p, ``gpipe_bf16`` and ``1f1b_bf16`` (T = 2048, launches, shapes and
   peaks as the fp32 runs', hop bytes 16,777,216 a step a rank against
   33,554,432 in fp32; T = 512: GPipe against pp 1 under the policy, 1F1B
   against GPipe bitwise). Phase 7 holds the bf16 kernels at [1, 2048, 8,
   64].
g. precision_serve (after 11c) — serve_main's traffic with
   ``compute_dtype="bfloat16"``: pools in bf16, 8,192 bytes a row, all
   ``ok``, decode tokens/s, TTFT and ITL beside serve_main's, paged ≡
   contiguous tokens up to the first near-tie (a first difference only at
   a top-2 margin below 0.0625), no kernel launched.

If the profiler records no device time for a kernel or a call, the phase
fails; nothing falls back to CUDA events. Then one ``{"kernels": [...]}``
line (each kernel's cold ``ms``, ``hot_ms``, ``call_ms`` and ``timer``; the
Adam row's ``launches`` from phase 4, ``async_launches`` from 5a and
``bf16_launches`` from a; each flash row's ``launches`` from phase 9,
``ulysses_launches`` from 11s, ``tp_launches`` (rank 0's, tp 2) from 11t
and ``pp_launches`` (rank 0's, GPipe) from 11p, and under the policy
``bf16_launches`` (c), ``bf16_ulysses_zero1_launches`` (d),
``bf16_tp_launches`` (e) and ``bf16_pp_launches`` (f)), the
``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no ``ok`` line. It needs no network and one card.
"""

from __future__ import annotations

import json
import math
import os
import re
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
FLASH_SHAPES = ((1, 64, 2, 16), (2, 200, 4, 32), (4, 2048, 8, 64), (1, 512, 2, 128),
                (4, 2048, 4, 64),  # lm_tp's: a tp-2 rank's half of the heads
                (1, 2048, 8, 64))  # lm_pp's: one microbatch of 4
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


# The precision phases' tolerances. bf16 against fp32 (JAX's
# tests/test_precision.py): |got - ref| <= BF16_VS_FP32_RTOL * |ref| +
# BF16_VS_FP32_ATOL. bf16 against bf16 (another grid, the same policy):
# losses at rtol BF16_LOSS_RTOL (2.5 bf16 ulps), and the parameter updates
# from one init within ||Δa - Δb|| <= BF16_UPDATE_REL * ||Δb||
# (:func:`_update_rel_diff`), set from readings: tp 2 against tp 1 0.0495
# and GPipe against pp 1 0.0143 on an NVIDIA H100 80GB HBM3, 700.00 W;
# 0.081 at most in the CPU tests, where one CNN sample of eight swapped
# gives 0.39.
BF16_VS_FP32_RTOL, BF16_VS_FP32_ATOL = 0.1, 0.05
BF16_LOSS_RTOL = 1e-2
BF16_UPDATE_REL = 0.2
BF16_NEAR_TIE = 0.0625  # a bf16 token may flip only below this top-2 margin
# conv_matmul against the conv lowering (JAX's tests/test_model.py).
CONV_MATMUL_LOGITS_ATOL = 1e-5
CONV_MATMUL_GRAD_TOL = (2e-5, 1e-4)


def _fp32_state(torch, trainer) -> bool:
    """Every parameter and moment of the trainer is a float32 tensor."""
    return all(t.dtype == torch.float32 for t in _state_leaves(trainer))


def _update_rel_diff(got, want, init) -> float:
    """||got - want|| / ||want - init|| over all leaves: how far two runs'
    parameter updates from one init part, relative to the update."""
    import numpy as np

    num = sum(float(np.sum((np.asarray(a, np.float64) - b) ** 2)) for a, b in zip(got, want))
    den = sum(float(np.sum((np.asarray(b, np.float64) - c) ** 2)) for b, c in zip(want, init))
    return math.sqrt(num / den) if den else 0.0


def _param_pair(got, want, init, loss, oracle_loss, *, loss_rtol, atol=None, rtol=0.0,
                update_rel=None, bitwise=False) -> dict:
    """Two runs' parameter leaves from one ``init`` and final losses, held
    elementwise (``atol`` / ``rtol``), by their updates in norm
    (``update_rel``, :func:`_update_rel_diff`) or bit for bit; the row
    printed, with ``ok``."""
    import numpy as np

    urd = _update_rel_diff(got, want, init)
    same = all(np.array_equal(a, b) for a, b in zip(got, want, strict=True))
    row = dict(loss_rtol=loss_rtol, params_max_abs_diff=max(
        float(np.abs(a - b).max()) for a, b in zip(got, want)), update_rel_diff=urd,
        bitwise=same, loss=loss, oracle_loss=oracle_loss,
        loss_rel_diff=abs(loss - oracle_loss) / abs(oracle_loss))
    ok = abs(loss - oracle_loss) <= loss_rtol * abs(oracle_loss) and (same or not bitwise)
    if atol is not None:
        share = max(float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())
                    for a, b in zip(got, want))
        row.update(atol=atol, rtol=rtol, params_share_of_tolerance=share)
        ok = ok and share <= 1.0
    if update_rel is not None:
        row.update(update_rel_limit=update_rel)
        ok = ok and urd <= update_rel
    row["ok"] = ok
    return row


def _bf16_vs_fp32(got, ref) -> tuple[bool, float]:
    """(every loss within JAX's bf16-against-fp32 bound, the largest share
    of it)."""
    share = max(abs(a - b) / (BF16_VS_FP32_RTOL * abs(b) + BF16_VS_FP32_ATOL)
                for a, b in zip(got, ref, strict=True))
    return share <= 1.0, share


def cnn_bf16(torch, world, fused_adam, main_out) -> dict:
    """Precision a: the CNN main path under ``precision="bf16"`` (images
    staged in bf16, bf16 convs and matmuls, fp32 masters, moments and
    gradients into the fused-Adam kernel), then the same trainer at
    keep_prob 1 from one init, fp32 and bf16, step by step."""
    from ddl_tpu_torch.convert import params_to_numpy
    from ddl_tpu_torch.data.mnist import load_mnist
    from ddl_tpu_torch.models import cnn
    from ddl_tpu_torch.strategies.sync import SyncTrainer
    from ddl_tpu_torch.train.config import TrainConfig

    quiet = lambda s: None  # noqa: E731
    start = time.perf_counter()
    base = dict(batch_size=100, num_workers=1, num_ps=2, layout="flat", fused_adam=True)
    ds = load_mnist(path=None, synthetic_train=MAIN_STEPS * 100, synthetic_test=1000, seed=0)
    trainer = SyncTrainer(TrainConfig(keep_prob=0.5, eval_every=10, seed=0, precision="bf16",
                                      **base), ds, world=world)
    fused_adam.launches = 0
    result = trainer.train(log=quiet)
    launches = fused_adam.launches
    failures = []
    if launches != MAIN_STEPS:
        failures.append(f"fused-Adam launched {launches} times, want {MAIN_STEPS}")
    if not (all(math.isfinite(x) for x in result.span_losses) and _finite_state(torch, trainer)):
        failures.append("non-finite loss, parameter or moment")
    if not _fp32_state(torch, trainer):
        failures.append("masters or moments are not float32")
    # fp32 against bf16, keep_prob 1, one init, a loss a step.
    init = params_to_numpy(cnn.init_params(torch.Generator().manual_seed(1), "cpu"))
    small = load_mnist(path=None, synthetic_train=MAIN_STEPS * 100, synthetic_test=100, seed=1)
    losses = {}
    for prec in ("fp32", "bf16"):
        cfg = TrainConfig(keep_prob=1.0, eval_every=1, seed=1, precision=prec, **base)
        losses[prec] = SyncTrainer(cfg, small, world=world, init=init).train(
            log=quiet).span_losses
    ok, share = _bf16_vs_fp32(losses["bf16"], losses["fp32"])
    if not ok:
        failures.append(f"bf16 losses off the fp32 run: share {share}")
    stats = result.step_stats
    out = dict(steps=MAIN_STEPS, launches=launches, images_per_sec=result.images_per_sec,
               fp32_images_per_sec=main_out["images_per_sec"],
               span_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "mean": stats.mean_ms},
               fp32_span_ms=main_out["span_ms"], span_losses=result.span_losses,
               final_accuracy=result.final_accuracy, masters_fp32=_fp32_state(torch, trainer),
               vs_fp32=dict(steps=MAIN_STEPS, keep_prob=1.0, bf16=losses["bf16"],
                            fp32=losses["fp32"], share_of_tolerance=share,
                            rtol=BF16_VS_FP32_RTOL, atol=BF16_VS_FP32_ATOL),
               failures=failures, seconds=time.perf_counter() - start)
    emit("precision_cnn_bf16", **out)
    if failures:
        raise AssertionError(f"precision_cnn_bf16: {failures}")
    return out


def cnn_conv_matmul(torch) -> dict:
    """Precision b: each patches-matmul mode of the full-width CNN against
    the conv lowering on the card, fp32 (TF32 off): the logits of a batch of
    100 (the main path's), and the logits and 14 gradients of JAX's test
    batch (8 uniform images, labels i % 10; tests/test_model.py). At batch
    100 some pre-activation lies within 1e-7 of a ReLU or max-pool tie, and
    the two lowerings' last-bit differences then route that gradient
    differently (5.7e-4 on fc1's bias on the CPU), so the gradients are
    held on JAX's batch. cuDNN runs its deterministic algorithms here: its
    fp32 conv backward carries most of the difference (printed: each
    lowering's gradients against an fp64 run of the conv lowering), and its
    other algorithms move it from run to run."""
    from ddl_tpu_torch.models import cnn
    from ddl_tpu_torch.train.trainer import value_and_grad

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    params = cnn.init_params(torch.Generator().manual_seed(8), dev)
    x100 = torch.rand((100, 784), generator=gen, device=dev)
    x = torch.rand((8, 784), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(torch.arange(8, device=dev) % 10, 10).float()
    ga, gr = CONV_MATMUL_GRAD_TOL
    _, exact = value_and_grad({k: v.double() for k, v in params.items()}, x.double(),
                              y.double(), None, 1.0)

    def vs_exact(grads):
        return max(_close(grads[k], exact[k], ga, gr)[2] for k in grads)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref100 = cnn.apply_fn(params, x100)
        ref_logits = cnn.apply_fn(params, x)
        _, ref_grads = value_and_grad(params, x, y, None, 1.0)
        out, failures = {"none": dict(grads_share_vs_fp64=vs_exact(ref_grads))}, []
        for mode in ("first", "tail", "first+tail", "all"):
            logits100 = cnn.apply_fn(params, x100, conv_matmul=mode)
            logits = cnn.apply_fn(params, x, conv_matmul=mode)
            _, grads = value_and_grad(params, x, y, None, 1.0, conv_matmul=mode)
            torch.cuda.synchronize()
            checks = {"logits100": _close(logits100, ref100, CONV_MATMUL_LOGITS_ATOL, 0.0),
                      "logits": _close(logits, ref_logits, CONV_MATMUL_LOGITS_ATOL, 0.0)}
            checks.update({k: _close(grads[k], ref_grads[k], ga, gr) for k in grads})
            out[mode] = dict(logits100_max_abs=checks["logits100"][1],
                             logits_max_abs=checks["logits"][1],
                             grads_max_abs=max(e for k, (_, e, _) in checks.items()
                                               if k in grads),
                             share_of_tolerance=max(sh for _, _, sh in checks.values()),
                             grads_share_vs_fp64=vs_exact(grads))
            if not all(ok for ok, _, _ in checks.values()):
                failures.append(mode)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit("precision_conv_matmul", batches=[100, 8], logits_atol=CONV_MATMUL_LOGITS_ATOL,
         grads_atol=ga, grads_rtol=gr, cudnn_deterministic=True, modes=out, failures=failures)
    if failures:
        raise AssertionError(f"precision_conv_matmul: modes off the conv lowering: {failures}")
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
        profile_windows=kern["profile_windows"],
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
                # The forward's LSE, which both backward kernels read.
                scale = 1.0 / math.sqrt(shape[-1])
                _, lse = fa.flash_fwd(*(t.detach() for t in got), causal, scale)
                _, lse_want = fa.flash_fwd_reference(q, k, v, causal, scale)
                checks["lse"] = _close(lse, lse_want, oa, orl)
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
                del q, k, v, r, got, out, ref, want, lse, lse_want
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


def _state_leaves(trainer) -> list:
    """Every parameter and every moment of the trainer's optimizer state
    (any of its kinds: tree, flat chunk, or the hybrid's chunk and tp
    shards)."""
    import dataclasses

    from ddl_tpu_torch.utils import tree

    opt = trainer.opt_state
    return tree.leaves([trainer.params] + [getattr(opt, f.name) for f in
                                           dataclasses.fields(opt) if f.name != "step"])


def _finite_state(torch, trainer) -> bool:
    """Every parameter and moment of the trainer is finite."""
    return all(bool(torch.isfinite(t).all()) for t in _state_leaves(trainer))


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


def lm_policy(torch, fa, lm_out) -> dict:
    """Precision c: lm_main's run (the same init, data and steps) under
    ``precision="bf16"``: the bf16 flash kernels counted as lm_main's,
    every span loss within JAX's bound of lm_main's fp32 one, fp32 masters
    and moments."""
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer

    spec, bs, seq_len = lm_spec(), 4, 2048
    cfg = SeqConfig(scheme="full", attn_impl="flash", batch_size=bs, learning_rate=1e-3,
                    eval_every=4, seed=0, spec=spec, precision="bf16")
    ds = synthesize_copy(num_train=LM_STEPS * bs, num_test=8, seq_len=seq_len,
                         vocab=spec.vocab, seed=0)
    trainer = SeqTrainer(cfg, ds)
    for key in fa.launches:
        fa.launches[key] = 0
    result = trainer.train(log=lambda s: None)
    launches = dict(fa.launches)
    eval_batches = len(result.history) * -(-ds.test_tokens.shape[0] // bs)
    steps = LM_STEPS + 1  # the warm-up's discarded step too
    want = {"fwd": spec.num_layers * (steps + eval_batches),
            "bwd_dkv": spec.num_layers * steps, "bwd_dq": spec.num_layers * steps}
    failures = []
    if launches != want:
        failures.append(f"flash launches {launches}, want {want}")
    if not (all(math.isfinite(x) for x in result.span_losses) and _finite_state(torch, trainer)):
        failures.append("non-finite loss, parameter or moment")
    if not _fp32_state(torch, trainer):
        failures.append("masters or moments are not float32")
    ok, share = _bf16_vs_fp32(result.span_losses, lm_out["span_losses"])
    if not ok:
        failures.append(f"bf16 losses off lm_main's fp32 ones: share {share}")
    stats = result.step_stats
    out = dict(steps=LM_STEPS, batch_size=bs, seq_len=seq_len, launches=launches,
               tokens_per_sec=result.tokens_per_sec, fp32_tokens_per_sec=lm_out["tokens_per_sec"],
               span_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "mean": stats.mean_ms,
                        "spans": stats.steps},
               fp32_span_ms=lm_out["span_ms"], span_losses=result.span_losses,
               fp32_span_losses=lm_out["span_losses"], share_of_tolerance=share,
               final_accuracy=result.final_accuracy, masters_fp32=_fp32_state(torch, trainer),
               failures=failures)
    emit("precision_lm", **out)
    if failures:
        raise AssertionError(f"precision_lm: {failures}")
    return out


def lm_seq_policy(torch, fa, world) -> dict:
    """Precision d: Ulysses + flash + ZeRO-1 over the NCCL world of one at
    T = 2048, fp32 then ``precision="bf16"``, 2 steps each from one init:
    the ZeRO-1 reduce-scatter's input dtype and bytes recorded at every
    call (bf16, half the fp32 run's), the bf16 run's flash launches
    counted, its losses within JAX's bound of the fp32 run's."""
    from ddl_tpu_torch.convert import lm_params_to_numpy
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.models.transformer import init_lm_params
    from ddl_tpu_torch.parallel import collectives as coll
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer

    spec, bs, seq_len, n = lm_spec(), 4, 2048, 2
    init = lm_params_to_numpy(init_lm_params(torch.Generator().manual_seed(9), spec))
    ds = synthesize_copy(num_train=n * bs, num_test=bs, seq_len=seq_len, vocab=spec.vocab,
                         seed=9)
    calls = []
    scatter = coll.reduce_scatter_flat

    def recording(flat, *a, **k):
        calls.append((str(flat.dtype).split(".")[-1], flat.numel() * flat.element_size()))
        return scatter(flat, *a, **k)

    runs, failures = {}, []
    coll.reduce_scatter_flat = recording
    try:
        for prec in ("fp32", "bf16"):
            cfg = SeqConfig(scheme="ulysses", attn_impl="flash", zero1=True, batch_size=bs,
                            learning_rate=1e-3, eval_every=0, seed=9, spec=spec, precision=prec)
            trainer = SeqTrainer(cfg, ds, init=init, world=world)
            calls.clear()
            for key in fa.launches:
                fa.launches[key] = 0
            res = trainer.train(log=lambda s: None)
            L, steps = spec.num_layers, n + 1  # the warm-up's discarded step too
            evals = len(res.history) * -(-ds.test_tokens.shape[0] // bs)
            want = {"fwd": L * (steps + evals), "bwd_dkv": L * steps, "bwd_dq": L * steps}
            runs[prec] = dict(launches=dict(fa.launches), reduce_scatter=sorted(set(calls)),
                              reduce_scatter_calls=len(calls), span_losses=res.span_losses,
                              masters_fp32=_fp32_state(torch, trainer),
                              finite=_finite_state(torch, trainer))
            if runs[prec]["launches"] != want:
                failures.append(f"{prec}: flash launches {runs[prec]['launches']}, want {want}")
            if not (runs[prec]["masters_fp32"] and runs[prec]["finite"]):
                failures.append(f"{prec}: masters or moments not finite float32")
            del trainer
    finally:
        coll.reduce_scatter_flat = scatter
    fp32_bytes = 4 * spec.num_params()
    want_rs = {"fp32": [("float32", fp32_bytes)], "bf16": [("bfloat16", fp32_bytes // 2)]}
    for prec, rs in want_rs.items():
        if runs[prec]["reduce_scatter"] != rs or runs[prec]["reduce_scatter_calls"] != n + 1:
            failures.append(f"{prec}: reduce-scatter moved {runs[prec]['reduce_scatter']} in "
                            f"{runs[prec]['reduce_scatter_calls']} calls, want {rs} in {n + 1}")
    ok, share = _bf16_vs_fp32(runs["bf16"]["span_losses"], runs["fp32"]["span_losses"])
    if not ok:
        failures.append(f"bf16 losses off the fp32 run: share {share}")
    emit("precision_lm_seq", scheme="ulysses", zero1=True, seq_len=seq_len, steps=n,
         reduce_scatter_bytes={p: r["reduce_scatter"][0][1] if r["reduce_scatter"] else None
                               for p, r in runs.items()},
         runs=runs, share_of_tolerance=share, failures=failures)
    if failures:
        raise AssertionError(f"precision_lm_seq: {failures}")
    torch.cuda.empty_cache()
    return runs


# The lm_seq phase: runs at T = 2048 (name, SeqConfig fields), and the
# equivalence pairs at T = 512 (run, oracle, (atol, rtol)).
LM_SEQ_STEPS = 4
LM_SEQ_RUNS = (
    ("ulysses_flash", dict(scheme="ulysses", attn_impl="flash")),
    ("ring_zigzag", dict(scheme="ring", seq_layout="zigzag")),
    ("ulysses_flash_zero1", dict(scheme="ulysses", attn_impl="flash", zero1=True)),
)
LM_SEQ_EQ_RUNS = {
    "full_flash": dict(scheme="full", attn_impl="flash"),
    "full_xla": dict(scheme="full", attn_impl="xla"),
    "ulysses_flash": dict(scheme="ulysses", attn_impl="flash"),
    "ring": dict(scheme="ring"),
    "ring_zigzag": dict(scheme="ring", seq_layout="zigzag"),
    "ulysses_flash_zero1": dict(scheme="ulysses", attn_impl="flash", zero1=True),
}
LM_SEQ_EQ = (
    ("ulysses_flash", "full_flash", (1e-6, 0.0)),
    ("ring", "full_xla", (2e-5, 1e-3)),
    ("ring_zigzag", "full_xla", (2e-5, 1e-3)),
    ("ulysses_flash_zero1", "ulysses_flash", (1e-5, 1e-4)),
)


def lm_seq(torch, fa, world) -> dict:
    import numpy as np

    from ddl_tpu_torch.convert import lm_params_to_numpy
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.models.transformer import init_lm_params
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
    from ddl_tpu_torch.utils import tree

    start = time.perf_counter()
    spec, bs, seq_len = lm_spec(), 4, 2048
    quiet = lambda s: None  # noqa: E731
    ds = synthesize_copy(num_train=LM_SEQ_STEPS * bs, num_test=bs, seq_len=seq_len,
                         vocab=spec.vocab, seed=4)
    runs = {}
    for name, kw in LM_SEQ_RUNS:
        cfg = SeqConfig(batch_size=bs, learning_rate=1e-3, eval_every=1, seed=4, spec=spec, **kw)
        trainer = SeqTrainer(cfg, ds, world=world)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for key in fa.launches:
            fa.launches[key] = 0
        result = trainer.train(log=quiet)
        launches = dict(fa.launches)
        peak = torch.cuda.max_memory_allocated()
        steps = LM_SEQ_STEPS + 1  # the warm-up's discarded step too
        evals = len(result.history) * -(-ds.test_tokens.shape[0] // bs)
        L = spec.num_layers
        want = ({"fwd": L * (steps + evals), "bwd_dkv": L * steps, "bwd_dq": L * steps}
                if cfg.attn_impl == "flash" else dict.fromkeys(fa.launches, 0))
        stats = result.step_stats
        out = dict(run=name, scheme=cfg.scheme, seq_layout=cfg.seq_layout, zero1=cfg.zero1,
                   attn_impl=cfg.attn_impl, steps=LM_SEQ_STEPS, seq_len=seq_len, batch_size=bs,
                   launches=launches, want_launches=want, evals=len(result.history),
                   step_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "mean": stats.mean_ms,
                            "spans": stats.steps},
                   tokens_per_sec=result.tokens_per_sec, peak_memory_gb=peak / 1e9,
                   warmup_s=result.compile_time_s, span_losses=result.span_losses,
                   final_accuracy=result.final_accuracy)
        emit("lm_seq", **out)
        if launches != want:
            raise AssertionError(f"lm_seq {name}: flash launches {launches}, want {want}")
        if not (all(math.isfinite(x) for x in result.span_losses)
                and _finite_state(torch, trainer)):
            raise AssertionError(f"lm_seq {name}: non-finite loss, parameter or moment")
        if int(trainer.opt_state.step) != LM_SEQ_STEPS:
            raise AssertionError(f"lm_seq {name}: Adam step {int(trainer.opt_state.step)}")
        runs[name] = out
        del trainer, result
        torch.cuda.empty_cache()

    # Equivalence: 2 steps at T = 512 from one init.
    init = lm_params_to_numpy(init_lm_params(torch.Generator().manual_seed(5), spec))
    ds = synthesize_copy(num_train=2 * bs, num_test=bs, seq_len=512, vocab=spec.vocab, seed=5)
    res = {name: SeqTrainer(SeqConfig(batch_size=bs, learning_rate=1e-3, eval_every=0, seed=5,
                                      spec=spec, **kw), ds, init=init, world=world
                            ).train(log=quiet)
           for name, kw in LM_SEQ_EQ_RUNS.items()}
    pairs, bad = {}, []
    for name, oracle, (atol, rtol) in LM_SEQ_EQ:
        a_leaves, b_leaves = tree.leaves(res[name].params), tree.leaves(res[oracle].params)
        err = max(float(np.abs(a - b).max()) for a, b in zip(a_leaves, b_leaves))
        share = max(float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())
                    for a, b in zip(a_leaves, b_leaves))
        la, lb = res[name].final_loss, res[oracle].final_loss
        pairs[f"{name}_vs_{oracle}"] = dict(
            atol=atol, rtol=rtol, params_max_abs_diff=err, params_share_of_tolerance=share,
            bitwise=all(np.array_equal(a, b) for a, b in zip(a_leaves, b_leaves)),
            loss=la, oracle_loss=lb, loss_rel_diff=abs(la - lb) / abs(lb))
        if share > 1.0 or abs(la - lb) > 1e-4 * abs(lb):
            bad.append(f"{name}_vs_{oracle}")
    emit("lm_seq_equivalence", steps=2, seq_len=512, pairs=pairs,
         seconds=time.perf_counter() - start)
    if bad:
        raise AssertionError(f"lm_seq: schemes differ: {bad}")
    return runs


# The lm_tp phase: tensor parallelism at tp 2 as two processes on the one
# card over gloo (NCCL takes one rank a card), each on half the heads.
LM_TP = 2
LM_TP_STEPS = 4
LM_TP_RUNS = (
    ("tp2_full_flash", dict(scheme="full", attn_impl="flash", tensor_parallel=LM_TP)),
    ("hybrid_full_flash", dict(scheme="full", attn_impl="flash", tensor_parallel=LM_TP,
                               zero1=True)),
    # Precision e: the same two under the bf16 policy (bf16 activations
    # through the tp all-reduces, bf16 gradient sums).
    ("tp2_full_flash_bf16", dict(scheme="full", attn_impl="flash", tensor_parallel=LM_TP,
                                 precision="bf16")),
    ("hybrid_full_flash_bf16", dict(scheme="full", attn_impl="flash", tensor_parallel=LM_TP,
                                    zero1=True, precision="bf16")),
)
LM_TP_TIMEOUT_S = 600
LM_TP_LABEL = "two processes on one card over gloo: not a tp scaling figure"


def _rank_run(torch, fa, world, name, kw, shapes, steps=LM_TP_STEPS, label=LM_TP_LABEL):
    """One T = 2048 run of lm_tp or lm_pp on this rank: launches (and the
    shapes they ran at, with their counts), step ms, the device's idle share
    over profiled steady steps, peak memory; under a pipeline also the
    rank's peak of saved stage inputs and its hop bytes a step."""
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
    from ddl_tpu_torch.tools.step_anatomy import LM_FAMILIES, anatomy

    spec, bs, seq_len = lm_spec(), 4, 2048
    ds = synthesize_copy(num_train=steps * bs, num_test=bs, seq_len=seq_len,
                         vocab=spec.vocab, seed=4)
    cfg = SeqConfig(batch_size=bs, learning_rate=1e-3, eval_every=1, seed=4, spec=spec, **kw)
    trainer = SeqTrainer(cfg, ds, world=world)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launches:
        fa.launches[key] = 0
        shapes[key] = {}
    result = trainer.train(log=lambda s: None)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    ran_at = {k: sorted(v) for k, v in shapes.items()}
    ran_at_counts = {k: [[list(shape), n] for shape, n in sorted(v.items())]
                     for k, v in shapes.items()}
    rec = trainer.pipeline_record
    pipeline = {} if rec is None else dict(
        peak_saved=rec.peak_saved, pp_index=trainer.grid.pp_index,
        hop_wire_bytes_per_step=rec.hop.wire_bytes / rec.steps,
        hop_host_copy_bytes_per_step=rec.hop.host_copy_bytes / rec.steps,
        hops_per_step=rec.hop.hops / rec.steps)
    evals = len(result.history) * -(-ds.test_tokens.shape[0] // bs)
    finite = (all(math.isfinite(x) for x in result.span_losses)
              and _finite_state(torch, trainer))
    # Steady steps under the profiler (each process sees its own kernels).
    step = trainer.step_fn()
    xs, ys, ws = (trainer.stage_batches(a, steps, bs)
                  for a in (ds.tokens, ds.targets, ds.weights))
    state = [trainer.params, trainer.opt_state]

    def run(n):
        for i in range(n):
            state[0], state[1], _ = step(*state, xs[i % steps], ys[i % steps], ws[i % steps])

    # gloo's copies through the host show as memcpy on the device.
    anat = anatomy(run, 3, LM_FAMILIES + (("copy", re.compile(r"memcpy|memset", re.I)),))
    stats = result.step_stats
    if "device_busy_ms_per_step" in anat:
        # The profiler slows the host: the busy time over the unprofiled
        # step's median beside the traced window's share.
        anat["device_idle_share_of_steady"] = (1.0 - anat["device_busy_ms_per_step"]
                                               / stats.p50_ms)
    return dict(
        run=name, rank=world.rank, label=label, steps=steps, seq_len=seq_len,
        batch_size=bs, launches=launches, ran_at=ran_at, ran_at_counts=ran_at_counts,
        evals=evals, **pipeline,
        adam_step=int(trainer.opt_state.step), finite=finite,
        step_ms={"p50": stats.p50_ms, "p95": stats.p95_ms, "mean": stats.mean_ms,
                 "spans": stats.steps},
        device_idle_share=anat.get("device_idle_share", "not measured"),
        device_idle_share_of_steady=anat.get("device_idle_share_of_steady", "not measured"),
        device_busy_ms_per_step=anat.get("device_busy_ms_per_step", "not measured"),
        device_ms_per_step_by_family=anat.get("family_ms_per_step", "not measured"),
        profiled_wall_ms_per_step=anat.get("wall_ms_per_step"),
        peak_memory_gb=peak / 1e9, span_losses=result.span_losses,
        final_accuracy=result.final_accuracy,
    )


def _rank_setup(torch, fa, phase: str) -> dict:
    """A spawned rank's start: the build phase's libraries present, TF32
    off, and every flash launch's shape counted (the wrapper still counts
    its launches). Returns the counts, key -> {shape: launches}."""
    from ddl_tpu_torch.ops import build

    for name in build.KERNEL_SOURCES:
        if not build.library_path(name).exists():
            raise RuntimeError(f"{phase}: the build phase's {name} library is missing")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = {key: {} for key in fa.launches}
    launch = fa._launch

    def recording(key, name, tensors, q, causal, scale):
        shapes[key][tuple(q.shape)] = shapes[key].get(tuple(q.shape), 0) + 1
        return launch(key, name, tensors, q, causal, scale)

    fa._launch = recording
    return shapes


def _spawn_ranks(target, n: int, tmp: str, inputs: str, phase: str, timeout_s: float):
    """Runs ``target(rank, store, inputs, out)`` in ``n`` spawned processes
    (a fork after CUDA init is fatal) and returns each rank's ``out``.json
    and ``out``.npz. A rank that fails leaves its peers blocked in a
    collective, so a failure (or the deadline) kills the rest at once; the
    failed ranks' tracebacks are printed and the phase fails."""
    import multiprocessing

    import numpy as np

    outs = [os.path.join(tmp, f"{phase}_rank{r}") for r in range(n)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, f"file://{tmp}/{phase}_store", inputs,
                                              outs[r])) for r in range(n)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + timeout_s
    while (any(pr.is_alive() for pr in procs) and time.monotonic() < deadline
           and not any(pr.exitcode not in (None, 0) for pr in procs)):
        time.sleep(0.5)
    hung = [r for r, pr in enumerate(procs) if pr.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    if hung or any(pr.exitcode != 0 for pr in procs):
        for r in range(n):
            if os.path.exists(outs[r] + ".err"):
                with open(outs[r] + ".err") as f:
                    print(f"{phase} rank {r} failed:\n{f.read()}", file=sys.stderr, flush=True)
        raise AssertionError(f"{phase}: ranks killed (still running) {hung}, exit codes "
                             f"{[pr.exitcode for pr in procs]}")
    ranks = []
    for o in outs:
        with open(o + ".json") as f:
            ranks.append(json.load(f))
    return ranks, [dict(np.load(o + ".npz")) for o in outs]


def lm_tp_rank(rank: int, store: str, inputs: str, out: str) -> None:
    """One rank of lm_tp, in a spawned process: a gloo world of LM_TP ranks
    on cuda:0, the kernels loaded from the build phase's libraries. Writes
    ``out``.json (and ``out``.npz, the equivalence runs' gathered params);
    a failure writes its traceback to ``out``.err and re-raises."""
    import traceback

    import numpy as np
    import torch

    try:
        from ddl_tpu_torch.data.lm import synthesize_copy, synthesize_prompts
        from ddl_tpu_torch.models.transformer import init_lm_params
        from ddl_tpu_torch.ops import flash_attention as fa
        from ddl_tpu_torch.ops import fused_adam
        from ddl_tpu_torch.parallel.mesh import destroy_world, init_world, make_grid
        from ddl_tpu_torch.serve import InferenceEngine, Request, Scheduler, ServeConfig
        from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
        from ddl_tpu_torch.utils import tree

        shapes = _rank_setup(torch, fa, "lm_tp")
        world = init_world(LM_TP, rank, store, "cuda", backend="gloo")
        results, arrays = {"device": str(world.device)}, {}
        try:
            for name, kw in LM_TP_RUNS:
                row = _rank_run(torch, fa, world, name, kw, shapes)
                emit("lm_tp_rank", **row)
                results[name] = row
            # Equivalence: T = 512, 2 steps from the parent's init.
            spec, bs = lm_spec(), 4
            data = np.load(inputs)
            like = init_lm_params(torch.Generator().manual_seed(0), spec)
            init = tree.unflatten(like, [data[f"init/{i}"] for i in range(len(tree.leaves(like)))])
            ds = synthesize_copy(num_train=2 * bs, num_test=bs, seq_len=512, vocab=spec.vocab,
                                 seed=5)
            for name, kw in LM_TP_RUNS:
                res = SeqTrainer(SeqConfig(batch_size=bs, learning_rate=1e-3, eval_every=0,
                                           seed=5, spec=spec, **kw), ds, init=init,
                                 world=world).train(log=lambda s: None)
                for i, leaf in enumerate(tree.leaves(res.params)):
                    arrays[f"{name}/{i}"] = leaf
                results[f"{name}/final_loss"] = res.final_loss
            # The serve at tp 2 over serve_main's traffic (paged, greedy), the
            # port's init from seed 0 sliced by tp index.
            prompts = synthesize_prompts(**SERVE_PROMPTS)
            grid = make_grid(world, 1, 1, LM_TP)
            eng = InferenceEngine(ServeConfig(spec=spec, slots=8, capacity=512, page_size=64,
                                              tensor_parallel=LM_TP), grid=grid)
            margins = record_margins(eng)
            zero_launches(fused_adam, fa)
            t0 = time.perf_counter()
            done, stats = Scheduler(eng).run(
                [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
            results["serve"] = dict(
                seconds=time.perf_counter() - t0, local_heads=int(eng.cache.k.shape[3]),
                kernel_launches=serve_launches("lm_tp serve", fused_adam, fa),
                tokens={str(i): c.tokens for i, c in done.items()},
                status={str(i): c.status for i, c in done.items()},
                margins={str(i): m for i, m in margins.items()},
                decode_tokens_per_s=stats.decode_tokens_per_s, label=LM_TP_LABEL)
        finally:
            destroy_world()
        np.savez(out + ".npz", **arrays)
        with open(out + ".json", "w") as f:
            json.dump(results, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def lm_tp(torch, fa, world) -> dict:
    """Tensor parallelism at tp 2 on the one card: two spawned ranks in a
    gloo world (:func:`lm_tp_rank`), held to their launch counts and shapes
    and to this process's tp 1 runs (training in the NCCL world of one,
    and serving)."""
    import types

    import numpy as np

    from ddl_tpu_torch.convert import lm_params_to_numpy
    from ddl_tpu_torch.data.lm import synthesize_copy, synthesize_prompts
    from ddl_tpu_torch.models.transformer import init_lm_params
    from ddl_tpu_torch.serve import Request
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
    from ddl_tpu_torch.utils import tree

    start = time.perf_counter()
    spec, bs = lm_spec(), 4
    init = lm_params_to_numpy(init_lm_params(torch.Generator().manual_seed(6), spec))
    ds = synthesize_copy(num_train=2 * bs, num_test=bs, seq_len=512, vocab=spec.vocab, seed=5)
    tp1, tp1_bf16 = (SeqTrainer(SeqConfig(scheme="full", attn_impl="flash", batch_size=bs,
                                          learning_rate=1e-3, eval_every=0, seed=5, spec=spec,
                                          precision=prec), ds, init=init, world=world
                                ).train(log=lambda s: None) for prec in (None, "bf16"))
    prompts = synthesize_prompts(**SERVE_PROMPTS)
    serve_params = init_lm_params(torch.Generator().manual_seed(0), spec, "cuda")
    tp1_serve = serve_run(serve_params, [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW)
                                         for i, p in enumerate(prompts)], page_size=64)
    del serve_params
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **{f"init/{i}": a for i, a in enumerate(tree.leaves(init))})
        ranks, params = _spawn_ranks(lm_tp_rank, LM_TP, tmp, inputs, "lm_tp", LM_TP_TIMEOUT_S)

    failures = []
    L, steps = spec.num_layers, LM_TP_STEPS + 1  # the warm-up's discarded step too
    local = [bs, 2048, spec.num_heads // LM_TP, spec.head_dim]
    for r, res in enumerate(ranks):
        for name, _ in LM_TP_RUNS:
            row = res[name]
            want = {"fwd": L * (steps + row["evals"]), "bwd_dkv": L * steps,
                    "bwd_dq": L * steps}
            if row["launches"] != want:
                failures.append(f"rank {r} {name}: flash launches {row['launches']}, want {want}")
            if any(v != [local] for v in row["ran_at"].values()):
                failures.append(f"rank {r} {name}: flash ran at {row['ran_at']}, want {local}")
            if not row["finite"] or row["adam_step"] != LM_TP_STEPS:
                failures.append(f"rank {r} {name}: finite {row['finite']}, "
                                f"Adam step {row['adam_step']}")
    # Equivalence at T = 512: tp 2 against tp 1, the hybrid against tp 2
    # replicated (each in fp32 and under the bf16 policy), and the two
    # ranks' gathered params bit for bit.
    n = len(tree.leaves(tp1.params))
    got = {name: [params[0][f"{name}/{i}"] for i in range(n)] for name, _ in LM_TP_RUNS}
    loss = {name: ranks[0][f"{name}/final_loss"] for name, _ in LM_TP_RUNS}
    # The hybrid repeats tp 2's sums in another order only, so it is held
    # as closely under the policy as in fp32.
    fp32_tol = dict(atol=2e-5, rtol=1e-3, loss_rtol=1e-4)
    hybrid_tol = dict(atol=1e-5, rtol=1e-4, loss_rtol=1e-4)
    bf16_tol = dict(update_rel=BF16_UPDATE_REL, loss_rtol=BF16_LOSS_RTOL)
    pairs = {}
    for name, a_name, want, tol, lb in (
        ("tp2_vs_tp1", "tp2_full_flash", tree.leaves(tp1.params), fp32_tol, tp1.final_loss),
        ("hybrid_vs_tp2", "hybrid_full_flash", got["tp2_full_flash"], hybrid_tol,
         loss["tp2_full_flash"]),
        ("tp2_bf16_vs_tp1_bf16", "tp2_full_flash_bf16", tree.leaves(tp1_bf16.params), bf16_tol,
         tp1_bf16.final_loss),
        ("hybrid_bf16_vs_tp2_bf16", "hybrid_full_flash_bf16", got["tp2_full_flash_bf16"],
         hybrid_tol, loss["tp2_full_flash_bf16"]),
    ):
        pairs[name] = row = _param_pair(got[a_name], want, tree.leaves(init), loss[a_name], lb,
                                        **tol)
        if not row["ok"]:
            failures.append(f"{name}: {row}")
    ranks_bitwise = all(np.array_equal(params[0][k], params[1][k]) for k in params[0])
    if not ranks_bitwise or sorted(params[0]) != sorted(params[1]):
        failures.append("the two ranks' gathered params differ")
    # The serve at tp 2 against tp 1: tokens equal on both ranks.
    serve = {}
    tp1_done, tp1_margins = tp1_serve[0], tp1_serve[3]
    for r, res in enumerate(ranks):
        sv = res["serve"]
        done = {int(i): types.SimpleNamespace(tokens=t) for i, t in sv["tokens"].items()}
        margins = {int(i): m for i, m in sv["margins"].items()}
        diff = _first_difference(done, tp1_done, margins, tp1_margins)
        bad = {i: s for i, s in sv["status"].items() if s != "ok"}
        serve[f"rank{r}"] = dict(tokens_equal_tp1=diff is None, first_difference=diff,
                                 not_ok=bad, local_heads=sv["local_heads"],
                                 kernel_launches=sv["kernel_launches"],
                                 seconds=sv["seconds"],
                                 decode_tokens_per_s=sv["decode_tokens_per_s"],
                                 label=sv["label"])
        if diff is not None or bad or sv["local_heads"] != spec.num_heads // LM_TP:
            failures.append(f"rank {r} serve: first difference {diff}, not ok {bad}")
    out = dict(tp=LM_TP, backend="gloo", devices=[res["device"] for res in ranks],
               launches={name: ranks[0][name]["launches"] for name, _ in LM_TP_RUNS},
               launch_shape=local, equivalence=pairs, ranks_params_bitwise=ranks_bitwise,
               serve=serve, label=LM_TP_LABEL, failures=failures,
               seconds=time.perf_counter() - start)
    emit("lm_tp", **out)
    if failures:
        raise AssertionError(f"lm_tp: {failures}")
    return out


# The lm_pp phase: pipeline parallelism at pp 2 as two processes on the one
# card over gloo, each holding half the layers.
LM_PP = 2
LM_PP_M = 4
LM_PP_STEPS = 4
LM_PP_RUNS = (
    ("gpipe", dict(scheme="full", attn_impl="flash", pipeline_parallel=LM_PP,
                   microbatches=LM_PP_M)),
    ("1f1b", dict(scheme="full", attn_impl="flash", pipeline_parallel=LM_PP,
                  microbatches=LM_PP_M, pipeline_schedule="1f1b")),
    # Precision f: both under the bf16 policy (bf16 hops and gradient sums).
    ("gpipe_bf16", dict(scheme="full", attn_impl="flash", pipeline_parallel=LM_PP,
                        microbatches=LM_PP_M, precision="bf16")),
    ("1f1b_bf16", dict(scheme="full", attn_impl="flash", pipeline_parallel=LM_PP,
                       microbatches=LM_PP_M, pipeline_schedule="1f1b", precision="bf16")),
)


def lm_pp_hop_bytes(spec, elem_bytes: int, bs: int = 4, seq_len: int = 2048) -> int:
    """A rank's hop bytes a step: M activations and M cotangents of [B/M,
    T, d_model] sent or received (lm_main's width: 33,554,432 in fp32,
    16,777,216 in bf16)."""
    return 2 * LM_PP_M * (bs // LM_PP_M) * seq_len * spec.d_model * elem_bytes
LM_PP_TIMEOUT_S = 600
LM_PP_LABEL = "two processes on one card over gloo: not a pipeline scaling figure"
SHARED = ("embed", "head", "lnf_g", "lnf_b")


def lm_pp_rank(rank: int, store: str, inputs: str, out: str) -> None:
    """One rank (one stage) of lm_pp, in a spawned process: a gloo world of
    LM_PP ranks on cuda:0, the kernels loaded from the build phase's
    libraries. Writes ``out``.json (each T = 2048 run's row) and
    ``out``.npz (the T = 512 runs' gathered params and this rank's own
    shared leaves); a failure writes its traceback to ``out``.err and
    re-raises."""
    import traceback

    import numpy as np
    import torch

    try:
        from ddl_tpu_torch.data.lm import synthesize_copy
        from ddl_tpu_torch.models.transformer import init_lm_params
        from ddl_tpu_torch.ops import flash_attention as fa
        from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
        from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
        from ddl_tpu_torch.utils import tree

        shapes = _rank_setup(torch, fa, "lm_pp")
        world = init_world(LM_PP, rank, store, "cuda", backend="gloo")
        results, arrays = {"device": str(world.device)}, {}
        try:
            for name, kw in LM_PP_RUNS:
                row = _rank_run(torch, fa, world, name, kw, shapes, steps=LM_PP_STEPS,
                                label=LM_PP_LABEL)
                emit("lm_pp_rank", **row)
                results[name] = row
            # Equivalence: T = 512, 2 steps from the parent's init.
            spec, bs = lm_spec(), 4
            data = np.load(inputs)
            like = init_lm_params(torch.Generator().manual_seed(0), spec)
            init = tree.unflatten(like, [data[f"init/{i}"] for i in range(len(tree.leaves(like)))])
            ds = synthesize_copy(num_train=2 * bs, num_test=bs, seq_len=512, vocab=spec.vocab,
                                 seed=5)
            for name, kw in LM_PP_RUNS:
                trainer = SeqTrainer(SeqConfig(batch_size=bs, learning_rate=1e-3, eval_every=0,
                                               seed=5, spec=spec, **kw), ds, init=init,
                                     world=world)
                res = trainer.train(log=lambda s: None)
                for i, leaf in enumerate(tree.leaves(res.params)):
                    arrays[f"{name}/{i}"] = leaf
                for k in SHARED:
                    arrays[f"{name}/shared/{k}"] = trainer.params[k].cpu().numpy()
                results[f"{name}/final_loss"] = res.final_loss
        finally:
            destroy_world()
        np.savez(out + ".npz", **arrays)
        with open(out + ".json", "w") as f:
            json.dump(results, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _row_peak(f_tab, b_tab, s: int) -> int:
    """The most stage inputs stage ``s``'s row of the tables holds at once:
    forwarded microbatches not yet backwarded."""
    live = peak = 0
    for f, b in zip(f_tab[s], b_tab[s]):
        live += int(f >= 0)
        peak = max(peak, live)
        live -= int(b >= 0)
    return peak


def lm_pp(torch, fa, world) -> dict:
    """Pipeline parallelism at pp 2 on the one card: two spawned ranks in a
    gloo world (:func:`lm_pp_rank`), held to their launch counts and shapes,
    their saved-input peaks, and to this process's pp 1 run in the NCCL
    world of one."""
    import numpy as np

    from ddl_tpu_torch.convert import lm_params_to_numpy
    from ddl_tpu_torch.data.lm import synthesize_copy
    from ddl_tpu_torch.models.transformer import init_lm_params
    from ddl_tpu_torch.pipeline import max_in_flight, schedule_tables
    from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
    from ddl_tpu_torch.utils import tree

    start = time.perf_counter()
    spec, bs = lm_spec(), 4
    init = lm_params_to_numpy(init_lm_params(torch.Generator().manual_seed(7), spec))
    ds = synthesize_copy(num_train=2 * bs, num_test=bs, seq_len=512, vocab=spec.vocab, seed=5)
    pp1, pp1_bf16 = (SeqTrainer(SeqConfig(scheme="full", attn_impl="flash", batch_size=bs,
                                          learning_rate=1e-3, eval_every=0, seed=5, spec=spec,
                                          precision=prec), ds, init=init, world=world
                                ).train(log=lambda s: None) for prec in (None, "bf16"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **{f"init/{i}": a for i, a in enumerate(tree.leaves(init))})
        ranks, params = _spawn_ranks(lm_pp_rank, LM_PP, tmp, inputs, "lm_pp", LM_PP_TIMEOUT_S)

    failures = []
    per_stage = spec.num_layers // LM_PP
    steps = LM_PP_STEPS + 1  # the warm-up's discarded step too
    micro = [bs // LM_PP_M, 2048, spec.num_heads, spec.head_dim]
    whole = [bs, 2048, spec.num_heads, spec.head_dim]
    peaks = {}
    for name, kw in LM_PP_RUNS:
        f_tab, b_tab = schedule_tables(kw.get("pipeline_schedule", "gpipe"), LM_PP, LM_PP_M)
        peaks[name] = []
        for r, res in enumerate(ranks):
            row = res[name]
            train = per_stage * LM_PP_M * steps
            want = {"fwd": 2 * train + per_stage * row["evals"], "bwd_dkv": train,
                    "bwd_dq": train}
            if row["launches"] != want:
                failures.append(f"rank {r} {name}: flash launches {row['launches']}, want {want}")
            # Training at the microbatch's shape; the eval at its chunk's.
            want_at = {"fwd": [[micro, 2 * train], [whole, per_stage * row["evals"]]],
                       "bwd_dkv": [[micro, train]], "bwd_dq": [[micro, train]]}
            got_at = {k: sorted(v) for k, v in row["ran_at_counts"].items()}
            if got_at != {k: sorted(v) for k, v in want_at.items()}:
                failures.append(f"rank {r} {name}: flash ran at {got_at}, want {want_at}")
            peak = _row_peak(f_tab, b_tab, row["pp_index"])
            peaks[name].append(row["peak_saved"])
            if row["peak_saved"] != peak:
                failures.append(f"rank {r} {name}: {row['peak_saved']} saved inputs at the "
                                f"peak, its table row implies {peak}")
            hop = lm_pp_hop_bytes(spec, 2 if kw.get("precision") == "bf16" else 4)
            if row["hop_wire_bytes_per_step"] != hop:
                failures.append(f"rank {r} {name}: {row['hop_wire_bytes_per_step']} hop bytes "
                                f"a step, want {hop}")
            if not row["finite"] or row["adam_step"] != LM_PP_STEPS:
                failures.append(f"rank {r} {name}: finite {row['finite']}, "
                                f"Adam step {row['adam_step']}")
        if max(peaks[name]) != max_in_flight(f_tab, b_tab):
            failures.append(f"{name}: peaks {peaks[name]}, max_in_flight "
                            f"{max_in_flight(f_tab, b_tab)}")
    # Equivalence at T = 512: GPipe against pp 1, 1F1B against GPipe (fp32
    # and under the bf16 policy, where 1F1B must be bitwise), and the ranks'
    # own shared leaves bit for bit.
    n = len(tree.leaves(pp1.params))
    got = {name: [params[0][f"{name}/{i}"] for i in range(n)] for name, _ in LM_PP_RUNS}
    loss = {name: ranks[0][f"{name}/final_loss"] for name, _ in LM_PP_RUNS}
    fp32_tol = dict(atol=2e-5, rtol=1e-3, loss_rtol=1e-4)
    bf16_tol = dict(update_rel=BF16_UPDATE_REL, loss_rtol=BF16_LOSS_RTOL)
    pairs = {}
    for name, a_name, b, lb, tol in (
        ("gpipe_vs_pp1", "gpipe", tree.leaves(pp1.params), pp1.final_loss, fp32_tol),
        ("1f1b_vs_gpipe", "1f1b", got["gpipe"], loss["gpipe"], fp32_tol),
        ("gpipe_bf16_vs_pp1_bf16", "gpipe_bf16", tree.leaves(pp1_bf16.params),
         pp1_bf16.final_loss, bf16_tol),
        ("1f1b_bf16_vs_gpipe_bf16", "1f1b_bf16", got["gpipe_bf16"], loss["gpipe_bf16"],
         dict(bitwise=True, loss_rtol=BF16_LOSS_RTOL)),
    ):
        pairs[name] = row = _param_pair(got[a_name], b, tree.leaves(init), loss[a_name], lb,
                                        **tol)
        if not row["ok"]:
            failures.append(f"{name}: {row}")
    shared_bitwise = all(np.array_equal(params[0][f"{name}/shared/{k}"],
                                        params[1][f"{name}/shared/{k}"])
                         for name, _ in LM_PP_RUNS for k in SHARED)
    ranks_bitwise = all(np.array_equal(params[0][k], params[1][k]) for k in params[0])
    if not shared_bitwise or not ranks_bitwise:
        failures.append(f"the ranks' shared leaves (bitwise {shared_bitwise}) or gathered "
                        f"params (bitwise {ranks_bitwise}) differ")
    rows = {name: [{k: res[name][k] for k in (
        "pp_index", "step_ms", "device_idle_share", "device_idle_share_of_steady",
        "device_busy_ms_per_step", "device_ms_per_step_by_family", "peak_memory_gb",
        "peak_saved", "hop_wire_bytes_per_step", "hop_host_copy_bytes_per_step",
        "hops_per_step")} for res in ranks] for name, _ in LM_PP_RUNS}
    out = dict(pp=LM_PP, microbatches=LM_PP_M, backend="gloo",
               devices=[res["device"] for res in ranks],
               launches={name: ranks[0][name]["launches"] for name, _ in LM_PP_RUNS},
               launch_shape=micro, peak_saved=peaks, ranks=rows, equivalence=pairs,
               shared_leaves_bitwise=shared_bitwise, ranks_params_bitwise=ranks_bitwise,
               label=LM_PP_LABEL, failures=failures, seconds=time.perf_counter() - start)
    emit("lm_pp", **out)
    if failures:
        raise AssertionError(f"lm_pp: {failures}")
    return out


# The serving phases: benchmarks/serve_bench.py's width and traffic.
SERVE_PROMPTS = dict(num=16, min_len=16, max_len=128, vocab=256, seed=0)
SERVE_NEW = 64
SERVE_TOL = (1e-4, 1e-3)  # (atol, rtol) of serve_vs_full_forward


def zero_launches(fused_adam, fa) -> None:
    """Every kernel's launch count to 0."""
    fused_adam.launches = 0
    for key in fa.launches:
        fa.launches[key] = 0


def serve_launches(phase: str, fused_adam, fa) -> dict:
    """Every kernel's launch count since :func:`zero_launches`, by kernel
    name; raises unless all are 0 (no kernel of ``csrc/`` lies on the serve
    path)."""
    counts = {"adam_flat_fused": fused_adam.launches,
              **{FLASH_KERNELS[key][0]: n for key, n in fa.launches.items()}}
    if any(counts.values()):
        raise AssertionError(f"{phase}: kernels launched on the serve path: {counts}")
    return counts


def serve_engine(params, **kw):
    """An engine at serve_bench's slots and capacity over the shared
    ``params`` (the port's init from seed 0, placed once)."""
    from ddl_tpu_torch.serve import InferenceEngine, ServeConfig

    return InferenceEngine(ServeConfig(spec=lm_spec(), slots=8, capacity=512, **kw),
                           placed_params=params, device="cuda")


def record_margins(eng, ticks=None) -> dict:
    """Wraps ``eng``'s prefill and decode to keep, per request id, the top-2
    logit margin of each sampled token in order (the last prefill block's,
    then each decode step's), and in ``ticks`` (a list) the active rows'
    logits of each decode tick. Returns the margins dict."""
    import numpy as np

    margins = {}
    prefill, decode = eng.prefill, eng.decode

    def top2(rows):
        s = np.sort(rows, axis=-1)
        return s[..., -1] - s[..., -2]

    def rec_prefill(prompt, *, slot, request_id, base=0, _bucket=None):
        tok, logits = prefill(prompt, slot=slot, request_id=request_id, base=base,
                              _bucket=_bucket)
        margins[request_id] = [float(top2(logits[-1]))]  # the last block's sample
        return tok, logits

    def rec_decode(last, lengths, rids, active, **k):
        nxt, logits = decode(last, lengths, rids, active, **k)
        act = np.asarray(active, bool)
        for i, m in zip(np.nonzero(act)[0], top2(logits[act])):
            margins[int(rids[i])].append(float(m))
        if ticks is not None:
            ticks.append(logits[act])
        return nxt, logits

    eng.prefill, eng.decode = rec_prefill, rec_decode
    return margins


def serve_run(params, requests, *, warmup=False, **kw):
    """(completions, stats, engine, per-request top-2 margins of each
    sampled token, the active rows' logits of each decode tick) of one
    ``Scheduler.run`` over a fresh engine."""
    from ddl_tpu_torch.serve import Scheduler

    eng = serve_engine(params, **kw)
    sched = Scheduler(eng)
    if warmup:
        sched.warmup(requests)
    ticks = []
    margins = record_margins(eng, ticks)
    done, stats = sched.run(requests)
    return done, stats, eng, margins, ticks


def serve_main(torch, params, fused_adam, fa) -> dict:
    from ddl_tpu_torch.data.lm import synthesize_prompts
    from ddl_tpu_torch.serve import Request, Scheduler

    prompts = synthesize_prompts(**SERVE_PROMPTS)
    requests = [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)]
    start = time.perf_counter()
    zero_launches(fused_adam, fa)
    eng = serve_engine(params, page_size=64)
    sched = Scheduler(eng)
    t0 = time.perf_counter()
    sched.warmup(requests)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    done, stats = sched.run(requests)
    peak = torch.cuda.max_memory_allocated()
    launches = serve_launches("serve_main", fused_adam, fa)
    bad = {i: (c.status, len(c.tokens)) for i, c in done.items()
           if c.status != "ok" or len(c.tokens) != SERVE_NEW}
    whole = eng.pages.free == eng.num_pages and eng.pages.reserved == 0 and not eng.table_len.any()
    out = dict(
        requests=len(done), new_tokens=SERVE_NEW, slots=8, capacity=512, page_size=64,
        num_pages=eng.num_pages, kernel_launches=launches,
        decode_tokens_per_s=stats.decode_tokens_per_s, decode_ticks=stats.decode_steps,
        decode_tokens=stats.decode_tokens, prefill_tokens_per_s=stats.prefill_tokens_per_s,
        decode_tick_ms={"p50": stats.latency.p50_ms, "p95": stats.latency.p95_ms,
                        "mean": stats.latency.mean_ms},
        ttft_ms={"p50": stats.ttft.p50_ms, "p95": stats.ttft.p95_ms},
        itl_ms={"p50": stats.itl.p50_ms, "p95": stats.itl.p95_ms},
        last_attend_width=eng.last_attend_width, peak_memory_gb=peak / 1e9,
        warmup_s=warmup_s, pool_whole_after_release=whole, not_ok=bad,
        seconds=time.perf_counter() - start,
    )
    emit("serve_main", **out)
    if bad or len(done) != len(prompts) or not whole:
        raise AssertionError(f"serve_main: requests not ok {bad}, pool whole {whole}")
    return out


def _first_difference(a, b, margins_a, margins_b):
    """(request, step, top-2 margins there) of the first differing token
    (margins as :func:`record_margins` keeps them: step k's is the k-th)."""
    for i in sorted(a):
        ta, tb = a[i].tokens, b[i].tokens
        if ta != tb:
            step = next((k for k, (x, y) in enumerate(zip(ta, tb)) if x != y),
                        min(len(ta), len(tb)))
            at = lambda m: m[i][step] if step < len(m[i]) else None  # noqa: E731
            return {"request": i, "step": step, "margin_a": at(margins_a),
                    "margin_b": at(margins_b)}
    return None


def serve_equivalence(params, fused_adam, fa) -> dict:
    import numpy as np

    from ddl_tpu_torch.data.lm import synthesize_prompts, synthesize_shared_prefix_prompts
    from ddl_tpu_torch.serve import Request

    prompts = synthesize_prompts(**SERVE_PROMPTS)
    def reqs(ps, n=SERVE_NEW, stagger=False):
        # Staggered: one arrival a tick, so a family's later prompts find its
        # first one registered.
        return [Request(id=i, prompt=p, max_new_tokens=n, arrival=i if stagger else 0)
                for i, p in enumerate(ps)]

    # Prompts of 128-152 tokens sharing 112: paged entries hold 2 full pages,
    # so a hit shares one page and copies the boundary page (48 rows).
    start = time.perf_counter()
    zero_launches(fused_adam, fa)
    shared = synthesize_shared_prefix_prompts(n_families=2, per_family=4, prefix_len=112,
                                              tail_min=16, tail_max=40, vocab=256, seed=0)
    results, failures = {}, {}

    def same(name, a, b, extra=None):
        diff = _first_difference(a[0], b[0], a[3], b[3])
        results[name] = dict(tokens_equal=diff is None, **(extra or {}))
        if diff is not None:
            failures[name] = diff

    paged, contiguous = serve_run(params, reqs(prompts), page_size=64), serve_run(params,
                                                                                reqs(prompts))
    # Not a gate: whether the two layouts' decode logits are bitwise equal.
    logits = {}
    if len(paged[4]) == len(contiguous[4]):
        a, b = np.concatenate(paged[4]), np.concatenate(contiguous[4])
        logits = dict(logits_max_abs_diff=float(np.abs(a - b).max()),
                      logits_bitwise_equal=bool(np.array_equal(a, b)))
    same("paged_vs_contiguous", paged, contiguous, logits)
    for kw, name in (({}, "batched_vs_alone"),
                     (dict(temperature=0.8, top_k=20), "sampled_batched_vs_alone")):
        three = [Request(id=i, prompt=prompts[i], max_new_tokens=SERVE_NEW) for i in (2, 7, 11)]
        batched = serve_run(params, three, **kw)
        for r in three:
            alone = serve_run(params, [r], **kw)
            same(f"{name}[{r.id}]", ({r.id: batched[0][r.id]},) + batched[1:3]
                 + ({r.id: batched[3][r.id]},), alone[:4])
    for ps in (0, 64):
        on = serve_run(params, reqs(shared, 32, True), page_size=ps, prefix_slots=4, warmup=True)
        same(f"prefix_on_vs_off[page_size={ps}]", on,
             serve_run(params, reqs(shared, 32, True), page_size=ps),
             dict(prefix_hits=on[1].prefix_hits, page_copies=on[2].page_copies if ps else None))
        if on[1].prefix_hits <= 0:
            failures[f"prefix_on_vs_off[page_size={ps}]"] = "no prefix hit"
    same("chunk64_vs_whole", serve_run(params, reqs(prompts, 16), page_size=64, prefill_chunk=64),
         serve_run(params, reqs(prompts, 16), page_size=64))
    launches = serve_launches("serve_equivalence", fused_adam, fa)
    emit("serve_equivalence", cases=results, failures=failures, kernel_launches=launches,
         seconds=time.perf_counter() - start)
    if failures:
        raise AssertionError(f"serve paths differ: {failures}")
    return results


def serve_vs_full_forward(torch, params, fused_adam, fa) -> dict:
    import numpy as np

    from ddl_tpu_torch.data.lm import synthesize_prompts
    from ddl_tpu_torch.models.transformer import apply_lm

    start = time.perf_counter()
    prompt = synthesize_prompts(**SERVE_PROMPTS)[5]
    steps = 32
    atol, rtol = SERVE_TOL
    out = {}
    for ps in (0, 64):
        zero_launches(fused_adam, fa)
        eng = serve_engine(params, page_size=ps)
        tok, prefill_logits = eng.prefill(prompt, slot=0, request_id=0)
        seq, logits = [*prompt.tolist(), tok], [prefill_logits]
        S = eng.config.slots
        active = np.zeros(S, bool)
        active[0] = True
        for _ in range(steps):
            last = np.zeros(S, np.int32)
            last[0] = seq[-1]
            lengths = np.zeros(S, np.int32)
            lengths[0] = len(seq) - 1
            nxt, lg = eng.decode(last, lengths, np.zeros(S, np.int32), active)
            logits.append(lg[:1])
            seq.append(int(nxt[0]))
        # Read before the oracle below launches the flash forward.
        launches = serve_launches(f"serve_vs_full_forward[page_size={ps}]", fused_adam, fa)
        got = torch.tensor(np.concatenate(logits), device="cuda")
        tokens = torch.tensor([seq[:-1]], device="cuda")
        want = apply_lm(eng.params, tokens, eng.config.spec,
                        attn_fn=lambda q, k, v: fa.flash_attention_bthd(q, k, v, causal=True))[0]
        ok, err, share = _close(got, want, atol, rtol)
        out[f"page_size={ps}"] = dict(positions=int(got.shape[0]), max_abs_err=err,
                                      share_of_tolerance=share, kernel_launches=launches)
        if not ok:
            emit("serve_vs_full_forward", atol=atol, rtol=rtol, **out)
            raise AssertionError(f"serve logits != full forward (page_size={ps}): {err}")
    emit("serve_vs_full_forward", atol=atol, rtol=rtol, prompt_len=len(prompt),
         decode_steps=steps, seconds=time.perf_counter() - start, **out)
    return out


def serve_bf16(torch, params, fused_adam, fa, fp32_out) -> dict:
    """Precision g: serve_main's traffic with ``compute_dtype="bfloat16"``:
    the pools in bf16 (8,192 bytes a row at this width), every request
    ``ok``, decode tokens/s, TTFT and ITL beside serve_main's fp32 run, and
    paged ≡ contiguous tokens up to the first near-tie (a first difference
    only at a top-2 margin below BF16_NEAR_TIE on either side). No kernel
    of ``csrc/`` launches."""
    from ddl_tpu_torch.data.lm import synthesize_prompts
    from ddl_tpu_torch.serve import Request, Scheduler
    from ddl_tpu_torch.serve.cache import kv_row_bytes

    prompts = synthesize_prompts(**SERVE_PROMPTS)
    requests = [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)]
    start = time.perf_counter()
    zero_launches(fused_adam, fa)
    eng = serve_engine(params, page_size=64, compute_dtype="bfloat16")
    spec = eng.config.spec
    row_bytes = kv_row_bytes(spec, None, eng.config.pool_dtype())
    pool_row_bytes = (2 * spec.num_layers * spec.num_heads * spec.head_dim
                      * eng.cache.k.element_size())
    sched = Scheduler(eng)
    sched.warmup(requests)
    torch.cuda.synchronize()
    done, stats = sched.run(requests)
    failures = []
    half = kv_row_bytes(spec, None, torch.float32) // 2  # 8,192 at serve_main's width
    if (row_bytes, pool_row_bytes) != (half, half) or eng.cache.k.dtype != torch.bfloat16:
        failures.append(f"pool {eng.cache.k.dtype}, {row_bytes} / {pool_row_bytes} bytes a row, "
                        f"want {half}")
    bad = {i: (c.status, len(c.tokens)) for i, c in done.items()
           if c.status != "ok" or len(c.tokens) != SERVE_NEW}
    if bad or len(done) != len(prompts):
        failures.append(f"requests not ok: {bad}")
    paged = serve_run(params, requests, page_size=64, compute_dtype="bfloat16")
    contiguous = serve_run(params, requests, compute_dtype="bfloat16")
    diff = _first_difference(paged[0], contiguous[0], paged[3], contiguous[3])
    equal = sum(paged[0][i].tokens == contiguous[0][i].tokens for i in paged[0])
    if diff is not None:
        margins = [m for m in (diff["margin_a"], diff["margin_b"]) if m is not None]
        if not margins or min(margins) >= BF16_NEAR_TIE:
            failures.append(f"paged != contiguous off a near-tie: {diff}")
    launches = serve_launches("precision_serve", fused_adam, fa)
    out = dict(
        compute_dtype="bfloat16", requests=len(done), new_tokens=SERVE_NEW, slots=8,
        capacity=512, page_size=64, kv_row_bytes=row_bytes,
        fp32_kv_row_bytes=kv_row_bytes(spec, None, torch.float32), kernel_launches=launches,
        decode_tokens_per_s=stats.decode_tokens_per_s,
        fp32_decode_tokens_per_s=fp32_out["decode_tokens_per_s"],
        decode_tick_ms={"p50": stats.latency.p50_ms, "p95": stats.latency.p95_ms},
        fp32_decode_tick_ms=fp32_out["decode_tick_ms"],
        ttft_ms={"p50": stats.ttft.p50_ms, "p95": stats.ttft.p95_ms},
        fp32_ttft_ms=fp32_out["ttft_ms"],
        itl_ms={"p50": stats.itl.p50_ms, "p95": stats.itl.p95_ms}, fp32_itl_ms=fp32_out["itl_ms"],
        paged_vs_contiguous=dict(requests_equal=equal, first_difference=diff,
                                 near_tie=BF16_NEAR_TIE),
        failures=failures, seconds=time.perf_counter() - start)
    emit("precision_serve", **out)
    if failures:
        raise AssertionError(f"precision_serve: {failures}")
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
                       profile_windows=kern["profile_windows"],
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


def run_phases(torch, world, card: str):
    """Every phase after the build, in order; returns what the kernels line
    reads."""
    from ddl_tpu_torch.models.transformer import init_lm_params
    from ddl_tpu_torch.ops import flash_attention, fused_adam
    from ddl_tpu_torch.tools import devtime

    max_err = check_kernel(torch, fused_adam)
    main_out = main_path(torch, world, fused_adam)
    fused_vs_plain(torch, world)
    async_out = async_main(torch, world, fused_adam)
    async_equivalence(torch, world)
    cnn_bf16_out = cnn_bf16(torch, world, fused_adam, main_out)
    cnn_conv_matmul(torch)

    flush = devtime.L2Flush(torch.device("cuda"))
    tim = timing(torch, fused_adam, devtime, flush, card)

    flash_err = check_flash(torch, flash_attention)
    flash_determinism(torch, flash_attention)
    lm_out = lm_main(torch, flash_attention)
    lm_flash_vs_xla(torch)
    lm_bf16(torch, flash_attention)
    policy_out = lm_policy(torch, flash_attention, lm_out)
    seq_policy_out = lm_seq_policy(torch, flash_attention, world)
    seq_out = lm_seq(torch, flash_attention, world)
    tp_out = lm_tp(torch, flash_attention, world)
    pp_out = lm_pp(torch, flash_attention, world)

    serve_params = init_lm_params(torch.Generator().manual_seed(0), lm_spec(), "cuda")
    serve_out = serve_main(torch, serve_params, fused_adam, flash_attention)
    serve_equivalence(serve_params, fused_adam, flash_attention)
    serve_vs_full_forward(torch, serve_params, fused_adam, flash_attention)
    serve_bf16(torch, serve_params, fused_adam, flash_attention, serve_out)
    del serve_params
    flash_tim = flash_timing(torch, flash_attention, devtime, flush, card)
    bf16 = dict(cnn=cnn_bf16_out, lm=policy_out, seq=seq_policy_out)
    return (max_err, main_out, async_out, tim, flash_err, lm_out, seq_out, tp_out, pp_out,
            flash_tim, bf16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ddl_tpu_torch.ops import build
    from ddl_tpu_torch.parallel.mesh import destroy_world, init_world

    card = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=list(build.KERNEL_SOURCES))

    with tempfile.TemporaryDirectory() as store:
        # One NCCL world of one, set up once, for every phase that needs one
        # (the CNN paths and lm_seq).
        world = init_world(1, 0, f"file://{os.path.join(store, 'store')}", "cuda")
        try:
            (max_err, main_out, async_out, tim, flash_err, lm_out, seq_out, tp_out, pp_out,
             flash_tim, bf16) = run_phases(torch, world, card)
        finally:
            destroy_world()

    kernels = [{
        "name": "adam_flat_fused",
        "route": "cuda",
        "source": "ddl_tpu_torch/csrc/fused_adam.cu",
        "replaces": "ddl_tpu/ops/pallas_adam.py:54",
        "launches": main_out["launches"],
        "async_launches": async_out["launches"],
        "bf16_launches": bf16["cnn"]["launches"],
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
            "ulysses_launches": seq_out["ulysses_flash"]["launches"][key],
            "tp_launches": tp_out["launches"]["tp2_full_flash"][key],
            "pp_launches": pp_out["launches"]["gpipe"][key],
            "bf16_launches": bf16["lm"]["launches"][key],
            "bf16_ulysses_zero1_launches": bf16["seq"]["bf16"]["launches"][key],
            "bf16_tp_launches": tp_out["launches"]["tp2_full_flash_bf16"][key],
            "bf16_pp_launches": pp_out["launches"]["gpipe_bf16"][key],
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
