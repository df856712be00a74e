"""Command-line launcher for the port — the subset of ``ddl_tpu/cli.py``
the ported slices carry: the seven CNN variants (single, sync and async,
whole or sharded), the decoder LM over a [data-parallel, num-workers,
tensor-parallel, pipeline-parallel] grid (ring, Ulysses or full attention,
ZeRO-1, Megatron tensor parallelism, GPipe or 1F1B pipeline stages), and
serving: one engine, at tp 1 or over a tp group, or a fleet of replicas
behind the SLO-aware router (``--replicas``), with disaggregated
prefill/decode roles, the self-healing fleet controller, speculative
decoding (``--speculate``) and the int8 KV pool (``--kv-dtype int8``), with
serve telemetry (metrics, traces, burn-rate SLO rules, anomaly rules, the
/metrics endpoint); and ``sim``, the fleet's cost-model digital twin
replaying a named scenario (``--scenario``, costs fitted with ``--fit``).

    python -m ddl_tpu_torch single
    python -m ddl_tpu_torch sync_sharding --num-workers 1 --num-ps 2 --layout flat --fused-adam
    python -m ddl_tpu_torch async_sharding --num-ps 2
    torchrun --nproc-per-node 4 -m ddl_tpu_torch sync --num-workers 4
    python -m ddl_tpu_torch lm --seq-scheme ulysses --attn-impl flash
    torchrun --nproc-per-node 4 -m ddl_tpu_torch lm --num-workers 2 --data-parallel 2 --zero1
    torchrun --nproc-per-node 4 -m ddl_tpu_torch lm --num-workers 2 --tensor-parallel 2
    torchrun --nproc-per-node 2 -m ddl_tpu_torch lm --pipeline-parallel 2 --microbatches 4
    python -m ddl_tpu_torch sync_sharding --precision bf16 --conv-matmul tail
    python -m ddl_tpu_torch lm --precision bf16 --seq-scheme full --attn-impl flash
    python -m ddl_tpu_torch serve --slots 8 --capacity 512 --page-size 64 --json
    torchrun --nproc-per-node 2 -m ddl_tpu_torch serve --tensor-parallel 2 --json
    python -m ddl_tpu_torch sync_sharding --checkpoint-dir ck --checkpoint-every 10 --resume auto
    python -m ddl_tpu_torch lm --checkpoint-dir ck --checkpoint-every 1 --max-bad-steps 2 \
        --inject-fault nan_grads@1x2
    python -m ddl_tpu_torch serve --checkpoint-dir ck --json
    python -m ddl_tpu_torch serve --replicas 2 --page-size 64 --traffic \
        "horizon=20;chat:rate=0.7,pmin=16,pmax=48,new=16" --slo "chat:ttft=5" --json
    python -m ddl_tpu_torch serve --replicas 2 --page-size 64 --roles prefill=1,decode=1
    python -m ddl_tpu_torch serve --replicas 1 --page-size 64 --autoscale backlog=3 \
        --max-replicas 3 --inject-fault replica_crash@6:0
    python -m ddl_tpu_torch serve --replicas 2 --page-size 64 --speculate 4 --kv-dtype int8
    python -m ddl_tpu_torch serve --metrics-out m.jsonl --trace-dir tr \
        --slo-rules "ttft:metric=serve_ttft_seconds,target=0.5" --anomaly-rules queue_depth
    python -m ddl_tpu_torch sim --scenario bulk_burst --fit m.jsonl --json
    python -m ddl_tpu_torch lm --multihost --coordinator host0:8476 --num-processes 2 \
        --process-id $P --num-workers 2 --tensor-parallel 2

Flags are spelled as in the JAX CLI, with its defaults; a flag of another
variant set away from its default is refused. One process drives one
device: a multi-worker run is launched with ``torchrun``, whose ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` / ``LOCAL_RANK``
variables this reads, or with JAX's ``--multihost`` flags, one command a
host, whose process starts that host's ranks with the same variables
(``parallel/multihost.py``); a run of one worker makes a world of one
itself. Runs on ``cuda`` unless ``--device cpu`` or JAX's ``--platform
cpu`` (``sim`` touches no device), in fp32 with TF32 off unless
``--precision bf16`` (bf16 compute and bf16 gradient sums, fp32 master
weights and moments) or the legacy ``--bf16`` (bf16 compute only); the JAX
CLI's bf16 default on a TPU does not carry over, as JAX on a GPU defaults
to fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

VARIANTS = (
    "single",
    "sync",
    "async",
    "sync_sharding",
    "async_sharding",
    "sync_sharding_greedy",
    "async_sharding_greedy",
    "lm",
    "serve",
    "sim",
)
# Flags of one variant group, each refused, set away from its default, by
# the others (as ddl_tpu/cli.py's _reject_foreign_flags).
_CNN_ONLY = ("num_ps", "layout", "keep_prob", "staleness_seed", "data", "synthetic_train",
             "synthetic_test", "fused_adam", "conv1_matmul", "conv_matmul", "conv_channels",
             "fc_sizes", "tiny", "reference_compat")
# The LM's width and its tp degree: lm and serve.
_MODEL = ("vocab", "d_model", "heads", "layers", "d_ff", "tensor_parallel")
_LM_TRAIN = ("seq_scheme", "seq_len", "train_seqs", "test_seqs", "target_accuracy",
             "attn_impl", "remat", "seq_layout", "data_parallel", "zero1",
             "pipeline_parallel", "microbatches", "pipeline_schedule")
_LM_ONLY = _LM_TRAIN + _MODEL
_TRAIN_ONLY = ("num_workers", "epochs", "batch_size", "lr", "eval_every", "checkpoint_every",
               "resume", "dispatch_timeout", "max_bad_steps")
_SERVE_ONLY = ("slots", "capacity", "max_new_tokens", "num_prompts", "prompt_min",
               "prompt_max", "temperature", "top_k", "prefix_cache", "prefill_chunk",
               "prefill_budget", "page_size", "num_pages", "ttft_deadline",
               "request_deadline", "shed_threshold", "replicas", "traffic", "slo",
               "slo_rules", "autoscale", "max_replicas", "roles", "speculate")
_SIM_ONLY = ("scenario", "fit")
_MULTIHOST = ("multihost", "coordinator", "num_processes", "process_id")
# The serve flags whose job the scenario does on sim (topology, traffic,
# per-request policy); --replicas, --autoscale and --max-replicas stay the
# twin's scale and policy knobs.
_SIM_REJECT = tuple(d for d in _SERVE_ONLY if d not in ("replicas", "autoscale", "max_replicas"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ddl_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("variant", choices=VARIANTS)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where a run computes (default cuda; sim touches no device and "
                        "refuses it)")
    p.add_argument("--platform", default=None, choices=["cpu", "tpu"],
                   help="JAX's spelling of the device: 'cpu' is --device cpu; 'tpu' is "
                        "refused (the port runs on an NVIDIA card or the CPU); sim takes "
                        "it and ignores it, as JAX's")
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-parallel degree (default: torchrun's WORLD_SIZE, else 1)")
    p.add_argument("--num-ps", type=int, default=2,
                   help="parameter shard count for *_sharding variants")
    p.add_argument("--layout", default=None,
                   choices=["block", "zigzag", "lpt", "flat"],
                   help="shard layout policy (default: block for *_sharding, "
                        "zigzag for *_greedy)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=None,
                   help="sync: global batch size (default 100, rounded up to a "
                        "multiple of --num-workers for sharded data); async: "
                        "the batch of one push (default 100)")
    p.add_argument("--lr", type=float, default=None,
                   help="Adam learning rate (default 1e-4, the reference's)")
    p.add_argument("--keep-prob", type=float, default=0.5)
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--staleness-seed", type=int, default=0,
                   help="async: seed of the arrival schedule (one permutation "
                        "of the workers a round)")
    p.add_argument("--data", default="data/mnist.pkl",
                   help="mnist.pkl path; synthesized procedurally if absent")
    p.add_argument("--synthetic-train", type=int, default=50_000)
    p.add_argument("--synthetic-test", type=int, default=10_000)
    p.add_argument("--fused-adam", action="store_true",
                   help="run the sharded update through the hand-written "
                        "CUDA fused-Adam kernel")
    p.add_argument("--conv1-matmul", action="store_true",
                   help="run the 1-input-channel first conv as an explicit "
                        "patches-matmul (im2col and one matmul)")
    p.add_argument("--conv-matmul", default="none",
                   choices=["none", "first", "tail", "first+tail", "all"],
                   help="which conv stages run as explicit patches-matmuls: first "
                        "(= --conv1-matmul), tail (convs 3-4, the small-spatial "
                        "stages), first+tail, all")
    p.add_argument("--conv-channels", type=_int_tuple, default=None, metavar="C1,C2,C3,C4",
                   help="conv widths of the model family (default 32,64,128,256, the "
                        "reference architecture)")
    p.add_argument("--fc-sizes", type=_int_tuple, default=None, metavar="F1,F2",
                   help="FC widths of the model family (default 1024,512)")
    p.add_argument("--tiny", action="store_true",
                   help="narrow model preset (--conv-channels 4,8,8,8 --fc-sizes 32,16)")
    p.add_argument("--reference-compat", action="store_true",
                   help="summed (not averaged) gradients and identical "
                        "batches on every worker, as the reference")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute with fp32 gradient sums, master weights and "
                        "moments (the legacy compute-only thread)")
    p.add_argument("--fp32", action="store_true",
                   help="fp32 compute (the default on this port)")
    p.add_argument("--precision", default=None, choices=["fp32", "bf16"],
                   help="precision policy: fp32 = the default programs; bf16 = bf16 "
                        "activations AND gradient sums with fp32 master weights and "
                        "Adam moments. Owns the compute dtype: mutually exclusive with "
                        "--bf16/--fp32")
    p.add_argument("--json", action="store_true",
                   help="print one JSON summary line at the end")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save an atomic rolling checkpoint (params + optimizer state) at "
                        "every epoch end, in the format both packages read; serve: load "
                        "the params (only) of a training checkpoint of any topology")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="additionally checkpoint every N batches (async: N rounds); "
                        "0 = epoch end only")
    p.add_argument("--resume", nargs="?", const="latest", default=None,
                   choices=["latest", "auto"], metavar="MODE",
                   help="resume from --checkpoint-dir: bare --resume (or 'latest') loads "
                        "the rolling checkpoint exactly; 'auto' discovers the newest VALID "
                        "save (corrupt or truncated files are checksum-verified out and "
                        "resume falls back to the previous retained one); a missing "
                        "checkpoint starts fresh either way")
    p.add_argument("--max-bad-steps", type=int, default=None, metavar="K",
                   help="single/lm: run the non-finite guarded step (a step whose "
                        "gradients hold a NaN or Inf applies the identity) and roll back "
                        "to the last good checkpoint after K CONSECUTIVE skipped steps, "
                        "replaying from its step (requires --checkpoint-dir)")
    p.add_argument("--inject-fault", default=None, metavar="SPEC",
                   help="deterministic chaos (resilience/faults.py): nan_grads@K[xN] / "
                        "inf_grads@K[xN] on single/lm (poison N batches from global step "
                        "K; a trailing '!' persists through rollbacks); sigterm@K (a real "
                        "SIGTERM once step K completes) and corrupt_ckpt / truncate_ckpt "
                        "(damage the latest checkpoint at startup, then prove --resume "
                        "auto) on every training variant; serve: stall@REQID and "
                        "replica_crash parse, and are refused (not ported)")
    p.add_argument("--dispatch-timeout", type=float, default=0.0, metavar="SECONDS",
                   help="fail with a diagnosis (instead of hanging forever) if a training "
                        "span or eval does not complete in SECONDS; <= 0 disables")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the training loop into DIR "
                        "(one Chrome trace a rank, torch_profile_p<rank>.json; view in "
                        "Perfetto); training variants only, serve traces with --trace-dir")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write run telemetry as JSONL (ddl_tpu_torch.obs registry "
                        "snapshots: counters/gauges/histograms; the FIRST record is a run "
                        "manifest with the torch and CUDA versions, the card's name and "
                        "power limit, the grid's shape, the config and the git sha). On "
                        "single/lm this also enables the in-step health signals (grad "
                        "norm, per-subtree param/update norms, non-finite counters); on "
                        "serve the scheduler's serve_* metrics, the compile counts and the "
                        "goodput phases, snapshotted as the run goes (the router's "
                        "router_*/fleet_* metrics with --replicas)")
    p.add_argument("--metrics-interval", type=int, default=None, metavar="N",
                   help="record the health norms every N global steps (default 10; "
                        "read with the span barrier, never an extra per-step sync); "
                        "requires --metrics-out")
    p.add_argument("--prom-port", type=int, default=None, metavar="PORT",
                   help="serve the live metric registry over HTTP from a daemon thread: "
                        "GET /metrics returns the Prometheus text exposition "
                        "(byte-identical to prometheus_text()), GET /healthz a liveness "
                        "JSON. PORT 0 binds an ephemeral port (printed at startup)")
    p.add_argument("--peak-flops", type=float, default=None, metavar="FLOPS",
                   help="per-device peak FLOP/s for the train_mfu and serve_mfu gauges "
                        "(ddl_tpu_torch.obs.cost): overrides the device table (the H100's "
                        "bf16 and fp32 rows; the CPU falls back to a nominal anchor)")
    p.add_argument("--ici-bw", type=float, default=None, metavar="BPS",
                   help="per-device interconnect bytes/s for the comms roofline gauges "
                        "(ddl_tpu_torch.obs.comms): overrides the device table (the "
                        "H100's NVLink; the CPU falls back to a nominal anchor)")
    p.add_argument("--anomaly-rules", default=None, metavar="SPEC",
                   help="streaming anomaly detection (ddl_tpu_torch.obs.anomaly): "
                        "';'-joined SIGNAL[:window=W,min=M,threshold=Z,direction="
                        "high|low|both,scale=S] segments, rolling median/MAD baselines "
                        "with anomaly_total{signal=} counters and 'anomaly' trace events; "
                        "the trainers' signals are step_time and mfu, the scheduler's "
                        "step_time, itl, mfu, queue_depth, active_slots, occupied_slots "
                        "and pages_free, the router's backlog and shed_rate. Applies to "
                        "single/lm/serve")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="capture a structured trace into DIR: host spans as "
                        "host_trace_p<rank>.jsonl (convert to Chrome/Perfetto with "
                        "'python -m ddl_tpu_torch.obs.trace in.jsonl out.json'; analyse "
                        "with 'python -m ddl_tpu_torch.obs.analyze report') PLUS the "
                        "torch.profiler timeline of the card in the same directory")
    lm = p.add_argument_group(
        "lm options",
        "the 'lm' variant trains the decoder LM on the procedural copy task "
        "(strategies/seq.py) over a [--data-parallel, --num-workers, "
        "--tensor-parallel, --pipeline-parallel] grid of processes, one a rank "
        "(torchrun beyond one); --num-workers is the sequence-parallel degree "
        "(default: 1 under --pipeline-parallel, else WORLD_SIZE / "
        "(--data-parallel * --tensor-parallel), else 1), --batch-size counts "
        "sequences (default 32), --lr defaults to 1e-3. The model flags (--vocab, "
        "--d-model, --heads, --layers, --d-ff) and --tensor-parallel also size "
        "the 'serve' model",
    )
    lm.add_argument("--seq-scheme", default="ring", choices=["ring", "ulysses", "full"],
                    help="cross-shard attention scheme: ring (K/V blocks passed around "
                         "the sequence ranks), ulysses (all-to-all head re-partition; "
                         "needs --heads divisible by --num-workers), full (no sharding; "
                         "--num-workers 1 only)")
    lm.add_argument("--seq-len", type=int, default=512)
    lm.add_argument("--vocab", type=int, default=64)
    lm.add_argument("--d-model", type=int, default=256)
    lm.add_argument("--heads", type=int, default=8)
    lm.add_argument("--layers", type=int, default=4)
    lm.add_argument("--d-ff", type=int, default=1024)
    lm.add_argument("--train-seqs", type=int, default=2048,
                    help="procedural copy-task training sequences")
    lm.add_argument("--test-seqs", type=int, default=256)
    lm.add_argument("--target-accuracy", type=float, default=None,
                    help="stop at the first eval reaching this next-token accuracy")
    lm.add_argument("--attn-impl", default="xla", choices=["xla", "flash"],
                    help="attention: xla (plain, materialised scores) or flash (the "
                         "hand-written CUDA flash kernels; their plain version on the CPU)")
    lm.add_argument("--remat", action="store_true",
                    help="recompute each transformer block in the backward pass")
    lm.add_argument("--seq-layout", default="contiguous", choices=["contiguous", "zigzag"],
                    help="ring position layout: contiguous (block i on rank i) or zigzag "
                         "(two-ended chunk pairs, which balance the causal sweep; "
                         "--seq-scheme ring, --seq-len divisible by 2 * --num-workers)")
    lm.add_argument("--data-parallel", type=int, default=1, metavar="DP",
                    help="the batch shards over DP rows while the sequence shards over "
                         "--num-workers columns (ranks = DP * num-workers); --batch-size "
                         "must divide by DP")
    lm.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 over the (data-parallel, num-workers) ranks: "
                         "reduce-scatter the gradient, Adam on each rank's flat chunk, "
                         "all-gather the parameters; with --tensor-parallel the hybrid "
                         "(the tp-sharded leaves keep tree Adam on their shards)")
    lm.add_argument("--tensor-parallel", type=int, default=1, metavar="TP",
                    help="Megatron tensor parallelism: each block's QKV/W1 shard "
                         "column-wise (H/TP heads, d_ff/TP hidden units a rank), WO/W2 "
                         "row-wise with one completing all-reduce each; grid "
                         "[data-parallel, num-workers, TP], tp minor; composes with "
                         "--zero1 (the hybrid sharded optimizer). serve: the engine's "
                         "tp group (torchrun --nproc-per-node TP)")
    lm.add_argument("--pipeline-parallel", type=int, default=1, metavar="PP",
                    help="pipeline parallelism: the layer stack in PP contiguous stages "
                         "over the grid's minor pp axis, activations handed stage to "
                         "stage; needs --layers divisible by PP, --microbatches >= 2, "
                         "--num-workers 1 --seq-scheme full; composes with "
                         "--data-parallel and --tensor-parallel on the grid [dp, 1, tp, "
                         "PP] (not with --zero1 or sequence parallelism)")
    lm.add_argument("--microbatches", type=int, default=1, metavar="M",
                    help="microbatches streamed through the pipeline a step (their "
                         "gradients summed; bubble (PP-1)/(M+PP-1)); must divide the "
                         "per-dp-row batch; requires --pipeline-parallel > 1")
    lm.add_argument("--pipeline-schedule", default="gpipe", choices=["gpipe", "1f1b"],
                    help="microbatch schedule: gpipe (all forwards, then all backwards; "
                         "M saved stage inputs a stage) or 1f1b (one forward, one "
                         "backward; min(PP, M) saved: the same bubble, less memory)")
    sv = p.add_argument_group(
        "serve options",
        "the 'serve' variant runs KV-cache autoregressive decode with continuous "
        "batching (serve/) over a seeded prompt set on one device; the model flags, "
        "--seed and --json apply as usual; the weights are the port's own seeded "
        "init, or with --checkpoint-dir the params of a training checkpoint of any "
        "topology (no optimizer state required)",
    )
    sv.add_argument("--slots", type=int, default=4,
                    help="continuous-batching width: concurrent sequences decoded per step")
    sv.add_argument("--capacity", type=int, default=256,
                    help="KV-cache rows per slot — bounds prompt + generated length")
    sv.add_argument("--max-new-tokens", type=int, default=32,
                    help="tokens generated per request")
    sv.add_argument("--num-prompts", type=int, default=8,
                    help="size of the seeded synthetic prompt set (data.lm.synthesize_prompts)")
    sv.add_argument("--prompt-min", type=int, default=4, help="minimum synthetic prompt length")
    sv.add_argument("--prompt-max", type=int, default=48, help="maximum synthetic prompt length")
    sv.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy decode")
    sv.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k highest logits; 0 = full vocab "
                         "(temperature > 0 only)")
    sv.add_argument("--prefix-cache", type=int, default=0, metavar="SLOTS",
                    help="prefix-cache pool width (paged: resident entries); 0 = off")
    sv.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                    help="chunked prefill in N-token chunks (a power of two >= 8) "
                         "interleaved with decode ticks; 0 = whole-prompt prefill")
    sv.add_argument("--prefill-budget", type=int, default=0, metavar="T",
                    help="max prefill tokens per scheduler tick when chunking "
                         "(>= --prefill-chunk); 0 = one chunk per tick")
    sv.add_argument("--page-size", type=int, default=0, metavar="ROWS",
                    help="paged KV cache: rows per page (a power of two dividing "
                         "--capacity); 0 = contiguous per-slot rings")
    sv.add_argument("--num-pages", type=int, default=0, metavar="N",
                    help="paged KV pool size in pages (requires --page-size; >= --slots); "
                         "0 = slots * capacity / page-size")
    sv.add_argument("--ttft-deadline", type=float, default=None, metavar="SECONDS",
                    help="default per-request time-to-first-token deadline (expiry: "
                         "status 'deadline_exceeded')")
    sv.add_argument("--request-deadline", type=float, default=None, metavar="SECONDS",
                    help="default per-request total deadline (eligibility to completion)")
    sv.add_argument("--shed-threshold", type=int, default=None, metavar="N",
                    help="admission shedding: a request whose first eligible tick finds N "
                         "outstanding requests is refused with status 'shed' (N >= --slots)")
    sv.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="multi-tenant front door (serve.router): N scheduler/engine replicas "
                         "(each with its own KV pool and prefix index, sharing one set of "
                         "params) behind an SLO-aware router (prefix-affinity placement, "
                         "per-class priority shedding, per-class TTFT/ITL accounting), "
                         "driving the --traffic stream instead of the --num-prompts set")
    sv.add_argument("--traffic", default=None, metavar="SPEC",
                    help="mixed-traffic scenario for --replicas "
                         "(data.lm.synthesize_mixed_traffic): ';'-joined segments, global "
                         "keys horizon=N, seed=N, max_requests=N, burst=START:LEN:MULT[:CLASS], "
                         "diurnal=AMPLITUDE:PERIOD and class segments "
                         "NAME:rate=R,pmin=A,pmax=B,new=T[,families=F,fprefix=L]; default: "
                         "the three-class chat/longdoc/bulk mix at horizon 32")
    sv.add_argument("--slo", default=None, metavar="SPEC",
                    help="per-class SLO targets and priorities for --replicas: ';'-joined "
                         "NAME:ttft=S,itl=S,priority=P[,margin=M] segments (priority 0 = most "
                         "protected; margin defaults to priority)")
    sv.add_argument("--autoscale", default=None, metavar="SPEC",
                    help="self-healing fleet controller for --replicas (serve.controller): "
                         "comma-joined key=val, max=N, min=N, backlog=F, sustain=N, idle=N, "
                         "preempt=0|1, wait=N, gap=N, defer=0|1 and per-role ROLE.key=val; "
                         "scales out on sustained pressure, drains before scale-in, heals "
                         "replica crashes and preempts across replicas on paged engines; "
                         "'' with --max-replicas uses the defaults")
    sv.add_argument("--max-replicas", type=int, default=None, metavar="N",
                    help="fleet cap for --autoscale (overrides its max= key)")
    sv.add_argument("--roles", default=None, metavar="SPEC",
                    help="disaggregated prefill/decode fleet (serve.disagg): comma-joined "
                         "ROLE=COUNT segments (prefill/decode/mixed) summing to --replicas; "
                         "arrivals land on prefill replicas and at the first token the "
                         "prompt's KV pages hand off to a decode replica (needs --page-size)")
    sv.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="KV-pool storage dtype (needs --page-size): int8 stores pool pages "
                         "as int8 with per-head fp32 scales (about 3.8x the pages per byte at "
                         "head_dim 64, and as many fewer bytes through every page hand-off); "
                         "dequantized in the attend view")
    sv.add_argument("--speculate", default=None, metavar="K[,METHOD]",
                    help="speculative decoding (serve.speculate): draft up to K tokens a tick "
                         "for each active slot by n-gram lookup (METHOD 'ngram' over prompt "
                         "and generated tokens, the default, or 'prompt') and verify them "
                         "through FREE slots of the one batched decode (greedy-accept: the "
                         "output equals plain greedy decode's). Needs --replicas, --page-size "
                         "> 0, temperature 0 and --slots >= 2")
    sv.add_argument("--slo-rules", default=None, metavar="SPEC",
                    help="streaming burn-rate SLO monitors (ddl_tpu_torch.obs.slo) stepped "
                         "once a scheduler or router tick over the live registry: "
                         "';'-joined NAME:metric=M,... segments with target=SECONDS "
                         "(histogram mode: samples above it are misses) or total=COUNTER "
                         "(counter mode: metric counts bad events, total the attempts), "
                         "plus objective=, fast=/slow= (window ticks), threshold= and "
                         "label.K=V selectors; slo_burn_rate{rule=,window=} gauges, "
                         "slo_alerts_total{rule=} counters, slo_alert trace events. Under "
                         "--replicas the monitor reads the ROUTER registry: histogram "
                         "rules target router_ttft_seconds with label.class=; "
                         "--autoscale's burn=RULE|RULE names these rules")
    sm = p.add_argument_group(
        "sim options",
        "the 'sim' variant replays a named scenario (ddl_tpu_torch.serve.scenarios) on "
        "the cost-model digital twin (ddl_tpu_torch.serve.sim): the real router, "
        "scheduler and controller drive engines that charge fitted per-phase virtual "
        "time instead of computing, on no device; --replicas, --autoscale/"
        "--max-replicas, --json, --metrics-out, --trace-dir and --prom-port apply as on "
        "serve (topology and traffic come from the scenario)",
    )
    sm.add_argument("--scenario", default=None, metavar="NAME[:K=V,..]",
                    help="scenario to replay (bulk_burst, replica_crash, diurnal, "
                         "crash_storm, role_mix, longtail_prefix), with optional "
                         "comma-joined overrides horizon=, max_requests=, rate_scale=, "
                         "seed= (traffic scale; refused on pinned-request scenarios) and "
                         "replicas= (topology scale)")
    sm.add_argument("--fit", default=None, metavar="METRICS_JSONL",
                    help="fit the twin's per-phase costs from a measured serve run's "
                         "--metrics-out file (obs.goodput.phase_cost_fit: "
                         "time_in_seconds{phase=} over the phase's work units); default: "
                         "the CostModel's CPU-scale constants")
    p.add_argument("--multihost", action="store_true",
                   help="one command per host: this process starts its host's ranks "
                        "(world / --num-processes of them, global ranks p*n .. p*n+n-1) "
                        "and they join one torch.distributed world over a TCP rendezvous "
                        "at --coordinator (parallel/multihost.py). Run the same command "
                        "on every host with --process-id set")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multihost coordinator address (process 0's host, where global "
                        "rank 0 serves the rendezvous; default: self-hosted when "
                        "--num-processes 1)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multihost world size in host processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in the multihost world (default 0 when "
                        "--num-processes 1)")
    return p


def _int_tuple(text: str) -> tuple[int, ...]:
    try:
        return tuple(int(t) for t in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected comma-separated ints, got {text!r}")


def _resolve_precision(args) -> str | None:
    """The --precision policy name (None = the legacy compute_dtype
    thread); a policy beside --bf16/--fp32 exits, as the JAX CLI's."""
    if args.precision is not None and (args.bf16 or args.fp32):
        raise SystemExit("--precision owns the compute dtype; drop --bf16/--fp32")
    return args.precision


def _resolve_dtype(args) -> str | None:
    """The legacy compute dtype: None under --precision (the policy owns
    it), "bfloat16" for --bf16, else fp32 (None). JAX's default of bf16 on
    a TPU platform has no counterpart: JAX on a GPU defaults to fp32."""
    if _resolve_precision(args) is not None:
        return None
    if args.bf16 and args.fp32:
        raise SystemExit("--bf16 and --fp32 are mutually exclusive")
    return "bfloat16" if args.bf16 else None


def _install_sigterm_flag(enabled: bool) -> dict:
    """Graceful preemption (a SIGTERM before the machine is reclaimed, or
    an operator's Ctrl-C): finish the span in flight, save the rolling
    checkpoint, exit 0, so a later --resume run continues where this one
    stopped. Returns the flag dict the trainer's ``should_stop`` reads."""
    term = {"flag": False}
    if enabled:
        import signal

        def _handler_for(signum):
            def _on_sig(sig, frame):
                # Flag only, no IO in the handler (a print here can hit
                # CPython's reentrant-BufferedWriter guard). Restoring the
                # default lets a second delivery terminate at once.
                term["flag"] = True
                signal.signal(signum, signal.SIG_DFL)

            return _on_sig

        signal.signal(signal.SIGTERM, _handler_for(signal.SIGTERM))
        signal.signal(signal.SIGINT, _handler_for(signal.SIGINT))
    return term


def _fatal_timeout(e) -> int:
    """The dispatch watchdog's exit: the watched call is still wedged in
    native code, and a normal exit would re-enter the wedged runtime
    through its finalizers and hang; report, flush, and leave."""
    print(f"[ddl_tpu] FATAL: {e}", file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(1)


def _check_resilience_flags(args) -> None:
    """JAX's checks of --max-bad-steps, --inject-fault and --resume, with
    its texts. The port takes --inject-fault on every training variant:
    the kinds that need no guard (sigterm, corrupt_ckpt, truncate_ckpt)
    also run on sync and async (:func:`_make_injector`)."""
    if args.max_bad_steps is not None:
        if args.max_bad_steps < 1:
            raise SystemExit(f"--max-bad-steps must be >= 1, got {args.max_bad_steps}")
        if args.variant not in ("single", "lm"):
            raise SystemExit("--max-bad-steps applies to the single/lm variants (the "
                             "guarded trainers)")
        if not args.checkpoint_dir:
            raise SystemExit("--max-bad-steps rollback requires --checkpoint-dir")
    if args.resume and not args.checkpoint_dir and args.variant not in ("serve", "sim"):
        # serve and sim refuse --resume as a training flag (_TRAIN_ONLY), as
        # JAX's.
        raise SystemExit("--resume requires --checkpoint-dir")


def _make_injector(args, variant: str):
    """Resolve ``--inject-fault`` for this variant: checks the kind against
    the variant, applies startup checkpoint chaos (corrupt or truncate the
    latest save in --checkpoint-dir, on rank 0 only; pair it with --resume
    auto) and returns the runtime ``FaultInjector`` (None when no runtime
    fault is armed). As JAX's: a serve kind needs the serve variant, and
    the data-poisoning kinds the guarded trainers (single, lm); beyond
    JAX's, sigterm and the checkpoint kinds also run on sync and async."""
    if not args.inject_fault:
        return None
    from .resilience import faults

    try:
        spec = faults.parse_fault(args.inject_fault)
    except ValueError as e:
        raise SystemExit(f"--inject-fault: {e}")
    if spec.kind in faults.SERVE_KINDS:
        if variant != "serve":
            raise SystemExit(f"--inject-fault {spec.kind} applies to the serve variant")
        return faults.FaultInjector(spec)
    if variant == "serve" or (variant not in ("single", "lm")
                              and spec.kind not in ("sigterm",) + faults.CKPT_KINDS):
        raise SystemExit(
            f"--inject-fault {spec.kind} applies to the single/lm "
            "variants (the guarded trainers)"
        )
    if spec.kind in faults.CKPT_KINDS:
        from .train.trainer import checkpoint_file
        from .utils.checkpoint import find_latest_valid

        if not args.checkpoint_dir:
            raise SystemExit(f"--inject-fault {spec.kind} needs --checkpoint-dir")
        if os.environ.get("RANK", "0") != "0":
            return None  # rank 0 damages the file before the world forms
        found = find_latest_valid(args.checkpoint_dir)
        target = found[0] if found else checkpoint_file(args.checkpoint_dir)
        if not os.path.exists(target):
            raise SystemExit(f"--inject-fault {spec.kind}: no checkpoint at {target}")
        if spec.kind == "corrupt_ckpt":
            faults.corrupt_checkpoint(target, seed=args.seed)
        else:
            faults.truncate_checkpoint(target)
        print(f"[ddl_tpu] chaos: {spec.kind} applied to {target}")
        return None
    return faults.FaultInjector(spec)


def _train_kwargs(args, injector) -> dict:
    """The resilience keywords every trainer's ``train`` takes, from the
    flags; the SIGTERM flag is installed when there is a checkpoint dir."""
    term = _install_sigterm_flag(bool(args.checkpoint_dir))
    return dict(checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
                resume=args.resume, should_stop=lambda: term["flag"],
                dispatch_timeout=args.dispatch_timeout, fault_injector=injector)


def _resilience_json(result) -> dict:
    return {"resumed_from_step": result.resumed_from_step, "preempted": result.preempted,
            "skipped_steps": result.skipped_steps, "rollbacks": result.rollbacks}


def _check_obs_flags(args) -> None:
    """JAX's checks of the telemetry flags, with its texts."""
    if args.metrics_interval is not None:
        if args.metrics_interval < 1:
            raise SystemExit(f"--metrics-interval must be >= 1, got {args.metrics_interval}")
        if args.metrics_out is None:
            raise SystemExit("--metrics-interval requires --metrics-out")
    else:
        args.metrics_interval = 10
    if args.anomaly_rules and args.variant not in ("single", "lm", "serve"):
        # The sync/async span loops take no per-span feed (as JAX's).
        raise SystemExit("--anomaly-rules applies to the single/lm/serve variants")


def _build_obs(args, *, config=None, grid=None, rank: int = 0, make_tracer: bool = True):
    """``(registry, writer, tracer)`` from the telemetry flags, None where
    off (JAX's ``_build_obs``). A registry exists whenever anything reads
    it live (the JSONL writer, the /metrics endpoint, an SLO monitor, an
    anomaly detector), on EVERY rank: the health sums are collectives. The
    writer (manifest first) is rank 0's alone; each rank traces into its
    own ``host_trace_p<rank>.jsonl`` (``make_tracer=False`` leaves the
    tracer to the caller, as serve's)."""
    registry = writer = tracer = None
    if (args.metrics_out or args.prom_port is not None or args.slo_rules
            or args.anomaly_rules):
        from .obs import MetricRegistry

        registry = MetricRegistry()
    if args.metrics_out and rank == 0:
        from .obs import MetricsWriter, run_manifest

        writer = MetricsWriter(args.metrics_out, registry,
                               run_manifest(config=config, mesh=grid,
                                            extra={"variant": args.variant}))
    if make_tracer and args.trace_dir:
        from .obs.trace import Tracer, host_trace_file

        tracer = Tracer(host_trace_file(args.trace_dir))
    return registry, writer, tracer


def _start_exporter(args, registry, rank: int = 0):
    """``--prom-port``: the /metrics + /healthz endpoint on rank 0's
    registry (None when the flag is off); close it in the run's
    ``finally``."""
    if args.prom_port is None or rank != 0:
        return None
    from .obs.export import MetricsExporter

    try:
        exp = MetricsExporter(registry, args.prom_port).start()
    except OSError as e:
        raise SystemExit(f"--prom-port {args.prom_port}: {e}")
    print(f"[ddl_tpu] metrics endpoint: {exp.url('/metrics')} "
          f"(healthz: {exp.url('/healthz')})")
    return exp


def _make_slo_monitor(args, registry, tracer=None):
    """``--slo-rules``: the burn-rate monitor on the run's registry; None
    when the flag is off."""
    if not args.slo_rules:
        return None
    from .obs.slo import SloMonitor, parse_slo_rules

    try:
        return SloMonitor(parse_slo_rules(args.slo_rules), registry, tracer=tracer)
    except ValueError as e:
        raise SystemExit(f"--slo-rules: {e}")


def _slo_report(monitor):
    """End-of-run ``--slo-rules`` lines (one a rule); the JSON digest, None
    without a monitor."""
    if monitor is None:
        return None
    digest = {}
    for name in sorted(r.name for r in monitor.rules):
        row = {"fast_burn": monitor.burn_rate(name, "fast"),
               "slow_burn": monitor.burn_rate(name, "slow"),
               "alerts": monitor.alerts(name), "fired_ticks": monitor.fired_ticks(name)}
        digest[name] = row
        print(f"slo rule {name}: burn fast {row['fast_burn']:.2f} slow "
              f"{row['slow_burn']:.2f} | alerts {row['alerts']}")
    return digest


def _goodput_line(registry) -> None:
    """The serve run's live goodput digest line (JAX's), when the registry
    has one."""
    gf = registry.get("goodput_fraction") if registry is not None else None
    if gf is None or gf.value() is None:
        return
    tis = registry.get("time_in_seconds")
    phases = " ".join(
        f"{ls['phase']}={tis.value(**ls):.2f}s"
        for ls in sorted(tis.label_sets(), key=lambda d: -tis.value(**d))
        if tis.value(**ls) > 0
    ) if tis is not None else ""
    print(f"goodput: {gf.value():.1%} ({phases})")


def _make_anomaly(args, registry, tracer=None):
    """``--anomaly-rules``: the streaming detector on the run's registry;
    None when the flag is off."""
    if not args.anomaly_rules:
        return None
    from .obs.anomaly import AnomalyDetector, parse_anomaly_rules

    try:
        return AnomalyDetector(parse_anomaly_rules(args.anomaly_rules), registry,
                               tracer=tracer)
    except ValueError as e:
        raise SystemExit(f"--anomaly-rules: {e}")


def _anomaly_report(detector):
    """End-of-run ``--anomaly-rules`` lines (one a signal); the JSON digest,
    None without a detector."""
    if detector is None:
        return None
    digest = detector.summary()
    for signal in sorted(digest):
        row = digest[signal]
        ticks = row["fired_ticks"]
        print(f"anomaly signal {signal}: {row['alerts']} alerts"
              f"{' at ticks ' + str(ticks) if ticks else ''}")
    return digest


def _close_obs(*parts) -> None:
    """Close the exporter, tracer and writer that exist: on any exit with
    a live interpreter the metrics file ends with a forced final
    snapshot."""
    for part in parts:
        if part is not None:
            part.close()


def _reject_foreign_flags(args, variant: str, dests: tuple[str, ...]) -> None:
    defaults = build_parser()
    for dest in dests:
        if getattr(args, dest) != defaults.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} does not apply to the {variant} variant")


def config_from_args(args, num_workers: int):
    from .models.cnn import TINY_CONV_CHANNELS, TINY_FC_SIZES
    from .train.config import TrainConfig

    _reject_foreign_flags(args, args.variant, _LM_ONLY + _SERVE_ONLY + _SIM_ONLY)

    sharded = "sharding" in args.variant
    layout = args.layout or ("zigzag" if args.variant.endswith("greedy") else "block")
    shard_data = not args.reference_compat
    batch_size = args.batch_size
    if batch_size is None:
        batch_size = 100
        if shard_data and args.variant.startswith("sync"):
            batch_size = -(-100 // num_workers) * num_workers
    elif (shard_data and args.variant.startswith("sync")
          and batch_size % num_workers):
        raise SystemExit(
            f"--batch-size {batch_size} is not divisible by {num_workers} "
            "workers (data is sharded per worker); use a multiple, drop "
            "--batch-size to auto-round, or pass --reference-compat"
        )
    if args.fused_adam and not (
        sharded and args.variant.startswith("sync") and args.num_ps > 1
    ):
        raise SystemExit(
            "--fused-adam applies to the ZeRO-1 sharded sync update only "
            "(sync_sharding / sync_sharding_greedy with --num-ps >= 2); "
            "other variants (and num_ps <= 1, which is pure DP) use "
            "different update programs and would silently ignore it"
        )
    conv_channels, fc_sizes = args.conv_channels, args.fc_sizes
    if args.tiny:
        conv_channels = conv_channels or TINY_CONV_CHANNELS
        fc_sizes = fc_sizes or TINY_FC_SIZES
    if conv_channels is not None and (len(conv_channels) != 4 or min(conv_channels) < 1):
        raise SystemExit("--conv-channels takes exactly 4 positive widths")
    if fc_sizes is not None and (len(fc_sizes) != 2 or min(fc_sizes) < 1):
        raise SystemExit("--fc-sizes takes exactly 2 positive widths")
    return TrainConfig(
        epochs=args.epochs,
        batch_size=batch_size,
        learning_rate=args.lr if args.lr is not None else 1e-4,
        keep_prob=args.keep_prob,
        eval_every=args.eval_every,
        seed=args.seed,
        num_workers=num_workers,
        num_ps=args.num_ps if sharded else 1,
        layout=layout,
        grad_reduction="sum" if args.reference_compat else "mean",
        shard_data=shard_data,
        staleness_seed=args.staleness_seed,
        compute_dtype=_resolve_dtype(args),
        precision=_resolve_precision(args),
        fused_adam=args.fused_adam,
        conv1_matmul=args.conv1_matmul,
        conv_matmul=args.conv_matmul,
        conv_channels=conv_channels or (32, 64, 128, 256),
        fc_sizes=fc_sizes or (1024, 512),
    )


def _join_world(num_workers: int, device: str, store_dir: str):
    """torchrun's world, or the multi-host launch's, when their variables
    are set (a card by ``LOCAL_RANK``; a rendezvous and collectives bounded
    by ``multihost.RENDEZVOUS_TIMEOUT_S``), else a world of one over a file
    store in ``store_dir``. ``num_workers`` is the number of ranks the run
    needs."""
    from .parallel import multihost
    from .parallel.mesh import init_world

    env_size = os.environ.get("WORLD_SIZE")
    if env_size is not None:
        if int(env_size) != num_workers:
            raise SystemExit(f"the run needs {num_workers} ranks, WORLD_SIZE is {env_size}")
        local = os.environ.get("LOCAL_RANK")
        return init_world(num_workers, int(os.environ["RANK"]), "env://", device,
                          local_rank=None if local is None else int(local),
                          timeout_s=multihost.RENDEZVOUS_TIMEOUT_S)
    if num_workers != 1:
        raise SystemExit(
            f"{num_workers} ranks need one process each: "
            f"launch with torchrun --nproc-per-node {num_workers} -m ddl_tpu_torch ..."
        )
    return init_world(1, 0, f"file://{os.path.join(store_dir, 'store')}", device)


def lm_config_from_args(args):
    from .models.transformer import LMSpec
    from .strategies.seq import SeqConfig

    _reject_foreign_flags(args, "lm", _CNN_ONLY + _SERVE_ONLY + _SIM_ONLY)
    if args.data_parallel < 1:
        raise SystemExit(f"--data-parallel must be >= 1, got {args.data_parallel}")
    if args.tensor_parallel < 1:
        raise SystemExit(f"--tensor-parallel must be >= 1, got {args.tensor_parallel}")
    if args.pipeline_parallel < 1:
        raise SystemExit(f"--pipeline-parallel must be >= 1, got {args.pipeline_parallel}")
    if args.num_workers:
        num_workers = args.num_workers
    elif args.pipeline_parallel > 1:
        # A pipeline has no sequence axis (validate_topology wants
        # num_workers 1): never default it to the spare ranks.
        num_workers = 1
    else:
        # Default: every rank of the world, split between the dp rows and tp columns.
        num_workers = max(1, int(os.environ.get("WORLD_SIZE", "1"))
                          // (args.data_parallel * args.tensor_parallel))
    scheme = args.seq_scheme
    if args.pipeline_parallel > 1 and scheme == "ring":
        # The stages hold the whole sequence, so the parser's ring default
        # maps to the stage-local full attention, loudly (rank 0 says so; an
        # explicit --seq-scheme ulysses still fails validation).
        if os.environ.get("RANK", "0") == "0":
            print("[ddl_tpu] --pipeline-parallel: sequence is whole per "
                  "stage; using --seq-scheme full")
        scheme = "full"
    return SeqConfig(
        epochs=args.epochs,
        batch_size=args.batch_size or 32,
        learning_rate=args.lr if args.lr is not None else 1e-3,
        eval_every=args.eval_every,
        seed=args.seed,
        num_workers=num_workers,
        data_parallel=args.data_parallel,
        tensor_parallel=args.tensor_parallel,
        pipeline_parallel=args.pipeline_parallel,
        microbatches=args.microbatches,
        pipeline_schedule=args.pipeline_schedule,
        scheme=scheme,
        compute_dtype=_resolve_dtype(args),
        precision=_resolve_precision(args),
        target_accuracy=args.target_accuracy,
        zero1=args.zero1,
        attn_impl=args.attn_impl,
        remat=args.remat,
        seq_layout=args.seq_layout,
        spec=LMSpec(vocab=args.vocab, d_model=args.d_model, num_heads=args.heads,
                    num_layers=args.layers, d_ff=args.d_ff),
    )


def _run_lm(args, device) -> int:
    """The ``lm`` variant: decoder-LM training on the copy task over the
    [dp, num_workers, tp, pp] grid, one process a rank."""
    from .data.lm import synthesize_copy
    from .parallel.mesh import destroy_world
    from .strategies.seq import SeqTrainer, check_config

    cfg = lm_config_from_args(args)
    try:
        dataset = synthesize_copy(
            num_train=args.train_seqs, num_test=args.test_seqs,
            seq_len=args.seq_len, vocab=args.vocab, seed=args.seed,
        )
        # Every config check, before any rank joins the world.
        check_config(cfg, dataset)
    except ValueError as e:
        raise SystemExit(f"lm config error: {e}")
    from .parallel.mesh import AcceleratorTimeout

    injector = _make_injector(args, "lm")
    train_kw = _train_kwargs(args, injector)
    with tempfile.TemporaryDirectory() as store_dir:
        world = _join_world(cfg.num_workers * cfg.data_parallel * cfg.tensor_parallel
                            * cfg.pipeline_parallel, args.device, store_dir)
        registry = writer = tracer = exporter = None
        try:
            trainer = SeqTrainer(cfg, dataset, world=world)
            registry, writer, tracer = _build_obs(args, config=cfg, grid=trainer.grid,
                                                  rank=world.rank)
            detector = _make_anomaly(args, registry, tracer)
            exporter = _start_exporter(args, registry, world.rank)
            result = trainer.train(
                log=print if world.lead else (lambda s: None),
                max_bad_steps=args.max_bad_steps or 0,
                # --trace-dir captures the card's timeline beside the host
                # spans (an explicit --profile dir wins for the profiler).
                profile_dir=args.profile or args.trace_dir,
                metrics=registry, metrics_interval=args.metrics_interval,
                metrics_writer=writer, tracer=tracer, peak_flops=args.peak_flops,
                ici_bw=args.ici_bw, anomaly_detector=detector, **train_kw)
            if registry is not None:
                registry.gauge("train_final_accuracy").set(result.final_accuracy)
                registry.gauge("train_run_tokens_per_sec").set(result.tokens_per_sec)
        except AcceleratorTimeout as e:
            return _fatal_timeout(e)
        finally:
            _close_obs(exporter, tracer, writer)
            destroy_world()
    if not world.lead:
        return 0
    anomaly_digest = _anomaly_report(detector)
    print(f"training time: {result.train_time_s:.2f}s "
          f"({result.tokens_per_sec:.0f} tokens/s, "
          f"warm-up {result.compile_time_s:.1f}s excluded)")
    if args.json:
        print(json.dumps({
            "variant": "lm",
            "device": str(device),
            "anomaly_rules": anomaly_digest,
            "config": {**dataclasses.asdict(cfg), "seq_len": args.seq_len,
                       "train_seqs": args.train_seqs},
            "final_accuracy": result.final_accuracy,
            "final_loss": result.final_loss,
            "history": [[e, b, round(a, 6)] for e, b, a in result.history],
            "train_time_s": result.train_time_s,
            "tokens_per_sec": result.tokens_per_sec,
            "compile_time_s": result.compile_time_s,
            "step_stats": dataclasses.asdict(result.step_stats)
                          if result.step_stats else None,
            **_resilience_json(result),
        }))
    return 0


def _run_serve(args, device) -> int:
    """The ``serve`` variant: continuous-batching KV-cache decode over a
    seeded prompt set, warmed up outside the clock (JAX's ``_run_serve``,
    one engine; at ``--tensor-parallel`` > 1 one engine a rank of the tp
    group, every rank running the same scheduler, rank 0 printing). Every
    config check runs before any rank joins the world."""
    from .models.transformer import LMSpec
    from .parallel.mesh import destroy_world, make_grid
    from .serve import ServeConfig
    from .serve.engine import check_config

    # JAX's training-only group holds --profile: serve traces with
    # --trace-dir.
    _reject_foreign_flags(args, "serve",
                          _CNN_ONLY + _LM_TRAIN + _TRAIN_ONLY + ("profile",) + _SIM_ONLY)
    if args.tensor_parallel < 1:
        raise SystemExit(f"--tensor-parallel must be >= 1, got {args.tensor_parallel}")
    spec = LMSpec(vocab=args.vocab, d_model=args.d_model, num_heads=args.heads,
                  num_layers=args.layers, d_ff=args.d_ff)
    # The engine has no optimizer boundary: a precision policy here is its
    # compute dtype ("bf16" -> bfloat16, "fp32" -> fp32).
    spec_k, spec_method = 0, "ngram"
    if args.speculate is not None:
        try:
            spec_k, spec_method = _parse_speculate(args.speculate)
        except ValueError as e:
            raise SystemExit(f"--speculate: {e}")
    prec = _resolve_precision(args)
    serve_dtype = "bfloat16" if prec == "bf16" else None if prec == "fp32" else _resolve_dtype(args)
    cfg = ServeConfig(
        spec=spec, slots=args.slots, capacity=args.capacity,
        tensor_parallel=args.tensor_parallel,
        temperature=args.temperature, top_k=args.top_k, seed=args.seed,
        compute_dtype=serve_dtype, kv_dtype=args.kv_dtype,
        prefix_slots=args.prefix_cache, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, page_size=args.page_size,
        num_pages=args.num_pages, speculate_k=spec_k, speculate_method=spec_method,
    )
    if args.top_k and args.temperature <= 0:
        raise SystemExit("--top-k requires --temperature > 0 (greedy decode ignores it)")
    _check_fleet_flags(args)
    if args.replicas is not None:
        return _run_serve_router(args, cfg, device)
    if args.max_new_tokens < 1:
        raise SystemExit(f"--max-new-tokens must be >= 1, got {args.max_new_tokens}")
    if args.prompt_max + args.max_new_tokens > args.capacity:
        raise SystemExit(
            f"serve config error: --prompt-max {args.prompt_max} + --max-new-tokens "
            f"{args.max_new_tokens} exceeds --capacity {args.capacity}"
        )
    try:
        check_config(cfg)
    except (ValueError, KeyError) as e:
        raise SystemExit(f"serve config error: {e}")
    from .train.trainer import checkpoint_file

    # The checkpoint path is checked before any engine is built, and the
    # loaded tree goes straight to the constructor (no throwaway init).
    ckpt = checkpoint_file(args.checkpoint_dir)
    if ckpt is not None and not os.path.exists(ckpt):
        raise SystemExit(f"no checkpoint at {ckpt}")
    injector = _make_injector(args, "serve")
    if injector is not None and injector.spec.kind == "replica_crash":
        # The bare scheduler never consults crashes_replica.
        raise SystemExit("--inject-fault replica_crash needs --replicas and --autoscale (only "
                         "the fleet controller delivers the crash)")
    if args.tensor_parallel == 1:
        return _serve(args, cfg, device, None, injector)
    with tempfile.TemporaryDirectory() as store_dir:
        world = _join_world(args.tensor_parallel, args.device, store_dir)
        try:
            return _serve(args, cfg, device, make_grid(world, 1, 1, args.tensor_parallel),
                          injector)
        finally:
            destroy_world()


def _parse_speculate(text: str) -> tuple[int, str]:
    """``--speculate`` grammar: ``K`` or ``K,METHOD`` (the methods of
    ``serve.speculate.SPECULATE_METHODS``, the one list the engine checks
    too). The engine checks the rest (paged layout, greedy, slots)."""
    from .serve.speculate import SPECULATE_METHODS

    head, _, method = text.partition(",")
    try:
        k = int(head.strip())
    except ValueError:
        raise ValueError(f"draft length {head.strip()!r} must be an int")
    if k < 1:
        raise ValueError(f"draft length must be >= 1, got {k}")
    method = method.strip() or "ngram"
    if method not in SPECULATE_METHODS:
        raise ValueError(f"unknown method {method!r} (valid: {', '.join(SPECULATE_METHODS)})")
    return k, method


def _check_fleet_flags(args) -> None:
    """JAX's checks of the fleet flags on serve, with its texts: each needs
    --replicas, --max-replicas needs --autoscale, --roles and --speculate
    need the paged layout."""
    if args.traffic is not None and args.replicas is None:
        raise SystemExit("--traffic requires --replicas (the router path)")
    if args.slo is not None and args.replicas is None:
        raise SystemExit("--slo requires --replicas (the router path)")
    if args.autoscale is not None and args.replicas is None:
        raise SystemExit("--autoscale requires --replicas (the fleet controller drives the "
                         "router)")
    if args.max_replicas is not None and args.autoscale is None:
        raise SystemExit("--max-replicas requires --autoscale (it caps the fleet the "
                         "controller may grow; pass --autoscale '' for defaults)")
    if args.roles is not None:
        if args.replicas is None:
            raise SystemExit(
                f"--roles {args.roles} requires --replicas (roles split the ROUTER's fleet "
                "by phase; bare single-engine serve has no fleet to split)")
        if args.page_size <= 0:
            raise SystemExit(
                f"--roles {args.roles} requires --page-size > 0 (the prefill->decode "
                "hand-off moves KV pages; the contiguous slot-ring layout has none)")
    if args.speculate is not None:
        if args.replicas is None:
            raise SystemExit(
                f"--speculate {args.speculate} requires --replicas (speculative serving runs "
                "behind the router; bare single-engine serve rejects the flag)")
        if args.page_size <= 0:
            raise SystemExit(
                f"--speculate {args.speculate} requires --page-size > 0 (draft lanes verify "
                "through block-table ALIASES of the speculating slot's pages; the contiguous "
                "layout has no pages to alias)")


def _class_tallies(done, cls_of) -> dict:
    """Per-class completion and status tallies for the serve JSON."""
    out: dict = {}
    for i, c in done.items():
        row = out.setdefault(cls_of.get(i, "default"),
                             {"total": 0, "ok": 0, "shed": 0, "deadline_exceeded": 0})
        row["total"] += 1
        row[c.status] = row.get(c.status, 0) + 1
    return out


def _run_serve_router(args, cfg, device) -> int:
    """The ``--replicas`` path of serve (JAX's ``_run_serve_router``): the
    SLO-aware router over N replicas sharing one set of params, driving the
    ``--traffic`` stream with per-class SLO accounting, optionally under
    the fleet controller (``--autoscale``) and disaggregated roles
    (``--roles``). Every check runs before any rank joins the world; at
    ``--tensor-parallel`` > 1 every rank runs the same router over its
    engines' shards and rank 0 prints."""
    from .data.lm import DEFAULT_TRAFFIC_CLASSES, synthesize_mixed_traffic
    from .parallel.mesh import destroy_world, make_grid
    from .serve.engine import check_config
    from .serve.router import RouterConfig, parse_slo_spec, parse_traffic_spec
    from .train.trainer import checkpoint_file

    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    # The bare path's prompt-set flags have no meaning here: the per-class
    # shapes come from --traffic.
    defaults = build_parser()
    for dest in ("num_prompts", "prompt_min", "prompt_max", "max_new_tokens"):
        if getattr(args, dest) != defaults.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} does not apply with --replicas "
                             "(per-class prompt/token shapes come from --traffic)")
    roles = None
    if args.roles is not None:
        from .serve.disagg import parse_roles_spec

        try:
            roles = parse_roles_spec(args.roles, args.replicas)
        except ValueError as e:
            raise SystemExit(f"--roles: {e}")
    try:
        gen_kw = (parse_traffic_spec(args.traffic) if args.traffic
                  else {"classes": dict(DEFAULT_TRAFFIC_CLASSES)})
        gen_kw.setdefault("horizon", 32)
        gen_kw.setdefault("seed", args.seed)
        gen_kw.setdefault("vocab", args.vocab)
        traffic = synthesize_mixed_traffic(**gen_kw)
        class_specs = parse_slo_spec(args.slo or "", set(gen_kw["classes"]))
        rcfg = RouterConfig(serve=cfg, replicas=args.replicas, classes=class_specs,
                            shed_threshold=args.shed_threshold,
                            ttft_deadline_s=args.ttft_deadline,
                            deadline_s=args.request_deadline, roles=roles)
    except ValueError as e:
        raise SystemExit(f"serve config error: {e}")
    if not traffic:
        raise SystemExit("serve config error: the --traffic scenario produced no arrivals "
                         "(raise a class rate or the horizon)")
    for name, spec_d in gen_kw["classes"].items():
        worst = spec_d.get("prompt_max", 16) + spec_d.get("max_new_tokens", 8)
        if worst > cfg.capacity:
            raise SystemExit(f"serve config error: class {name!r} worst case (pmax + new = "
                             f"{worst}) exceeds --capacity {cfg.capacity}")
    ckpt = checkpoint_file(args.checkpoint_dir)
    if ckpt is not None and not os.path.exists(ckpt):
        raise SystemExit(f"no checkpoint at {ckpt}")
    injector = _make_injector(args, "serve")
    controller = None
    if args.autoscale is not None:
        from .serve.controller import FleetController, parse_autoscale_spec

        try:
            acfg = parse_autoscale_spec(args.autoscale, max_replicas=args.max_replicas,
                                        replicas=args.replicas)
        except ValueError as e:
            raise SystemExit(f"--autoscale: {e}")
        controller = FleetController(acfg, injector=injector)
    if injector is not None and injector.spec.kind == "replica_crash" and controller is None:
        raise SystemExit("--inject-fault replica_crash needs --autoscale (only the fleet "
                         "controller delivers the crash and heals the fleet)")
    try:
        check_config(cfg)
    except ValueError as e:
        raise SystemExit(f"serve config error: {e}")
    run = (rcfg, traffic, ckpt, injector, controller)
    if args.tensor_parallel == 1:
        return _serve_router(args, *run, device, None)
    with tempfile.TemporaryDirectory() as store_dir:
        world = _join_world(args.tensor_parallel, args.device, store_dir)
        try:
            return _serve_router(args, *run, device,
                                 make_grid(world, 1, 1, args.tensor_parallel))
        finally:
            destroy_world()


def _serve_router(args, rcfg, traffic, ckpt, injector, controller, device, grid) -> int:
    """One rank's router run of the ``--replicas`` path; rank 0 prints
    JAX's lines and JSON. The telemetry lives on the ROUTER registry
    (``--slo-rules``, ``--anomaly-rules``); each replica gets its own."""
    from .obs.trace import Tracer, host_trace_file
    from .serve.router import Router
    from .utils.metrics import trace as profiler_trace

    rank = grid.rank if grid is not None else 0
    registry, writer, _ = _build_obs(args, config=rcfg.serve, grid=grid, rank=rank,
                                     make_tracer=False)
    # keep=True: the per-class SLO derivation reads the records back.
    tracer = (Tracer(host_trace_file(args.trace_dir), keep=True) if args.trace_dir
              else None)
    monitor = _make_slo_monitor(args, registry, tracer)
    detector = _make_anomaly(args, registry, tracer)
    where = dict(grid=grid) if grid is not None else dict(device=device)
    kw = dict(registry=registry, tracer=tracer, injector=injector, slo_monitor=monitor,
              peak_flops=args.peak_flops, anomaly_detector=detector, controller=controller,
              **where)
    try:
        router = (Router.from_checkpoint(rcfg, ckpt, **kw) if ckpt is not None
                  else Router(rcfg, **kw))
    except (ValueError, KeyError) as e:
        raise SystemExit(f"serve config error: {e}")
    rank0 = rank == 0
    if ckpt is not None and rank0:
        print(f"[ddl_tpu] serving params from {ckpt} (params-only load, placed once for "
              f"{args.replicas} replicas)")
    exporter = None
    try:
        exporter = _start_exporter(args, registry, rank)
        # Every program shape runs once outside the reported run (each
        # replica may receive any request, so each warms on the whole
        # stream); the profiler opens after it.
        router.warmup(traffic)
        with profiler_trace(args.trace_dir, device):
            done, rstats = router.run(traffic)
    finally:
        _close_obs(exporter, tracer, writer)
    if not rank0:
        return 0
    slo_digest = _slo_report(monitor)
    anomaly_digest = _anomaly_report(detector)
    cls_of = {m.id: m.traffic_class for m in traffic}
    summary = rstats.summary()
    for name, row in summary["per_class"].items():
        print(f"class {name}: {row['requests']} requests -> ok {row['ok']} shed {row['shed']} "
              f"deadline {row['deadline_exceeded']} | ttft p95 {row['ttft_ms']['p95']:.1f}ms "
              f"itl p95 {row['itl_ms']['p95']:.1f}ms | slo attained ttft "
              f"{row['ttft_slo_attained']:.0%} itl {row['itl_slo_attained']:.0%}")
    print(f"router: {args.replicas} replicas | placements {summary['per_replica_requests']} "
          f"(affinity {rstats.affinity_placements}, load {rstats.load_placements}) | router "
          f"sheds {rstats.router_sheds} | prefix hit rate {rstats.prefix_hit_rate:.0%}")
    if rstats.fleet is not None:
        fl = rstats.fleet
        print(f"fleet: max {fl['max_replicas']} | scale out {fl['scale_outs']} in "
              f"{fl['scale_ins']} (drains {fl['drains']}) | preemptions {fl['preemptions']} | "
              f"crashes {fl['crashes']} (requeues {fl['requeues']})")
    if rstats.disagg is not None:
        dg = rstats.disagg
        role_str = " ".join(f"{r}={n}" for r, n in sorted(dg["roles"].items()))
        print(f"disagg: roles {role_str} | handoffs {dg['handoffs']} "
              f"({dg['handoff_pages']} pages)")
    spec_digest = _speculate_digest(rcfg.serve, router)
    if spec_digest is not None:
        acc, prop = spec_digest["accepted"], spec_digest["proposed"]
        print(f"speculate: k={spec_digest['k']} ({spec_digest['method']}) | accepted "
              f"{acc}/{prop} drafts" + (f" ({acc / prop:.0%})" if prop else ""))
    if args.json:
        print(json.dumps({
            "variant": "serve",
            "device": str(device),
            "config": dataclasses.asdict(rcfg.serve),
            "replicas": args.replicas,
            "router": summary,
            "speculate": spec_digest,
            "slo_rules": slo_digest,
            "anomaly_rules": anomaly_digest,
            "per_class": _class_tallies(done, cls_of),
            "completions": {
                str(i): {"prompt_len": done[i].prompt_len, "tokens": done[i].tokens,
                         "status": done[i].status,
                         "traffic_class": cls_of.get(i, "default")}
                for i in sorted(done)
            },
        }))
    return 0


def _speculate_digest(cfg, router) -> dict | None:
    """The serve JSON's ``speculate`` digest, JAX's: k, method and the
    drafts proposed and accepted, summed over the replicas' registries (read
    without creating a metric). None without speculation or without
    registries (no telemetry flag on the run)."""
    if not cfg.speculate_k or not router.replica_registries:
        return None
    totals = {}
    for name in ("speculate_proposed_total", "speculate_accepted_total"):
        totals[name] = 0
        for rg in router.replica_registries:
            c = rg.get(name)
            if c is not None:
                totals[name] += int(sum(c.value(**ls) for ls in c.label_sets()))
    prop, acc = totals["speculate_proposed_total"], totals["speculate_accepted_total"]
    return {"k": cfg.speculate_k, "method": cfg.speculate_method, "proposed": prop,
            "accepted": acc, "acceptance": round(acc / prop, 3) if prop else None}


def _serve(args, cfg, device, grid, injector) -> int:
    """One engine's run of the serve variant (this rank's, at tp > 1). A
    ``stall`` fault ``injector`` reaches the scheduler."""
    from .data.lm import synthesize_prompts
    from .serve import InferenceEngine, Request, Scheduler

    from .train.trainer import checkpoint_file

    ckpt = checkpoint_file(args.checkpoint_dir)
    where = dict(grid=grid) if grid is not None else dict(device=device)
    try:
        engine = (InferenceEngine.from_checkpoint(cfg, ckpt, **where) if ckpt is not None
                  else InferenceEngine(cfg, **where))
    except (ValueError, KeyError) as e:
        raise SystemExit(f"serve config error: {e}")
    if ckpt is not None and (grid is None or grid.rank == 0):
        print(f"[ddl_tpu] serving params from {ckpt} (params-only load)")
    try:
        prompts = synthesize_prompts(num=args.num_prompts, min_len=args.prompt_min,
                                     max_len=args.prompt_max, vocab=args.vocab, seed=args.seed)
    except ValueError as e:
        raise SystemExit(f"serve config error: {e}")
    requests = [Request(id=i, prompt=pr, max_new_tokens=args.max_new_tokens)
                for i, pr in enumerate(prompts)]
    rank = grid.rank if grid is not None else 0
    registry, writer, _ = _build_obs(args, config=cfg, grid=grid, rank=rank, make_tracer=False)
    monitor = _make_slo_monitor(args, registry)
    detector = _make_anomaly(args, registry)
    try:
        scheduler = Scheduler(engine, registry=registry, metrics_writer=writer,
                              ttft_deadline_s=args.ttft_deadline,
                              deadline_s=args.request_deadline,
                              shed_threshold=args.shed_threshold, injector=injector,
                              slo_monitor=monitor, peak_flops=args.peak_flops,
                              anomaly_detector=detector)
    except ValueError as e:
        raise SystemExit(f"serve config error: {e}")
    from .obs.trace import trace_context

    exporter = None
    try:
        exporter = _start_exporter(args, registry, rank)
        # Every program shape runs once outside the reported run: the
        # latency percentiles and tok/s measure serving, not first-use
        # set-up. Warm-up keeps telemetry off.
        scheduler.warmup(requests)
        # One --trace-dir context holds the host spans and the profiler's
        # timeline of the run, opened after the warm-up.
        with trace_context(args.trace_dir) as tracer:
            scheduler.tracer = tracer
            for consumer in (monitor, detector):
                if consumer is not None:
                    # slo_alert and anomaly events land in the run's trace.
                    consumer.tracer = tracer
            done, stats = scheduler.run(requests)
    finally:
        _close_obs(exporter, writer)
    if rank != 0:
        return 0
    slo_digest = _slo_report(monitor)
    anomaly_digest = _anomaly_report(detector)
    _goodput_line(registry)
    for i in sorted(done):
        c = done[i]
        tag = "" if c.status == "ok" else f" [{c.status}]"
        print(f"request {i}: prompt {c.prompt_len} tokens -> {len(c.tokens)} generated "
              f"{c.tokens[:8]}{'...' if len(c.tokens) > 8 else ''}{tag}")
    lat = stats.latency
    print(f"prefill {stats.prefill_tokens_per_s:.0f} tok/s | decode "
          f"{stats.decode_tokens_per_s_per_slot:.1f} tok/s/slot ({stats.slots} slots) | "
          f"per-token latency p50 {lat.p50_ms:.1f}ms p95 {lat.p95_ms:.1f}ms "
          f"p99 {lat.p99_ms:.1f}ms")
    print(f"ttft p50 {stats.ttft.p50_ms:.1f}ms p95 {stats.ttft.p95_ms:.1f}ms"
          f" | itl p95 {stats.itl.p95_ms:.1f}ms")
    if args.prefix_cache:
        print(f"prefix cache: {stats.prefix_hits}/{stats.prefix_lookups} hits "
              f"({stats.prefix_hit_rate:.0%}), {stats.prefill_tokens_saved} prefill "
              "tokens saved")
    if args.page_size:
        print(f"paged pool: {engine.num_pages} pages x {args.page_size} rows, "
              f"{engine.pages.free} free at exit, {engine.page_copies} CoW tail-page copies")
    if args.json:
        print(json.dumps({
            "variant": "serve",
            "device": str(device),
            "config": dataclasses.asdict(cfg),
            "num_prompts": args.num_prompts,
            "max_new_tokens": args.max_new_tokens,
            "completions": {
                str(i): {"prompt_len": done[i].prompt_len, "tokens": done[i].tokens,
                         "status": done[i].status}
                for i in sorted(done)
            },
            "per_class": _class_tallies(done, {r.id: r.traffic_class for r in requests}),
            "slo_rules": slo_digest,
            "anomaly_rules": anomaly_digest,
            "goodput": (scheduler.goodput.summary() if scheduler.goodput is not None
                        else None),
            "prefill_tokens_per_s": stats.prefill_tokens_per_s,
            "decode_tokens_per_s": stats.decode_tokens_per_s,
            "decode_tokens_per_s_per_slot": stats.decode_tokens_per_s_per_slot,
            "decode_steps": stats.decode_steps,
            "latency_ms": {"p50": lat.p50_ms, "p95": lat.p95_ms, "p99": lat.p99_ms},
            "ttft_ms": {"p50": stats.ttft.p50_ms, "p95": stats.ttft.p95_ms},
            "itl_ms": {"p50": stats.itl.p50_ms, "p95": stats.itl.p95_ms,
                       "p99": stats.itl.p99_ms},
            "prefix_lookups": stats.prefix_lookups,
            "prefix_hits": stats.prefix_hits,
            "prefill_tokens_saved": stats.prefill_tokens_saved,
            "kv_page_copies": engine.page_copies if args.page_size else 0,
            "kv_pages_free": engine.pages.free if args.page_size else 0,
        }))
    return 0


def _run_sim(args) -> int:
    """The ``sim`` variant (JAX's ``_run_sim``): replay a named scenario on
    the cost-model twin, the real router, scheduler and controller over
    ``serve.sim.CostModelEngine`` replicas that charge fitted per-phase
    virtual time and touch no device. Its decisions are the real fleet's
    tick for tick; its tokens are hashes and its clock virtual. Prints
    JAX's lines and JSON."""
    if args.inject_fault:
        raise SystemExit("--inject-fault applies to the single/lm/serve variants")
    # --device too: the twin touches no device, and a --device cpu that
    # changed nothing would read as if it had; and the multi-host flags:
    # the twin replays in this process. --platform is taken and ignored,
    # as JAX's.
    _reject_foreign_flags(args, "sim", _CNN_ONLY + _LM_TRAIN + _TRAIN_ONLY + ("profile",)
                          + _SIM_REJECT + ("device",) + _MULTIHOST)
    if args.scenario is None:
        raise SystemExit(
            "sim requires --scenario NAME[:key=value,...] (choices: "
            "bulk_burst, replica_crash, diurnal, crash_storm, role_mix, "
            "longtail_prefix)"
        )
    from .models.transformer import LMSpec
    from .obs.goodput import fleet_summary, phase_cost_fit
    from .serve.engine_iface import engine_kind
    from .serve.router import Router
    from .serve.scenarios import parse_scenario
    from .serve.sim import CostModel, sim_engine_factory

    try:
        scn, over = parse_scenario(args.scenario)
    except ValueError as e:
        raise SystemExit(f"--scenario: {e}")
    spec = LMSpec(vocab=args.vocab, d_model=args.d_model, num_heads=args.heads,
                  num_layers=args.layers, d_ff=args.d_ff)
    cost = CostModel()
    if args.fit is not None:
        try:
            cost = CostModel.from_phase_fit(phase_cost_fit(args.fit))
        except (OSError, ValueError) as e:
            raise SystemExit(f"--fit: {e}")
    replicas = over.pop("replicas", None)
    if args.replicas is not None:
        replicas = args.replicas
    acfg = None
    if args.autoscale is not None:
        from .serve.controller import parse_autoscale_spec

        try:
            acfg = parse_autoscale_spec(args.autoscale, max_replicas=args.max_replicas,
                                        replicas=replicas if replicas is not None
                                        else scn.replicas)
        except ValueError as e:
            raise SystemExit(f"--autoscale: {e}")
    elif args.max_replicas is not None:
        raise SystemExit("--max-replicas requires --autoscale (it caps the fleet the "
                         "controller may grow; pass --autoscale '' for defaults)")
    try:
        traffic = scn.build_traffic(args.vocab, **over)
        rcfg = scn.router_config(spec, replicas=replicas,
                                 engine_factory=sim_engine_factory(cost))
        controller = scn.make_controller(autoscale=acfg, replicas=replicas)
    except ValueError as e:
        raise SystemExit(f"sim config error: {e}")
    registry, writer, _ = _build_obs(args, config=rcfg.serve, make_tracer=False)
    tracer = None
    if args.trace_dir:
        from .obs.trace import Tracer, host_trace_file

        # keep=True: the per-class SLO derivation reads the records back;
        # the trace reads through obs.analyze as a real fleet's does.
        tracer = Tracer(host_trace_file(args.trace_dir), keep=True)
    monitor = None
    if scn.slo_rule_classes:
        if registry is None:
            from .obs import MetricRegistry

            registry = MetricRegistry()
        from .obs.slo import SloMonitor

        monitor = SloMonitor(scn.slo_rules(), registry, tracer=tracer)
    exporter = None
    try:
        try:
            router = Router(rcfg, registry=registry, tracer=tracer, slo_monitor=monitor,
                            controller=controller)
        except ValueError as e:
            raise SystemExit(f"sim config error: {e}")
        exporter = _start_exporter(args, registry)
        # No warm-up: the twin has nothing to run ahead.
        done, rstats = router.run(traffic)
    finally:
        _close_obs(exporter, tracer, writer)
    vt = {"prefill": 0.0, "decode": 0.0, "handoff": 0.0, "total": 0.0}
    for eng in router.engines:
        if eng is not None and engine_kind(eng) == "sim":
            for k, v in eng.virtual_time().items():
                vt[k] += v
    summary = rstats.summary()
    print(f"sim: scenario {scn.name} | {rcfg.replicas} replicas (cost-model twin) | "
          f"{len(traffic)} requests")
    for name, row in summary["per_class"].items():
        print(f"class {name}: {row['requests']} requests -> ok {row['ok']} shed {row['shed']} "
              f"deadline {row['deadline_exceeded']}")
    print(f"router: placements {summary['per_replica_requests']} | router sheds "
          f"{rstats.router_sheds} | prefix hit rate {rstats.prefix_hit_rate:.0%}")
    if rstats.fleet is not None:
        fl = rstats.fleet
        print(f"fleet: max {fl['max_replicas']} | scale out {fl['scale_outs']} in "
              f"{fl['scale_ins']} (drains {fl['drains']}) | preemptions {fl['preemptions']} | "
              f"crashes {fl['crashes']} (requeues {fl['requeues']})")
    print(f"virtual time: prefill {vt['prefill']:.3f}s decode {vt['decode']:.3f}s handoff "
          f"{vt['handoff']:.3f}s | total {vt['total']:.3f}s")
    if args.json:
        cls_of = {m.id: m.traffic_class for m in traffic}
        print(json.dumps({
            "variant": "sim",
            "scenario": args.scenario,
            "engine_kind": "sim",
            "replicas": rcfg.replicas,
            "cost_model": dataclasses.asdict(cost),
            "router": summary,
            "virtual_time": vt,
            "slo_rules": _slo_report(monitor),
            "fleet_digest": fleet_summary(registry) if registry is not None else None,
            "per_class": _class_tallies(done, cls_of),
        }))
    return 0


def _run_gauges(args, cfg, registry, result, device) -> None:
    """JAX's end-of-run gauges of the CNN variants: the final accuracy and
    the run's images/s; on sync and async, whose span loops take no
    per-span telemetry, also one end-of-run ``train_mfu`` from the
    analytic per-image FLOPs over the run's workers."""
    registry.gauge("train_final_accuracy").set(result.final_accuracy)
    registry.gauge("train_run_images_per_sec").set(result.images_per_sec)
    if args.variant != "single" and result.train_time_s > 0:
        from .obs import cost

        registry.gauge("train_mfu").set(cost.mfu(
            cost.cnn_train_step_flops(1, cfg.conv_channels, cfg.fc_sizes)
            * result.images_per_sec * result.train_time_s,
            result.train_time_s,
            max(1, cfg.num_workers),
            cost.peak_flops_per_device(device, args.peak_flops,
                                       precision=cfg.policy().mfu_kind),
        ))


def _resolve_platform(args) -> None:
    """JAX's ``--platform`` onto ``--device``: ``cpu`` is ``--device cpu``,
    ``tpu`` is refused, and ``--device`` defaults to cuda."""
    if args.platform == "tpu":
        raise SystemExit("--platform tpu: the port runs on an NVIDIA card (--device cuda, "
                         "the default) or the CPU (--platform cpu); it has no TPU backend")
    if args.platform == "cpu":
        if args.device == "cuda":
            raise SystemExit("--platform cpu conflicts with --device cuda")
        args.device = "cpu"
    args.device = args.device or "cuda"


def _launch_host(args, argv: list[str]) -> int:
    """``--multihost`` on one host (``parallel/multihost.py``): JAX's
    world-size rule and refusals, JAX's line, then this host's ranks, each
    this same command line with torchrun's variables, until they end."""
    from .parallel import multihost

    if args.variant == "serve":
        raise SystemExit("serve is single-controller (one process drives the tp mesh); "
                         "--multihost does not apply")
    if args.variant == "single":
        raise SystemExit("single trains one device in one process; --multihost does not apply")
    if "WORLD_SIZE" in os.environ:
        raise SystemExit("--multihost starts its own ranks: run it once a host, not under "
                         "torchrun (WORLD_SIZE is set)")
    if args.num_processes is None:
        raise SystemExit("--multihost needs --num-processes (the port has no TPU environment "
                         "to infer the world from)")
    # JAX's world (ddl_tpu/cli.py's CPU device count): the lm grid's
    # defaulting, num_workers 1 under pipeline parallelism.
    total = ((args.num_workers or (1 if args.pipeline_parallel > 1 else args.num_processes))
             * args.data_parallel * args.tensor_parallel * args.pipeline_parallel)
    try:
        host = multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                                    total)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if host.n_local > cards:
            raise SystemExit(
                f"--multihost: this host runs {host.n_local} ranks over NCCL, which takes one "
                f"card a rank, and it has {cards} card(s)")
    print(f"[ddl_tpu_torch] multihost: process {host.process_id}/{host.num_processes}, "
          f"{total} global devices", flush=True)
    return multihost.launch(host, [sys.executable, "-m", "ddl_tpu_torch", *argv])


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _check_obs_flags(args)
    _check_resilience_flags(args)
    if args.variant == "sim":
        return _run_sim(args)
    _resolve_platform(args)
    from .parallel import multihost

    if args.multihost and multihost.launched() is None:
        return _launch_host(args, argv)
    import torch

    from .data.mnist import load_mnist
    from .parallel.mesh import default_device, destroy_world

    device = default_device(args.device)
    if device.type == "cuda":
        # fp32 runs in full fp32: keep cuDNN convs and cuBLAS matmuls out of
        # TF32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.variant == "lm":
        return _run_lm(args, device)
    if args.variant == "serve":
        return _run_serve(args, device)
    num_workers = args.num_workers or int(os.environ.get("WORLD_SIZE", "1"))
    if args.variant == "single" and num_workers != 1:
        raise SystemExit("single runs one worker")
    cfg = config_from_args(args, num_workers)
    dataset = load_mnist(
        path=args.data,
        synthetic_train=args.synthetic_train,
        synthetic_test=args.synthetic_test,
    )
    from .parallel.mesh import AcceleratorTimeout

    train_kw = _train_kwargs(args, _make_injector(args, args.variant))
    with tempfile.TemporaryDirectory() as store_dir:
        world = None
        if args.variant != "single":
            world = _join_world(num_workers, args.device, store_dir)
        rank = world.rank if world is not None else 0
        lead = world is None or world.lead
        registry = writer = tracer = exporter = detector = None
        try:
            registry, writer, tracer = _build_obs(args, config=cfg, rank=rank)
            exporter = _start_exporter(args, registry, rank)
            run_span = contextlib.nullcontext()
            if args.variant == "single":
                from .train.trainer import SingleChipTrainer

                detector = _make_anomaly(args, registry, tracer)
                trainer = SingleChipTrainer(cfg, dataset, device=device)
                train_kw.update(max_bad_steps=args.max_bad_steps or 0, metrics=registry,
                                metrics_interval=args.metrics_interval,
                                metrics_writer=writer, tracer=tracer,
                                peak_flops=args.peak_flops, ici_bw=args.ici_bw,
                                anomaly_detector=detector)
            else:
                if args.variant.startswith("async"):
                    from .strategies.async_ps import AsyncTrainer as Trainer
                else:
                    from .strategies.sync import SyncTrainer as Trainer
                trainer = Trainer(cfg, dataset, world=world)
                train_kw["log"] = print if lead else (lambda s: None)
                if tracer is not None:
                    # The sync/async trainers take no tracer (as JAX's):
                    # one run-level span wraps the whole training call.
                    run_span = tracer.span("train/run", variant=args.variant)
            with run_span:
                result = trainer.train(profile_dir=args.profile or args.trace_dir,
                                       **train_kw)
            if registry is not None:
                _run_gauges(args, cfg, registry, result, device)
        except AcceleratorTimeout as e:
            return _fatal_timeout(e)
        finally:
            _close_obs(exporter, tracer, writer)
            if world is not None:
                destroy_world()
    anomaly_digest = _anomaly_report(detector) if lead else None
    if not lead:
        return 0
    print(f"training time: {result.train_time_s:.2f}s "
          f"({result.images_per_sec:.0f} images/s, "
          f"warm-up {result.compile_time_s:.1f}s excluded)")
    if result.step_stats and result.step_stats.steps:
        print(f"step stats (per span): {result.step_stats.line()}")
    if args.json:
        print(json.dumps({
            "variant": args.variant,
            "device": str(device),
            "anomaly_rules": anomaly_digest,
            "config": dataclasses.asdict(cfg),
            "final_accuracy": result.final_accuracy,
            "history": [[e, b, round(a, 6)] for e, b, a in result.history],
            # Async only: each worker's stale-replica accuracy per eval
            # point; null for sync and single.
            "worker_history": (
                [[e, b, [round(a, 6) for a in accs]] for e, b, accs in result.worker_history]
                if result.worker_history is not None else None
            ),
            "train_time_s": result.train_time_s,
            "images_per_sec": result.images_per_sec,
            "compile_time_s": result.compile_time_s,
            "step_stats": dataclasses.asdict(result.step_stats)
                          if result.step_stats else None,
            **_resilience_json(result),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
