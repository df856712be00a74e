"""Command-line launcher for the port — the subset of ``ddl_tpu/cli.py``
the ported slices carry: the seven CNN variants (single, sync and async,
whole or sharded), the decoder LM over a [data-parallel, num-workers,
tensor-parallel, pipeline-parallel] grid (ring, Ulysses or full attention,
ZeRO-1, Megatron tensor parallelism, GPipe or 1F1B pipeline stages), and
single-engine serving, at tp 1 or over a tp group.

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

Flags are spelled as in the JAX CLI, with its defaults; a flag of another
variant set away from its default is refused. One process drives one
device: a multi-worker run is launched with ``torchrun``, whose ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` variables this reads; a
run of one worker makes a world of one itself. Runs on ``cuda``
unless ``--device cpu``, in fp32 with TF32 off unless ``--precision bf16``
(bf16 compute and bf16 gradient sums, fp32 master weights and moments) or
the legacy ``--bf16`` (bf16 compute only); the JAX CLI's bf16 default on a
TPU does not carry over, as JAX on a GPU defaults to fp32.
"""

from __future__ import annotations

import argparse
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
_TRAIN_ONLY = ("num_workers", "epochs", "batch_size", "lr", "eval_every")
_SERVE_ONLY = ("slots", "capacity", "max_new_tokens", "num_prompts", "prompt_min",
               "prompt_max", "temperature", "top_k", "prefix_cache", "prefill_chunk",
               "prefill_budget", "page_size", "num_pages", "ttft_deadline",
               "request_deadline", "shed_threshold")
# JAX CLI flags of slices not ported yet, with their ROADMAP items: setting
# one raises NotImplementedError, whatever the variant.
_NOT_PORTED = {
    "kv_dtype": "ROADMAP queue 1, item 8: the int8 pool",
    "checkpoint_dir": "ROADMAP queue 1, item 5: checkpoints",
    "replicas": "ROADMAP queue 1, item 8: the router",
    "traffic": "ROADMAP queue 1, item 8: the router",
    "slo": "ROADMAP queue 1, item 8: the router",
    "autoscale": "ROADMAP queue 1, item 8: the controller",
    "roles": "ROADMAP queue 1, item 8: disagg",
    "speculate": "ROADMAP queue 1, item 8: speculate",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ddl_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("variant", choices=VARIANTS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
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
        "--seed and --json apply as usual; the model's weights are the port's own "
        "seeded init",
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
    # The JAX CLI's flags of later slices (_NOT_PORTED): parsed so that
    # setting one fails with its ROADMAP item, not a generic parse error.
    sv.add_argument("--kv-dtype", default=None, help="not ported")
    sv.add_argument("--checkpoint-dir", default=None, help="not ported")
    sv.add_argument("--replicas", type=int, default=None, help="not ported")
    sv.add_argument("--traffic", default=None, help="not ported")
    sv.add_argument("--slo", default=None, help="not ported")
    sv.add_argument("--autoscale", default=None, help="not ported")
    sv.add_argument("--roles", default=None, help="not ported")
    sv.add_argument("--speculate", default=None, help="not ported")
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


def _reject_foreign_flags(args, variant: str, dests: tuple[str, ...]) -> None:
    defaults = build_parser()
    for dest in dests:
        if getattr(args, dest) != defaults.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} does not apply to the {variant} variant")


def config_from_args(args, num_workers: int):
    from .models.cnn import TINY_CONV_CHANNELS, TINY_FC_SIZES
    from .train.config import TrainConfig

    _reject_foreign_flags(args, args.variant, _LM_ONLY + _SERVE_ONLY)

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
    """torchrun's world when its variables are set, else a world of one
    over a file store in ``store_dir``. ``num_workers`` is the number of
    ranks the run needs."""
    from .parallel.mesh import init_world

    env_size = os.environ.get("WORLD_SIZE")
    if env_size is not None:
        if int(env_size) != num_workers:
            raise SystemExit(f"the run needs {num_workers} ranks, WORLD_SIZE is {env_size}")
        return init_world(num_workers, int(os.environ["RANK"]), "env://", device)
    if num_workers != 1:
        raise SystemExit(
            f"{num_workers} ranks need one process each: "
            f"launch with torchrun --nproc-per-node {num_workers} -m ddl_tpu_torch ..."
        )
    return init_world(1, 0, f"file://{os.path.join(store_dir, 'store')}", device)


def lm_config_from_args(args):
    from .models.transformer import LMSpec
    from .strategies.seq import SeqConfig

    _reject_foreign_flags(args, "lm", _CNN_ONLY + _SERVE_ONLY)
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
    with tempfile.TemporaryDirectory() as store_dir:
        world = _join_world(cfg.num_workers * cfg.data_parallel * cfg.tensor_parallel
                            * cfg.pipeline_parallel, args.device, store_dir)
        try:
            trainer = SeqTrainer(cfg, dataset, world=world)
            result = trainer.train(log=print if world.rank == 0 else (lambda s: None))
        finally:
            destroy_world()
    if world.rank != 0:
        return 0
    print(f"training time: {result.train_time_s:.2f}s "
          f"({result.tokens_per_sec:.0f} tokens/s, "
          f"warm-up {result.compile_time_s:.1f}s excluded)")
    if args.json:
        print(json.dumps({
            "variant": "lm",
            "device": str(device),
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

    _reject_foreign_flags(args, "serve", _CNN_ONLY + _LM_TRAIN + _TRAIN_ONLY)
    if args.tensor_parallel < 1:
        raise SystemExit(f"--tensor-parallel must be >= 1, got {args.tensor_parallel}")
    spec = LMSpec(vocab=args.vocab, d_model=args.d_model, num_heads=args.heads,
                  num_layers=args.layers, d_ff=args.d_ff)
    # The engine has no optimizer boundary: a precision policy here is its
    # compute dtype ("bf16" -> bfloat16, "fp32" -> fp32).
    prec = _resolve_precision(args)
    serve_dtype = "bfloat16" if prec == "bf16" else None if prec == "fp32" else _resolve_dtype(args)
    cfg = ServeConfig(
        spec=spec, slots=args.slots, capacity=args.capacity,
        tensor_parallel=args.tensor_parallel,
        temperature=args.temperature, top_k=args.top_k, seed=args.seed,
        compute_dtype=serve_dtype,
        prefix_slots=args.prefix_cache, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, page_size=args.page_size,
        num_pages=args.num_pages,
    )
    if args.top_k and args.temperature <= 0:
        raise SystemExit("--top-k requires --temperature > 0 (greedy decode ignores it)")
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
    if args.tensor_parallel == 1:
        return _serve(args, cfg, device, None)
    with tempfile.TemporaryDirectory() as store_dir:
        world = _join_world(args.tensor_parallel, args.device, store_dir)
        try:
            return _serve(args, cfg, device, make_grid(world, 1, 1, args.tensor_parallel))
        finally:
            destroy_world()


def _serve(args, cfg, device, grid) -> int:
    """One engine's run of the serve variant (this rank's, at tp > 1)."""
    from .data.lm import synthesize_prompts
    from .serve import InferenceEngine, Request, Scheduler

    try:
        engine = (InferenceEngine(cfg, grid=grid) if grid is not None
                  else InferenceEngine(cfg, device=device))
    except (ValueError, KeyError) as e:
        raise SystemExit(f"serve config error: {e}")
    try:
        prompts = synthesize_prompts(num=args.num_prompts, min_len=args.prompt_min,
                                     max_len=args.prompt_max, vocab=args.vocab, seed=args.seed)
    except ValueError as e:
        raise SystemExit(f"serve config error: {e}")
    requests = [Request(id=i, prompt=pr, max_new_tokens=args.max_new_tokens)
                for i, pr in enumerate(prompts)]
    try:
        scheduler = Scheduler(engine, ttft_deadline_s=args.ttft_deadline,
                              deadline_s=args.request_deadline,
                              shed_threshold=args.shed_threshold)
    except ValueError as e:
        raise SystemExit(f"serve config error: {e}")
    # Every program shape runs once outside the reported run: the latency
    # percentiles and tok/s measure serving, not first-use set-up.
    scheduler.warmup(requests)
    done, stats = scheduler.run(requests)
    if grid is not None and grid.rank != 0:
        return 0
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


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, item in _NOT_PORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            raise NotImplementedError(f"--{dest.replace('_', '-')} is not ported yet ({item})")
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
    rank = 0
    if args.variant == "single":
        from .train.trainer import SingleChipTrainer

        result = SingleChipTrainer(cfg, dataset, device=device).train()
    else:
        if args.variant.startswith("async"):
            from .strategies.async_ps import AsyncTrainer as Trainer
        else:
            from .strategies.sync import SyncTrainer as Trainer

        with tempfile.TemporaryDirectory() as store_dir:
            world = _join_world(num_workers, args.device, store_dir)
            try:
                rank = world.rank
                result = Trainer(cfg, dataset, world=world).train()
            finally:
                destroy_world()
    if rank != 0:
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
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
