"""Command-line launcher for the port — the subset of ``ddl_tpu/cli.py``
the ported slices carry: the seven CNN variants (single, sync and async,
whole or sharded) and the decoder LM on one device.

    python -m ddl_tpu_torch single
    python -m ddl_tpu_torch sync_sharding --num-workers 1 --num-ps 2 --layout flat --fused-adam
    python -m ddl_tpu_torch async_sharding --num-ps 2
    torchrun --nproc-per-node 4 -m ddl_tpu_torch sync --num-workers 4
    python -m ddl_tpu_torch lm --seq-scheme full --attn-impl flash

Flags are spelled as in the JAX CLI, with its defaults; a flag of another
variant set away from its default is refused. One process drives one
device: a multi-worker CNN run is launched with ``torchrun``, whose
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` variables this
reads; a run of one worker makes a world of one itself. Runs on ``cuda``
unless ``--device cpu``, in fp32 with TF32 off unless ``--bf16`` (the JAX
CLI's bf16 default on a TPU does not carry over).
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
)
# Flags of the CNN variants and of the lm variant: each is refused, set away
# from its default, by the other (as ddl_tpu/cli.py's _reject_foreign_flags).
_CNN_ONLY = ("num_ps", "layout", "keep_prob", "staleness_seed", "data", "synthetic_train",
             "synthetic_test", "fused_adam", "tiny", "reference_compat")
_LM_ONLY = ("seq_scheme", "seq_len", "vocab", "d_model", "heads", "layers", "d_ff",
            "train_seqs", "test_seqs", "target_accuracy", "attn_impl", "remat")


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
    p.add_argument("--tiny", action="store_true",
                   help="narrow model preset (conv 4,8,8,8, fc 32,16)")
    p.add_argument("--reference-compat", action="store_true",
                   help="summed (not averaged) gradients and identical "
                        "batches on every worker, as the reference")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute with fp32 master weights and moments "
                        "(lm only; the CNN variants' bf16 is not ported yet)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON summary line at the end")
    lm = p.add_argument_group(
        "lm options",
        "the 'lm' variant trains the decoder LM on the procedural copy task "
        "(strategies/seq.py) on one device; --batch-size counts sequences "
        "(default 32), --lr defaults to 1e-3",
    )
    lm.add_argument("--seq-scheme", default="ring", choices=["ring", "ulysses", "full"],
                    help="cross-shard attention scheme; only full (one device) is "
                         "ported, so pass --seq-scheme full")
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
    # The JAX CLI's parallelism flags (--tensor-parallel, --data-parallel,
    # --pipeline-parallel, --zero1, ...) wait for ROADMAP queue 1, item 3.
    return p


def _reject_foreign_flags(args, variant: str, dests: tuple[str, ...]) -> None:
    defaults = build_parser()
    for dest in dests:
        if getattr(args, dest) != defaults.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} does not apply to the {variant} variant")


def config_from_args(args, num_workers: int):
    from .models.cnn import TINY_CONV_CHANNELS, TINY_FC_SIZES
    from .train.config import TrainConfig

    _reject_foreign_flags(args, args.variant, _LM_ONLY)
    if args.bf16:
        raise SystemExit(
            f"--bf16 for {args.variant}: the CNN's bf16 compute is not ported yet "
            "(ROADMAP queue 1, item 4)"
        )

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
        fused_adam=args.fused_adam,
        conv_channels=TINY_CONV_CHANNELS if args.tiny else (32, 64, 128, 256),
        fc_sizes=TINY_FC_SIZES if args.tiny else (1024, 512),
    )


def _join_world(num_workers: int, device: str, store_dir: str):
    """torchrun's world when its variables are set, else a world of one
    over a file store in ``store_dir``."""
    from .parallel.mesh import init_world

    env_size = os.environ.get("WORLD_SIZE")
    if env_size is not None:
        if int(env_size) != num_workers:
            raise SystemExit(f"--num-workers {num_workers} != WORLD_SIZE {env_size}")
        return init_world(num_workers, int(os.environ["RANK"]), "env://", device)
    if num_workers != 1:
        raise SystemExit(
            f"--num-workers {num_workers} needs one process per worker: "
            f"launch with torchrun --nproc-per-node {num_workers} -m ddl_tpu_torch ..."
        )
    return init_world(1, 0, f"file://{os.path.join(store_dir, 'store')}", device)


def lm_config_from_args(args):
    from .models.transformer import LMSpec
    from .strategies.seq import SeqConfig

    _reject_foreign_flags(args, "lm", _CNN_ONLY)
    if args.seq_scheme != "full":
        raise SystemExit(
            f"--seq-scheme {args.seq_scheme} is not ported yet (ROADMAP queue 1, item 3): "
            "pass --seq-scheme full, which trains on one device"
        )
    return SeqConfig(
        epochs=args.epochs,
        batch_size=args.batch_size or 32,
        learning_rate=args.lr if args.lr is not None else 1e-3,
        eval_every=args.eval_every,
        seed=args.seed,
        num_workers=args.num_workers or 1,
        scheme=args.seq_scheme,
        compute_dtype="bfloat16" if args.bf16 else None,
        target_accuracy=args.target_accuracy,
        attn_impl=args.attn_impl,
        remat=args.remat,
        spec=LMSpec(vocab=args.vocab, d_model=args.d_model, num_heads=args.heads,
                    num_layers=args.layers, d_ff=args.d_ff),
    )


def _run_lm(args, device) -> int:
    """The ``lm`` variant: decoder-LM training on the copy task, one device."""
    from .data.lm import synthesize_copy
    from .strategies.seq import SeqTrainer

    cfg = lm_config_from_args(args)
    try:
        dataset = synthesize_copy(
            num_train=args.train_seqs, num_test=args.test_seqs,
            seq_len=args.seq_len, vocab=args.vocab, seed=args.seed,
        )
        trainer = SeqTrainer(cfg, dataset, device=device)
    except ValueError as e:
        # Only construction is guarded: every config check lives there.
        raise SystemExit(f"lm config error: {e}")
    result = trainer.train()
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


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
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
