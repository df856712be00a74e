"""Device time of the fused-Adam kernel of one or more source trees, by one
timer (``devtime.py`` beside this file), on one card.

    python ddl_tpu_torch/tools/adam_timing.py [--trees DIR ...] [--grids] [--out FILE]

Each tree (a checkout of this repo, e.g. one unpacked with ``git archive``;
default: the tree this file is in) runs in its own process, in the order
given, so ``--trees parent this this parent`` compares two versions in
turns on the same card. In each, at the n of the CNN's ZeRO-1 ``flat``
shard with one worker and with four (both from that tree's
``resolve_layout``), one JSON line gives:

- the kernel's ``ms`` (cold), ``hot_ms`` and ``call_ms`` (``devtime``),
  its bound (28 bytes an element over the card's HBM rate), the cold
  reading's share of it and GB/s, and whether it is bit-equal to the plain
  chain (``adam_flat_reference``);
- ``cold_read_flush_ms``: the cold reading with a flush that also reads the
  scratch back, so the L2 holds no dirty lines to write back during the
  call; ``after_grad_ms``: the flush, then g written anew, as a train step
  leaves the L2 for the update (also for the library call);
- ``torch._fused_adam_`` driven to the same function (eps rescaled by
  1/sqrt(1-b2^t)) and the plain chain, by the same timer;
- ``copy_same_bytes``: a copy that moves the same 28 bytes an element
  (14 read, 14 written), what the card reaches in the simplest pattern;
- ``scalar_path``: the kernel on buffers one float off 16-byte alignment
  (the scalar path), cold and hot, and whether it is bit-equal;
- with ``--grids`` (a tree with ``launch_plan``), the float4 kernel
  launched at other grids than its plan's: one block a tile, the plan's
  grid, the same tiles over the fewest blocks that keep the plan's number
  of rounds (every block as many tiles, give or take one), and one and two
  blocks an SM; each one's cold, hot and after-gradient ms and whether it
  is bit-equal. A round is one tile for every block of the grid.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL = r"adam_flat_\w*kernel"  # the device names of both kernels (and the parent's)


def _flat_shard(tree_sync, config_cls, workers: int) -> int:
    cfg = config_cls(batch_size=100, num_workers=workers, num_ps=max(2, workers), layout="flat")
    return tree_sync.resolve_layout(cfg, workers).max_shard


def run_tree(tree: str, grids: bool, emit) -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(tree))
    import devtime
    import torch

    from ddl_tpu_torch.ops import fused_adam as fa
    from ddl_tpu_torch.strategies import sync
    from ddl_tpu_torch.train.config import TrainConfig

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    flush = devtime.L2Flush(dev)

    def read_flush():
        flush()
        flush.buf.max()  # read it back: the L2 then holds clean lines only

    b1, b2, eps, lr, t = 0.9, 0.999, 1e-8, 1e-4, 10
    lr_t = torch.tensor([lr * math.sqrt(1 - b2**t) / (1 - b1**t)], device=dev)
    step_t = torch.tensor(float(t), device=dev)
    fa.load_kernel()
    for workers in (1, 4):
        n = _flat_shard(sync, TrainConfig, workers)
        gen = torch.Generator(device=dev).manual_seed(2)
        p, m, g = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
        v = torch.randn(n, generator=gen, device=dev).abs()
        want = fa.adam_flat_reference(p, m, v, g, lr_t)
        kp, km, kv = p.clone(), m.clone(), v.clone()
        fa.adam_flat_fused(kp, km, kv, g, lr_t)
        bit_equal = all(bool(torch.equal(a, b)) for a, b in zip((kp, km, kv), want))

        def kernel():
            fa.adam_flat_fused(kp, km, kv, g, lr_t)

        g_src = g.clone()

        def grad_flush():
            # As in a train step: the L2 flushed by other work, then the
            # gradient written just before the update reads it.
            flush()
            g.copy_(g_src)

        lp, lm, lv = p.clone(), m.clone(), v.clone()

        def library():
            torch._fused_adam_([lp], [g], [lm], [lv], [], [step_t], lr=lr, beta1=b1, beta2=b2,
                               weight_decay=0.0, eps=eps / math.sqrt(1 - b2**t),
                               amsgrad=False, maximize=False)

        row = devtime.timings(kernel, flush, kernel=KERNEL, reps=100,
                              call_reps=200)
        nbytes = 28 * n
        bound_ms = nbytes / devtime.hbm_bytes_per_s(card) * 1e3
        row.update(
            n=n, workers=workers, bit_equal=bit_equal, bound_ms=bound_ms,
            share_of_bound=bound_ms / row["ms"], gb_per_s=nbytes / (row["ms"] * 1e-3) / 1e9,
            cold_read_flush_ms=devtime.device_ms(kernel, reps=100, flush=read_flush,
                                                 kernel=KERNEL)["ms"],
            after_grad_ms=devtime.device_ms(kernel, reps=100, flush=grad_flush,
                                            kernel=KERNEL)["ms"],
        )
        lib = devtime.timings(library, flush, reps=100, call_reps=200)
        row["library"] = {k: lib[k] for k in ("ms", "hot_ms", "call_ms", "device_events")}
        row["library"]["after_grad_ms"] = devtime.device_ms(library, reps=100,
                                                            flush=grad_flush)["ms"]
        plain = devtime.timings(lambda: fa.adam_flat_reference(p, m, v, g, lr_t), flush,
                                reps=50)
        row["plain"] = {k: plain[k] for k in ("ms", "hot_ms", "call_ms")}
        # What the card reaches for the same bytes in the simplest pattern:
        # one copy of 14 bytes an element, read once and written once.
        src = torch.empty(14 * n, dtype=torch.uint8, device=dev).fill_(3)
        dst = torch.empty_like(src)
        copy = devtime.timings(lambda: dst.copy_(src), flush, reps=100)
        row["copy_same_bytes"] = {k: copy[k] for k in ("ms", "hot_ms")}
        del src, dst
        # The scalar path: the same n on buffers one float past 16-byte
        # alignment, checked bit-equal first.
        sp, sm, sv, sg = (torch.empty(n + 1, device=dev)[1:] for _ in range(4))
        for dst, src in zip((sp, sm, sv, sg), (p, m, v, g)):
            dst.copy_(src)

        def scalar():
            fa.adam_flat_fused(sp, sm, sv, sg, lr_t)

        scalar()
        equal = all(bool(torch.equal(a, b)) for a, b in zip((sp, sm, sv), want))
        sc = devtime.timings(scalar, flush, kernel=KERNEL, reps=100)
        row["scalar_path"] = {"ms": sc["ms"], "hot_ms": sc["hot_ms"], "bit_equal": equal,
                              "share_of_bound": bound_ms / sc["ms"]}
        del sp, sm, sv, sg
        if grids and hasattr(fa, "launch_plan"):
            row["grids"] = time_grids(fa, devtime, n, p, m, v, g, lr_t, want, flush, grad_flush,
                                      (b1, b2, eps))
        emit({"tree": tree, "card": card, "kernel": "adam_flat_fused", **row})
        del p, m, v, g, g_src, want, kp, km, kv, lp, lm, lv


def time_grids(fa, devtime, n, p, m, v, g, lr_t, want, flush, grad_flush, coeffs) -> dict:
    """The float4 kernel at other grids (``--grids``), each launched on the
    library's ABI with its block count, checked bit-equal first."""
    import torch

    lib = fa.load_kernel()
    sms, per_sm = fa.occupancy(0, True)
    plan = fa.launch_plan(n, True, sms, per_sm)
    tiles = -(-plan.units // fa.THREADS)
    rounds = -(-tiles // plan.blocks)
    b1, b2, eps = coeffs
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for blocks in sorted({tiles, plan.blocks, -(-tiles // rounds), 2 * sms, sms}):
        up, um, uv = p.clone(), m.clone(), v.clone()

        def ring():
            err = lib.ddl_adam_flat_f32(up.data_ptr(), um.data_ptr(), uv.data_ptr(),
                                        g.data_ptr(), lr_t.data_ptr(), n, b1, 1.0 - b1, b2,
                                        1.0 - b2, eps, 1, blocks, 0, stream)
            if err:
                raise RuntimeError(f"adam grid {blocks}: {lib.ddl_cuda_error_string(err)}")

        ring()
        equal = all(bool(torch.equal(a, b)) for a, b in zip((up, um, uv), want))
        out[str(blocks)] = {
            "ms": devtime.device_ms(ring, reps=100, flush=flush, kernel=KERNEL)["ms"],
            "hot_ms": devtime.device_ms(ring, reps=100, kernel=KERNEL)["ms"],
            "after_grad_ms": devtime.device_ms(ring, reps=100, flush=grad_flush,
                                               kernel=KERNEL)["ms"],
            "blocks": blocks, "rounds": -(-tiles // blocks), "tiles": tiles,
            "plan": blocks == plan.blocks, "bit_equal": equal}
        del up, um, uv
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="adam_timing")
    ap.add_argument("--tree", help="time this tree's kernel in this process")
    ap.add_argument("--trees", nargs="+", default=None,
                    help="trees to time, each in its own process, in this order")
    ap.add_argument("--grids", action="store_true",
                    help="also time the float4 kernel at other grids than its plan's")
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.tree:
        run_tree(args.tree, args.grids, emit)
        return 0
    trees = [os.path.abspath(t) for t in args.trees or [os.path.dirname(os.path.dirname(HERE))]]
    for i, tree in enumerate(trees):
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree]
        cmd += ["--grids"] if args.grids else []
        cmd += ["--out", os.path.abspath(args.out)] if args.out else []
        print(json.dumps({"run": i, "tree": tree}), flush=True)
        subprocess.run(cmd, check=True, cwd=tree)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
