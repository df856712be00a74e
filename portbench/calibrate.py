"""The readings that a training cell's limits are set from, on the card, at
the cell's own sizes (the benchmark's own runs never run this):

    python3 portbench/calibrate.py --workload <cell> [--workload <cell> ...]
        [--seeds 12] [--first-seed 2147483701] [--control-seeds 4] [--fault-seeds 3]

For each seed, the reference follows the cell's checked steps, and against
it are read: the program as the cell runs it (the lower readings); the
control, the reference computed with float8 e4m3 products, the precision
below the configuration's bf16 (on the first ``--control-seeds``); and the
program with each fault of ``harness/faults.py`` planted under its step
(on the first ``--fault-seeds``). Prints one JSON line a reading, then one
a cell: the largest program reading of each number and the smallest of the
control and of each fault. The state left unchanged reads 1 on
``update_gap`` by definition.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SEED_STRIDE = 7919


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2147483701)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--fault-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import faults, spec, traffic, verdict
    from portbench.runners import lm_train

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for name in args.workload:
        cell = spec.load_cell(name)
        seen: dict[str, list[dict]] = {}

        def emit(kind, seed, values, t0):
            seen.setdefault(kind, []).append(values)
            print(json.dumps({"cell": name, "seed": seed, "kind": kind, **values,
                              "seconds": time.perf_counter() - t0}), flush=True)

        def program(seed, data, ref, kind, wrap=None):
            t0 = time.perf_counter()
            prog = lm_train.build(cell, seed, dev, data, wrap)
            got = lm_train.checked_steps(prog, cell, seed, dev)
            del prog
            lm_train.free(dev)
            emit(kind, seed, verdict.gaps(got, ref), t0)

        for i in range(args.seeds):
            seed = args.first_seed + i * SEED_STRIDE
            d = cell.dims()
            data = traffic.generate(cell.traffic, cell.batch, d.vocab, seed)
            t0 = time.perf_counter()
            ref = lm_train.reference_follow(cell, seed, dev, data)
            lm_train.free(dev)
            print(json.dumps({"cell": name, "seed": seed, "kind": "reference",
                              "losses": ref.losses, "seconds": time.perf_counter() - t0}),
                  flush=True)
            program(seed, data, ref, "program")
            if i < args.control_seeds:
                t0 = time.perf_counter()
                ctl = lm_train.reference_follow(cell, seed, dev, data, quant=True)
                lm_train.free(dev)
                emit("control", seed, verdict.gaps(ctl, ref), t0)
            if i < args.fault_seeds:
                for fault in ("half_batch", "double_leaf"):
                    program(seed, data, ref, fault, faults.FAULTS[fault])
        summary = {"cell": name, "kind": "summary"}
        for kind, rows in seen.items():
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(r[k] for r in rows) for k in verdict.NUMBERS}
            summary[kind]["seeds"] = len(rows)
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
