"""The readings that the latent-attention and expert cell's limits are set
from, on the card, at the cell's own sizes (the benchmark's own runs never
run this; ``calibrate.py`` does the same for the dense cells):

    python3 portbench/calibrate_mla_moe.py [--workload <cell>] [--seeds 8]
        [--first-seed 2147483701] [--own-seeds 8] [--control-seeds 4]
        [--fault-seeds 3] [--router-seeds 2]

For each seed the program runs the checked steps as the cell runs them,
recording its chosen experts; against it are read (one JSON line each):

- ``program``: the reference taking the program's choices (the cell's
  comparison), and ``own``: the reference routing on its own (on the first
  ``--own-seeds``), which is the comparison without the replay;
- ``control``: the reference with float8 e4m3 products, taking the same
  choices (first ``--control-seeds``);
- ``half_batch``, ``double_leaf``: the program with each fault of
  ``harness/faults.py`` planted under its step, against the sound run's
  reference (first ``--fault-seeds``);
- ``softmax_router``, ``bias_ignored``, ``bias_as_weight``: the program
  with a wrong router (first ``--router-seeds``), against a reference
  taking its choices (the first two) or the sound run's (the third, whose
  choices are the sound ones).

Each line carries the three gaps, ``route_agreement`` (the mean over the
expert layers, as the cell reads it), the first layer's and each layer's,
and ``route_replay`` (the smallest over the expert layers, as the cell
reads it; the control replays in float8) and each layer's; the last line
the largest program reading and the smallest of every other kind
(agreements and replays: the smallest program and largest other).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SEED_STRIDE = 7919


def routers(mla_moe, torch):
    """The wrong routers, each with ``mla_moe.route``'s signature."""
    def softmax(x, router, bias, spec):
        s = torch.softmax(mla_moe._Gate.apply(x, router), -1)
        chosen = torch.topk(s.detach() + bias, spec.top_k, dim=-1).indices
        w = s.gather(-1, chosen)
        return chosen, w * (spec.routed_scale / w.sum(-1, keepdim=True))

    sound = mla_moe.route

    def bias_ignored(x, router, bias, spec):
        return sound(x, router, torch.zeros_like(bias), spec)

    def bias_as_weight(x, router, bias, spec):
        s = torch.sigmoid(mla_moe._Gate.apply(x, router))
        chosen = torch.topk(s.detach() + bias, spec.top_k, dim=-1).indices
        w = (s + bias).gather(-1, chosen)
        return chosen, w * (spec.routed_scale / w.sum(-1, keepdim=True))

    return {"softmax_router": softmax, "bias_ignored": bias_ignored,
            "bias_as_weight": bias_as_weight}


def main(argv=None, device=None) -> int:
    """``device``: where to run instead of the first card (the tests drive
    a small cell on the CPU so)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="moonlight-16b-a3b-ep8.pretrain-t8192")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--first-seed", type=int, default=2147483701)
    ap.add_argument("--own-seeds", type=int, default=8)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--router-seeds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    from ddl_tpu_torch.models import mla_moe
    from portbench.harness import faults, spec, verdict
    from portbench.runners import lm_train, mla_moe_train as mt

    if device is None and not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = device or torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    wrong = routers(mla_moe, torch)
    seen: dict[str, list[dict]] = {}

    def emit(kind, seed, got, ref, shares, replay, t0):
        """``shares``: each expert layer's route agreement, whose mean the
        check reads; ``replay``: each expert layer's route replay, whose
        smallest the check reads."""
        values = dict(verdict.gaps(got, ref), route_agreement=sum(shares) / len(shares),
                      route_agreement_first=shares[0], route_replay=min(replay))
        seen.setdefault(kind, []).append(values)
        print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind, **values,
                          "layers": [round(x, 5) for x in shares],
                          "replay_layers": [round(x, 6) for x in replay],
                          "seconds": time.perf_counter() - t0}), flush=True)

    def program(seed, data, wrap=None):
        prog = mt.build(cell, seed, dev, data, wrap)
        got = mt.checked_steps(prog, cell, seed, dev)
        del prog
        lm_train.free(dev)
        return got

    def replay(seed, rows, routes, quant=False):
        out = mt.router_replay(cell, seed, dev, rows, routes[0], quant)
        lm_train.free(dev)
        return out

    def reference(seed, data, routes, quant=False):
        out = mt.reference_follow(cell, seed, dev, data, routes=routes, quant=quant)
        lm_train.free(dev)
        return out

    for i in range(args.seeds):
        seed = args.first_seed + i * SEED_STRIDE
        data = mt.generate(cell, seed)
        t0 = time.perf_counter()
        got, routes, rows = program(seed, data)
        exact = replay(seed, rows, routes)
        ref, agreement = reference(seed, data, routes)
        print(json.dumps({"cell": cell.name, "seed": seed, "kind": "reference",
                          "losses": ref.losses, "program_losses": got.losses}), flush=True)
        emit("program", seed, got, ref, agreement, exact, t0)
        if i < args.own_seeds:
            t0 = time.perf_counter()
            own, _ = reference(seed, data, None)
            emit("own", seed, got, own, [1.0], [1.0], t0)
        if i < args.control_seeds:
            t0 = time.perf_counter()
            ctl, ctl_agreement = reference(seed, data, routes, quant=True)
            emit("control", seed, ctl, ref, ctl_agreement, replay(seed, rows, routes, True), t0)
        if i < args.fault_seeds:
            for fault in ("half_batch", "double_leaf"):
                t0 = time.perf_counter()
                bad = program(seed, data, faults.FAULTS[fault])[0]
                cut = fault == "half_batch"  # its choices cover half the batch
                emit(fault, seed, bad, ref, [0.0] if cut else agreement, [0.0] if cut else exact,
                     t0)
        if i < args.router_seeds:
            for name, fn in wrong.items():
                t0 = time.perf_counter()
                sound = mla_moe.route
                mla_moe.route = fn
                try:
                    bad, bad_routes, bad_rows = program(seed, data)
                finally:
                    mla_moe.route = sound
                bad_exact = replay(seed, bad_rows, bad_routes)
                del bad_rows
                if name == "bias_as_weight":
                    emit(name, seed, bad, ref, agreement, bad_exact, t0)
                else:
                    bref, bad_agreement = reference(seed, data, bad_routes)
                    emit(name, seed, bad, bref, bad_agreement, bad_exact, t0)
    summary = {"cell": cell.name, "kind": "summary"}
    for kind, rows in seen.items():
        pick = max if kind in ("program", "own") else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in verdict.NUMBERS}
        for k in ("route_agreement", "route_agreement_first", "route_replay"):
            summary[kind][k] = (min if kind in ("program", "own") else max)(r[k] for r in rows)
        summary[kind]["seeds"] = len(rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
