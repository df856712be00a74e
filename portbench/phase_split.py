"""Device and idle ms a step of a training cell by the phase of the LM step
that launched the work (``harness/phases.py``), on the card (the
benchmark's own runs never run this):

    python3 portbench/phase_split.py --workload <cell> --seed <n>

The cell's trainer is built as a run builds it and warmed by three steps;
then, as in a ``--trace 1`` run, one profiler session over a step warms the
tracer and a second holds an untimed step and the
``runners/lm_train.py::PROFILED_STEPS`` steps read.
Prints on standard error one line of device ms and one of idle ms a step by
phase, each with the unattributed remainder, and ends standard output with
one JSON object: those, the kernel-launch calls a step by phase, each
phase's device ms by ``harness/trace.py``'s kernel family and its costliest
kernels, the window's matrix-product, flash and other device ms a step, and
its busy and wall seconds. A program that opens no phase range prints the
families and ``"phases": null``.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

TOP = 8  # kernels listed a phase


def profiled(prog, device, steps: int):
    """``runners/lm_train.py::profiled`` over ``steps`` steps, keeping the
    session's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.harness.trace import WINDOW_TAG
    from portbench.runners.lm_train import _sync

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        prog.advance()
        _sync(device)
    with profile(activities=acts) as prof:
        prog.advance()
        _sync(device)
        with record_function(WINDOW_TAG):
            t0 = time.perf_counter()
            for _ in range(steps):
                prog.advance()
            _sync(device)
            window_s = time.perf_counter() - t0
    return prof.events(), window_s


def report(events, steps: int, window_s: float) -> dict:
    """What the tool prints of a session's events, but the cell, the seed
    and the device."""
    from portbench.harness import phases
    from portbench.harness.trace import family, reduce

    tr = reduce(events, steps, window_s)
    ms = lambda keep: 1e3 * tr.seconds(keep) / steps  # noqa: E731
    out = {"steps": steps,
           "families_ms_per_step": {"matmul": ms(lambda n: family(n) == "matmul"),
                                    "flash": ms(lambda n: family(n) == "flash"),
                                    "other": ms(lambda n: family(n) not in ("matmul", "flash"))},
           "busy_s": tr.busy_s(), "window_s": window_s, "phases": None}
    sp = phases.split(events, steps)
    if sp is None:
        return out
    by_family = {k: {} for k in sp.kernels}
    for k, kernels in sp.kernels.items():
        for name, sec in kernels.items():
            fam = family(name)
            by_family[k][fam] = by_family[k].get(fam, 0.0) + 1e3 * sec / steps
    out["phases"] = {"device_ms_per_step": sp.ms_per_step("device_s"),
                     "idle_ms_per_step": sp.ms_per_step("idle_s"),
                     "launches_per_step": {k: v / steps for k, v in sp.launches.items()},
                     "families_ms_per_step": by_family,
                     "top_kernels_ms_per_step": {
                         k: [[n, 1e3 * v / steps] for n, v in
                             sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]]
                         for k, kernels in sp.kernels.items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import spec, traffic
    from portbench.runners import lm_train

    if not torch.cuda.is_available():
        print("phase_split: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    data = traffic.generate(cell.traffic, cell.batch, cell.dims().vocab, args.seed)
    prog = lm_train.build(cell, args.seed, dev, data)
    for _ in range(3):
        prog.advance()
    lm_train._sync(dev)
    events, window_s = profiled(prog, dev, lm_train.PROFILED_STEPS)
    out = {"cell": cell.name, "seed": args.seed, "device": torch.cuda.get_device_name(dev),
           **report(events, lm_train.PROFILED_STEPS, window_s)}
    for what in ("device", "idle") if out["phases"] is not None else ():
        row = out["phases"][f"{what}_ms_per_step"]
        print(f"phases {what}_ms " + " ".join(f"{k.split('/')[-1]} {v!r}" for k, v in row.items()),
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
