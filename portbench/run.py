"""Run one cell of the port's benchmark once, on the card of the machine
it is started on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the result reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (a
profiled session after the window). The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit); the same numbers end standard
error. Without a CUDA card, or with fewer than the cell asks for, it
exits 2 and prints no result; nothing falls back to the CPU.

The cell is found by name (``workloads/<cell>.json``), its traffic kind
names the runner (``runners/<kind>.py``), and each per-layer metric of
``BENCHMARK.json`` is read by ``metrics/<metric>.py``. Build and kernel
caches go to ``.portbench_cache/`` in the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ddl_tpu")  # top-level module names


def _caches() -> None:
    """Every cache a build or a compiler may write, at a fixed path inside
    the checkout (the port's own kernels build into ``ddl_tpu_torch/_build``)."""
    base = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> int:
    """``device``: where to run instead of the first card; given, the look
    for a card is skipped (the tests drive a run on the CPU so)."""
    args = parse(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import spec

    bench = spec.benchmark()
    cell = spec.load_cell(args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    readers = {}
    if args.trace:
        readers = {m["name"]: (m["unit"], reader(m["name"]))
                   for m in spec.metrics_for(bench, "per_layer", cell.name)}
    runner = importlib.import_module(f"portbench.runners.{cell.traffic['kind']}")
    result, checks = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, T0,
                                readers)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
