"""The harness's data and arithmetic, on the CPU: every cell, configuration
and traffic file parses and names only files that exist, within the
benchmark's name and unit rules; every per-layer metric has its reader;
the FLOP formula; the traffic generator's seeding; and ``run.py``'s
refusal to run without a card."""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import cost, spec, traffic  # noqa: E402
from portbench.reference.lm import Dims, leaf_shapes  # noqa: E402

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_benchmark_keys_and_paths():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert {m["name"] for m in BENCHMARK["end_to_end"]} >= {"setup_s"}


def test_names_units_and_lines():
    names = [c["name"] for c in BENCHMARK["configs"]] + CELLS + [
        m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    names += [w[k] for w in BENCHMARK["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCHMARK["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCHMARK["workloads"] + BENCHMARK["configs"]]
                 + [m["layer"] for m in BENCHMARK["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_names_known_files_and_agrees_with_the_benchmark(cell):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    c = spec.load_cell(cell)
    assert (c.workload["config"], c.workload["traffic"], c.chips, c.workload["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert c.limits and set(c.limits) <= {"loss_gap", "grad_gap", "update_gap"}
    assert all(0 < v < 1 for v in c.limits.values())
    d = c.dims()
    assert d.d_model % d.num_heads == 0 and d.head_dim in (16, 32, 64, 128)
    assert sum(int(np.prod(s)) for s in leaf_shapes(d).values()) == c.config["parameters"]


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_each_configuration_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert set(config["reduced"]) == set(data["published"])
    assert all(data[k] != v for k, v in data["published"].items())


@pytest.mark.parametrize("metric", BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(metric):
    sys.path.insert(0, str(BENCH))
    import run

    assert callable(run.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCHMARK["end_to_end"]}


def test_an_unknown_reader_is_refused():
    sys.path.insert(0, str(BENCH))
    import run

    with pytest.raises(FileNotFoundError):
        run.reader("no_such_metric")


@pytest.mark.parametrize("cell,flops", [("pythia-410m.pretrain-t2048", 3.97e13),
                                        ("pythia-1.4b.pretrain-t2048", 6.94e13),
                                        ("pythia-410m.finetune-t512", 3.60e13)])
def test_the_flop_formula(cell, flops):
    c = spec.load_cell(cell)
    d, b, t = c.dims(), c.batch, c.traffic["seq_len"]
    e, f = d.d_model, d.d_ff
    by_hand = 3 * (d.num_layers * b * ((8 * e * e + 4 * e * f) * t + 2 * t * t * e)
                   + 2 * b * t * e * d.vocab)
    assert cost.train_step_flops(d, b, t) == by_hand
    assert cost.train_step_flops(d, b, t) == pytest.approx(flops, rel=2e-3)


def test_flash_bounds_count_the_causal_half():
    d = Dims(vocab=64, d_model=64, num_heads=1, num_layers=1, d_ff=64)
    least = cost.flash_least_seconds(d, 1, 4096, "NVIDIA H100 80GB HBM3")
    product = 4096 * 4096 * 64  # B H T^2 D: one product over the causal half
    assert least["fwd"] == pytest.approx(2 * product / 989.4e12)
    assert least["bwd_dkv"] == pytest.approx(4 * product / 989.4e12)
    assert least["bwd_dq"] == pytest.approx(max(product / 989.4e12,
                                                (5 * 4096 * 64 * 2 + 2 * 4096 * 4) / 3.35e12))
    with pytest.raises(ValueError):
        cost.peak_bf16_flops("cpu")


@pytest.mark.parametrize("mix", sorted(p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_is_byte_equal_for_one_seed_and_differs_across_seeds(mix):
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    m = dict(m, seq_len=64, distinct_batches=3)  # the generator is the same at any length
    a, b = (traffic.generate(m, 2, 50304, 2**31 + 11) for _ in range(2))
    c = traffic.generate(m, 2, 50304, 2**31 + 12)
    for x, y, z in ((a.tokens, b.tokens, c.tokens), (a.targets, b.targets, c.targets)):
        assert x.tobytes() == y.tobytes() and x.tobytes() != z.tobytes()
    assert a.tokens.min() >= 0 and a.tokens.max() < 50304
    assert (a.tokens[:, 1:] == a.targets[:, :-1]).all() and (a.weights == 1).all()


def test_run_exits_non_zero_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def fake_events():
    """A profiler session's events: the window's range, two launches
    inside it (one by aten::mm, one by aten::mul), one before it, and the
    device events they made."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, start, end, cid=-1, parent=None):
        return NS(name=name, device_type=dev, time_range=NS(start=start, end=end), id=cid,
                  cpu_parent=NS(name=parent) if parent else None)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    return [ev("portbench_window", cpu, 100.0, 1000.0),
            ev("cudaLaunchKernel", cpu, 50.0, 51.0, 1, "aten::add"),
            ev("cudaLaunchKernel", cpu, 110.0, 111.0, 2, "aten::mm"),
            ev("cuLaunchKernel", cpu, 120.0, 121.0, 3, "aten::mul"),
            ev("cudaMemsetAsync", cpu, 130.0, 131.0, 4, "aten::zero_"),
            ev("before_window_kernel", cuda, 5000.0, 5100.0, 1),
            ev("nvjet_tst_256x128", cuda, 5200.0, 5500.0, 2),
            ev("vectorized_elementwise_kernel", cuda, 5400.0, 5600.0, 3),
            ev("Memset (Device)", cuda, 5800.0, 5850.0, 4)]


def test_the_trace_reducer_places_device_work_by_launch():
    from portbench.harness.trace import family, reduce

    tr = reduce(fake_events(), steps=2, window_s=1e-3)
    assert [o[0] for o in tr.ops] == ["nvjet_tst_256x128", "vectorized_elementwise_kernel",
                                      "Memset (Device)"]
    assert tr.launches == 2  # the memset is an API call, not a kernel launch
    assert tr.busy_s() == pytest.approx(450e-6)  # [5200, 5600] and [5800, 5850]
    assert tr.gaps == [("aten::zero_", pytest.approx(200e-6))]
    assert tr.top_ops(1) == [["nvjet_tst_256x128", pytest.approx(300e-6)]]
    assert family("nvjet_tst_256x128") == "matmul"
    assert family("void flash_bwd_dq_kernel<bf16, 64>") == "flash"


def test_readers_on_a_trace_and_on_nothing():
    sys.path.insert(0, str(BENCH))
    import run
    from portbench.harness.trace import Trace, reduce
    from portbench.runners.lm_train import Reading

    d = Dims(vocab=64, d_model=64, num_heads=1, num_layers=1, d_ff=64)
    kind = "NVIDIA H100 80GB HBM3"
    r = Reading(dims=d, batch=1, seq_len=8, kind=kind, step_s=0.5,
                trace=reduce(fake_events(), steps=2, window_s=1e-3))
    assert run.reader("host_launches_per_step.train")(r) == 1.0
    assert run.reader("device_idle_share.train")(r) == pytest.approx(55.0)
    assert run.reader("nonmatmul_ms_per_step")(r) == pytest.approx(0.125)
    assert run.reader("flash_roofline_share")(r) is None  # no flash kernel in the trace
    least = 2 * cost.matmul_least_seconds(d, 1, 8, kind)
    assert run.reader("matmul_roofline_share")(r) == pytest.approx(100 * least / 300e-6)
    flops = cost.train_step_flops(d, 1, 8)
    assert run.reader("train_mfu")(r) == pytest.approx(100 * flops / 0.5 / 989.4e12)
    empty = Reading(dims=d, batch=1, seq_len=8, kind=kind, step_s=0.0,
                    trace=Trace(steps=1, window_s=0.0, ops=[], launches=0, gaps=[]))
    for m in BENCHMARK["per_layer"]:
        assert run.reader(m["name"])(empty) is None, m["name"]
