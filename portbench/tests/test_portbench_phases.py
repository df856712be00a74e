"""The phase split (``harness/phases.py``) on the CPU: hand-made events in
the style of ``test_portbench_harness.py``'s, and the program's own step
under a CPU profiler.

- the harness's phase names are the program's ``obs.trace.STEP_PHASES``;
- a launch belongs to the innermost phase range whose host interval holds
  its call, on any thread; its device operation and the idle gap that
  operation ends go to that phase; launches inside the window and outside
  every phase are the unattributed remainder; launches before the window
  count nowhere;
- the phases and the remainder add up to ``trace.reduce``'s totals on the
  same events;
- a trace without phase ranges reads None, and the tool's report then
  only the families; with them, each phase by family and kernel;
- the program's step, profiled as a ``--trace 1`` run profiles it, opens
  each phase once a step inside the window.
"""

import pathlib
import sys
from types import SimpleNamespace as NS

import pytest
import torch
from torch.autograd import DeviceType

BENCH = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH.parent))

from portbench.harness import phases, spec, traffic  # noqa: E402
from portbench.harness.trace import reduce  # noqa: E402

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, dev, start, end, cid=-1, thread=1):
    return NS(name=name, device_type=dev, time_range=NS(start=start, end=end), id=cid,
              thread=thread, cpu_parent=None)


def phased_events(with_phases=True):
    """One step in the window [100, 1000]: forward [110, 200] with a launch
    on the step's thread, backward [200, 400] with a launch on autograd's
    thread, grad_sync [400, 450] with a memcpy, a launch between phases,
    optimizer [500, 600] with two launches (the second's device operation
    starts after a gap), health [600, 610] with none; and a launch before
    the window. Device clock offset by 5000."""
    rng = [("step/forward", 110, 200), ("step/backward", 200, 400),
           ("step/grad_sync", 400, 450), ("step/optimizer", 500, 600),
           ("step/health", 600, 610)] if with_phases else []
    return ([ev("portbench_window", CPU, 100.0, 1000.0)]
            + [ev(n, CPU, float(s), float(e)) for n, s, e in rng]
            + [ev("cudaLaunchKernel", CPU, 50.0, 51.0, 1),
               ev("cudaLaunchKernel", CPU, 120.0, 121.0, 2),
               ev("cudaLaunchKernel", CPU, 250.0, 251.0, 3, thread=2),
               ev("cudaMemcpyAsync", CPU, 410.0, 411.0, 4),
               ev("cudaLaunchKernel", CPU, 470.0, 471.0, 5),
               ev("cudaLaunchKernel", CPU, 510.0, 511.0, 6),
               ev("cuLaunchKernel", CPU, 520.0, 521.0, 7),
               ev("before_window_kernel", CUDA, 5000.0, 5100.0, 1),
               ev("nvjet_tst_256x128", CUDA, 5200.0, 5300.0, 2),
               ev("flash_bwd_dq_kernel", CUDA, 5300.0, 5500.0, 3),
               ev("Memcpy DtoD (Device -> Device)", CUDA, 5500.0, 5520.0, 4),
               ev("vectorized_elementwise_kernel", CUDA, 5520.0, 5530.0, 5),
               ev("multi_tensor_apply_kernel", CUDA, 5530.0, 5570.0, 6),
               ev("vectorized_elementwise_kernel", CUDA, 5600.0, 5650.0, 7)])


def test_the_phase_names_are_the_programs():
    from ddl_tpu_torch.obs.trace import STEP_PHASES

    assert phases.PHASES == STEP_PHASES


def test_work_goes_to_the_phase_whose_range_holds_its_launch_on_any_thread():
    sp = phases.split(phased_events(), steps=2)
    assert sp.device_s == pytest.approx({
        "step/forward": 100e-6, "step/backward": 200e-6, "step/grad_sync": 20e-6,
        "step/optimizer": 90e-6, "step/health": 0.0, "unattributed": 10e-6})
    assert sp.kernels["step/optimizer"] == pytest.approx({
        "multi_tensor_apply_kernel": 40e-6, "vectorized_elementwise_kernel": 50e-6})
    assert sp.idle_s == pytest.approx({
        "step/forward": 0.0, "step/backward": 0.0, "step/grad_sync": 0.0,
        "step/optimizer": 30e-6, "step/health": 0.0, "unattributed": 0.0})
    assert sp.launches == {"step/forward": 1, "step/backward": 1, "step/grad_sync": 0,
                           "step/optimizer": 2, "step/health": 0, "unattributed": 1}
    assert sp.ms_per_step("device_s")["step/backward"] == pytest.approx(0.1)
    assert sp.ms_per_step("idle_s")["step/optimizer"] == pytest.approx(0.015)


def test_the_phases_add_up_to_the_reducers_totals():
    events = phased_events()
    sp, tr = phases.split(events, steps=2), reduce(events, steps=2, window_s=1e-3)
    assert sum(sp.device_s.values()) == pytest.approx(tr.seconds())
    assert sum(sp.idle_s.values()) == pytest.approx(sum(s for _, s in tr.gaps))
    assert sum(sp.launches.values()) == tr.launches


def test_a_trace_without_phase_ranges_reads_none():
    assert phases.split(phased_events(with_phases=False), steps=2) is None


def test_the_tools_report_splits_each_phase_by_family_and_kernel():
    sys.path.insert(0, str(BENCH))
    import phase_split

    got = phase_split.report(phased_events(), steps=2, window_s=1e-3)
    assert got["families_ms_per_step"] == pytest.approx(
        {"matmul": 0.05, "flash": 0.1, "other": 0.06})
    ph = got["phases"]
    assert ph["device_ms_per_step"]["step/optimizer"] == pytest.approx(0.045)
    assert ph["idle_ms_per_step"]["step/optimizer"] == pytest.approx(0.015)
    assert ph["launches_per_step"]["step/optimizer"] == 1.0
    assert ph["families_ms_per_step"]["step/backward"] == pytest.approx({"flash": 0.1})
    assert ph["families_ms_per_step"]["step/forward"] == pytest.approx({"matmul": 0.05})
    assert [n for n, _ in ph["top_kernels_ms_per_step"]["step/optimizer"]] == [
        "vectorized_elementwise_kernel", "multi_tensor_apply_kernel"]
    assert phase_split.report(phased_events(with_phases=False), 2, 1e-3)["phases"] is None


def test_the_programs_step_opens_each_phase_once_a_step_inside_the_window():
    sys.path.insert(0, str(BENCH))
    import phase_split
    from portbench.runners import lm_train

    real = spec.load_cell("pythia-410m.finetune-t512")
    config = dict(real.config, vocab_size=64, hidden_size=32, num_attention_heads=2,
                  num_hidden_layers=1, intermediate_size=64)
    cell = spec.Cell(real.name, dict(real.workload, batch=2), config,
                     dict(real.traffic, seq_len=16, distinct_batches=3))
    dev = torch.device("cpu")
    data = traffic.generate(cell.traffic, cell.batch, config["vocab_size"], 2**31 + 7)
    prog = lm_train.build(cell, 2**31 + 7, dev, data)
    events, window_s = phase_split.profiled(prog, dev, steps=2)
    lo, hi = next((e.time_range.start, e.time_range.end) for e in events
                  if e.name == "portbench_window")
    opened = sorted((e.time_range.start, e.name) for e in events
                    if e.name in phases.PHASES and lo <= e.time_range.start <= hi)
    assert [name for _, name in opened] == list(phases.PHASES) * 2
    assert window_s > 0 and phases.split(events, steps=2) is not None
