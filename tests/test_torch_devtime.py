"""The device timer (``ddl_tpu_torch/tools/devtime.py``) on the CPU: how it
reads each call's device time from the profiler's events, held to
hand-made events (the profiler records device events only on a card).

- a call's device time is the sum of the device events launched inside its
  range (by the correlation id a device event shares with its runtime
  launch call), restricted to the kernel's name when one is given, however
  far the device timestamps are offset from the host's;
- the device-side copies of the ranges themselves, and device work launched
  outside every range (the L2 flush), never count;
- a range with no device time, or a range count other than the call
  count, raises: nothing falls back to host-side events; the error says
  where the device events no range holds were launched.

And ``tools/step_anatomy.py``'s kernel families take cuBLAS's Hopper
``nvjet_*`` kernels for matrix products.
"""

import types

import pytest
import torch

from ddl_tpu_torch.tools import devtime, step_anatomy

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ev(name, device_type, start, end, id=0):
    return types.SimpleNamespace(name=name, device_type=device_type, id=id,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _trace(calls, offset=0.0):
    """Events of ``calls`` calls 100 us apart: a flush kernel launched
    before each range, the range on the host and its device-side copy, and
    inside it the launches of the kernel (20 us) and of a helper kernel (5
    us). Device timestamps are shifted by ``offset`` us against the host's."""
    events = []
    for i in range(calls):
        t, cid = 100.0 * i, 1000 + 10 * i
        d = t + offset
        events += [
            _ev("cudaLaunchKernel", CPU, t + 1, t + 3, cid),
            _ev("void fill_kernel<uchar>", CUDA, d + 5, d + 30, cid),
            _ev(f"{devtime._TAG}{i}", CPU, t + 40, t + 95, 7 + i),
            _ev(f"{devtime._TAG}{i}", CUDA, d + 50, d + 90, 7 + i),
            _ev("cudaLaunchKernel", CPU, t + 45, t + 47, cid + 1),
            _ev("adam_flat_kernel<true, 4>", CUDA, d + 50, d + 70 + i, cid + 1),
            _ev("cudaLaunchKernel", CPU, t + 48, t + 49, cid + 2),
            _ev("void helper", CUDA, d + 80, d + 85, cid + 2),
            _ev("cudaDeviceSynchronize", CPU, t + 50, t + 94, cid + 3),
            _ev("aten::empty", CPU, t + 41, t + 42, 900 + i),
        ]
    return events


def test_per_call_sums_device_events_inside_each_range():
    per_call, names, _ = devtime.per_call_ms(_trace(3), 3)
    assert per_call == pytest.approx([0.025, 0.026, 0.027])
    assert names == {"adam_flat_kernel<true, 4>", "void helper"}


def test_per_call_counts_only_the_named_kernel():
    per_call, names, _ = devtime.per_call_ms(_trace(3), 3, kernel="adam_flat_kernel")
    assert per_call == pytest.approx([0.020, 0.021, 0.022])
    assert names == {"adam_flat_kernel<true, 4>"}


def test_ranges_in_call_order_whatever_the_event_order():
    events = _trace(12)
    per_call, _, _ = devtime.per_call_ms(list(reversed(events)), 12, kernel="adam")
    assert per_call == pytest.approx([0.020 + 0.001 * i for i in range(12)])


@pytest.mark.parametrize("offset", [-1300.0, -250.0, 30.0, 700.0])
def test_device_clock_offset_does_not_move_work_between_calls(offset):
    """The device timestamps may sit far from the host's, by more than a
    kernel's length: each kernel still counts for the call that launched
    it, and the offset shows in device_minus_launch."""
    per_call, names, offsets = devtime.per_call_ms(_trace(20, offset), 20, kernel="adam")
    assert per_call == pytest.approx([0.020 + 0.001 * i for i in range(20)])
    assert names == {"adam_flat_kernel<true, 4>"}
    assert offsets == pytest.approx([(offset + 5) / 1e3] * 20)


def test_a_lost_device_event_raises_for_its_call():
    events = [e for e in _trace(5) if not (e.name.startswith("adam") and e.id == 1021)]
    with pytest.raises(RuntimeError, match="call 2 of 5"):
        devtime.per_call_ms(events, 5, kernel="adam")


@pytest.mark.parametrize("kernel", [None, "flash_fwd_kernel"])
def test_a_range_without_device_time_raises(kernel):
    events = _trace(2)
    if kernel is None:  # drop the second call's device work
        events = [e for e in events if not (e.device_type == CUDA and e.id >= 1011)]
    with pytest.raises(RuntimeError, match="no device time"):
        devtime.per_call_ms(events, 2, kernel=kernel)


def test_the_lost_call_names_where_its_device_events_were_launched():
    # Call 1's kernel launched 1 us after its range closed; call 2's has no
    # launch record at all.
    events = []
    for e in _trace(3):
        if e.name == "cudaLaunchKernel" and e.id == 1011:
            e = _ev(e.name, CPU, 196.0, 197.0, e.id)
        if not (e.name == "cudaLaunchKernel" and e.id == 1021):
            events.append(e)
    with pytest.raises(devtime.MissingDeviceTime, match=r"call 1 of 3 \(its range 55.0 us long; "
                       r"device events no range holds: 2, of them without a launch record 1, "
                       r".*call 1's start: \[56.0\]\)"):
        devtime.per_call_ms(events, 3, kernel="adam")


def test_range_count_must_match_the_calls():
    with pytest.raises(RuntimeError, match="ranges"):
        devtime.per_call_ms(_trace(2), 3)


def test_hbm_rates():
    assert devtime.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert devtime.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert devtime.hbm_bytes_per_s("NVIDIA H200") == 4.8e12


@pytest.mark.parametrize("families", ["CNN_FAMILIES", "LM_FAMILIES", "SERVE_FAMILIES"])
def test_step_anatomy_takes_hopper_cublas_kernels_for_matmul(families):
    fams = getattr(step_anatomy, families)
    assert step_anatomy.family("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", fams) == "matmul"
