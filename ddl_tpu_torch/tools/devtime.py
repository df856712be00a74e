"""Device time of a kernel or a library call on the card, read from the
profiler (CUPTI through ``torch.profiler``).

A kernel's time in this repo is its device time: what CUPTI records for
its own launches. An event pair around one Python call measures more: its
window opens when the host records the start event and so also holds the
host's time to reach the launch (argument checks, ctypes, the runtime).
For a kernel of tens of microseconds that share is large and it wanders
with the host's load, so it is kept beside the device time as ``call_ms``,
never in its place.

Three readings of one callable, each the median over its calls:

- ``ms`` (cold): an L2 flush before every call, a write of a 256 MB scratch
  tensor (five times the H100's 50 MB L2), so the call finds none of its
  bytes in the L2, as in a train step where other work ran in between.
  Bounds and shares of bound are computed from this reading alone.
- ``hot_ms``: no flush; the same buffers call after call, so up to 50 MB of
  them are served from the L2 and the reading can beat the HBM bound.
- ``call_ms``: CUDA events around each Python call, back to back, no flush
  (the reading of earlier PRs); ``call_ms - ms`` shows the host's share.

How a call's device time is read: each call runs inside a
``record_function`` range, closed by a device synchronize. Every device
event (kernel, memset, copy) carries the correlation id of the runtime call
that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and that
call lies inside the range of the Python call that made it on the host's
clock. So a call's device time is the sum of the durations of the device
events whose launch lies in its range. Placing device events by their own
timestamps would not do: on the card the profiler maps the device clock to
the host's with an offset that differs from session to session, by far
more than a kernel's length (``device_minus_launch_ms`` reports it: the
launch latency, a few microseconds, plus that offset). ``kernel`` (a
regular expression) restricts the sum to the kernel's own launches. The
tracer may lose the first device events after it starts, so untimed calls
run first inside the profiler. A range with no device time (the tracer
dropped a record) costs the reading its window: it is taken once more in a
new profiler session, and ``profile_windows`` says how many it took; a
second such window raises. The reading never falls back to events.

Needs a CUDA card.
"""

from __future__ import annotations

import bisect
import math
import re
import statistics
import time
from typing import Callable

import torch

TIMER = "device, cupti"
FLUSH_BYTES = 256 * 2**20
_TAG = "devtime_call_"


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM rate of the card named ``name`` (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM (80GB HBM3)


class L2Flush:
    """Writes a scratch tensor larger than the L2 (``FLUSH_BYTES``): after
    a call the L2 holds none of what came before."""

    def __init__(self, device, nbytes: int = FLUSH_BYTES):
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)

    def __call__(self) -> None:
        self.buf.fill_(1)


def _windows(events) -> list[tuple[float, float]]:
    """(start, end) on the profiler's timeline of each call's range, in
    call order."""
    wins: dict[int, tuple[float, float]] = {}
    for e in events:
        if e.name.startswith(_TAG) and e.device_type == torch.autograd.DeviceType.CPU:
            wins.setdefault(int(e.name[len(_TAG):]), (e.time_range.start, e.time_range.end))
    return [wins[i] for i in sorted(wins)]


class MissingDeviceTime(RuntimeError):
    """A call's range holds no device time."""


def per_call_ms(events, reps: int,
                kernel: str | None = None) -> tuple[list[float], set[str], list[float]]:
    """Each call's device ms from the profiler's events: the device events
    (those matching ``kernel``, if given) launched inside the call's range,
    placed by the correlation id they share with their runtime launch call,
    summed; their names; and, for each counted event, its device start
    minus its launch call's host start in ms (the launch latency, plus the
    profiler's clock offset between the two). Raises if the ranges are not
    ``reps`` or a range holds no device time."""
    wins = _windows(events)
    if len(wins) != reps:
        raise RuntimeError(f"devtime: {len(wins)} profiler ranges for {reps} calls")
    launched_at = {}  # correlation id -> host time of the runtime call
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cu"):
            launched_at.setdefault(e.id, e.time_range.start)
    pat = re.compile(kernel) if kernel else None
    total_us = [0.0] * reps
    names: set[str] = set()
    offsets_ms: list[float] = []
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA or e.name.startswith(_TAG)
                or (pat is not None and not pat.search(e.name))):
            continue
        t = launched_at.get(e.id)
        i = bisect.bisect_right(wins, (t, math.inf)) - 1 if t is not None else -1
        if i >= 0 and t <= wins[i][1]:
            total_us[i] += e.time_range.end - e.time_range.start
            names.add(e.name[:80])
            offsets_ms.append((e.time_range.start - t) / 1e3)
    for i, us in enumerate(total_us):
        if us <= 0:
            raise MissingDeviceTime(f"devtime: the profiler recorded no device time for "
                               f"{kernel or 'the call'} in call {i} of {reps}")
    return [us / 1e3 for us in total_us], names, offsets_ms


def device_ms(fn: Callable[[], object], *, reps: int = 50, warm: int = 3,
              flush: Callable[[], None] | None = None, kernel: str | None = None) -> dict:
    """Device time of ``fn()`` per call over ``reps`` calls (after ``warm``
    untimed ones), with ``flush()`` before each call if given. Only device
    events whose name matches ``kernel`` count, if given. Returns ms
    (median), mean, min, max, the call count, the device events' names and
    the profiler windows taken (2 when the first lost a call's record)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for window in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # Untimed calls first (at least 3, and 20 ms): the tracer may miss
            # device work launched right after it starts.
            t0, warmed = time.perf_counter(), 0
            while warmed < 3 or time.perf_counter() - t0 < 0.02:
                fn()
                torch.cuda.synchronize()
                warmed += 1
            for i in range(reps):
                if flush is not None:
                    flush()
                torch.cuda.synchronize()
                with record_function(f"{_TAG}{i}"):
                    fn()
                    torch.cuda.synchronize()
        try:
            per_call, names, offsets = per_call_ms(prof.events(), reps, kernel)
            break
        except MissingDeviceTime:
            if window == 2:
                raise
    return {"ms": statistics.median(per_call), "mean_ms": statistics.fmean(per_call),
            "min_ms": min(per_call), "max_ms": max(per_call), "calls": reps,
            "device_events": sorted(names), "profile_windows": window,
            "device_minus_launch_ms": [min(offsets), statistics.median(offsets), max(offsets)]}


def call_ms(fn: Callable[[], object], reps: int = 200, warm: int = 10) -> float:
    """Median of CUDA-event pairs, each around one Python call of ``fn``,
    back to back: device time plus the host's time to reach the launch."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def timings(fn: Callable[[], object], flush: L2Flush, *, kernel: str | None = None,
            reps: int = 50, call_reps: int | None = None) -> dict:
    """``ms`` (cold), ``hot_ms`` and ``call_ms`` of ``fn`` (see the module
    docstring), with the cold reading's spread and device events."""
    cold = device_ms(fn, reps=reps, flush=flush, kernel=kernel)
    hot = device_ms(fn, reps=reps, kernel=kernel)
    return {"ms": cold["ms"], "hot_ms": hot["ms"],
            "call_ms": call_ms(fn, call_reps or reps), "timer": TIMER,
            "cold_min_max_ms": [cold["min_ms"], cold["max_ms"]],
            "hot_min_max_ms": [hot["min_ms"], hot["max_ms"]],
            "device_events": cold["device_events"],
            "profile_windows": {"cold": cold["profile_windows"], "hot": hot["profile_windows"]},
            "device_minus_launch_ms": {"cold": cold["device_minus_launch_ms"],
                                       "hot": hot["device_minus_launch_ms"]}}
