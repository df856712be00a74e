"""Reduces a ``torch.profiler`` session over a few training steps to what
the per-layer metrics read: each device operation launched inside the
window, the host's kernel launches, the union of device time, and the idle
gaps named by the host operation whose launch ended each gap.

A device event is placed by the correlation id it shares with the runtime
call that launched it, whose host time lies inside the window's range: on
the card the profiler's device and host clocks differ by an offset that
changes from session to session, so device timestamps are compared only
with each other. The kernel family table is a copy of the port's
``tools/step_anatomy.py`` ``LM_FAMILIES``, with cuBLAS's Hopper kernels
(``nvjet``) added to the matrix products.
"""

from __future__ import annotations

import dataclasses
import re

FAMILIES = (
    ("flash", re.compile(r"flash_(fwd|bwd_dkv|bwd_dq)_kernel")),
    ("nccl", re.compile(r"nccl", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|cublas|xmma|sgemm|splitK|nvjet", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)
FLASH_KERNELS = {k: re.compile(rf"flash_{k}_kernel") for k in ("fwd", "bwd_dkv", "bwd_dq")}
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchKernelExC|cuLaunchKernelEx"
                    r"|cudaLaunchCooperativeKernel|cudaGraphLaunch)")
WINDOW_TAG = "portbench_window"


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other"


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float  # host clock, from the window's first launch to its closing barrier
    ops: list[tuple[str, float, float]]  # device (name, start_us, end_us), in start order
    launches: int  # kernel-launch API calls on the host inside the window
    gaps: list[tuple[str, float]]  # (host op that launched the next device op, idle s)

    def seconds(self, keep=lambda name: True) -> float:
        return sum(e - s for n, s, e in self.ops if keep(n)) / 1e6

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.ops:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for name, s, e in self.ops:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list[list]:
        total: dict[str, float] = {}
        for label, sec in self.gaps:
            total[label] = total.get(label, 0.0) + sec
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def reduce(events, steps: int, window_s: float) -> Trace:
    """``events``: ``prof.events()`` of a session holding one range named
    :data:`WINDOW_TAG` around ``steps`` steps."""
    from torch.autograd import DeviceType

    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CPU and e.name == WINDOW_TAG]
    if len(ranges) != 1:
        raise RuntimeError(f"trace: {len(ranges)} window ranges, expected 1")
    lo, hi = ranges[0]
    launched: dict[int, str] = {}  # correlation id -> host op that made the call
    launches = 0
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name.startswith("cu")
                and lo <= e.time_range.start <= hi):
            parent = getattr(e, "cpu_parent", None)
            launched.setdefault(e.id, parent.name if parent is not None else e.name)
            launches += bool(LAUNCH.match(e.name))
    ops = []
    for e in events:
        if e.device_type == DeviceType.CUDA and e.id in launched:
            ops.append((e.name, e.time_range.start, e.time_range.end, launched[e.id]))
    ops.sort(key=lambda o: o[1])
    gaps, end = [], None
    for name, s, e, label in ops:
        if end is not None and s > end:
            gaps.append((label, (s - end) / 1e6))
        end = e if end is None else max(end, e)
    return Trace(steps=steps, window_s=window_s, ops=[o[:3] for o in ops], launches=launches,
                 gaps=gaps)
