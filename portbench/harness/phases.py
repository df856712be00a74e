"""Splits the device work of a profiled session by the phase of the LM step
that launched it, for the program's phase ranges (``step/forward``,
``step/backward``, ``step/grad_sync``, ``step/optimizer``,
``step/health``: ``ddl_tpu_torch.obs.trace.STEP_PHASES``, whose names are
kept here so that a program without them reads as having none).

The ranges and the launch calls are both stamped by the profiler's host
clock, so a launch belongs to the innermost phase range whose host interval
holds the call's start, on whatever thread it was made: on a card autograd
runs the backward on a thread of its own, where no range of the step's
thread is a parent. The device operation that launch made, and the idle
gap that operation ends, go to that phase; launches inside the window and
outside every phase go to :data:`UNATTRIBUTED`. The launches, the device
operations and the gaps are those of ``trace.reduce`` on the same events,
so the phases and the remainder add up to its totals.
"""

from __future__ import annotations

import dataclasses

from .trace import LAUNCH, WINDOW_TAG

PHASES = ("step/forward", "step/backward", "step/grad_sync", "step/optimizer", "step/health")
UNATTRIBUTED = "unattributed"


@dataclasses.dataclass
class Split:
    steps: int
    kernels: dict[str, dict[str, float]]  # phase -> device operation's name -> its seconds
    idle_s: dict[str, float]  # phase -> idle seconds ended by an operation launched in it
    launches: dict[str, int]  # phase -> kernel-launch API calls made in it

    @property
    def device_s(self) -> dict[str, float]:
        """Phase -> device seconds of the operations launched in it."""
        return {k: sum(v.values()) for k, v in self.kernels.items()}

    def ms_per_step(self, what: str) -> dict[str, float]:
        """``device_s`` or ``idle_s`` in ms a step."""
        return {k: 1e3 * v / self.steps for k, v in getattr(self, what).items()}


def split(events, steps: int) -> Split | None:
    """``events``: ``prof.events()`` of a session holding one range named
    ``WINDOW_TAG`` around ``steps`` steps. None where the window holds no
    phase range."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    (lo, hi), = [(e.time_range.start, e.time_range.end) for e in cpu if e.name == WINDOW_TAG]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                    if e.name in PHASES and lo <= e.time_range.start <= hi)
    if not ranges:
        return None
    names = PHASES + (UNATTRIBUTED,)
    out = Split(steps=steps, kernels={k: {} for k in names}, idle_s=dict.fromkeys(names, 0.0),
                launches=dict.fromkeys(names, 0))
    launched: dict[int, str] = {}  # correlation id -> phase
    for e in cpu:
        t = e.time_range.start
        if e.name.startswith("cu") and lo <= t <= hi:
            inner = [(s, name) for s, end, name in ranges if s <= t <= end]
            where = max(inner)[1] if inner else UNATTRIBUTED
            launched.setdefault(e.id, where)
            out.launches[where] += bool(LAUNCH.match(e.name))
    ops = sorted(((e.time_range.start, e.time_range.end, launched[e.id], e.name) for e in events
                  if e.device_type == DeviceType.CUDA and e.id in launched),
                 key=lambda o: o[0])
    end = None
    for s, e, where, name in ops:
        kernels = out.kernels[where]
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e6
        if end is not None and s > end:
            out.idle_s[where] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    return out
