"""The device time of a profiled session launched inside the expert layer's
spans (``moe/route``, ``moe/experts``: the program's
``ddl_tpu_torch.obs.trace.MOE_PHASES``, whose names are kept here so that a
program without them reads as having none).

The rule is ``phases.py``'s, applied to these names: a launch call inside
the window belongs to the innermost of these ranges whose host interval
holds the call's start, on whatever thread either was made (the backward's
``moe/experts`` ranges open and close on autograd's thread), and the device
operation it made counts to that span. Launches outside every such range
count to none.
"""

from __future__ import annotations

from .trace import WINDOW_TAG

SPANS = ("moe/route", "moe/experts")


def device_seconds(events) -> dict[str, float] | None:
    """Span -> device seconds of the operations launched inside it, over
    the window's range (``WINDOW_TAG``) of ``events`` (``prof.events()``).
    None where the window holds none of the spans."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    (lo, hi), = [(e.time_range.start, e.time_range.end) for e in cpu if e.name == WINDOW_TAG]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                    if e.name in SPANS and lo <= e.time_range.start <= hi)
    if not ranges:
        return None
    launched: dict[int, str] = {}  # correlation id -> span
    for e in cpu:
        t = e.time_range.start
        if e.name.startswith("cu") and lo <= t <= hi:
            inner = [(s, name) for s, end, name in ranges if s <= t <= end]
            if inner:
                launched.setdefault(e.id, max(inner)[1])
    out = dict.fromkeys(SPANS, 0.0)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.id in launched:
            out[launched[e.id]] += (e.time_range.end - e.time_range.start) / 1e6
    return out
