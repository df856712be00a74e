"""Structured span tracing — the port of ``ddl_tpu/obs/trace.py``:
nestable host wall-clock spans and instant events as JSONL.

One record a line, so a trace survives a crash mid-run and concatenates
across processes. Each record carries both clocks: ``t``/``t0`` are
``time.perf_counter`` (every in-run computation uses these) and ``t_wall``
is ``time.time`` (correlation across hosts and files), plus ``pid`` and
``process_index`` (the ``torch.distributed`` rank) so several ranks' files
merge::

    {"type": "span",  "name": ..., "t0": ..., "t": ..., "dur_s": ...,
     "depth": ..., "seq": ..., "pid": ..., "process_index": ...,
     "t_wall": ..., "attrs": {...}}
    {"type": "event", "name": ..., "t": ..., "depth": ..., ...}

Spans nest (``depth``; a record is written at span END, so a child's
precedes its parent's). ``chrome_trace_events`` converts records to the
Chrome/Perfetto ``trace_event`` format; ``python -m ddl_tpu_torch.obs.trace
in.jsonl out.json`` converts a file.

Two sinks, two clocks. The JSONL records are on ``perf_counter``, which no
profiler shares. The second sink is the profiler's: while a
``torch.profiler`` session records, :func:`phase` opens a
``record_function`` range on the profiler's host clock, the one it stamps
each kernel launch with, and ``Tracer.span`` opens one under its own name.
So in a ``--trace-dir`` run (``trace_context``) every span, and each phase
of the LM step (:data:`STEP_PHASES`), is a range of the profiler's Chrome
trace, and the device work it launched is found by the launches' host
times, never by device timestamps, whose clock is offset from the host's
for a whole session on a card. ``complete`` records are written after the
fact and get no range.

``NULL_TRACER`` is the disabled instance: same API, no records, and FALSY,
so call sites guard clock reads with ``if tracer:`` and a disabled run pays
not even the ``perf_counter`` calls. Outside a profiler session
:func:`phase` returns one shared null context: a flag read, no allocation.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

# The LM step's phases (strategies/seq.py), in the order a step opens them.
STEP_PHASES = ("step/forward", "step/backward", "step/grad_sync", "step/optimizer",
               "step/health")

_NULL = contextlib.nullcontext()


def phase(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler session
    records, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def _process_index() -> int:
    """This process's ``torch.distributed`` rank, 0 outside a world. Read
    lazily at the first emit or context entry, never at import."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Tracer:
    """JSONL span/event emitter. ``path=None`` keeps records in memory
    only (``self.records`` — the test/derivation surface); with a path,
    records stream to disk and are ALSO kept when ``keep=True``."""

    def __init__(self, path: str | os.PathLike | None = None, *,
                 keep: bool | None = None):
        self._path = os.fspath(path) if path is not None else None
        self._file = None
        self._keep = keep if keep is not None else self._path is None
        self.records: list[dict] = []
        self._depth = 0
        self._seq = 0
        self._pid = os.getpid()
        self._pindex: int | None = None

    def __bool__(self) -> bool:
        return True

    # -- emission ----------------------------------------------------------

    def _emit(self, rec: dict) -> None:
        if self._pindex is None:
            self._pindex = _process_index()
        rec["seq"] = self._seq
        self._seq += 1
        rec["pid"] = self._pid
        rec["process_index"] = self._pindex
        rec["t_wall"] = time.time()
        if self._keep:
            self.records.append(rec)
        if self._path is not None:
            if self._file is None:
                parent = os.path.dirname(self._path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                # "w", matching MetricsWriter: a rerun into the same
                # --trace-dir replaces the old trace — appending would
                # interleave two runs' unrelated monotonic clocks in
                # the Chrome conversion. Crash-safety is unaffected
                # (records still stream line by line).
                self._file = open(self._path, "w")
            self._file.write(json.dumps(rec) + "\n")

    def event(self, name: str, t: float | None = None, **attrs) -> None:
        """Instant event. ``t`` (``perf_counter`` seconds) defaults to
        now; pass it explicitly to stamp the event with a timestamp you
        also used elsewhere (exact-derivation contract, module doc)."""
        self._emit({
            "type": "event", "name": name,
            "t": time.perf_counter() if t is None else t,
            "depth": self._depth, "attrs": attrs,
        })

    def complete(self, name: str, t0: float, t1: float, **attrs) -> None:
        """A finished span with caller-supplied bracket timestamps."""
        self._emit({
            "type": "span", "name": name, "t0": t0, "t": t1,
            "dur_s": t1 - t0, "depth": self._depth, "attrs": attrs,
        })

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Nestable wall-clock span; the record is emitted at exit (so
        an exception inside still leaves the span on disk)."""
        t0 = time.perf_counter()
        self._depth += 1
        try:
            with phase(name):
                yield self
        finally:
            self._depth -= 1
            self.complete(name, t0, time.perf_counter(), **attrs)

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracer:
    """Disabled tracer: same API, records nothing, and FALSY so call
    sites can skip even their clock reads (``if tracer: ...``)."""

    records: tuple = ()

    def __bool__(self) -> bool:
        return False

    def event(self, name: str, t: float | None = None, **attrs) -> None:
        pass

    def complete(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = NullTracer()
_NULL_SPAN = contextlib.nullcontext(NULL_TRACER)  # gives the tracer, as Tracer.span does


def host_trace_file(trace_dir: str | os.PathLike) -> str:
    """The per-process host-span JSONL path inside ``trace_dir``
    (created): ``host_trace_p<rank>.jsonl``, one file a rank, mergeable by
    concatenation."""
    trace_dir = os.fspath(trace_dir)
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"host_trace_p{_process_index()}.jsonl")


@contextlib.contextmanager
def trace_context(trace_dir: str | os.PathLike | None):
    """Host tracer + the ``torch.profiler`` trace in one directory (None =
    disabled: yields ``NULL_TRACER``, starts nothing). The host spans land
    in ``host_trace_p<rank>.jsonl`` next to the profiler's Chrome trace,
    which holds each span again as a range on the profiler's clock (module
    doc)."""
    if trace_dir is None:
        yield NULL_TRACER
        return
    trace_dir = os.fspath(trace_dir)
    tracer = Tracer(host_trace_file(trace_dir))
    from ..utils.metrics import trace as profiler_trace

    try:
        with profiler_trace(trace_dir):
            yield tracer
    finally:
        tracer.close()


# -- Chrome/Perfetto conversion ---------------------------------------------

# Instant events that mark attribution incidents: rendered GLOBALLY
# scoped (a full-height line on the timeline, not a thread-local tick)
# under a dedicated category, and chained into flow
# arrows so the timeline shows WHERE the incident's time went — a
# guard_skip flows to its guard_rollback, a shed to the request's
# completion record, consecutive anomalies of one signal to each other.
# Fleet incidents: scale/drain/crash render full-height; a
# preempt flows to its resume (both carry req) and on to the request's
# completion record — the timeline shows the hand-off. The names are
# JAX's, so both packages' traces convert alike.
FLEET_EVENTS = ("scale_out", "scale_in", "drain", "preempt", "resume",
                "preempt_move", "replica_crash", "requeue", "handoff")

INCIDENT_EVENTS = frozenset({
    "anomaly", "guard_skip", "guard_rollback", "shed", "router_shed",
    "deadline_exceeded", "slo_alert",
    *FLEET_EVENTS,
})


def _flow_key(name: str, attrs: dict):
    """The identity a flow chain follows: the request for lifecycle
    incidents (a preempt chains to its resume to the completion), the
    signal for anomalies, the rule for SLO alerts, the replica for
    fleet scale/drain/crash events (a drain flows into the scale_in
    that removes the replica), one shared chain for the trainer guard
    (its skips flow into the rollback that resolves them)."""
    if "req" in attrs:
        return ("req", attrs["req"])
    if "signal" in attrs:
        return ("signal", attrs["signal"])
    if "rule" in attrs:
        return ("rule", attrs["rule"])
    if "replica" in attrs:
        return ("replica", attrs["replica"])
    if name.startswith("guard_"):
        return ("guard", "train")
    return None


def chrome_trace_events(records) -> list[dict]:
    """Tracer records -> Chrome ``trace_event`` list (``ph``="X"
    complete events for spans, "i" instants for events; timestamps in
    microseconds of the monotonic clock). Incident instants
    (:data:`INCIDENT_EVENTS`) carry ``cat="incident"``, global scope,
    and flow (``s``/``t``/``f``) chains as above. Wrap in
    ``{"traceEvents": [...]}`` or pass through :func:`convert`."""
    out = []
    chains: dict[tuple, list[dict]] = {}
    for r in records:
        base = {
            "name": r["name"],
            "pid": r.get("pid", 0),
            "tid": r.get("process_index", 0),
            "args": r.get("attrs", {}),
        }
        if r.get("type") == "span":
            out.append({**base, "ph": "X", "ts": r["t0"] * 1e6,
                        "dur": r["dur_s"] * 1e6})
            continue
        inst = {**base, "ph": "i", "ts": r["t"] * 1e6, "s": "t"}
        attrs = r.get("attrs", {})
        name = r["name"]
        incident = name in INCIDENT_EVENTS
        if incident:
            inst["s"] = "g"
            inst["cat"] = "incident"
        out.append(inst)
        # Flow chains: every incident joins its key's chain; a
        # request's `complete` instant terminates that request's chain
        # (so shed/deadline incidents point at the completion record)
        # without itself opening one.
        key = _flow_key(name, attrs)
        if key is not None and (incident or (name == "complete"
                                             and key in chains)):
            chains.setdefault(key, []).append(inst)
    for flow_id, key in enumerate(sorted(chains, key=str), start=1):
        chain = chains[key]
        if len(chain) < 2:
            continue
        for i, inst in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            flow = {
                "name": f"incident:{key[0]}={key[1]}",
                "cat": "incident_flow", "ph": ph, "id": flow_id,
                "ts": inst["ts"], "pid": inst["pid"], "tid": inst["tid"],
            }
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice's end
            out.append(flow)
    return sorted(out, key=lambda e: (e["ts"], e["name"], e["ph"]))


def read_jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def convert(src, dst) -> int:
    """JSONL trace file -> Chrome ``trace_event`` JSON file; returns the
    event count."""
    events = chrome_trace_events(read_jsonl(src))
    with open(dst, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a ddl_tpu_torch host-trace JSONL file to a "
                    "Chrome/Perfetto trace_event JSON file "
                    "(open at https://ui.perfetto.dev)"
    )
    ap.add_argument("src", help="host_trace_p*.jsonl input")
    ap.add_argument("dst", help="trace_event JSON output")
    args = ap.parse_args(argv)
    n = convert(args.src, args.dst)
    # sys.stdout.write, not print: library code routes through the
    # tracer/registry — tests/test_no_stray_prints.py enforces it, and
    # this one-line converter report is not worth an exemption.
    import sys

    sys.stdout.write(f"[obs.trace] wrote {n} trace events to {args.dst}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
