"""Offline trace and metrics analysis — the port of
``ddl_tpu/obs/analyze.py``, with its JSON, texts and exit codes::

    python -m ddl_tpu_torch.obs.analyze report  TRACE.jsonl   [--json] [--top N]
    python -m ddl_tpu_torch.obs.analyze comms   ARTIFACT      [--json]
    python -m ddl_tpu_torch.obs.analyze compare OLD NEW [--threshold F]
                                                [--keys SUBSTR ...]
                                                [--ignore SUBSTR ...] [--json]

The record schemas are the two packages' shared ones, so every command
reads traces and metrics files of either package.

``report`` reads a host-trace JSONL file (``--trace-dir``'s
``host_trace_p*.jsonl``) and tells where the run's time went:

- **Goodput**: per-span-name wall-time totals mapped onto the
  ``obs.goodput`` phases (``prefill_chunk`` -> prefill, ``decode_tick`` ->
  decode, ``train/span`` -> compute, ...), with the trace-side goodput
  fraction. The trace carries only closed spans, so the live gauges'
  host and idle residuals are absent.
- **Per-request critical path**: ``submit -> eligible -> admit -> prefill
  -> first_token -> complete`` per request, grouped by traffic class (the
  router's ``route`` events; ``default`` without one). TTFT and ITL come
  from :func:`serve.scheduler.request_slo_samples` /
  :func:`derive_request_slo` themselves, so the report cannot disagree
  with the live SLO surfaces.
- **Stragglers and anomalies**: the slowest-TTFT requests with their
  breakdowns, every ``anomaly`` event, and incident counts (guard skips
  and rollbacks, sheds, deadline evictions, SLO alerts, fleet events).

``comms`` renders the communication story of a
``benchmarks/collective_bytes.py`` JSON artifact (per-topology collective
schedules, the two-roofline fit, the fp32/bf16 gradient-collective byte
ratio of precision twins) or of a ``--metrics-out`` JSONL (the per-program
collective ledger, per-axis bytes, the roofline gauges and
``handoff_bytes_total`` paths of the LAST snapshot). It exits 0 on
well-formed input.

``compare`` diffs two metrics artifacts (``--metrics-out`` JSONL files, by
their LAST snapshot, or plain JSON documents flattened to dotted numeric
leaves) and exits 1 when a shared numeric key moved by more than
``--threshold`` (relative); an identical pair exits 0.

Exit codes: 0 clean, 1 regressions found (compare only), 2 usage or input
errors.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import math
import sys

from .trace import FLEET_EVENTS, read_jsonl

# Span-name -> goodput phase for the trace-side attribution (the
# live-gauge taxonomy of obs.goodput, minus the residual-only phases).
SPAN_PHASE = {
    "prefill_chunk": "prefill",
    "decode_tick": "decode",
    "prefix_copy": "prefix_copy",
    "prefix_map": "prefix_copy",
    "compile": "compile",
    "train/span": "compute",
    "train/eval": "eval",
}
GOODPUT_SPAN_PHASES = ("prefill", "decode", "compute")

# Fleet-incident table rows: every scale, drain, preempt and crash event,
# in trace order, with its tick and actors; the same tuple the Chrome
# converter renders under cat=incident (obs.trace.FLEET_EVENTS).
_FLEET_NAMES = FLEET_EVENTS

_INCIDENT_NAMES = ("guard_skip", "guard_rollback", "shed", "router_shed",
                   "deadline_exceeded", "slo_alert", "anomaly",
                   *_FLEET_NAMES)


def _emit(line: str = "") -> None:
    # sys.stdout.write, as JAX's: the module is library code first.
    sys.stdout.write(line + "\n")


# -- report -------------------------------------------------------------------


def _span_totals(records) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for r in records:
        if r.get("type") != "span":
            continue
        row = out.setdefault(r["name"], {"count": 0, "total_s": 0.0})
        row["count"] += 1
        row["total_s"] += float(r.get("dur_s", 0.0))
    return out


def _class_of(records) -> dict[int, str]:
    """request id -> traffic class from the router's ``route`` events
    (every request without one is ``default`` — the single-engine
    path)."""
    out: dict[int, str] = {}
    for r in records:
        # router_shed carries the class too: a door-shed request never
        # gets a route event (it never reached a replica).
        if r.get("name") in ("route", "router_shed"):
            attrs = r.get("attrs", {})
            out[int(attrs["req"])] = str(attrs.get("cls", "default"))
    return out


def _request_paths(records) -> dict[int, dict]:
    """Per-request critical-path stamps from the lifecycle events."""
    paths: dict[int, dict] = {}

    def at(rid):
        return paths.setdefault(int(rid), {})

    for r in records:
        name = r.get("name")
        attrs = r.get("attrs", {})
        if name in ("submit", "eligible", "admit", "first_token"):
            at(attrs["req"]).setdefault(name, r["t"])
        elif name == "complete":
            p = at(attrs["req"])
            p.setdefault("complete", r["t"])
            p["tokens"] = attrs.get("tokens")
            p["status"] = attrs.get("status", "ok")
        elif name in ("shed", "router_shed", "deadline_exceeded") \
                and "req" in attrs:
            at(attrs["req"]).setdefault(
                "status", "shed" if name == "router_shed" else name
            )
    return paths


def _breakdown(p: dict) -> dict:
    """The critical-path segment durations one request's stamps allow
    (absent stamps -> absent segments; a shed request has no path)."""
    out = {}

    def seg(name, a, b):
        if a in p and b in p:
            out[name] = p[b] - p[a]

    seg("queue_wait_s", "eligible", "admit")
    seg("prefill_s", "admit", "first_token")
    seg("decode_s", "first_token", "complete")
    seg("total_s", "submit", "complete")
    return out


def build_report(records, top: int = 5) -> dict:
    """The full report dict from tracer records (list of dicts — a
    ``Tracer.records`` slice or a read-back JSONL file)."""
    from ..serve.scheduler import derive_request_slo, request_slo_samples

    spans = _span_totals(records)
    phases: dict[str, float] = {}
    other_s = 0.0
    for name, row in spans.items():
        phase = SPAN_PHASE.get(name)
        if phase is None:
            other_s += row["total_s"]
        else:
            phases[phase] = phases.get(phase, 0.0) + row["total_s"]
    if other_s:
        phases["other"] = other_s
    observed = sum(phases.values())
    goodput = sum(phases.get(p, 0.0) for p in GOODPUT_SPAN_PHASES)

    cls_of = _class_of(records)
    samples = request_slo_samples(records)
    grouped = derive_request_slo(
        records, group_by=lambda rid: cls_of.get(rid, "default")
    )
    paths = _request_paths(records)
    per_class: dict[str, dict] = {}
    for rid, p in paths.items():
        cls = cls_of.get(rid, "default")
        row = per_class.setdefault(cls, {
            "requests": 0, "served": 0, "shed": 0, "deadline_exceeded": 0,
            "_sums": {}, "_served": 0,
        })
        row["requests"] += 1
        status = p.get("status", "ok")
        if status in ("shed", "deadline_exceeded"):
            row[status] += 1
        if rid in samples:
            row["served"] += 1
        bd = _breakdown(p)
        if bd:
            row["_served"] += 1
            for k, v in bd.items():
                row["_sums"][k] = row["_sums"].get(k, 0.0) + v
    for cls, row in per_class.items():
        n = row.pop("_served")
        sums = row.pop("_sums")
        row["mean_breakdown_s"] = (
            {k: v / n for k, v in sums.items()} if n else {}
        )
        if cls in grouped:
            ttft, itl = grouped[cls]
            row["ttft_ms"] = {"p50": ttft.p50_ms, "p95": ttft.p95_ms,
                              "p99": ttft.p99_ms}
            row["itl_ms"] = {"p50": itl.p50_ms, "p95": itl.p95_ms,
                             "p99": itl.p99_ms}

    stragglers = sorted(
        ({"req": rid, "class": cls_of.get(rid, "default"),
          "ttft_s": samples[rid][0], **_breakdown(paths.get(rid, {}))}
         for rid in samples),
        key=lambda row: -row["ttft_s"],
    )[:top]

    anomalies = [
        {"signal": r["attrs"].get("signal"), "tick": r["attrs"].get("tick"),
         "value": r["attrs"].get("value"), "z": r["attrs"].get("z")}
        for r in records if r.get("name") == "anomaly"
    ]
    incidents = {
        name: sum(1 for r in records if r.get("name") == name)
        for name in _INCIDENT_NAMES
    }
    fleet = [
        {"kind": r["name"],
         "tick": r["attrs"].get("tick", r["attrs"].get("step")),
         **{k: r["attrs"][k]
            for k in ("replica", "req", "src", "dst", "reason", "pages")
            if k in r["attrs"]}}
        for r in records if r.get("name") in _FLEET_NAMES
    ]
    return {
        "spans": {n: spans[n] for n in sorted(spans)},
        "goodput": {
            "phases_s": {k: phases[k] for k in sorted(phases)},
            "observed_s": observed,
            "goodput_fraction": goodput / observed if observed else 0.0,
        },
        "requests": {
            "count": len(paths),
            "served": len(samples),
            "per_class": {c: per_class[c] for c in sorted(per_class)},
        },
        "stragglers": stragglers,
        "anomalies": anomalies,
        "incidents": incidents,
        "fleet_incidents": fleet,
    }


def _print_report(rep: dict) -> None:
    g = rep["goodput"]
    _emit(f"goodput: {g['goodput_fraction']:.1%} of "
          f"{g['observed_s']:.3f}s traced span time")
    for phase, s in g["phases_s"].items():
        frac = s / g["observed_s"] if g["observed_s"] else 0.0
        _emit(f"  {phase:<12} {s:>10.3f}s  {frac:>6.1%}")
    req = rep["requests"]
    if req["count"]:
        _emit(f"requests: {req['count']} total, {req['served']} served")
        for cls, row in req["per_class"].items():
            ttft = row.get("ttft_ms", {})
            _emit(f"  class {cls}: {row['requests']} requests "
                  f"(shed {row['shed']}, deadline "
                  f"{row['deadline_exceeded']}) ttft p95 "
                  f"{ttft.get('p95', 0.0):.1f}ms")
            for k, v in row["mean_breakdown_s"].items():
                _emit(f"    mean {k:<13} {v * 1e3:>8.1f}ms")
        if rep["stragglers"]:
            _emit("stragglers (by ttft):")
            for s in rep["stragglers"]:
                _emit(f"  req {s['req']} [{s['class']}] ttft "
                      f"{s['ttft_s'] * 1e3:.1f}ms total "
                      f"{s.get('total_s', 0.0) * 1e3:.1f}ms")
    if rep["anomalies"]:
        _emit("anomalies:")
        for a in rep["anomalies"]:
            _emit(f"  tick {a['tick']}: {a['signal']} value {a['value']} "
                  f"z {a['z']:.1f}")
    if rep.get("fleet_incidents"):
        _emit("fleet incidents:")
        for f in rep["fleet_incidents"]:
            who = " ".join(f"{k}={f[k]}"
                           for k in ("replica", "req", "src", "dst",
                                     "reason", "pages") if k in f)
            _emit(f"  tick {f.get('tick')}: {f['kind']:<14} {who}")
    hits = {k: v for k, v in rep["incidents"].items() if v}
    if hits:
        _emit("incidents: " + ", ".join(f"{k}={v}"
                                        for k, v in sorted(hits.items())))


# -- comms --------------------------------------------------------------------


def _load_comms_doc(path: str):
    """``("bench", doc)`` for a ``collective_bytes.py`` JSON artifact
    (recognized by its ``lm`` row list), else ``("metrics",
    metrics_list)`` for a ``--metrics-out`` JSONL's LAST snapshot."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and isinstance(doc.get("lm"), list):
        return "bench", doc
    if isinstance(doc, dict) and doc.get("record") in ("manifest",
                                                       "snapshot"):
        doc = None  # single-line JSONL — fall through to line scan
    if doc is not None:
        raise ValueError(
            f"{path}: JSON document without an 'lm' benchmark section "
            "(not a collective_bytes.py artifact)"
        )
    snapshot = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if rec.get("record") == "snapshot":
            snapshot = rec
    if snapshot is None:
        raise ValueError(
            f"{path}: neither a collective_bytes.py artifact nor a "
            "metrics JSONL with snapshot records"
        )
    return "metrics", snapshot["metrics"]


def _bench_comms_report(doc: dict) -> dict:
    """The comms story of a benchmark artifact: per-topology collective
    schedules, the two-roofline fit (recomputed through
    :func:`obs.comms.fit_roofline` when the artifact predates the
    stored fit), and the fp32/bf16 gradient-collective byte ratio of
    every precision-twin pair (same mode, same mesh)."""
    from .comms import fit_roofline

    rows = []
    for r in doc.get("lm", []):
        by_kind: dict[str, int] = {}
        for o in r.get("collectives", []):
            by_kind[o["op"]] = by_kind.get(o["op"], 0) + o["bytes"]
        rows.append({
            "mode": r.get("mode"), "mesh": r.get("mesh"),
            "precision": r.get("precision", "fp32"),
            "devices": r.get("devices"),
            "by_kind": {k: by_kind[k] for k in sorted(by_kind)},
            "reduce_bytes": r.get("reduce_bytes"),
            "wire_reduce_bytes": r.get("wire_reduce_bytes"),
            "comms_bytes_per_step": r.get("comms_bytes_per_step"),
            "flops_per_step": r.get("flops_per_step"),
            "measured_step_s": r.get("measured_step_s"),
        })
    fit = doc.get("roofline_fit")
    if fit is None:
        fit = fit_roofline([
            {"flops": r["flops_per_step"],
             "bytes": r["comms_bytes_per_step"],
             "measured_s": r["measured_step_s"]}
            for r in rows
        ])
    if fit is not None:
        for i, r in enumerate(rows):
            if i < len(fit.get("model_s", [])):
                r["model_s"] = fit["model_s"][i]
                r["rel_err"] = fit["rel_err"][i]
                comms_s = ((r.get("comms_bytes_per_step") or 0)
                           * fit["inv_bw_s_per_byte"])
                compute_s = ((r.get("flops_per_step") or 0)
                             * fit["inv_peak_s_per_flop"])
                r["bound"] = "comms" if comms_s > compute_s else "compute"
    twins = {}
    for r in rows:
        twins.setdefault((r["mode"], r["mesh"]), {})[r["precision"]] = r
    ratios = []
    for (mode, mesh), by_prec in sorted(twins.items()):
        if "fp32" in by_prec and "bf16" in by_prec:
            # Wire bytes (the as-written schedule) when the artifact
            # carries them: the backend that compiled the artifact may
            # fold bf16 collectives back to f32 (CPU does), so only the
            # pre-optimization schedule can show the policy's ratio.
            def _rb(row):
                wb = row.get("wire_reduce_bytes")
                return wb if wb is not None else row["reduce_bytes"]

            a, b = _rb(by_prec["fp32"]), _rb(by_prec["bf16"])
            ratios.append({
                "mode": mode, "mesh": mesh,
                "fp32_reduce_bytes": a,
                "bf16_reduce_bytes": b,
                "ratio": a / b if b else math.inf,
            })
    return {"source": "bench", "devices": doc.get("devices"),
            "rows": rows, "roofline_fit": fit,
            "precision_ratios": ratios}


def _metrics_comms_report(metrics: list[dict]) -> dict:
    """The comms story of a run's snapshot: the per-program ledger
    (``collective_bytes{kind=,program=}`` and friends), the roofline
    gauges, and the host byte plane (``handoff_bytes_total{path=}``)."""
    programs: dict[str, dict] = {}

    def prog(labels):
        return programs.setdefault(labels.get("program", "?"), {
            "total_bytes": None, "by_kind": {}, "by_axis": {}, "ops": {},
        })

    roofline: dict[str, float] = {}
    handoff: dict[str, float] = {}
    for m in metrics:
        name, labels = m["name"], m.get("labels", {})
        value = m.get("value")
        if name == "collective_bytes_total":
            prog(labels)["total_bytes"] = value
        elif name == "collective_bytes":
            prog(labels)["by_kind"][labels.get("kind", "?")] = value
        elif name == "collective_axis_bytes":
            prog(labels)["by_axis"][labels.get("axis", "?")] = value
        elif name == "collective_ops_total":
            prog(labels)["ops"][labels.get("kind", "?")] = value
        elif name == "handoff_bytes_total":
            handoff[labels.get("path", "?")] = value
        elif name in ("comms_bytes_per_step", "comms_time_model_s",
                      "compute_time_model_s", "step_time_model_s",
                      "comms_fraction"):
            roofline[name] = value
        elif name == "step_bound" and value:
            roofline["bound"] = labels.get("bound", "?")
    return {"source": "metrics",
            "programs": {p: programs[p] for p in sorted(programs)},
            "roofline": roofline, "handoff_bytes": handoff}


def _print_comms_report(rep: dict) -> None:
    if rep["source"] == "bench":
        fit = rep.get("roofline_fit")
        if fit:
            _emit(f"roofline fit: peak {fit['fitted_peak_flops']:.3g} "
                  f"FLOP/s, bw {fit['fitted_bw_bytes_per_s']:.3g} B/s, "
                  f"max rel err {fit['max_rel_err']:.2f}")
        for r in rep["rows"]:
            head = (f"[{r['mode']} {r['mesh']} {r['precision']}] "
                    f"{r['comms_bytes_per_step'] or 0} B/step")
            if "model_s" in r:
                head += (f"  measured {r['measured_step_s'] * 1e3:.1f}ms "
                         f"model {r['model_s'] * 1e3:.1f}ms "
                         f"(err {r['rel_err']:+.0%}, {r['bound']}-bound)")
            _emit(head)
            for k, b in r["by_kind"].items():
                _emit(f"    {k:<18} {b} B")
        for p in rep["precision_ratios"]:
            _emit(f"precision twin [{p['mode']} {p['mesh']}]: "
                  f"fp32/bf16 gradient-collective bytes "
                  f"{p['fp32_reduce_bytes']}/{p['bf16_reduce_bytes']} "
                  f"= {p['ratio']:.2f}x")
        return
    for name, row in rep["programs"].items():
        _emit(f"program {name}: {row['total_bytes']} B")
        for k, b in sorted(row["by_kind"].items()):
            n = row["ops"].get(k)
            _emit(f"    {k:<18} {b} B" + (f"  ({n:.0f} ops)"
                                          if n is not None else ""))
        axes = {a: b for a, b in sorted(row["by_axis"].items()) if b}
        if axes:
            _emit("    axes: " + ", ".join(f"{a}={b} B"
                                           for a, b in axes.items()))
    rl = rep["roofline"]
    if rl:
        parts = [f"{k}={rl[k]:.3g}" for k in
                 ("comms_bytes_per_step", "compute_time_model_s",
                  "comms_time_model_s", "step_time_model_s",
                  "comms_fraction") if k in rl]
        if "bound" in rl:
            parts.append(f"bound={rl['bound']}")
        _emit("roofline gauges: " + " ".join(parts))
    if rep["handoff_bytes"]:
        _emit("handoff bytes: " + ", ".join(
            f"{path}={v:.0f}" for path, v in
            sorted(rep["handoff_bytes"].items())))


# -- compare ------------------------------------------------------------------


def _flatten(obj, prefix: str, out: dict) -> None:
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return
    if isinstance(obj, (int, float)):
        if not (isinstance(obj, float) and math.isnan(obj)):
            out[prefix] = float(obj)
        return
    if isinstance(obj, dict):
        for k in obj:
            _flatten(obj[k], f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(v, f"{prefix}[{i}]", out)


def _snapshot_flat(metrics: list[dict]) -> dict[str, float]:
    """One registry snapshot record's ``metrics`` list -> flat
    ``{name{labels}[:field]: value}`` (histograms expand to
    count/mean/p50/p95/p99)."""
    out: dict[str, float] = {}
    for m in metrics:
        labels = m.get("labels", {})
        base = m["name"]
        if labels:
            body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            base += "{" + body + "}"
        if m.get("kind") == "histogram":
            for field in ("count", "mean", "p50", "p95", "p99"):
                _flatten(m.get(field), f"{base}:{field}", out)
        else:
            _flatten(m.get("value"), base, out)
    return out


def load_metrics_flat(path: str) -> dict[str, float]:
    """Load either artifact shape into a flat numeric dict: a
    ``--metrics-out`` JSONL file uses its LAST snapshot record (the
    final state a clean exit always forces); anything else is treated
    as a plain JSON document and flattened to dotted leaves."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and doc.get("record") in ("manifest",
                                                       "snapshot"):
        # A SINGLE-line metrics JSONL (e.g. a run that died before its
        # first snapshot flush leaves only the manifest) parses as one
        # JSON document — without this check it would be flattened as
        # a bench artifact and compare would diff manifest leaves
        # (pid, t_wall) as "regressions". Route it to the JSONL
        # handling below instead, where a snapshot-less file is the
        # documented input error.
        doc = None
    if isinstance(doc, (dict, list)):
        out: dict[str, float] = {}
        _flatten(doc, "", out)
        return out
    snapshot = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if rec.get("record") == "snapshot":
            snapshot = rec
    if snapshot is None:
        raise ValueError(
            f"{path}: neither a JSON document nor a metrics JSONL with "
            "snapshot records"
        )
    return _snapshot_flat(snapshot["metrics"])


def compare_metrics(old: dict[str, float], new: dict[str, float],
                    threshold: float, keys=(), ignore=()) -> list[dict]:
    """Relative deltas of the SHARED numeric keys exceeding
    ``threshold`` (sorted worst first). ``keys``/``ignore`` are
    substring-or-glob selectors applied to the flattened key names."""

    def selected(key: str) -> bool:
        if keys and not any(s in key or fnmatch.fnmatch(key, s)
                            for s in keys):
            return False
        return not any(s in key or fnmatch.fnmatch(key, s) for s in ignore)

    out = []
    for key in sorted(set(old) & set(new)):
        if not selected(key):
            continue
        a, b = old[key], new[key]
        if a == b:
            continue
        rel = (b - a) / abs(a) if a != 0 else math.inf
        if abs(rel) > threshold:
            out.append({"key": key, "old": a, "new": b, "rel": rel})
    out.sort(key=lambda r: -abs(r["rel"]))
    return out


# -- CLI ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ddl_tpu_torch.obs.analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="goodput / critical-path / anomaly "
                                       "report from a host-trace JSONL")
    rp.add_argument("trace", help="host_trace_p*.jsonl input")
    rp.add_argument("--top", type=int, default=5,
                    help="straggler rows to show (default 5)")
    rp.add_argument("--json", action="store_true")
    mp = sub.add_parser("comms", help="communication story of a "
                                      "collective_bytes.py artifact or a "
                                      "--metrics-out JSONL")
    mp.add_argument("artifact")
    mp.add_argument("--json", action="store_true")
    cp = sub.add_parser("compare", help="diff two metrics artifacts; exit 1 "
                                        "past --threshold")
    cp.add_argument("old")
    cp.add_argument("new")
    cp.add_argument("--threshold", type=float, default=0.1,
                    help="relative-change gate (default 0.1 = 10%%)")
    cp.add_argument("--keys", nargs="*", default=[],
                    help="only keys containing/matching any of these")
    cp.add_argument("--ignore", nargs="*", default=[],
                    help="skip keys containing/matching any of these")
    cp.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        try:
            records = read_jsonl(args.trace)
            rep = build_report(records, top=args.top)
            if args.json:
                _emit(json.dumps(rep))
            else:
                _print_report(rep)
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError) as e:
            # Exit-code contract (module docstring): malformed input —
            # unreadable file OR schema-broken records (a lifecycle
            # event missing its req, a span without a name) — is a
            # usage/input error (2), never a traceback.
            _emit(f"[obs.analyze] cannot analyze trace {args.trace}: "
                  f"{type(e).__name__}: {e}")
            return 2
        return 0

    if args.cmd == "comms":
        try:
            kind, payload = _load_comms_doc(args.artifact)
            rep = (_bench_comms_report(payload) if kind == "bench"
                   else _metrics_comms_report(payload))
        except (OSError, json.JSONDecodeError, KeyError, TypeError,
                ValueError) as e:
            _emit(f"[obs.analyze] cannot analyze comms artifact "
                  f"{args.artifact}: {type(e).__name__}: {e}")
            return 2
        if args.json:
            _emit(json.dumps(rep))
        else:
            _print_comms_report(rep)
        return 0

    if args.threshold <= 0:
        _emit("[obs.analyze] --threshold must be > 0")
        return 2
    try:
        old = load_metrics_flat(args.old)
        new = load_metrics_flat(args.new)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        _emit(f"[obs.analyze] cannot load metrics: {e}")
        return 2
    regressions = compare_metrics(old, new, args.threshold,
                                  keys=args.keys, ignore=args.ignore)
    shared = len(set(old) & set(new))
    if args.json:
        # rel can be math.inf (old == 0, new != 0); json.dumps would
        # emit the bare token `Infinity`, which is not legal JSON —
        # strict consumers (jq, JSON.parse) must keep parsing exactly
        # when a 0-to-nonzero regression was found.
        _emit(json.dumps({"shared_keys": shared,
                          "threshold": args.threshold,
                          "regressions": [
                              {**r, "rel": ("inf" if math.isinf(r["rel"])
                                            else r["rel"])}
                              for r in regressions
                          ]}))
    else:
        _emit(f"[obs.analyze] {shared} shared keys, threshold "
              f"{args.threshold:.0%}: {len(regressions)} past it")
        for r in regressions[:20]:
            rel = ("inf" if math.isinf(r["rel"])
                   else f"{r['rel']:+.1%}")
            _emit(f"  {r['key']}: {r['old']:.6g} -> {r['new']:.6g} ({rel})")
        if len(regressions) > 20:
            _emit(f"  ... and {len(regressions) - 20} more")
    return 1 if regressions else 0


if __name__ == "__main__":
    raise SystemExit(main())
