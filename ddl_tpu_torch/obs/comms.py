"""The communication plane — the port of ``ddl_tpu/obs/comms.py``: the
per-program collective ledger, the interconnect roofline, and
comms-versus-compute attribution.

JAX reads its ledger out of each compiled program's optimized HLO
(``collective_ops``, ``program_text``). The port has no compiled program to
read, so the collective CALL SITES report themselves instead
(``parallel.collectives.tally`` / ``note``: one ``{op, bytes, group}``
record per collective, bytes the result bytes, as XLA's are), and
:func:`publish_program_ledger` turns the records of a span program's
warm-up call into JAX's gauges: ``collective_bytes{kind=,program=}``,
``collective_axis_bytes{axis=,program=}``, the ``collective_ops_total``
counter and ``collective_bytes_total{program=}`` (present at 0). XLA merges
a few scalar all-reduces across a scanned span, so JAX's ``train_span[k]``
can read a few bytes less than k steps' worth; the tally counts every call.

:func:`grid_axis_labels` maps each process group of the trainer's
``parallel.mesh.Grid`` onto JAX's mesh-axis label (``dp``, ``sp``,
``dpxsp``, ``tp``, ``pp``...: the axes of size > 1 the group spans, joined
with ``x`` in mesh order).

:data:`ICI_BW_BY_KIND` / :func:`ici_bw_per_device`: the interconnect
bandwidth anchor behind ``--ici-bw``, with one NVIDIA row (the H100 SXM5's
NVLink 4, 900 GB/s bidirectional, published) and JAX's CPU fallback;
:func:`roofline` / :func:`fit_roofline`: the two-roofline step-time model
``t = max(flops/peak, bytes/bw)``, ported as is.
"""

from __future__ import annotations

import numpy as np

from ..parallel.mesh import LOCAL

_AXES = ("dp", "sp", "tp", "pp")


def grid_axis_labels(grid) -> dict:
    """``{id(group): axis label}`` for every process group of ``grid``
    (``None``, the world's group, included): the label of the axes of
    size > 1 the group spans, in mesh order, as JAX's
    ``mesh_axis_partitions`` names a collective's replica groups (an axis
    of size 1 adds nothing to a group, and a group whose spanned axes are
    all of size 1 is labelled with its first axis, JAX's smallest-subset
    rule). ``LOCAL``, noted only by the ``(dp, sp)`` sums of a rank alone
    on those axes, takes their label."""
    sizes = {"dp": grid.data_parallel, "sp": grid.num_workers,
             "tp": grid.tensor_parallel, "pp": grid.pipeline_parallel}

    def label(axes):
        big = [a for a in _AXES if a in axes and sizes[a] > 1]
        return "x".join(big) if big else axes[0]

    out = {id(LOCAL): label(("dp", "sp"))}  # the (dp, sp) sums of one rank
    for group, axes in ((grid.shared_group, ("dp", "sp", "pp")),
                        (grid.data_group, ("dp", "sp")),
                        (grid.sp_group, ("sp",)),
                        (grid.tp_group, ("tp",)),
                        (grid.pp_group, ("pp",)),
                        (None, _AXES)):
        if group is not LOCAL:
            out[id(group)] = label(axes)
    return out


def publish_program_ledger(registry, records, *, program: str, grid=None,
                           repeat: int = 1) -> dict:
    """Publish ONE span program's collective ledger on ``registry`` from
    the tallied ``records`` of its warm-up call, each taken ``repeat``
    times (a warm-up of one step stands for a span of ``repeat``), and
    return its summary. Gauges for the byte surfaces (a property of the
    program), the ``collective_ops_total`` counter per (kind, program).
    ``program`` is the ``kind[key]`` label of ``xla_compiles_total``
    (``train_span[3]``, ``eval[0]``); ``grid`` turns each record's group
    into a mesh-axis label (:func:`grid_axis_labels`), else ``unknown``."""
    labels = grid_axis_labels(grid) if grid is not None else {}
    by_kind: dict[str, int] = {}
    by_axis: dict[str, int] = {}
    ops = [r for r in records for _ in range(repeat)]
    for o in ops:
        by_kind[o["op"]] = by_kind.get(o["op"], 0) + o["bytes"]
        axis = labels.get(id(o["group"]), "unknown")
        by_axis[axis] = by_axis.get(axis, 0) + o["bytes"]
        registry.counter(
            "collective_ops_total",
            "collective ops per compiled program (kind=collective op)",
        ).inc(1, kind=o["op"], program=program)
    g = registry.gauge(
        "collective_bytes",
        "static per-program collective result bytes by collective kind",
    )
    for k, b in sorted(by_kind.items()):
        g.set(b, kind=k, program=program)
    ga = registry.gauge(
        "collective_axis_bytes",
        "static per-program collective bytes by mesh axis",
    )
    for a, b in sorted(by_axis.items()):
        ga.set(b, axis=a, program=program)
    total = sum(by_kind.values())
    # Present even at 0: a collective-free program (a single-device
    # span) still proves its ledger published.
    registry.gauge(
        "collective_bytes_total",
        "static per-program collective result bytes, all kinds",
    ).set(total, program=program)
    return {"program": program, "total_bytes": total, "ops": len(ops),
            "by_kind": by_kind, "by_axis": by_axis}


# -- interconnect bandwidth table (the comms twin of cost.PEAK_FLOPS_BY_KIND)

# Per-device interconnect bytes/s by device-name substring (lowercase):
# the H100 SXM5's NVLink 4, 900 GB/s bidirectional (NVIDIA data sheet).
# An anchor for the roofline model, not a measurement: --ici-bw pins a
# real number.
ICI_BW_BY_KIND: tuple[tuple[str, float], ...] = (
    ("h100", 9.0e11),
)

# JAX's nominal host fallback (~10 GB/s): keeps the comms roofline defined
# on CPU smoke runs. An anchor, not a measurement.
CPU_NOMINAL_ICI_BW = 1e10


_warned_kinds: set = set()


def ici_bw_per_device(device=None, override: float | None = None) -> float:
    """Nominal interconnect bytes/s for one device: ``override`` wins;
    else the device-name table; else the CPU nominal fallback. An
    ACCELERATOR the table does not know warns once per kind."""
    if override is not None:
        if override <= 0:
            raise ValueError(
                f"ici bw override must be > 0, got {override}"
            )
        return float(override)
    from .cost import device_kind

    kind, platform = device_kind(device)
    for key, bw in ICI_BW_BY_KIND:
        if key in kind:
            return bw
    if platform != "cpu" and kind not in _warned_kinds:
        import warnings

        _warned_kinds.add(kind)
        warnings.warn(
            f"unknown accelerator device_kind {kind!r}: comms roofline "
            f"gauges will use the CPU nominal anchor "
            f"({CPU_NOMINAL_ICI_BW:.0e} B/s) and read absurdly "
            "comms-bound — pass --ici-bw (or ici_bw=) with the chip's "
            "real link bandwidth",
            stacklevel=2,
        )
    return CPU_NOMINAL_ICI_BW


# -- the two-roofline step-time model -----------------------------------------


def roofline(flops: float, comm_bytes: float, n_devices: int,
             peak_per_device: float, bw_per_device: float) -> dict:
    """The two-roofline step-time model of one step:
    ``compute = flops / (n_devices * peak)``, ``comms = bytes / bw``
    (the ledger's bytes are already per-device result bytes — each
    device's share of the program's collective traffic), and the
    modeled step is their MAX (perfect-overlap assumption — the
    falsifiable claim :func:`fit_roofline` tests). ``comms_fraction``
    is the no-overlap share ``comms / (compute + comms)`` — a live
    dial, not the binding verdict; ``bound`` is the verdict."""
    compute_s = (flops / (n_devices * peak_per_device)
                 if n_devices >= 1 and peak_per_device > 0 else 0.0)
    comms_s = comm_bytes / bw_per_device if bw_per_device > 0 else 0.0
    denom = compute_s + comms_s
    return {
        "compute_time_model_s": compute_s,
        "comms_time_model_s": comms_s,
        "step_time_model_s": max(compute_s, comms_s),
        "comms_fraction": comms_s / denom if denom > 0 else 0.0,
        "bound": "comms" if comms_s > compute_s else "compute",
    }


def fit_roofline(rows, iters: int = 25) -> dict | None:
    """Fit the two parameters of ``t = max(f * inv_peak, b * inv_bw)``
    to measured rows ``{"flops": f, "bytes": b, "measured_s": t}`` —
    the falsification harness: if the two-roofline model is right, ONE
    (inv_peak, inv_bw) pair must explain every topology's measured step
    time at once (the way ``pipeline_bubble.py``'s one alpha had to
    explain every (pp, M) cell).

    Alternating assignment + per-side least squares: classify each row
    by which term currently binds, refit that side's slope on its rows,
    repeat to a fixed point. Returns the fitted peaks, per-row model
    times and relative errors, and ``max_rel_err`` — the fit's
    headline number. ``None`` with fewer than 2 usable
    rows (a 1-row fit is unfalsifiable)."""
    rows = [r for r in rows
            if r.get("measured_s") and r["measured_s"] > 0
            and r.get("flops") and r["flops"] > 0]
    if len(rows) < 2:
        return None
    f = np.array([float(r["flops"]) for r in rows])
    b = np.array([float(r.get("bytes") or 0.0) for r in rows])
    t = np.array([float(r["measured_s"]) for r in rows])
    inv_peak = float(np.median(t / f))
    with np.errstate(divide="ignore"):
        ratios = np.where(b > 0, t / np.where(b > 0, b, 1.0), np.inf)
    finite = ratios[np.isfinite(ratios)]
    inv_bw = float(np.median(finite)) if finite.size else 0.0
    for _ in range(iters):
        comp = f * inv_peak >= b * inv_bw
        new_peak, new_bw = inv_peak, inv_bw
        if comp.any():
            new_peak = float((t[comp] * f[comp]).sum()
                             / (f[comp] * f[comp]).sum())
        comms = ~comp & (b > 0)
        if comms.any():
            new_bw = float((t[comms] * b[comms]).sum()
                           / (b[comms] * b[comms]).sum())
        if new_peak == inv_peak and new_bw == inv_bw:
            break
        inv_peak, inv_bw = new_peak, new_bw
    model = np.maximum(f * inv_peak, b * inv_bw)
    rel = np.abs(model - t) / t
    return {
        "inv_peak_s_per_flop": inv_peak,
        "inv_bw_s_per_byte": inv_bw,
        "fitted_peak_flops": 1.0 / inv_peak if inv_peak > 0 else 0.0,
        "fitted_bw_bytes_per_s": 1.0 / inv_bw if inv_bw > 0 else 0.0,
        "model_s": [float(x) for x in model],
        "rel_err": [float(x) for x in rel],
        "max_rel_err": float(rel.max()),
    }


__all__ = [
    "CPU_NOMINAL_ICI_BW",
    "ICI_BW_BY_KIND",
    "fit_roofline",
    "grid_axis_labels",
    "ici_bw_per_device",
    "publish_program_ledger",
    "roofline",
]
