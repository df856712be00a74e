"""The comparison that decides ``correct`` for a training cell: the
program's first steps against the reference's, by three numbers.

- ``loss_gap``: over the checked steps, the largest ``|loss - ref| / ref``.
- ``grad_gap``: at the first step, the worst leaf's gap between the
  program's gradient norm (worked out from Adam's first moment after one
  step, ``m / (1 - b1)``) and the reference's, over the larger of that
  leaf's reference norm and the median leaf's.
- ``update_gap``: after the last checked step, the worst leaf's gap between
  the norms of the parameters' change from the initial ones, measured the
  same way. Leaves whose reference gradient at the first step is under a
  thousandth of the median leaf's are left out: Adam moves them by
  round-off alone.

A number that is not finite fails. Each number compared has its own limit,
in the cell's workload file; a number the file gives no limit is computed
and printed but not compared (one that no control or fault separates from
sound runs could only fail those).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "update_gap")
STILL = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _largest(values) -> float:
    """The largest value, or infinity where any is not finite (``max``
    skips a NaN that does not come first)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _worst_leaf(prog: dict[str, float], ref: dict[str, float], keep) -> float:
    kept = [k for k in ref if keep(k)]
    floor = statistics.median(ref[k] for k in kept)
    return _largest(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in kept)


def gaps(prog, ref) -> dict[str, float]:
    """``prog`` and ``ref``: readings with ``losses``, ``grad_norms`` and
    ``change_norms`` (``reference.lm.Follow``)."""
    if len(prog.losses) != len(ref.losses) or set(prog.grad_norms) != set(ref.grad_norms):
        raise ValueError("the program's and the reference's readings do not line up")
    median_grad = statistics.median(ref.grad_norms.values())
    moved = lambda k: ref.grad_norms[k] >= STILL * median_grad  # noqa: E731
    return {
        "loss_gap": _largest(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)),
        "grad_gap": _worst_leaf(prog.grad_norms, ref.grad_norms, lambda k: True),
        "update_gap": _worst_leaf(prog.change_norms, ref.change_norms, moved),
    }


def judge(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    ``limits`` names."""
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"limits must name some of {NUMBERS}, got {sorted(limits)}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def failed_count(checks: dict) -> int:
    return sum(not (math.isfinite(c["value"]) and c["value"] <= c["limit"])
               for c in checks.values())
