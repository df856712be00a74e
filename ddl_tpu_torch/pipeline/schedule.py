"""Microbatch schedules as static tick tables — the port of
``ddl_tpu/pipeline/schedule.py``, a copy of its pure-numpy tables (the port
imports nothing of the JAX package).

A pipeline step is a sequence of TICKS; at each tick every stage runs at
most one unit of work — one microbatch FORWARD or one microbatch BACKWARD.
A schedule is two ``[pp, T]`` int32 tables (``f_tab``, ``b_tab``): entry
``[s, t]`` is the microbatch index stage ``s`` forwards/backwards at tick
``t``, or :data:`IDLE`. The step (``pipeline/step.py``) executes any
well-formed pair of tables: each process runs its own stage's row, so
GPipe and 1F1B are data, not code.

Dependency model (what makes a table well-formed):

- ``F(s, j)`` needs ``F(s-1, j)`` to have finished at an EARLIER tick
  (the activation hops at tick end, arriving for tick t+1);
- ``B(s, j)`` needs ``B(s+1, j)`` earlier (cotangent hop), and on the
  LAST stage needs ``F(pp-1, j)`` earlier (the backward seeds from the
  loss that forward computed).

Both schedules run ``T = 2*(M + pp - 1)`` ticks — with equal-cost slots
their bubble fractions coincide at the GPipe closed form
``(pp-1)/(M + pp - 1)`` (:func:`predicted_bubble`). What 1F1B buys is the
WARMUP MEMORY: a stage's in-flight saved inputs peak at ``min(pp - s, M)``
instead of GPipe's ``M`` (:func:`max_in_flight`).
"""

from __future__ import annotations

import numpy as np

IDLE = -1

SCHEDULES = ("gpipe", "1f1b")


def gpipe_tables(pp: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """GPipe (flush) schedule: all M forwards drain through the stages,
    THEN all M backwards — closed form, no simulation. Stage ``s`` runs
    ``F_j`` at tick ``s + j``; backwards start once the last stage has
    every loss, ``B_j`` on stage ``s`` at ``(M + pp - 1) + (pp-1-s) + j``
    (the cotangent chain mirrors the forward chain, last stage first)."""
    _check(pp, m)
    t_f = m + pp - 1
    T = 2 * t_f
    f = np.full((pp, T), IDLE, np.int32)
    b = np.full((pp, T), IDLE, np.int32)
    for s in range(pp):
        for j in range(m):
            f[s, s + j] = j
            b[s, t_f + (pp - 1 - s) + j] = j
    return f, b


def one_f1b_tables(pp: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """1F1B (PipeDream-flush) schedule by greedy simulation: stage ``s``
    warms up with at most ``min(pp - s, M)`` forwards, then strictly
    alternates backward/forward (backward preferred as soon as its
    cotangent arrived), then drains the remaining backwards. The
    simulation IS the spec — the table is checked against the dependency
    model by tests, not derived twice."""
    _check(pp, m)
    fdone = [[None] * m for _ in range(pp)]  # completion tick of F(s, j)
    bdone = [[None] * m for _ in range(pp)]
    nf = [0] * pp  # next forward microbatch per stage
    nb = [0] * pp  # next backward microbatch per stage
    cols_f: list[list[int]] = []
    cols_b: list[list[int]] = []
    t = 0
    while any(n < m for n in nb):
        colf = [IDLE] * pp
        colb = [IDLE] * pp
        for s in range(pp):
            warm = min(pp - s, m)
            can_f = nf[s] < m and (
                s == 0
                or (fdone[s - 1][nf[s]] is not None
                    and fdone[s - 1][nf[s]] < t)
            )
            if s == pp - 1:
                can_b = (nb[s] < m and fdone[s][nb[s]] is not None
                         and fdone[s][nb[s]] < t)
            else:
                can_b = (nb[s] < m and bdone[s + 1][nb[s]] is not None
                         and bdone[s + 1][nb[s]] < t)
            if can_b:
                colb[s] = nb[s]
                bdone[s][nb[s]] = t
                nb[s] += 1
            elif can_f and nf[s] - nb[s] < warm:
                colf[s] = nf[s]
                fdone[s][nf[s]] = t
                nf[s] += 1
        cols_f.append(colf)
        cols_b.append(colb)
        t += 1
        if t > 4 * (m + pp) + 8:  # structurally impossible; guard a bug
            raise RuntimeError(
                f"1F1B simulation did not converge for pp={pp}, m={m}"
            )
    return (np.asarray(cols_f, np.int32).T.copy(),
            np.asarray(cols_b, np.int32).T.copy())


def schedule_tables(kind: str, pp: int, m: int):
    """``(f_tab, b_tab)`` for ``kind`` in :data:`SCHEDULES`."""
    if kind == "gpipe":
        return gpipe_tables(pp, m)
    if kind == "1f1b":
        return one_f1b_tables(pp, m)
    raise ValueError(
        f"unknown pipeline schedule {kind!r} (choices: {SCHEDULES})"
    )


def max_in_flight(f_tab: np.ndarray, b_tab: np.ndarray) -> int:
    """Peak saved-activation count over all stages: microbatches
    forwarded but not yet backwarded (each holds one stage-INPUT buffer
    for the backward's recompute). GPipe peaks at M (stage 0 forwards
    everything before any cotangent returns); 1F1B at ``min(pp, M)`` —
    THE memory difference between the schedules."""
    worst = 1
    for s in range(f_tab.shape[0]):
        live = peak = 0
        for t in range(f_tab.shape[1]):
            if f_tab[s, t] != IDLE:
                live += 1
                peak = max(peak, live)
            if b_tab[s, t] != IDLE:
                live -= 1
        worst = max(worst, peak)
    return worst


def buffer_slots(f_tab: np.ndarray, b_tab: np.ndarray) -> dict[str, int]:
    """Ring-buffer slot counts the step program needs for this table
    pair: ``save`` (stage inputs awaiting backward — the dominant term,
    = :func:`max_in_flight`), ``inbox`` (activations received from the
    previous stage but not yet consumed), ``ctbox`` (cotangents received
    from the next stage but not yet consumed). In-flight microbatch
    indices are CONSECUTIVE per buffer (forwards and backwards both
    retire in order), so indexing slot ``j % n`` is collision-free as
    long as ``n`` covers the peak — which is what these counts are."""
    pp, T = f_tab.shape

    def peak(arrive, consume):
        worst = 1
        for s in range(pp):
            ticks = sorted(
                (arr, con) for arr, con in (
                    (arrive(s, j), consume(s, j)) for j in range(_m(f_tab))
                ) if arr is not None and con is not None
            )
            live: list[int] = []
            mx = 0
            for arr, con in ticks:
                live = [c for c in live if c >= arr]
                live.append(con)
                mx = max(mx, len(live))
            worst = max(worst, mx)
        return worst

    f_tick = {(s, int(f_tab[s, t])): t
              for s in range(pp) for t in range(T) if f_tab[s, t] != IDLE}
    b_tick = {(s, int(b_tab[s, t])): t
              for s in range(pp) for t in range(T) if b_tab[s, t] != IDLE}
    inbox = peak(
        lambda s, j: f_tick.get((s - 1, j), 0) + 1 if s else None,
        lambda s, j: f_tick.get((s, j)) if s else None,
    )
    ctbox = peak(
        lambda s, j: (b_tick.get((s + 1, j), 0) + 1
                      if s < pp - 1 else None),
        lambda s, j: b_tick.get((s, j)) if s < pp - 1 else None,
    )
    return {
        "save": max_in_flight(f_tab, b_tab),
        "inbox": inbox,
        "ctbox": ctbox,
    }


def bubble_fraction(f_tab: np.ndarray, b_tab: np.ndarray) -> float:
    """Idle fraction of the schedule's (stage, tick) grid — each slot
    weighted equally (JAX's step runs the same masked body on every stage
    each tick; the port's stages wait for their neighbours' hops, so with
    equal slot costs wall time is proportional to tick count too)."""
    pp, T = f_tab.shape
    work = int((f_tab != IDLE).sum() + (b_tab != IDLE).sum())
    return 1.0 - work / (pp * T)


def predicted_bubble(pp: int, m: int) -> float:
    """The closed-form bubble both table families realize at equal slot
    cost: ``(pp-1)/(m+pp-1)`` (GPipe's classic expression; 1F1B's tables
    fill the same 2*(m+pp-1)-tick envelope — its win is warmup MEMORY,
    :func:`max_in_flight`)."""
    _check(pp, m)
    return (pp - 1) / (m + pp - 1)


def _m(f_tab: np.ndarray) -> int:
    return int(f_tab.max()) + 1


def _check(pp: int, m: int) -> None:
    if pp < 1 or m < 1:
        raise ValueError(f"need pp >= 1 and microbatches >= 1, "
                         f"got pp={pp}, m={m}")
