"""Deterministic fault injection — the port of ``ddl_tpu/resilience/faults.py``
(numpy only, as the JAX module is): the proof harness for every recovery
path. Each failure mode is a seeded, reproducible input, so the tests and
manual chaos runs (CLI ``--inject-fault``) exercise the paths a real
incident takes:

- ``nan_grads@K`` / ``inf_grads@K``: poison ONE element of the staged
  loss weights (LM) or input images (CNN) for the batch at global step
  ``K`` (``@KxN`` poisons ``N`` consecutive batches). The forward then
  produces a non-finite loss and non-finite gradients by itself, so the
  real guard path runs, not a mock. Transient by default (``once=True``:
  a guard rollback heals the data); a trailing ``!`` makes it persistent.
- ``sigterm@K``: deliver a real ``SIGTERM`` to this process once global
  step ``K`` completes (a preemption notice), driving the graceful drain,
  final checkpoint and clean exit.
- ``corrupt_ckpt`` / ``truncate_ckpt``: flip bytes in, or truncate, a
  checkpoint file (deterministic under ``seed``), the torn-write and
  bit-rot inputs ``find_latest_valid`` must survive.
- ``stall@RID``: the serve scheduler never advances request ``RID``'s
  prefill (an upstream hang), so its deadline must evict it and release
  its pinned prefix refs.
- ``replica_crash@T:R``: kill serve-fleet replica ``R`` at global tick
  ``T``: the fleet controller (``serve.controller``) discards the replica's
  engine and pool, re-queues its in-flight and queued requests at the
  router's door and heals the fleet; every request still completes exactly
  once. Fires once; deterministic on the tick clock.

Injection is host-side only (staged data, signals, files), so the programs
under test are the production programs.
"""

from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np

TRAIN_KINDS = ("nan_grads", "inf_grads", "sigterm")
CKPT_KINDS = ("corrupt_ckpt", "truncate_ckpt")
SERVE_KINDS = ("stall", "replica_crash")
KINDS = TRAIN_KINDS + CKPT_KINDS + SERVE_KINDS


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault. ``step`` is the trigger global step
    (train kinds), the target request id (``stall``), or the global
    tick (``replica_crash``); ``replica`` is the ``replica_crash``
    victim's id; ``count`` extends a grad fault over consecutive
    batches; ``once=True`` makes a grad fault transient (healed by a
    guard rollback)."""

    kind: str
    step: int = 0
    count: int = 1
    once: bool = True
    replica: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (choices: "
                f"{', '.join(KINDS)})"
            )
        if self.step < 0 or self.count < 1:
            raise ValueError(
                f"fault {self.kind}: need step >= 0 and count >= 1, got "
                f"step={self.step} count={self.count}"
            )
        if self.replica < 0:
            raise ValueError(
                f"fault {self.kind}: replica must be >= 0, got "
                f"{self.replica}"
            )


def parse_fault(text: str) -> FaultSpec:
    """CLI syntax: ``kind``, ``kind@STEP`` or ``kind@STEPxCOUNT`` —
    e.g. ``nan_grads@3``, ``nan_grads@3x2``, ``sigterm@5``,
    ``stall@7``, ``corrupt_ckpt``. ``replica_crash`` takes
    ``replica_crash@TICK:REPLICA``. A trailing ``!`` makes a grad
    fault persistent (``once=False``): ``nan_grads@3x2!``."""
    once = True
    if text.endswith("!"):
        once = False
        text = text[:-1]
    kind, at, rest = text.partition("@")
    step, count, replica = 0, 1, 0
    if kind == "replica_crash":
        head, colon, tail = rest.partition(":")
        try:
            step = int(head) if at else 0
            replica = int(tail) if colon else 0
        except ValueError:
            raise ValueError(
                f"bad fault spec {text!r}: replica_crash takes "
                "replica_crash@TICK:REPLICA with integer TICK/REPLICA"
            )
    elif at:
        head, x, tail = rest.partition("x")
        try:
            step = int(head)
            count = int(tail) if x else 1
        except ValueError:
            raise ValueError(
                f"bad fault spec {text!r}: expected kind@STEP or "
                "kind@STEPxCOUNT with integer STEP/COUNT"
            )
    return FaultSpec(kind=kind, step=step, count=count, once=once,
                     replica=replica)


class FaultInjector:
    """Stateful host-side delivery of one :class:`FaultSpec`.

    Trainers call :meth:`poison_batches` while staging data and
    :meth:`maybe_sigterm` at span boundaries; a guard rollback calls
    :meth:`heal` (True = restage clean data). The serve scheduler asks
    :meth:`stalls` per slot per tick. All decisions are pure functions
    of the spec + the healed flag — rerunning the same spec reproduces
    the same incident."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.healed = False
        self._sigterm_fired = False
        self._crash_fired = False

    # -- training: data poisoning -----------------------------------------

    def poisons_data(self) -> bool:
        return self.spec.kind in ("nan_grads", "inf_grads") \
            and not self.healed

    def poison_batches(self, arr: np.ndarray, batch_num: int,
                       batch_size: int) -> np.ndarray:
        """Copy of the 2-D host array ``[N, ...]`` (rows are examples,
        sequential batching: batch ``b`` = rows ``[b*bs, (b+1)*bs)``)
        with one element of each targeted batch's first row set
        non-finite. Targets are the batch indices of global steps
        ``step .. step+count-1`` (mod ``batch_num`` — data repeats per
        epoch, so a poisoned batch is poisoned on every epoch pass
        until healed). No-op (returns ``arr``) when not armed."""
        if not self.poisons_data() or batch_num < 1:
            return arr
        value = np.nan if self.spec.kind == "nan_grads" else np.inf
        out = np.array(arr, copy=True)
        for i in range(self.spec.count):
            b = (self.spec.step + i) % batch_num
            row = b * batch_size
            if row < out.shape[0]:
                out.reshape(out.shape[0], -1)[row, 0] = value
        return out

    def heal(self) -> bool:
        """Called by the trainer after a guard rollback: a transient
        (``once=True``) data fault clears — the trainer restages clean
        data when this returns True."""
        if self.poisons_data() and self.spec.once:
            self.healed = True
            return True
        return False

    # -- training: preemption ----------------------------------------------

    def maybe_sigterm(self, completed_gstep: int) -> None:
        """Deliver one real SIGTERM to this process once training has
        completed global step ``spec.step`` (called at span boundaries —
        delivery granularity is a span, exactly like a real notice)."""
        if self.spec.kind != "sigterm" or self._sigterm_fired:
            return
        if completed_gstep > self.spec.step:
            self._sigterm_fired = True
            os.kill(os.getpid(), signal.SIGTERM)

    # -- serving -----------------------------------------------------------

    def stalls(self, request_id: int) -> bool:
        """True while request ``request_id``'s prefill must not advance
        (``stall`` faults; ``spec.step`` holds the target id)."""
        return self.spec.kind == "stall" and not self.healed \
            and request_id == self.spec.step

    @property
    def crash_pending(self) -> bool:
        """An armed replica_crash that has not fired yet — the fleet
        controller checks this at run end: a crash tick beyond the
        run's horizon must FAIL the run loudly, never report a clean
        pass that exercised nothing."""
        return self.spec.kind == "replica_crash" and not self._crash_fired

    def rearm(self) -> None:
        """Re-arm the one-shot replica_crash latch for a fresh run (the
        fleet controller's ``reset`` — a replayed scenario must crash
        again at the same tick). Trainer-side latches (sigterm, healed
        data faults) are NOT touched: their one-shot semantics span
        resume cycles by design."""
        self._crash_fired = False

    def crashes_replica(self, tick: int) -> int | None:
        """The fleet-replica id to kill once the GLOBAL clock reaches
        ``spec.step`` (``replica_crash`` faults fire ONCE), else None.
        The controller (``serve.controller``) consults this every
        global tick — delivery is deterministic on the tick clock, so
        a seeded crash scenario replays exactly."""
        if self.spec.kind != "replica_crash" or self._crash_fired:
            return None
        if tick >= self.spec.step:
            self._crash_fired = True
            return self.spec.replica
        return None


class FaultStorm:
    """Sequenced ``replica_crash`` delivery — the multi-fault injector
    behind the ``crash_storm`` scenario (``serve.scenarios``). Exposes
    the exact surface the fleet controller consumes from
    :class:`FaultInjector` (``crashes_replica`` / ``rearm`` /
    ``crash_pending`` / ``spec``), firing each spec once in ``step``
    order, at most one per tick — two crashes due the same tick deliver
    on consecutive ticks, deterministically. ``spec`` reads as the
    first unfired spec so the controller's "never fired" run-end error
    names the crash that was actually missed."""

    def __init__(self, specs):
        specs = tuple(specs)
        if not specs:
            raise ValueError("FaultStorm needs at least one FaultSpec")
        bad = sorted({s.kind for s in specs if s.kind != "replica_crash"})
        if bad:
            raise ValueError(
                f"FaultStorm sequences replica_crash faults only, got "
                f"{', '.join(bad)}"
            )
        self.specs = tuple(sorted(specs, key=lambda s: (s.step, s.replica)))
        self._fired = [False] * len(self.specs)

    @property
    def spec(self) -> FaultSpec:
        for spec, fired in zip(self.specs, self._fired):
            if not fired:
                return spec
        return self.specs[-1]

    @property
    def crash_pending(self) -> bool:
        return not all(self._fired)

    def rearm(self) -> None:
        self._fired = [False] * len(self.specs)

    def stalls(self, request_id: int) -> bool:
        return False

    def crashes_replica(self, tick: int) -> int | None:
        for i, spec in enumerate(self.specs):
            if not self._fired[i] and tick >= spec.step:
                self._fired[i] = True
                return spec.replica
        return None


def parse_fault_storm(text: str):
    """``;``-separated :func:`parse_fault` specs — one spec builds a
    plain :class:`FaultInjector`, several build a :class:`FaultStorm`:
    ``replica_crash@3:1;replica_crash@9:2``."""
    specs = [parse_fault(part) for part in text.split(";") if part]
    if not specs:
        raise ValueError(f"empty fault spec {text!r}")
    if len(specs) == 1:
        return FaultInjector(specs[0])
    return FaultStorm(specs)


# -- checkpoint chaos ---------------------------------------------------------


def corrupt_checkpoint(path: str | os.PathLike, *, seed: int = 0,
                       nbytes: int = 64) -> None:
    """Deterministically flip ``nbytes`` bytes in the middle of
    ``path`` IN PLACE (bit rot / partial overwrite). The file keeps its
    size, so only content verification — the manifest checksums, or a
    failed zip read — can catch it."""
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    with open(path, "r+b") as f:
        start = max(size // 2 - nbytes // 2, 0)
        f.seek(start)
        chunk = bytearray(f.read(min(nbytes, size - start)))
        for i in range(len(chunk)):
            chunk[i] ^= int(rng.integers(1, 256))
        f.seek(start)
        f.write(bytes(chunk))
        f.flush()
        os.fsync(f.fileno())


def truncate_checkpoint(path: str | os.PathLike, *, frac: float = 0.5) -> None:
    """Truncate ``path`` to ``frac`` of its size IN PLACE — the torn
    write a preemption mid-save produces on non-atomic writers (ours is
    atomic; this models an externally damaged file)."""
    if not 0 <= frac < 1:
        raise ValueError(f"frac must be in [0, 1), got {frac}")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * frac))
        f.flush()
        os.fsync(f.fileno())
