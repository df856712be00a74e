"""Non-finite step skipping with host-side rollback escalation — the port
of ``ddl_tpu/resilience/guard.py``.

Device half (:func:`apply_guard`): inside a step body, AFTER the optimizer
proposed ``(new_params, new_opt)``, select the OLD state whenever the
step's fully reduced gradient held a non-finite element: a scalar
predicate on the device, ``torch.where`` over the concatenated leaves of
each dtype, written back into the proposed tensors. The predicate is
``obs.health.nonfinite_count`` (summed over each leaf's partition groups,
so it is the same on every rank and every rank takes the same branch). No
``.item()``, no host sync. ``guard=False`` is a Python-level branch in
every step body, so the default step does exactly the work it did before:
no ``torch.where``, no ``isfinite``, no extra all-reduce.

Host half (:class:`GuardMonitor`): the trainers fetch a span's stacked skip
flags with its loss (one small fetch, no added sync) and feed them here.
The monitor counts total and CONSECUTIVE skips; ``max_bad_steps``
consecutive skips trip escalation: the trainer rolls back to the newest
valid checkpoint at or before the streak's first bad step
(:func:`rollback_state`) and re-enters its span loop there, which re-seeds
the data stream (batches are indexed by global step, so position is the
seed). ``max_rollbacks`` bounds the retries: a persistent fault raises
instead of cycling. With a ``registry`` the monitor counts
``train_skipped_steps_total`` and ``train_rollbacks_total``, and with a
``tracer`` it traces ``guard_skip`` and ``guard_rollback`` events (JAX's
names).
"""

from __future__ import annotations

import numpy as np
import torch

def rollback_state(checkpoint_dir, monitor: "GuardMonitor", like, log, world=None):
    """The trainer-agnostic half of a guard rollback: locate the newest
    VALID checkpoint at or before the divergence streak's first bad step,
    load it in checkpoint (host) form, and prune every retained save NEWER
    than it (those describe the abandoned timeline and must not win a later
    ``--resume auto``). Returns ``(host_tree, step)``; raises with a
    diagnosis when there is nothing to roll back to.

    In a world of several ranks (``world``, a ``parallel.mesh.World``)
    every rank reads the same file, then each host's local rank 0 alone
    prunes its disk's saves (``World.lead``: rank 0 on one host), between
    two barriers, so no rank reads a file another is deleting."""
    from ..utils.checkpoint import discard_newer, find_latest_valid, load_checkpoint

    if checkpoint_dir is None:
        raise RuntimeError(
            "guard escalation tripped (max_bad_steps consecutive "
            "non-finite steps) but no checkpoint_dir is set — nothing "
            "to roll back to"
        )
    lead, size = (True, 1) if world is None else (world.lead, world.size)
    found = find_latest_valid(
        checkpoint_dir, max_step=monitor.streak_start, log=log
    )
    if found is None:
        raise RuntimeError(
            "guard escalation tripped but no valid checkpoint at or "
            f"before step {monitor.streak_start} exists under "
            f"{checkpoint_dir}"
        )
    path, _ = found
    host, step, _ = load_checkpoint(path, like)
    step = int(step or 0)
    if size > 1:
        import torch.distributed as dist

        dist.barrier()
    if lead:
        discard_newer(checkpoint_dir, step, log=log)
    if size > 1:
        dist.barrier()
    log(f"[guard] rolled back to checkpoint step {step} ({path})")
    return host, step


def _select(bad: torch.Tensor, old, new):
    """``torch.where(bad, old, new)`` over two trees of one structure
    (dicts, lists, tuples and optimizer-state dataclasses of tensors),
    written into ``new``'s own tensors, which are returned: the leaves of
    one dtype are selected in ONE ``where`` over their concatenation and
    copied back by one multi-tensor copy, so a step pays a few kernels for
    the select, not one a leaf, and its tensors keep the unguarded step's
    allocations."""
    from ..utils.checkpoint import flatten_with_paths

    olds = [x for _, x in flatten_with_paths(old)]
    news = [x for _, x in flatten_with_paths(new)]
    groups: dict[tuple, list[int]] = {}
    for i, o in enumerate(olds):
        groups.setdefault((o.dtype, o.device), []).append(i)
    for idx in groups.values():
        flat = torch.where(bad, torch.cat([olds[i].reshape(-1) for i in idx]),
                           torch.cat([news[i].reshape(-1) for i in idx]))
        parts = flat.split([olds[i].numel() for i in idx])
        torch._foreach_copy_([news[i] for i in idx],
                             [p.view(olds[i].shape) for p, i in zip(parts, idx)])
    return new


def apply_guard(nonfinite: torch.Tensor, params, opt_state, new_params, new_opt):
    """Identity on divergence (see the module docstring). ``nonfinite`` is
    the step's replicated non-finite gradient element count (an int32
    scalar tensor). Returns ``(params', opt', skipped)``: the proposed
    update when the gradients were finite and the UNCHANGED inputs
    otherwise, and ``skipped`` an int32 0/1 scalar tensor."""
    bad = nonfinite > 0
    params, opt_state = _select(bad, (params, opt_state), (new_params, new_opt))
    return params, opt_state, bad.to(torch.int32)


class GuardMonitor:
    """Host-side escalation policy over the guard's per-step skip flags.

    ``observe(skipped_stack, first_gstep)`` consumes one span's stacked
    flags and returns True when ``max_bad_steps`` CONSECUTIVE skips have
    accumulated (0 disables escalation: a skip-only guard). After the
    trainer rolls back it calls :meth:`rolled_back`, which resets the
    streak and enforces ``max_rollbacks``. ``streak_start`` is the global
    step of the current streak's first skip: the rollback's upper bound (a
    checkpoint saved DURING the streak embeds skipped steps and is not
    "good")."""

    def __init__(self, max_bad_steps: int = 0, *, max_rollbacks: int = 3,
                 registry=None, tracer=None):
        if max_bad_steps < 0:
            raise ValueError(
                f"max_bad_steps must be >= 0, got {max_bad_steps}"
            )
        if max_rollbacks < 1:
            raise ValueError(
                f"max_rollbacks must be >= 1, got {max_rollbacks}"
            )
        self.max_bad_steps = max_bad_steps
        self.max_rollbacks = max_rollbacks
        self.registry = registry
        self.tracer = tracer
        self.skipped_steps = 0
        self.rollbacks = 0
        self.consecutive = 0
        self.streak_start: int | None = None

    def observe(self, skipped_stack, first_gstep: int) -> bool:
        """Feed one span's ``[k]`` skip flags (host ints or an array);
        flags index global steps ``first_gstep + j``. Returns True the
        moment the escalation threshold trips: the REMAINING flags of the
        span are discarded unprocessed (the trainer rolls back and replays
        everything from the streak's first bad step, so a trailing healthy
        flag belongs to an abandoned timeline and must not reset
        ``streak_start``)."""
        for j, s in enumerate(np.asarray(skipped_stack).reshape(-1)):
            if int(s):
                if self.consecutive == 0:
                    self.streak_start = first_gstep + j
                self.consecutive += 1
                self.skipped_steps += 1
                if self.registry is not None:
                    self.registry.counter(
                        "train_skipped_steps_total",
                        "optimizer updates skipped by the non-finite "
                        "gradient guard",
                    ).inc()
                if self.tracer:
                    self.tracer.event("guard_skip", gstep=first_gstep + j,
                                      consecutive=self.consecutive)
                if self.max_bad_steps \
                        and self.consecutive >= self.max_bad_steps:
                    return True
            else:
                self.consecutive = 0
                self.streak_start = None
        return False

    def rolled_back(self, to_step: int) -> None:
        """Record a completed rollback; raises once ``max_rollbacks`` is
        exceeded (a persistent fault must fail loudly, not cycle)."""
        self.rollbacks += 1
        self.consecutive = 0
        self.streak_start = None
        if self.registry is not None:
            self.registry.counter(
                "train_rollbacks_total",
                "rollbacks to the last good checkpoint after "
                "max_bad_steps consecutive guarded skips",
            ).inc()
        if self.tracer:
            self.tracer.event("guard_rollback", to_step=int(to_step),
                              rollbacks=self.rollbacks)
        if self.rollbacks > self.max_rollbacks:
            raise RuntimeError(
                f"guard escalation: {self.rollbacks} rollbacks exceed "
                f"max_rollbacks={self.max_rollbacks} — the divergence "
                "recurs after restoring the last good checkpoint "
                "(persistent bad data or a real model divergence, not a "
                "transient fault); inspect train_skipped_steps_total and "
                "the guard_skip trace events"
            )
