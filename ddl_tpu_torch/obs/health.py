"""In-step training health signals — the port of ``ddl_tpu/obs/health.py``.

Computed inside the step bodies, right after each body's own explicit
gradient reduction, as device tensors (no host sync); the trainers fetch
them at the span barrier they already pay for.

Signals (JAX's names and values):

- ``grad_norm``: global L2 norm of the fully reduced gradient;
- ``nonfinite_grads``: count of non-finite gradient ELEMENTS (int32), the
  divergence tripwire, 0 on every healthy step;
- ``param_norm`` / ``update_norm``: global L2 norms of the parameters and
  of the step's APPLIED update (new - old), plus one
  ``param_norm/<subtree>`` / ``update_norm/<subtree>`` pair per top-level
  subtree (LM: blocks, embed, head, lnf_b, lnf_g; CNN: each variable).

A gradient or parameter leaf is complete on a rank up to the sharding its
partition spec names (``models/partition.py``): a replicated leaf holds the
whole tensor, a tensor-parallel shard its slice, a pipeline stage its
layers. Each leaf's count and squared sum are therefore summed over exactly
the process groups of its spec (``groups``: for each leaf in
``utils.tree.leaves`` order, a tuple of groups; None: every leaf whole
here), one collective per distinct tuple, so every rank ends with the same
(replicated) values. The ZeRO-1 flat-chunk bodies use
:func:`flat_grad_sq_nonfinite`: the chunks are disjoint over the ``(dp,
sp)`` group, so one sum of the local values is the global answer.

Where the port differs in HOW, never in WHAT: JAX computes the whole dict
on every step of a health span and records the last step's
(:func:`record_health` reads ``[-1]``); the trainers here count non-finite
elements on every step and compute the norms only on the last step of a
span that crosses ``metrics_interval`` (the values recorded are the same).
With metrics off no health op runs at all.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import LOCAL
from ..utils import tree

# Step bodies' health levels: nothing, the non-finite count alone, or the
# whole signal dict (:func:`health_signals`).
HEALTH_OFF, HEALTH_COUNT, HEALTH_FULL = 0, 1, 2


def _count(leaf: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(leaf).logical_not().sum(dtype=torch.int32)


def _reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over each process group of ``groups`` in turn (None is
    the world's group; ``LOCAL`` is no collective), in place."""
    from ..parallel import collectives as coll

    for g in groups:
        if g is not LOCAL:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        coll.note("all-reduce", t, g)
    return t


def _specs(leaves, groups) -> list[tuple]:
    specs = [()] * len(leaves) if groups is None else [tuple(g) for g in groups]
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} group specs for {len(leaves)} leaves")
    return specs


def _same(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _by_spec(items) -> list[tuple[tuple, list]]:
    """``[(spec, [item, ...])]`` of ``(spec, item)`` pairs, grouped by spec
    identity in first-seen order."""
    out: list[tuple[tuple, list]] = []
    for spec, item in items:
        for s, members in out:
            if _same(s, spec):
                members.append(item)
                break
        else:
            out.append((spec, [item]))
    return out


def nonfinite_count(grads, groups=None) -> torch.Tensor:
    """Global non-finite ELEMENT count (an int32 scalar tensor, the same on
    every rank) of a gradient tree whose leaves are complete up to the
    sharding ``groups`` describes (module docstring). Leaves sharing a
    spec share one collective, and one count: their elements are
    concatenated first, so a step pays a few kernels, not a handful a
    leaf."""
    leaves = tree.leaves(grads)
    total = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    for spec, members in _by_spec(zip(_specs(leaves, groups), leaves)):
        flat = torch.cat([x.reshape(-1) for x in members]) if len(members) > 1 else members[0]
        total = total + _reduce(_count(flat), spec)
    return total


def flat_grad_sq_nonfinite(g_own: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(global squared sum, global non-finite count) of a ZeRO-1 flat
    gradient CHUNK: the chunks are disjoint over ``group`` (``LOCAL``: no
    collective) and cover the whole gradient (the padding is zeros), so one
    sum of the local values is the global answer. Both ride one all-reduce
    in float64, exact for any count below 2^53."""
    g = g_own.float()
    both = torch.stack([g.square().sum().double(), _count(g).double()])
    _reduce(both, (group,))
    return both[0].float(), both[1].to(torch.int32)


def _top_keys(params) -> list[str]:
    """The top-level subtree label of each leaf, in leaf order."""
    return [k for k in sorted(params) for _ in tree.leaves(params[k])]


def subtree_keys(template) -> list[str]:
    """Sorted top-level subtree labels of a param tree."""
    return sorted(set(_top_keys(template)))


def health_keys(template) -> list[str]:
    """The key set of :func:`health_signals` for this param template."""
    keys = ["grad_norm", "nonfinite_grads", "param_norm", "update_norm"]
    for k in subtree_keys(template):
        keys.append(f"param_norm/{k}")
        keys.append(f"update_norm/{k}")
    return keys


def _grouped_sq(keys: list[str], leaves: list, specs: list[tuple]) -> dict[str, torch.Tensor]:
    """Per-subtree global sum of squares (float32 scalars): each leaf's
    squared sum (one multi-tensor norm kernel for all of them), grouped by
    (subtree, groups), and ONE all-reduce per distinct groups tuple over
    the vector of its subtrees' sums."""
    sq = torch.stack(torch._foreach_norm([x.float() for x in leaves])).square()
    subtrees = sorted(set(keys))
    out = {k: torch.zeros((), device=sq.device) for k in subtrees}
    for spec, idx in _by_spec((s, i) for i, s in enumerate(specs)):
        rows = torch.stack([sq[[i for i in idx if keys[i] == k]].sum() for k in subtrees])
        rows = _reduce(rows, spec)
        for j, k in enumerate(subtrees):
            out[k] = out[k] + rows[j]
    return out


def grad_signals(grads, groups=None, nonfinite=None) -> dict[str, torch.Tensor]:
    """``grad_norm`` + ``nonfinite_grads`` of a FULL gradient tree whose
    leaves are complete up to the sharding ``groups`` describes;
    ``nonfinite``, when the step has it already (its guard's), is taken
    as the count."""
    leaves = tree.leaves(grads)
    specs = _specs(leaves, groups)
    sq = _grouped_sq(["g"] * len(leaves), leaves, specs)["g"]
    if nonfinite is None:
        nonfinite = nonfinite_count(grads, groups)
    return {"grad_norm": sq.sqrt(), "nonfinite_grads": nonfinite}


@torch.no_grad()
def norm_signals(params, new_params, groups=None) -> dict[str, torch.Tensor]:
    """Global and per-subtree param and update (new - old) L2 norms."""
    old, new = tree.leaves(params), tree.leaves(new_params)
    specs = _specs(old, groups)
    keys = _top_keys(params)
    upd = torch._foreach_sub([x.float() for x in new], [x.float() for x in old])
    p_sub = _grouped_sq(keys, old, specs)
    u_sub = _grouped_sq(keys, upd, specs)
    out = {"param_norm": torch.stack(list(p_sub.values())).sum().sqrt(),
           "update_norm": torch.stack(list(u_sub.values())).sum().sqrt()}
    for k in sorted(p_sub):
        out[f"param_norm/{k}"] = p_sub[k].sqrt()
        out[f"update_norm/{k}"] = u_sub[k].sqrt()
    return out


def health_signals(grads, params, new_params, groups=None,
                   nonfinite=None) -> dict[str, torch.Tensor]:
    """The full signal dict (module docstring); key set ==
    :func:`health_keys` of ``params``."""
    out = grad_signals(grads, groups, nonfinite)
    out.update(norm_signals(params, new_params, groups))
    return {k: out[k] for k in health_keys(params)}


def sq_sum(leaves, groups=()) -> torch.Tensor:
    """Global float32 sum of squares of ``leaves``, each complete up to
    the process ``groups`` (one tuple for all of them)."""
    sq = torch.stack(torch._foreach_norm([x.float() for x in leaves])).square().sum()
    return _reduce(sq, groups)


@torch.no_grad()
def finish_step(guard: bool, health: int, nonfinite, full, params, opt, new_params, new_opt,
                loss) -> tuple:
    """A step body's return, ``(params', opt', loss[, health][, skipped])``.
    With ``guard``, the update is selected against the non-finite count
    (``resilience.guard.apply_guard``; ``nonfinite()`` computes it) and the
    skip flag comes LAST. At a ``health`` level, the health dict comes
    after the loss: the count alone, or ``full(new_params, nf)``, the
    whole dict of the APPLIED update (``nf`` the guard's count, or None).
    With both off, nothing beyond the step's own work runs."""
    if not guard and health == HEALTH_OFF:
        return new_params, new_opt, loss
    out, nf = (), None
    if guard:
        from ..resilience.guard import apply_guard

        nf = nonfinite()
        new_params, new_opt, skipped = apply_guard(nf, params, opt, new_params, new_opt)
        out = (skipped,)
    if health == HEALTH_COUNT:
        out = ({"nonfinite_grads": nf if nf is not None else nonfinite()},) + out
    elif health == HEALTH_FULL:
        h = full(new_params, nf)
        out = ({k: h[k] for k in health_keys(params)},) + out
    return (new_params, new_opt, loss) + out


def fetch_span(hs: list[dict]) -> dict[str, np.ndarray]:
    """A span's per-step health outputs on the host in ONE fetch: the
    ``[k]`` stack of non-finite counts, and the last step's other signals
    as ``[1]`` arrays (the last step is the one a full dict comes from)."""
    nf = torch.stack([h["nonfinite_grads"] for h in hs]).double()
    rest = [k for k in hs[-1] if k != "nonfinite_grads"]
    vals = torch.cat([nf] + [hs[-1][k].reshape(1).double() for k in rest]).tolist()
    out = {"nonfinite_grads": np.asarray(vals[:len(hs)], np.int64)}
    for i, k in enumerate(rest):
        out[k] = np.asarray([vals[len(hs) + i]])
    return out


def record_health(registry, hstack, *, prefix: str = "train",
                  include_nonfinite: bool = True) -> None:
    """Record a fetched health dict (one span's; each value an array whose
    LAST element is the span's last step) into the registry: gauges of the
    last step's values (per-subtree norms as ``subtree``-labelled series
    of the same metric name; the unlabelled series is the global norm) and
    the span's total non-finite count onto
    ``<prefix>_nonfinite_grads_total`` (skipped with
    ``include_nonfinite=False``, for trainers that feed it from EVERY span
    through :func:`record_nonfinite`)."""
    hs = {k: np.asarray(v) for k, v in hstack.items()}
    nf = hs.pop("nonfinite_grads")
    if include_nonfinite:
        record_nonfinite(registry, nf, prefix=prefix)
    for key, arr in hs.items():
        v = float(arr.reshape(-1)[-1])
        if "/" in key:
            base, sub = key.split("/", 1)
            registry.gauge(f"{prefix}_{base}").set(v, subtree=sub)
        else:
            registry.gauge(f"{prefix}_{key}").set(v)


def record_nonfinite(registry, nf_stack, *, prefix: str = "train") -> None:
    """Add one span's ``[k]`` non-finite element counts to the divergence
    tripwire counter (every span, so a NaN burst can never fall between
    metrics intervals)."""
    registry.counter(
        f"{prefix}_nonfinite_grads_total",
        "non-finite gradient elements seen (divergence tripwire)",
    ).inc(int(np.asarray(nf_stack).sum()))
