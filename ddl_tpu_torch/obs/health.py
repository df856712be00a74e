"""In-step health signals — the part of ``ddl_tpu/obs/health.py`` the
non-finite step guard needs (``resilience.guard``): the global count of
non-finite gradient elements, as a device tensor, with no host sync.

A gradient leaf is complete on a rank up to the sharding its partition
spec names (``models/partition.py``): a replicated leaf holds the whole
gradient, a tensor-parallel shard its slice, a pipeline stage its layers.
Each leaf's count is therefore summed over exactly the groups of its spec,
so every rank ends with the same (replicated) count and takes the same
branch. The rest of the JAX module (norms, the health dict, the registry
hooks) is ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import LOCAL
from ..utils import tree


def _count(leaf: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(leaf).logical_not().sum(dtype=torch.int32)


def _reduce(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over each process group of ``groups`` in turn (None is
    the world's group; ``LOCAL`` is no collective), in place."""
    for g in groups:
        if g is not LOCAL:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
    return t


def nonfinite_count(grads, groups=None) -> torch.Tensor:
    """Global non-finite ELEMENT count (an int32 scalar tensor, the same on
    every rank) of a gradient tree whose leaves are complete up to the
    sharding ``groups`` describes: None (every leaf whole on this rank) or
    a list with, for each leaf in ``utils.tree.leaves`` order, the tuple of
    process groups to sum that leaf's count over. Leaves sharing a tuple
    share one collective (JAX's psum per distinct axes), and one count:
    their elements are concatenated first, so a step pays a few kernels,
    not a handful a leaf."""
    leaves = tree.leaves(grads)
    specs = [()] * len(leaves) if groups is None else list(groups)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} group specs for {len(leaves)} gradient leaves")
    per_spec: list[tuple[tuple, list]] = []
    for leaf, spec in zip(leaves, specs):
        for s, members in per_spec:
            if len(s) == len(spec) and all(a is b for a, b in zip(s, spec)):
                members.append(leaf)
                break
        else:
            per_spec.append((tuple(spec), [leaf]))
    total = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    for spec, members in per_spec:
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
