"""Parameter layout policies: which shard owns which parameter.

The reference's sharded parameter servers use the mechanism "permute the
variable list, then block-partition it by *variable count*":

- **block**: identity permutation; PS ``r`` owns the contiguous variable
  block ``[L*r, L*(r+1))`` with ``L = num_vars // num_ps`` and the last PS
  absorbing the remainder (reference:
  mnist_sync_sharding/parameter_server.py:30-32, worker routing
  ``ind = i // avg_var_size`` at mnist_sync_sharding/worker.py:33-36).
- **zigzag** ("greedy" in the reference): sort variables by element count and
  interleave smallest/largest before block-partitioning, so each block pairs
  a big tensor with small ones (reference:
  mnist_sync_sharding_greedy/worker.py:14-30).

This module reproduces both as *policies over (name, size) lists* — no MPI
ranks, no TF variables — and generalizes them:

- **lpt**: true greedy bin-packing (Longest Processing Time): place each
  variable, largest first, on the least-loaded shard. Strictly better balance
  than zigzag at any shard count (SURVEY.md §2.2 notes zigzag is *worse* than
  naive at 2 shards).
- **flat**: element-granular equal split that ignores variable boundaries —
  the TPU-native default (classic ZeRO-1): every shard gets exactly
  ``ceil(total/S)`` elements, perfect balance by construction, and the update
  maps onto ``psum_scatter``/``all_gather`` with no padding waste beyond the
  final shard.

All outputs are static Python/numpy — computed once when a step is built
(the analogue of the reference's runtime metadata handshake,
mnist_sync_sharding/worker.py:72-75).

This is the PyTorch port's own numpy copy of ``ddl_tpu/parallel/layout.py``:
every ``LayoutAssignment`` field is identical to the JAX package's, so the
flat vectors, the m/v shards and the offsets match element for element
(pinned by ``tests/test_torch_layout.py``). ``LANE`` stays 128: the CUDA
fused-Adam kernel reads 4 floats a thread, and 128-element shard slices keep
every shard start 16-byte aligned for it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

Policy = str  # "block" | "zigzag" | "lpt" | "flat"

POLICIES = ("block", "zigzag", "lpt", "flat")

# The JAX package's TPU lane width, kept so layouts match it exactly.
# Per-shard slice lengths (max_shard) round up to this so every shard slice
# is aligned end-to-end — reduce-scatter chunks, Adam state, reassembly, and
# the fused Adam kernel all share the same aligned length and need no
# repacking copies. Cost: <= LANE-1 padded elements per shard.
LANE = 128


def align_lane(n: int) -> int:
    return -(-n // LANE) * LANE


def block_order(names: list[str], sizes: dict[str, int]) -> list[str]:
    """Identity permutation (reference creation order)."""
    return list(names)


def zigzag_order(names: list[str], sizes: dict[str, int]) -> list[str]:
    """Sort by element count (stable), then interleave smallest/largest —
    the reference's greedy ordering (mnist_sync_sharding_greedy/worker.py:14-30).
    For the 14-var CNN this yields
    [v13, v8, v1, v6, v3, v10, v5, v4, v7, v2, v11, v12, v0, v9]
    (SURVEY.md §2.2)."""
    asc = sorted(names, key=lambda n: sizes[n])
    desc = asc[::-1]
    out: list[str] = []
    for a, d in zip(asc, desc):
        out.append(a)
        out.append(d)
    return out[: len(names)]


def lpt_order(
    names: list[str], sizes: dict[str, int], num_shards: int
) -> tuple[list[str], list[int]]:
    """Longest-Processing-Time bin packing.

    Returns ``(order, shard_var_counts)`` where ``order`` lists the variables
    grouped by owning shard (shard 0's vars first) so that a contiguous
    block partition with the given per-shard counts realizes the assignment.
    """
    loads = [0] * num_shards
    bins: list[list[str]] = [[] for _ in range(num_shards)]
    for n in sorted(names, key=lambda n: -sizes[n]):
        s = int(np.argmin(loads))
        loads[s] += sizes[n]
        bins[s].append(n)
    order = [n for b in bins for n in b]
    return order, [len(b) for b in bins]


@dataclasses.dataclass(frozen=True)
class LayoutAssignment:
    """A fully-resolved layout: permutation + shard ownership.

    The flat parameter vector is the concatenation of variables in ``order``.
    Shard ``s`` owns flat elements ``[shard_starts[s], shard_starts[s] +
    shard_sizes[s])``. For var-granular policies these boundaries are
    variable-aligned; for ``flat`` they are arbitrary equal splits.
    """

    policy: Policy
    num_shards: int
    order: tuple[str, ...]  # variable names, layout order
    var_offsets: dict[str, int]  # flat offset of each var (layout order)
    shard_starts: tuple[int, ...]  # [S] flat element offsets
    shard_sizes: tuple[int, ...]  # [S] owned element counts
    var_to_shard: dict[str, int] | None  # None for "flat" (vars may span)
    total: int  # total element count (unpadded)

    @property
    def max_shard(self) -> int:
        """Per-shard slice length: the largest shard size, lane-aligned
        (see LANE above)."""
        return align_lane(max(self.shard_sizes))

    @property
    def balance(self) -> float:
        """max/mean shard load — 1.0 is perfect (true sizes, unaligned)."""
        return max(self.shard_sizes) / (self.total / self.num_shards)

    def summary(self) -> str:
        return (
            f"layout={self.policy} shards={self.num_shards} "
            f"sizes={list(self.shard_sizes)} balance={self.balance:.3f}"
        )


def _block_counts(num_vars: int, num_shards: int) -> list[int]:
    """Reference block split: ``L = num_vars // num_shards`` vars per shard,
    last shard takes the remainder (parameter_server.py:30-32)."""
    L = num_vars // num_shards
    counts = [L] * num_shards
    counts[-1] += num_vars - L * num_shards
    return counts


def _build(
    policy: Policy,
    order: list[str],
    starts: list[int],
    sz: list[int],
    var_to_shard: dict[str, int] | None,
    sizes: dict[str, int],
) -> LayoutAssignment:
    """Shared constructor tail: fill in the order-derived offsets."""
    var_offsets = {}
    off = 0
    for n in order:
        var_offsets[n] = off
        off += sizes[n]
    return LayoutAssignment(
        policy=policy,
        num_shards=len(sz),
        order=tuple(order),
        var_offsets=var_offsets,
        shard_starts=tuple(starts),
        shard_sizes=tuple(sz),
        var_to_shard=var_to_shard,
        total=sum(sizes[n] for n in order),
    )


def _var_granular(
    policy: Policy,
    order: list[str],
    counts: list[int],
    sizes: dict[str, int],
) -> LayoutAssignment:
    """Build a variable-aligned assignment from an ordered var list and
    per-shard variable counts (``order`` grouped by shard, shard 0 first)."""
    var_to_shard: dict[str, int] = {}
    starts, sz = [], []
    i = 0
    offset = 0
    for s, c in enumerate(counts):
        starts.append(offset)
        block = order[i : i + c]
        for n in block:
            var_to_shard[n] = s
        size_s = sum(sizes[n] for n in block)
        sz.append(size_s)
        offset += size_s
        i += c
    return _build(policy, order, starts, sz, var_to_shard, sizes)


def assign_layout(
    policy: Policy,
    num_shards: int,
    names: list[str],
    sizes: dict[str, int],
) -> LayoutAssignment:
    """Resolve a layout policy to a concrete shard assignment."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    total = sum(sizes[n] for n in names)

    if policy == "flat":
        # ceil then lane-align: equal padded shards whose boundaries match
        # the psum_scatter row split (collectives.reduce_scatter_flat with
        # chunk=max_shard).
        chunk = align_lane(-(-total // num_shards))
        starts = [min(s * chunk, total) for s in range(num_shards)]
        sz = [max(0, min(chunk, total - st)) for st in starts]
        return _build(policy, list(names), starts, sz, None, sizes)

    if policy == "block":
        order = block_order(names, sizes)
        counts = _block_counts(len(names), num_shards)
    elif policy == "zigzag":
        order = zigzag_order(names, sizes)
        counts = _block_counts(len(names), num_shards)
    elif policy == "lpt":
        order, counts = lpt_order(names, sizes, num_shards)
    else:
        raise ValueError(f"unknown layout policy {policy!r}; want {POLICIES}")
    if num_shards > len(names):
        raise ValueError(
            f"{policy!r} layout needs num_shards <= num_vars "
            f"({num_shards} > {len(names)}); use policy='flat'"
        )
    return _var_granular(policy, order, counts, sizes)


def fold_shards(
    base: LayoutAssignment, num_devices: int, sizes: dict[str, int]
) -> LayoutAssignment:
    """Fold an S-shard variable-granular assignment onto fewer owner devices:
    shard ``s`` lands on device ``s % num_devices``, keeping each shard's
    variable grouping intact.

    Reference parity: the launcher accepts ANY process split — ``run.sh 7 2``
    runs 7 PS processes serving 2 workers, each PS owning a block of the
    permuted variable list (mnist_sync_sharding/parameter_server.py:30-32).
    On TPU the shards co-locate with the workers (ZeRO), so when the
    requested shard count exceeds the mesh size the surplus shards wrap
    round-robin onto the devices — the balancing the policy computed over S
    bins is preserved per-bin, and the result is an ordinary
    ``num_devices``-shard assignment the step programs consume unchanged.
    ``flat`` never needs folding: re-splitting element-granular equal chunks
    over ``num_devices`` produces the identical ownership.
    """
    S, W = base.num_shards, num_devices
    if S <= W:
        return base
    if base.var_to_shard is None:
        raise ValueError("fold_shards applies to variable-granular layouts; "
                         "re-assign 'flat' over num_devices instead")
    groups: list[list[str]] = [[] for _ in range(W)]
    # base.order is grouped by shard in increasing shard index, so iterating
    # it appends each device's shards in round-robin order (d, d+W, d+2W, …)
    # with intra-shard order preserved.
    for n in base.order:
        groups[base.var_to_shard[n] % W].append(n)
    order = [n for g in groups for n in g]
    counts = [len(g) for g in groups]
    return _var_granular(base.policy, order, counts, sizes)
