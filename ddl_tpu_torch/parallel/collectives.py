"""Collective transport over ``torch.distributed`` — the port of
``ddl_tpu/parallel/collectives.py``.

JAX's ``lax.psum_scatter`` / ``lax.all_gather`` inside ``shard_map`` become
``reduce_scatter_tensor`` / ``all_gather_into_tensor`` on the process group
(NCCL on the card, gloo in the CPU test worlds). The static plans
(``FlatSpec``, ``OwnerSlices``, the reassembly index) are computed once in
numpy, identical to the JAX package's.

Two sharded-update paths, selected by the layout policy:

- **equal-chunk ("flat")**: pad the flat vector to ``S * chunk`` and
  reduce-scatter it in one call; update locally; all-gather back.
- **var-aligned (block/zigzag/lpt)**: gather the flat vector into
  owner-major padded rows ``[W, max_shard]`` (:func:`owner_slices`, rows may
  overlap) and reduce-scatter the rows; update locally; all-gather, then
  reassemble with :func:`reassembly_index`.

The async serve adds two transports: :func:`all_gather_rows` (every rank's
full gradient, the replicated serve) and :func:`all_to_all_rows` (gradient
slices to their owners and replica pieces back, the sharded serve).

``tp_allreduce`` and ``tp_promote`` (the tensor-parallel pair) are not
ported yet: they belong to the LM slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from .layout import LayoutAssignment
from .mesh import World


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static flatten/unflatten plan for a param dict in layout order."""

    order: tuple[str, ...]
    shapes: dict[str, tuple[int, ...]]
    offsets: dict[str, int]
    total: int

    @classmethod
    def from_layout(
        cls, layout: LayoutAssignment, shapes: Mapping[str, tuple[int, ...]]
    ) -> "FlatSpec":
        return cls(
            order=layout.order,
            shapes={n: tuple(shapes[n]) for n in layout.order},
            offsets=dict(layout.var_offsets),
            total=layout.total,
        )


def flatten_params(params: Mapping[str, torch.Tensor], spec: FlatSpec) -> torch.Tensor:
    """Concatenate params into one 1-D vector in layout order."""
    return torch.cat([params[n].reshape(-1) for n in spec.order])


def unflatten_params(flat: torch.Tensor, spec: FlatSpec) -> dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_params` (ignores any padding tail). The
    results are views of ``flat``."""
    out = {}
    for n in spec.order:
        off = spec.offsets[n]
        size = int(np.prod(spec.shapes[n])) if spec.shapes[n] else 1
        out[n] = flat[off : off + size].view(spec.shapes[n])
    return out


# ---------------------------------------------------------------------------
# Equal-chunk (ZeRO-1 "flat") path
# ---------------------------------------------------------------------------


def chunk_size(total: int, num_shards: int) -> int:
    return -(-total // num_shards)


def pad_to(flat: torch.Tensor, padded_total: int) -> torch.Tensor:
    return torch.nn.functional.pad(flat, (0, padded_total - flat.shape[0]))


def _reduce_scatter(rows: torch.Tensor, world: World, mean: bool) -> torch.Tensor:
    """Sum ``rows`` ``[W, chunk]`` over the world; return this rank's
    reduced row (divided by W when ``mean``, after the sum, as JAX does)."""
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    # Passed flat: gloo takes only a 1-D [W * chunk] input.
    dist.reduce_scatter_tensor(out, rows.reshape(-1), op=dist.ReduceOp.SUM)
    if mean:
        out = out / world.size
    return out


def reduce_scatter_flat(
    flat: torch.Tensor, world: World, *, mean: bool, chunk: int
) -> torch.Tensor:
    """Reduce-scatter a (padded) flat vector over the world; returns this
    rank's reduced chunk ``[chunk]``. ``chunk`` is the layout's
    ``max_shard``, so the row split matches the flat layout's lane-aligned
    shard boundaries."""
    W = world.size
    return _reduce_scatter(pad_to(flat, chunk * W).view(W, chunk), world, mean)


# ---------------------------------------------------------------------------
# Var-aligned (unequal shards) path
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OwnerSlices:
    """Static owner-major slicing plan for a var-aligned layout on a
    ``num_devices`` world: ``starts[s]`` is shard s's flat offset (surplus
    ranks own an empty range parked at the zero padding tail); ``pad_len``
    bounds every ``(start, chunk)`` slice; ``slice_idx`` is the
    ``[W, chunk]`` gather map. Rows may overlap for unbalanced layouts."""

    starts: np.ndarray  # [W] int32 flat offsets
    pad_len: int
    slice_idx: np.ndarray  # [W, chunk] int32 gather map


def owner_slices(layout: LayoutAssignment, num_devices: int) -> OwnerSlices:
    chunk = layout.max_shard
    starts = np.asarray(layout.shard_starts, np.int32)
    if len(starts) < num_devices:
        starts = np.concatenate([
            starts,
            np.full(num_devices - len(starts), layout.total, np.int32),
        ])
    pad_len = max(num_devices * chunk, layout.total + chunk)
    slice_idx = np.minimum(
        starts[:, None] + np.arange(chunk, dtype=np.int32)[None, :],
        pad_len - 1,
    )
    return OwnerSlices(starts=starts, pad_len=pad_len, slice_idx=slice_idx)


def owner_rows(
    flat: torch.Tensor, sl: OwnerSlices, index: torch.Tensor | None = None
) -> torch.Tensor:
    """Gather a flat vector into owner-major padded rows ``[W, chunk]``.
    ``index`` is ``sl.slice_idx`` already placed on ``flat``'s device
    (the step bodies keep one; absent, it is made here)."""
    if index is None:
        index = torch.as_tensor(sl.slice_idx, dtype=torch.long, device=flat.device)
    return pad_to(flat, sl.pad_len)[index]


def reduce_scatter_rows(
    flat: torch.Tensor,
    sl: OwnerSlices,
    world: World,
    *,
    mean: bool,
    index: torch.Tensor,
) -> torch.Tensor:
    """True reduce-scatter for a VAR-ALIGNED layout: gather the local flat
    vector into owner-major rows (:func:`owner_rows`, ``index`` its gather
    map on the device) and reduce-scatter the rows, so this rank receives
    only its reduced ``[chunk]`` shard."""
    return _reduce_scatter(owner_rows(flat, sl, index), world, mean)


def all_reduce_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """Sum ``t`` over the world in place (``lax.psum``); returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_gather_flat(shard: torch.Tensor, world: World) -> torch.Tensor:
    """Concatenate every rank's ``[chunk]`` shard in rank order:
    ``[W * chunk]``."""
    out = torch.empty(world.size * shard.shape[0], dtype=shard.dtype, device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous())
    return out


def all_gather_rows(row: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's ``[n]`` row stacked in rank order: ``[W, n]``
    (``lax.all_gather(row, tiled=False)``)."""
    return all_gather_flat(row, world).view(world.size, -1)


def all_to_all_rows(rows: torch.Tensor, world: World) -> torch.Tensor:
    """Row ``s`` of ``rows`` ``[W, chunk]`` goes to rank ``s``; row ``r`` of
    the result is what rank ``r`` sent here (``lax.all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``). The async serve's scatter of gradient
    slices to their owners and its return of refreshed replica pieces."""
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows.contiguous())
    return out


def reassembly_index(layout: LayoutAssignment) -> np.ndarray:
    """Static gather map: flat position j -> its position in the
    concatenation of per-shard padded owner slices ``[S * max_shard]``."""
    idx = np.empty(layout.total, dtype=np.int32)
    m = layout.max_shard
    for s, (start, size) in enumerate(zip(layout.shard_starts, layout.shard_sizes)):
        idx[start : start + size] = s * m + np.arange(size, dtype=np.int32)
    return idx


def to_logical(padded_flat, layout: LayoutAssignment) -> np.ndarray:
    """Per-shard padded concatenation ``[>= S * max_shard]`` -> logical flat
    ``[total]`` in THIS layout's variable order."""
    return np.asarray(padded_flat)[reassembly_index(layout)]


def from_logical(logical, layout: LayoutAssignment, n: int) -> np.ndarray:
    """Inverse of :func:`to_logical`: scatter a logical flat vector into an
    ``[n]`` per-shard padded concatenation (padding stays zero)."""
    logical = np.asarray(logical)
    out = np.zeros(n, logical.dtype)
    out[reassembly_index(layout)] = logical
    return out
