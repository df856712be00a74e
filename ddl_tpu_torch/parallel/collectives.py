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

The sequence-parallel LM adds two differentiable ones (autograd Functions,
whose backward is the transpose JAX takes):

- :func:`ring_shift`: every rank sends its tensors to the next rank of a
  :class:`Ring` and receives the previous rank's (``lax.ppermute`` with
  ``i -> i+1``); its backward shifts the gradients ``i -> i-1``. Tensors
  that move together move in one ``batch_isend_irecv`` and one autograd
  node, so every rank runs the same sequence of point-to-point calls in
  the backward pass too.
- :func:`seq_to_heads` / :func:`heads_to_seq`: Ulysses's tiled
  ``all_to_all`` (``split_axis=2, concat_axis=1`` and back) over
  ``all_to_all_single``; each one's backward is the other.

``LOCAL`` stands for "no process group": a ring or sequence axis of one
whose collectives are identities and are not called.

Tensor parallelism adds Megatron's conjugate pair, two autograd Functions
over the tp group: :func:`tp_allreduce` (``g``: all-reduce forward,
identity backward) completes a row-sharded matmul's partial sums, and
:func:`tp_promote` (``f``: identity forward, all-reduce backward) marks
where the tp-replicated residual stream enters the column-sharded matmuls.
:func:`all_gather_list` gathers one vector a rank over a group as a list
(the form gloo also takes for CUDA tensors).

Pipeline parallelism adds :func:`stage_hop`, one tick's point-to-point
exchange between neighbouring stages (``lax.ppermute`` over the pp axis in
JAX): the activations go to the next stage, the cotangents to the previous
one, all in one ``batch_isend_irecv``.

The reductions over the world take an optional ``group``: a process group
that stands for the world in them (the LM's ``(dp, sp)`` group under
tensor parallelism), of ``dist.get_world_size(group)`` ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from .layout import LayoutAssignment
from .mesh import LOCAL, World


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


def _size(world: World, group) -> int:
    return world.size if group is None else dist.get_world_size(group)


def _reduce_scatter(rows: torch.Tensor, world: World, mean: bool, group=None) -> torch.Tensor:
    """Sum ``rows`` ``[W, chunk]`` over the world (or ``group``); return
    this rank's reduced row (divided by W when ``mean``, after the sum, as
    JAX does)."""
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    # Passed flat: gloo takes only a 1-D [W * chunk] input.
    dist.reduce_scatter_tensor(out, rows.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    if mean:
        out = out / rows.shape[0]
    return out


def reduce_scatter_flat(
    flat: torch.Tensor, world: World, *, mean: bool, chunk: int, group=None
) -> torch.Tensor:
    """Reduce-scatter a (padded) flat vector over the world (or ``group``);
    returns this rank's reduced chunk ``[chunk]``. ``chunk`` is the
    layout's ``max_shard``, so the row split matches the flat layout's
    lane-aligned shard boundaries."""
    W = _size(world, group)
    return _reduce_scatter(pad_to(flat, chunk * W).view(W, chunk), world, mean, group)


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


def all_reduce_sum(t: torch.Tensor, world: World, group=None) -> torch.Tensor:
    """Sum ``t`` over the world (or ``group``) in place (``lax.psum``);
    returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_flat(shard: torch.Tensor, world: World, group=None) -> torch.Tensor:
    """Concatenate every rank's ``[chunk]`` shard in rank order:
    ``[W * chunk]``, over the world (or ``group``)."""
    out = torch.empty(_size(world, group) * shard.shape[0], dtype=shard.dtype,
                      device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


def all_gather_list(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all) in group rank order, through
    the list form of ``all_gather``."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
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


# ---------------------------------------------------------------------------
# Sequence-parallel transports (differentiable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ring:
    """A ring of ranks: ``ranks`` (global ranks, in ring order) over
    ``group``; this rank is ``ranks[index]``."""

    group: object
    ranks: tuple[int, ...]
    index: int

    @property
    def next(self) -> int:
        return self.ranks[(self.index + 1) % len(self.ranks)]

    @property
    def prev(self) -> int:
        return self.ranks[(self.index - 1) % len(self.ranks)]


def _shift(xs, dst: int, src: int, group) -> tuple[torch.Tensor, ...]:
    """Send each of ``xs`` to ``dst`` and receive as many from ``src``, all
    in one batch."""
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring: Ring, *xs):
        ctx.ring = ring
        return _shift(xs, ring.next, ring.prev, ring.group)

    @staticmethod
    def backward(ctx, *gs):
        ring = ctx.ring
        return (None, *_shift(gs, ring.prev, ring.next, ring.group))


def ring_shift(ring: Ring, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``xs`` of the previous rank of ``ring`` (each rank's go to the
    next)."""
    return _RingShift.apply(ring, *xs)


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *kept):
        ctx.like = [(x.shape, x.dtype, x.device) for x in kept]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.like))


def keep_in_backward(out: torch.Tensor, *kept: torch.Tensor) -> torch.Tensor:
    """``out``, with a zero gradient flowing back into each of ``kept``.

    Autograd runs a node's backward only when some output of it receives a
    gradient. A rank whose causal sweep skips the last blocks it receives
    would then never run the last ring shifts' backward while its
    neighbours wait in theirs; JAX's transpose of ``ppermute`` always runs.
    Tying the last received blocks to the output makes every rank run
    every shift's backward, in the same order."""
    if not torch.is_grad_enabled() or not any(x.requires_grad for x in kept):
        return out
    return _Keep.apply(out, *kept)


def _all_to_all(group, size: int, xs, split_axis: int, concat_axis: int):
    """JAX's tiled ``all_to_all`` of every tensor of ``xs`` over a group of
    ``size``: each tensor's ``split_axis`` is cut into ``size`` blocks,
    block ``j`` goes to group rank ``j``, and the blocks received are
    concatenated along ``concat_axis`` in the senders' order. One
    ``all_to_all_single`` carries all of ``xs``. The results are contiguous
    (a copy out of the receive buffer where the layout needs one), so the
    flash wrapper's own ``.contiguous()`` copies nothing."""
    shape = xs[0].shape
    n = shape[split_axis] // size
    # Send buffer [size, len(xs), *shape with split_axis cut to n]: block j
    # of each tensor in row j.
    block = list(shape)
    block[split_axis] = n
    send = torch.empty((size, len(xs), *block), dtype=xs[0].dtype, device=xs[0].device)
    for i, x in enumerate(xs):
        split = x.unflatten(split_axis, (size, n)).movedim(split_axis, 0)
        send[:, i].copy_(split)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = []
    for i in range(len(xs)):
        # Row s came from group rank s: it goes to block s of concat_axis.
        r = recv[:, i].movedim(0, concat_axis)
        out.append(r.flatten(concat_axis, concat_axis + 1))
    return tuple(o.contiguous() for o in out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, size: int, split_axis: int, concat_axis: int, *xs):
        ctx.args = (group, size, split_axis, concat_axis)
        return _all_to_all(group, size, xs, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, *gs):
        group, size, split_axis, concat_axis = ctx.args
        return (None, None, None, None, *_all_to_all(group, size, gs, concat_axis, split_axis))


def seq_to_heads(group, size: int, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``[B, T/P, H, D]`` sequence shards -> ``[B, T, H/P, D]`` head shards
    (rank ``j`` gets head block ``j``; ``lax.all_to_all(split_axis=2,
    concat_axis=1, tiled=True)``)."""
    if group is LOCAL:
        return xs
    return _AllToAll.apply(group, size, 2, 1, *xs)


def heads_to_seq(group, size: int, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The inverse of :func:`seq_to_heads` (``split_axis=1,
    concat_axis=2``)."""
    if group is LOCAL:
        return xs
    return _AllToAll.apply(group, size, 1, 2, *xs)


# ---------------------------------------------------------------------------
# Tensor-parallel conjugate pair (Megatron f/g)
# ---------------------------------------------------------------------------


def _group_sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _TPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _group_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _TPPromote(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _group_sum(g, ctx.group)


def tp_allreduce(group):
    """Megatron's ``g`` over the tp ``group``: all-reduce forward, identity
    backward. It completes a row-sharded matmul's partial sums (the ``wo``
    and ``w2`` outputs). Its output is consumed alike by every tp member,
    so its cotangent is already the same on each; re-reducing it, as
    ``torch.distributed.nn.functional.all_reduce``'s backward does, would
    scale the gradients by the tp degree. Conjugate of
    :func:`tp_promote`."""
    if group is LOCAL:
        return lambda x: x
    return lambda x: _TPAllReduce.apply(group, x)


def tp_promote(group):
    """Megatron's ``f`` over the tp ``group``: identity forward, all-reduce
    backward. Where the tp-replicated residual stream enters the
    column-sharded matmuls each member's branch yields only a partial
    cotangent; the all-reduce completes it, so the LayerNorms, earlier
    blocks and the embedding see full gradients. Conjugate of
    :func:`tp_allreduce`."""
    if group is LOCAL:
        return lambda x: x
    return lambda x: _TPPromote.apply(group, x)


# ---------------------------------------------------------------------------
# Pipeline stage hops
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HopTally:
    """Bytes moved by :func:`stage_hop`: ``wire_bytes`` sent and received
    by this rank, ``host_copy_bytes`` copied between the device and host
    buffers on the way (a gloo group's CUDA tensors), ``hops`` the calls."""

    wire_bytes: int = 0
    host_copy_bytes: int = 0
    hops: int = 0


def stage_hop(sends, recvs, group, tally: HopTally | None = None) -> list[torch.Tensor]:
    """One tick's exchange between pipeline neighbours: each ``(tensor,
    dst)`` of ``sends`` goes to global rank ``dst`` and each ``(like, src)``
    of ``recvs`` arrives from global rank ``src`` into a new tensor of
    ``like``'s shape, dtype and device; one ``batch_isend_irecv`` over
    ``group`` carries them all (``ring_shift``'s pattern: both neighbours
    read the same tick tables, so every send meets its receive). Returns
    the received tensors in ``recvs`` order.

    gloo's point-to-point takes CPU tensors only, so on a gloo group a CUDA
    tensor crosses through a host buffer, copied explicitly (decided by
    the group's backend); NCCL takes the device tensors themselves."""
    staged = dist.get_backend(group) == "gloo"
    ops, bufs, host = [], [], 0
    for x, dst in sends:
        x = x.detach().contiguous()
        if staged and x.is_cuda:
            x = x.cpu()
            host += x.numel() * x.element_size()
        ops.append(dist.P2POp(dist.isend, x, dst, group))
    for like, src in recvs:
        on_host = staged and like.is_cuda
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if on_host else like.device)
        bufs.append((buf, like.device if on_host else None))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = []
    for buf, device in bufs:
        if device is not None:
            host += buf.numel() * buf.element_size()
            buf = buf.to(device)
        out.append(buf)
    if tally is not None:
        tally.hops += 1
        tally.host_copy_bytes += host
        tally.wire_bytes += sum(x.numel() * x.element_size() for x, _ in sends)
        tally.wire_bytes += sum(b.numel() * b.element_size() for b, _ in bufs)
    return out
