"""Weight carry-over between the JAX package and the port.

The port stores parameters in the JAX package's layout (HWIO convs,
``[in, out]`` FCs, names ``v0..v13``; the LM's nested tree with ``[in,
out]`` projections) and its ZeRO-1 Adam moments as the same flat per-shard
vectors, so conversion is a check of names and shapes and a placement: no
transposes. The serving KV caches convert likewise, with the drop row or
page the port's caches add (``serve/cache.py``). Under tensor parallelism a
rank holds its Megatron shard of the LM (``models/partition.py``): the
full JAX tree goes in and comes back out, the shards live on the ranks.
Arrays cross as numpy (``np.asarray`` of a JAX array, or
``jax.tree.map(np.asarray, tree)``), so this module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.cnn import PARAM_SPECS, Specs
from .models.transformer import LMSpec, param_shapes
from .ops.kv_cache import PAD_POS
from .ops.optimizers import AdamState, ShardedAdam
from .utils import tree


def params_from_numpy(
    np_params: Mapping[str, np.ndarray],
    device: str | torch.device,
    specs: Specs = PARAM_SPECS,
) -> dict[str, torch.Tensor]:
    """JAX parameters (as numpy) -> the port's float32 tensors on
    ``device``. Raises unless the names and shapes are exactly ``specs``'."""
    want = [name for name, _ in specs]
    if sorted(np_params) != sorted(want):
        raise ValueError(f"parameter names {sorted(np_params)} != {sorted(want)}")
    out = {}
    for name, shape in specs:
        a = np.asarray(np_params[name])
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape} != spec {tuple(shape)}")
        out[name] = torch.tensor(a, dtype=torch.float32, device=device)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's parameters -> numpy, in the JAX package's layout."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def sharded_adam_from_numpy(
    step, m: np.ndarray, v: np.ndarray, device: str | torch.device
) -> ShardedAdam:
    """One rank's ZeRO-1 Adam state from numpy: ``m``/``v`` are that rank's
    ``[max_shard]`` slices of the JAX package's ``[W * max_shard]`` vectors."""
    m, v = np.asarray(m), np.asarray(v)
    if m.ndim != 1 or m.shape != v.shape:
        raise ValueError(f"m and v must be equal flat vectors, got {m.shape} and {v.shape}")
    return ShardedAdam(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=torch.tensor(m, dtype=torch.float32, device=device),
        v=torch.tensor(v, dtype=torch.float32, device=device),
    )


def _check_tree(np_tree, shapes, path: str = "") -> None:
    """Raise unless ``np_tree`` has the ``shapes`` tree's dict keys, list
    lengths and leaf shapes."""
    if isinstance(shapes, dict):
        if not isinstance(np_tree, dict) or sorted(np_tree) != sorted(shapes):
            got = sorted(np_tree) if isinstance(np_tree, dict) else type(np_tree).__name__
            raise ValueError(f"{path or 'params'}: names {got} != {sorted(shapes)}")
        for k, s in shapes.items():
            _check_tree(np_tree[k], s, f"{path}/{k}")
    elif isinstance(shapes, list):
        if not isinstance(np_tree, (list, tuple)) or len(np_tree) != len(shapes):
            raise ValueError(f"{path}: want a list of {len(shapes)}, got {np_tree!r:.60}")
        for i, (a, s) in enumerate(zip(np_tree, shapes)):
            _check_tree(a, s, f"{path}/{i}")
    elif np.shape(np_tree) != tuple(shapes):
        raise ValueError(f"{path}: shape {np.shape(np_tree)} != spec {tuple(shapes)}")


def lm_params_from_numpy(np_tree, spec: LMSpec, device: str | torch.device, *,
                         tensor_parallel: int = 1, tp_index: int = 0,
                         pipeline_parallel: int = 1, pp_index: int = 0) -> dict:
    """JAX LM parameters (the full nested tree of numpy arrays) -> the
    port's float32 tree on ``device``: at ``tensor_parallel > 1``, rank
    ``tp_index``'s Megatron shard of it; at ``pipeline_parallel > 1``,
    stage ``pp_index``'s blocks and the shared leaves
    (``models.partition.shard_stage_params``). Raises unless the names,
    nesting and shapes are exactly ``init_lm_params``' for ``spec``."""
    from .models.partition import shard_stage_params

    _check_tree(np_tree, param_shapes(spec))
    shard = shard_stage_params(tree.map(np.asarray, np_tree), spec, pipeline_parallel,
                               pp_index, tensor_parallel, tp_index)
    return tree.map(lambda a: torch.tensor(a, dtype=torch.float32, device=device), shard)


def lm_params_to_numpy(params) -> dict:
    """The port's LM parameter tree -> numpy, in the JAX package's layout.
    Every tp rank's shard, in tp order, makes the full tree through
    ``models.partition.gather_lm_params``."""
    return tree.map(lambda t: t.detach().cpu().numpy().copy(), params)


def _template(spec: LMSpec) -> dict:
    """Zero tensors in the shapes of ``spec``'s parameter tree: the
    template the flat plans take their shapes from."""
    return {k: [{n: torch.zeros(s) for n, s in blk.items()} for blk in v] if k == "blocks"
            else torch.zeros(v) for k, v in param_shapes(spec).items()}


def lm_zeros_numpy(spec: LMSpec) -> dict:
    """Numpy float32 zeros in the shapes of ``spec``'s full parameter tree:
    the template a checkpoint load reads shapes and dtypes from."""
    return {k: [{n: np.zeros(s, np.float32) for n, s in blk.items()} for blk in v]
            if k == "blocks" else np.zeros(v, np.float32) for k, v in param_shapes(spec).items()}


def adam_state_from_numpy(step, m, v, spec: LMSpec, device: str | torch.device) -> AdamState:
    """Tree-shaped TF1 Adam state (the JAX package's ``AdamState`` over the
    LM tree, as numpy) -> the port's, with ``m`` and ``v`` checked like the
    parameters."""
    return AdamState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=lm_params_from_numpy(m, spec, device),
        v=lm_params_from_numpy(v, spec, device),
    )


def lm_sharded_adam_from_numpy(step, m, v, spec: LMSpec, rank: int, world_size: int,
                               device: str | torch.device) -> ShardedAdam:
    """The LM's ZeRO-1 Adam state in its logical form (params-shaped numpy
    ``m``/``v`` trees, as the JAX package's checkpoints hold it) -> rank
    ``rank``'s ``ShardedAdam``: the trees flattened in ``utils.tree.leaves``
    order, zero-padded to ``world_size`` equal chunks, chunk ``rank``."""
    from .parallel.collectives import chunk_size, pad_to
    from .strategies.seq import _FlatPlan

    flat = [_FlatPlan.flatten(lm_params_from_numpy(t, spec, "cpu")) for t in (m, v)]
    chunk = chunk_size(flat[0].numel(), world_size)
    mine = slice(rank * chunk, (rank + 1) * chunk)
    m_own, v_own = (pad_to(f, chunk * world_size)[mine].to(device) for f in flat)
    return ShardedAdam(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=m_own, v=v_own,
    )


def lm_sharded_adam_to_numpy(rank_states, spec: LMSpec) -> dict:
    """Inverse of :func:`lm_sharded_adam_from_numpy` over every rank's
    state (in rank order): ``{"step", "m", "v"}`` with params-shaped numpy
    ``m`` and ``v`` trees (padding dropped)."""
    from .strategies.seq import _FlatPlan

    plan = _FlatPlan(_template(spec))
    out = {"step": np.asarray(int(rank_states[0].step), np.int32)}
    for k in ("m", "v"):
        flat = torch.cat([getattr(s, k).detach().cpu() for s in rank_states])
        out[k] = lm_params_to_numpy(plan.unflatten(flat))
    return out


def lm_hybrid_adam_from_numpy(step, m, v, spec: LMSpec, rank: int, *, tensor_parallel: int,
                              data_ranks: int, device: str | torch.device):
    """The hybrid ZeRO-1 x tp Adam state in its logical form (params-shaped
    numpy ``m``/``v`` trees, JAX's ``_opt_for_save`` form) -> global rank
    ``rank``'s ``strategies.seq.HybridAdam`` on a grid of ``data_ranks``
    ``(dp, sp)`` ranks by ``tensor_parallel``: the replicated leaves
    flattened in ``utils.tree.leaves`` order, zero-padded to
    ``data_ranks`` equal chunks, chunk ``rank // tensor_parallel``; the
    tp-sharded leaves as the rank's shards, in the same order."""
    from .models.partition import lm_param_specs
    from .parallel.collectives import chunk_size, pad_to
    from .strategies.seq import HybridAdam, _HybridPlan

    specs = lm_param_specs(spec, tensor_parallel)
    t, data_index = rank % tensor_parallel, rank // tensor_parallel
    parts = {}
    for name, full in (("m", m), ("v", v)):
        shard = lm_params_from_numpy(full, spec, "cpu", tensor_parallel=tensor_parallel,
                                     tp_index=t)
        plan = _HybridPlan(shard, specs)
        rep, tp = plan.split(tree.leaves(shard))
        flat = plan.flatten_rep(rep)
        chunk = chunk_size(flat.numel(), data_ranks)
        own = pad_to(flat, chunk * data_ranks)[data_index * chunk:(data_index + 1) * chunk]
        parts[name] = (own.to(device), [x.to(device) for x in tp])
    return HybridAdam(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m_flat=parts["m"][0], v_flat=parts["v"][0], m_tp=parts["m"][1], v_tp=parts["v"][1],
    )


def lm_hybrid_adam_to_numpy(rank_states, spec: LMSpec, *, tensor_parallel: int) -> dict:
    """Inverse of :func:`lm_hybrid_adam_from_numpy` over every rank's state
    (in global rank order): ``{"step", "m", "v"}`` with params-shaped
    numpy trees (padding dropped). The flat chunks come from the ranks of
    tp index 0 in chunk order, the tp shards from the first ``(dp, sp)``
    cell's ranks."""
    from .models.partition import gather_lm_params, lm_param_specs, shard_lm_params
    from .strategies.seq import _HybridPlan

    tp = tensor_parallel
    specs = lm_param_specs(spec, tp)
    full_like = _template(spec)
    out = {"step": np.asarray(int(rank_states[0].step), np.int32)}
    for k in ("m", "v"):
        flat = torch.cat([getattr(s, f"{k}_flat").detach().cpu() for s in rank_states[::tp]])
        shards = []
        for t in range(tp):
            plan = _HybridPlan(shard_lm_params(full_like, specs, tp, t), specs)
            rep = plan.unflatten_rep(flat)
            shards.append(lm_params_to_numpy(
                plan.merge(rep, [x.detach().cpu() for x in getattr(rank_states[t], f"{k}_tp")])))
        out[k] = gather_lm_params(shards, specs)
    return out


def lm_pipeline_adam_from_numpy(step, m, v, spec: LMSpec, *, pipeline_parallel: int,
                                pp_index: int, tensor_parallel: int = 1, tp_index: int = 0,
                                device: str | torch.device) -> AdamState:
    """The pipeline's Adam state in its logical form (params-shaped numpy
    ``m``/``v`` trees, JAX's ``_opt_for_save`` form) -> the tree
    ``AdamState`` of rank ``(tp_index, pp_index)``: its stage's moments,
    placed like its parameters (:func:`lm_params_from_numpy`)."""
    kw = dict(tensor_parallel=tensor_parallel, tp_index=tp_index,
              pipeline_parallel=pipeline_parallel, pp_index=pp_index)
    return AdamState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=lm_params_from_numpy(m, spec, device, **kw),
        v=lm_params_from_numpy(v, spec, device, **kw),
    )


def lm_pipeline_adam_to_numpy(rank_states, spec: LMSpec, *, pipeline_parallel: int,
                              tensor_parallel: int = 1) -> dict:
    """Inverse of :func:`lm_pipeline_adam_from_numpy` over the states of
    the ranks of one ``(dp, sp)`` cell, in global rank order (rank ``t *
    pipeline_parallel + p`` holds tp shard ``t`` of stage ``p``):
    ``{"step", "m", "v"}`` with params-shaped numpy trees."""
    from .models.partition import (
        gather_lm_params, gather_stage_params, lm_param_specs, stage_spec)

    pp, tp = pipeline_parallel, tensor_parallel
    specs = lm_param_specs(stage_spec(spec, pp), tp)
    out = {"step": np.asarray(int(rank_states[0].step), np.int32)}
    for k in ("m", "v"):
        stages = [gather_lm_params([lm_params_to_numpy(getattr(rank_states[t * pp + p], k))
                                    for t in range(tp)], specs) for p in range(pp)]
        out[k] = gather_stage_params(stages)
    return out


def async_state_from_numpy(state, rank: int, world_size: int, *, sharded: bool,
                           device: str | torch.device):
    """The JAX package's global ``AsyncState`` (as numpy: ``ps``, ``m``,
    ``v``, ``workers`` ``[W, total]`` and ``t``) -> rank ``rank``'s
    ``strategies.async_ps.AsyncState``. Sharded: the rank's ``[chunk]`` of
    the owner-major ``[W * chunk]`` ps/m/v and its replica row ``workers[r]``
    as ``[1, total]``; replicated: everything."""
    from .strategies.async_ps import AsyncState

    ps, m, v, workers = (np.asarray(getattr(state, k), np.float32)
                         for k in ("ps", "m", "v", "workers"))
    if ps.ndim != 1 or m.shape != ps.shape or v.shape != ps.shape or workers.ndim != 2:
        raise ValueError(f"want flat ps/m/v and [W, total] workers, got {ps.shape}, "
                         f"{m.shape}, {v.shape}, {workers.shape}")
    if workers.shape[0] != world_size:
        raise ValueError(f"workers has {workers.shape[0]} rows for a world of {world_size}")
    if sharded:
        if ps.shape[0] % world_size:
            raise ValueError(f"ps of {ps.shape[0]} does not split into {world_size} chunks")
        chunk = ps.shape[0] // world_size
        mine = slice(rank * chunk, (rank + 1) * chunk)
        ps, m, v, workers = ps[mine], m[mine], v[mine], workers[rank : rank + 1]
    put = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return AsyncState(ps=put(ps), m=put(m), v=put(v), workers=put(workers),
                      t=torch.tensor(int(np.asarray(state.t)), dtype=torch.int32, device=device))


def async_state_to_numpy(rank_states, *, sharded: bool) -> dict[str, np.ndarray]:
    """Inverse of :func:`async_state_from_numpy` over every rank's state (in
    rank order): the JAX package's global form as a dict of numpy arrays
    (``ps``, ``m``, ``v``, ``workers`` ``[W, total]``, ``t``). Sharded: the
    chunks and replica rows concatenated; replicated: rank 0's state, which
    every rank holds."""
    np_of = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    if not sharded:
        s = rank_states[0]
        return {"ps": np_of(s.ps), "m": np_of(s.m), "v": np_of(s.v),
                "workers": np_of(s.workers), "t": np.asarray(int(s.t), np.int32)}
    cat = lambda k: np.concatenate([np_of(getattr(s, k)) for s in rank_states])  # noqa: E731
    return {"ps": cat("ps"), "m": cat("m"), "v": cat("v"), "workers": cat("workers"),
            "t": np.asarray(int(rank_states[0].t), np.int32)}


def kv_cache_from_numpy(np_cache, *, paged: bool, device: str | torch.device):
    """The JAX package's serving cache (anything with numpy ``k``, ``v`` and
    ``pos``: a ``KVCache`` ``[L, S, C, H, D]`` / ``[S, C]``, or with
    ``paged`` a ``PagedKVCache`` ``[L, P, page, H, D]`` / ``[P, page]``) ->
    the port's, with the drop row of each slot (contiguous) or the drop page
    (paged) appended."""
    from .serve.cache import KVCache, PagedKVCache

    k, v, pos = (np.asarray(getattr(np_cache, n)) for n in ("k", "v", "pos"))
    if k.ndim != 5 or v.shape != k.shape or pos.shape != k.shape[1:3]:
        raise ValueError(f"want k/v [L, S|P, C|page, H, D] and pos [S|P, C|page], got "
                         f"{k.shape}, {v.shape}, {pos.shape}")
    axis = 1 if paged else 2  # the pages, or each slot's rows

    def put(a, ax, fill):
        pad = list(a.shape)
        pad[ax] = 1
        return torch.tensor(np.concatenate([a, np.full(pad, fill, a.dtype)], axis=ax),
                            device=device)

    cls = PagedKVCache if paged else KVCache
    return cls(k=put(k.astype(np.float32), axis, 0.0), v=put(v.astype(np.float32), axis, 0.0),
               pos=put(pos.astype(np.int32), axis - 1, PAD_POS))


def kv_cache_to_numpy(cache) -> dict[str, np.ndarray]:
    """Inverse of :func:`kv_cache_from_numpy`: the port's ``KVCache`` or
    ``PagedKVCache`` -> ``{"k", "v", "pos"}`` numpy in the JAX package's
    shapes (drop row or page removed), with ``k_scale``/``v_scale`` for an
    int8 pool."""
    from .serve.cache import PagedKVCache

    np_of = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    if isinstance(cache, PagedKVCache):
        n = cache.num_pages
        out = {"k": np_of(cache.k[:, :n]), "v": np_of(cache.v[:, :n]), "pos": np_of(cache.pos[:n])}
        if cache.k_scale is not None:  # the int8 pool's scale planes
            out.update(k_scale=np_of(cache.k_scale[:, :n]), v_scale=np_of(cache.v_scale[:, :n]))
        return out
    c = cache.capacity
    return {"k": np_of(cache.k[:, :, :c]), "v": np_of(cache.v[:, :, :c]),
            "pos": np_of(cache.pos[:, :c])}
