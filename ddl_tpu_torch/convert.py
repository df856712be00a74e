"""Weight carry-over between the JAX package and the port.

The port stores parameters in the JAX package's layout (HWIO convs,
``[in, out]`` FCs, names ``v0..v13``; the LM's nested tree with ``[in,
out]`` projections) and its ZeRO-1 Adam moments as the same flat per-shard
vectors, so conversion is a check of names and shapes and a placement: no
transposes. Arrays cross as numpy (``np.asarray`` of a JAX array, or
``jax.tree.map(np.asarray, tree)``), so this module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.cnn import PARAM_SPECS, Specs
from .models.transformer import LMSpec, param_shapes
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


def _tree_from_numpy(np_tree, shapes, device, path: str = ""):
    """Check ``np_tree`` against the ``shapes`` tree (same dict keys, list
    lengths and leaf shapes) and place it as float32 tensors."""
    if isinstance(shapes, dict):
        if not isinstance(np_tree, dict) or sorted(np_tree) != sorted(shapes):
            got = sorted(np_tree) if isinstance(np_tree, dict) else type(np_tree).__name__
            raise ValueError(f"{path or 'params'}: names {got} != {sorted(shapes)}")
        return {k: _tree_from_numpy(np_tree[k], s, device, f"{path}/{k}") for k, s in shapes.items()}
    if isinstance(shapes, list):
        if not isinstance(np_tree, (list, tuple)) or len(np_tree) != len(shapes):
            raise ValueError(f"{path}: want a list of {len(shapes)}, got {np_tree!r:.60}")
        return [_tree_from_numpy(a, s, device, f"{path}/{i}")
                for i, (a, s) in enumerate(zip(np_tree, shapes))]
    a = np.asarray(np_tree)
    if a.shape != tuple(shapes):
        raise ValueError(f"{path}: shape {a.shape} != spec {tuple(shapes)}")
    return torch.tensor(a, dtype=torch.float32, device=device)


def lm_params_from_numpy(np_tree, spec: LMSpec, device: str | torch.device) -> dict:
    """JAX LM parameters (a nested tree of numpy arrays) -> the port's
    float32 tree on ``device``. Raises unless the names, nesting and shapes
    are exactly ``init_lm_params``' for ``spec``."""
    return _tree_from_numpy(np_tree, param_shapes(spec), device)


def lm_params_to_numpy(params) -> dict:
    """The port's LM parameter tree -> numpy, in the JAX package's layout."""
    return tree.map(lambda t: t.detach().cpu().numpy().copy(), params)


def adam_state_from_numpy(step, m, v, spec: LMSpec, device: str | torch.device) -> AdamState:
    """Tree-shaped TF1 Adam state (the JAX package's ``AdamState`` over the
    LM tree, as numpy) -> the port's, with ``m`` and ``v`` checked like the
    parameters."""
    return AdamState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=lm_params_from_numpy(m, spec, device),
        v=lm_params_from_numpy(v, spec, device),
    )


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
