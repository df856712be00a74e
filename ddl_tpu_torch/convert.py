"""Weight carry-over between the JAX package and the port.

The port stores parameters in the JAX package's layout (HWIO convs,
``[in, out]`` FCs, names ``v0..v13``) and its ZeRO-1 Adam moments as the
same flat per-shard vectors, so conversion is a check of names and shapes
and a placement: no transposes. Arrays cross as numpy (``np.asarray`` of a
JAX array), so this module needs nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.cnn import PARAM_SPECS, Specs
from .ops.optimizers import ShardedAdam


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

