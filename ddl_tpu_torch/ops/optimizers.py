"""TF1-semantics Adam — the port of ``ddl_tpu/ops/optimizers.py``.

The reference trains every variant with ``tf.compat.v1.train.AdamOptimizer(1e-4)``
(mnist_sync/model/model.py:93). TF1 Adam applies

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    m_t  = b1 * m + (1 - b1) * g
    v_t  = b2 * v + (1 - b2) * g^2
    p   -= lr_t * m_t / (sqrt(v_t) + eps)

with ``eps`` added *outside* the square root of the **uncorrected** second
moment. This is not ``torch.optim.Adam`` (which uses
``m_hat / (sqrt(v_hat) + eps)``), so the port keeps its own update.

Functional like the JAX original: ``adam_update`` returns new tensors. The
step counter is a device tensor, and so is ``lr_t``: no host sync per step.
``adam_init``/``adam_update`` take any parameter tree (``utils/tree.py``):
the CNN's flat dict or the LM's nested one; m and v mirror its structure.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils import tree


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # int32 scalar on the device, updates applied
    m: Any  # first moment, same tree as params
    v: Any  # second moment


@dataclasses.dataclass
class ShardedAdam:
    """ZeRO-1 Adam state: this rank's ``[max_shard]`` slice of the flat
    moments (the JAX package's ``strategies/sync.py::ShardedAdam``, whose
    global ``[W * max_shard]`` vectors are sharded over the mesh axis)."""

    step: torch.Tensor  # int32 scalar on the device
    m: torch.Tensor
    v: torch.Tensor


def adam_init(params: Any) -> AdamState:
    some = tree.leaves(params)[0]
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        m=tree.map(torch.zeros_like, params),
        v=tree.map(torch.zeros_like, params),
    )


def bias_corrected_lr(
    step: torch.Tensor, lr: float, b1: float, b2: float
) -> torch.Tensor:
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in float32 on the step's device
    (shape of ``step``), as the JAX package computes it."""
    t = step.to(torch.float32)
    return lr * torch.sqrt(1.0 - b2**t) / (1.0 - b1**t)


def adam_update(
    params: Any,
    state: AdamState,
    grads: Any,
    *,
    lr: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[Any, AdamState]:
    """One TF1-semantics Adam step over a parameter tree. Returns
    ``(new_params, new_state)``."""
    step = state.step + 1
    lr_t = bias_corrected_lr(step, lr, b1, b2)
    new_m = tree.map(lambda m, g: b1 * m + (1.0 - b1) * g, state.m, grads)
    new_v = tree.map(lambda v, g: b2 * v + (1.0 - b2) * g * g, state.v, grads)
    new_params = tree.map(
        lambda p, m, v: p - lr_t * m / (torch.sqrt(v) + eps), params, new_m, new_v
    )
    return new_params, AdamState(step=step, m=new_m, v=new_v)
