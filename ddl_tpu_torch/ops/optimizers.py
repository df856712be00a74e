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
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # int32 scalar on the device, updates applied
    m: dict[str, torch.Tensor]  # first moment, same structure as params
    v: dict[str, torch.Tensor]  # second moment


@dataclasses.dataclass
class ShardedAdam:
    """ZeRO-1 Adam state: this rank's ``[max_shard]`` slice of the flat
    moments (the JAX package's ``strategies/sync.py::ShardedAdam``, whose
    global ``[W * max_shard]`` vectors are sharded over the mesh axis)."""

    step: torch.Tensor  # int32 scalar on the device
    m: torch.Tensor
    v: torch.Tensor


def adam_init(params: dict[str, torch.Tensor]) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
    )


def bias_corrected_lr(
    step: torch.Tensor, lr: float, b1: float, b2: float
) -> torch.Tensor:
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in float32 on the step's device
    (shape of ``step``), as the JAX package computes it."""
    t = step.to(torch.float32)
    return lr * torch.sqrt(1.0 - b2**t) / (1.0 - b1**t)


def adam_update(
    params: dict[str, torch.Tensor],
    state: AdamState,
    grads: dict[str, torch.Tensor],
    *,
    lr: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One TF1-semantics Adam step. Returns ``(new_params, new_state)``."""
    step = state.step + 1
    lr_t = bias_corrected_lr(step, lr, b1, b2)
    new_m = {k: b1 * state.m[k] + (1.0 - b1) * grads[k] for k in params}
    new_v = {k: b2 * state.v[k] + (1.0 - b2) * grads[k] * grads[k] for k in params}
    new_params = {
        k: p - lr_t * new_m[k] / (torch.sqrt(new_v[k]) + eps)
        for k, p in params.items()
    }
    return new_params, AdamState(step=step, m=new_m, v=new_v)
