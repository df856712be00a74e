"""Plain softmax attention — the part of ``ddl_tpu/parallel/ring.py`` the
one-card LM path needs (``attn_impl="xla"``).

The JAX module also holds ring attention over ``ppermute`` and Ulysses over
``all_to_all``; those schemes are not ported yet (ROADMAP queue 1, item 3).
XLA computed this function outside any Pallas kernel, so here it is torch
ops (cuBLAS batched matmuls), as the JAX package left it to XLA.
"""

from __future__ import annotations

import math

import torch

_MASKED = -1e30  # large-negative (not -inf): keeps exp(s - m) NaN-free


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
    scale: float | None = None, q_offset: int = 0, k_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention over ``[B, T, H, D]``: scores in the inputs'
    type, upcast to fp32, scaled, masked where a key's absolute position
    follows the query's (``q_offset``/``k_offset`` are the positions of
    element 0), softmaxed, then ``P`` cast to ``v``'s type times ``V``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
