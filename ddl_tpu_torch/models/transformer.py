"""Decoder-only transformer LM — the port of ``ddl_tpu/models/transformer.py``
(``LMSpec``, ``init_lm_params``, ``_layernorm``, ``rope``, ``apply_block``,
``apply_lm``, ``ce_sums``, ``lm_loss_sums``, ``lm_correct_sums``).

Parameters are the JAX package's nested tree with ``[in, out]`` weights
(``x @ w``)::

    {"embed": [V, E], "blocks": [{ln1_g, ln1_b, wq, wk, wv, wo,
                                  ln2_g, ln2_b, w1, b1, w2, b2}, ...],
     "lnf_g": [E], "lnf_b": [E], "head": [E, V]}

so weights carry over with no transposes (``convert.lm_params_from_numpy``).
Pre-LN blocks, RoPE from absolute positions, untied head; attention is
pluggable (``attn_fn(q, k, v)`` over ``[B, T, H, D]``, which owns causal
masking). Numerics follow the JAX code where the two libraries differ:
``jax.nn.gelu``'s default tanh approximation, RoPE on interleaved pairs,
LayerNorm with fp32 statistics written out (eps inside the rsqrt, cast back
before ``* g + b``), fp32 logits. ``compute_dtype`` casts every parameter
inside :func:`apply_lm`.

The serving entry points (``apply_lm_cached``, ``apply_lm_paged``) and the
tensor-parallel hooks wait for their slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils import tree

Params = Mapping[str, Any]
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LMSpec:
    """Architecture of one family member. ``head_dim`` must be even
    (RoPE rotates dimension pairs)."""

    vocab: int = 256
    d_model: int = 256
    num_heads: int = 8
    num_layers: int = 4
    d_ff: int = 1024
    rope_base: float = 10000.0

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by {self.num_heads} heads"
            )
        return self.d_model // self.num_heads

    def num_params(self) -> int:
        e, f, v = self.d_model, self.d_ff, self.vocab
        per_block = 4 * e * e + 2 * e * f + f + e + 4 * e
        return v * e + self.num_layers * per_block + 2 * e + e * v


# Test-sized member of the family (same structure, ~1/100 the FLOPs).
TINY_SPEC = LMSpec(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)


def param_shapes(spec: LMSpec = LMSpec()) -> dict[str, Any]:
    """The parameter tree's shapes, the same nesting as the parameters."""
    e, f = spec.d_model, spec.d_ff
    block = {
        "ln1_g": (e,), "ln1_b": (e,), "wq": (e, e), "wk": (e, e), "wv": (e, e),
        "wo": (e, e), "ln2_g": (e,), "ln2_b": (e,), "w1": (e, f), "b1": (f,),
        "w2": (f, e), "b2": (e,),
    }
    return {
        "embed": (spec.vocab, e),
        "blocks": [dict(block) for _ in range(spec.num_layers)],
        "lnf_g": (e,), "lnf_b": (e,),
        "head": (e, spec.vocab),
    }


def init_lm_params(
    gen: torch.Generator,
    spec: LMSpec = LMSpec(),
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict[str, Any]:
    """Glorot-uniform projections (TF1's default, as the JAX package), unit
    LN gains, zero biases, untied output head. Drawn on the CPU from
    ``gen`` (the same tree on every device for one seed), then placed."""

    def glorot(shape):
        limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
        return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * limit

    def make(name, shape):
        if name.endswith("_g"):
            return torch.ones(shape, dtype=dtype)
        if len(shape) == 1:
            return torch.zeros(shape, dtype=dtype)
        return glorot(shape)

    shapes = param_shapes(spec)
    blocks = [{k: make(k, s) for k, s in blk.items()} for blk in shapes["blocks"]]
    params = {
        "embed": glorot(shapes["embed"]),
        "blocks": blocks,
        "lnf_g": torch.ones(spec.d_model, dtype=dtype),
        "lnf_b": torch.zeros(spec.d_model, dtype=dtype),
        "head": glorot(shapes["head"]),
    }
    return tree.map(lambda t: t.to(device), params)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # fp32 statistics whatever the compute dtype (bf16 variance underflows).
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype) * g + b


def rope(x: torch.Tensor, positions: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate the interleaved dimension pairs ``(x[..., 0::2], x[..., 1::2])``
    of ``x [B, T, H, D]`` by angles ``positions[t] * base**(-2i/D)``, with
    ABSOLUTE ``positions [T]`` (or ``[B, T]``, one row per sequence)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"head_dim {d} must be even for RoPE")
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions.to(torch.float32)[..., :, None] * freqs  # [.., T, D/2]
    if angles.dim() == 2:  # shared positions: broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)  # [B|1, T, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def apply_block(
    h: torch.Tensor, blk: Params, spec: LMSpec, *, attn_fn: AttnFn, positions: torch.Tensor,
) -> torch.Tensor:
    """One pre-LN transformer block on the residual stream ``h [B, T, E]``."""
    b, t, _ = h.shape
    heads = lambda a: a.reshape(b, t, -1, spec.head_dim)  # noqa: E731
    x = _layernorm(h, blk["ln1_g"], blk["ln1_b"])
    q = rope(heads(x @ blk["wq"]), positions, spec.rope_base)
    k = rope(heads(x @ blk["wk"]), positions, spec.rope_base)
    v = heads(x @ blk["wv"])
    a = attn_fn(q, k, v)
    h = h + a.reshape(b, t, -1) @ blk["wo"]
    x = _layernorm(h, blk["ln2_g"], blk["ln2_b"])
    mlp = F.gelu(x @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"]
    return h + mlp + blk["b2"]


def apply_lm(
    params: Params,
    tokens: torch.Tensor,
    spec: LMSpec = LMSpec(),
    *,
    attn_fn: AttnFn,
    pos_offset: int = 0,
    positions: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
    remat: bool = False,
) -> torch.Tensor:
    """Forward pass: int tokens ``[B, T]`` -> fp32 logits ``[B, T, vocab]``.

    ``pos_offset`` is the absolute position of element 0 (``positions [T]``
    overrides it). ``remat=True`` wraps each block in
    ``torch.utils.checkpoint`` (non-reentrant): the backward pass recomputes
    the block, attention included, instead of keeping its activations."""
    if compute_dtype is not None:
        params = tree.map(lambda p: p.to(compute_dtype), dict(params))
    h = params["embed"][tokens]  # [B, T, E]
    t = h.shape[1]
    if positions is None:
        positions = pos_offset + torch.arange(t, device=h.device)

    def block(h, blk):
        return apply_block(h, blk, spec, attn_fn=attn_fn, positions=positions)

    for blk in params["blocks"]:
        h = checkpoint(block, h, blk, use_reentrant=False) if remat else block(h, blk)
    h = _layernorm(h, params["lnf_g"], params["lnf_b"])
    return (h @ params["head"]).float()


def ce_sums(
    logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted cross-entropy of fp32 ``logits [B, T, V]`` against
    ``targets [B, T]`` as ``(sum_ce, sum_weights)``."""
    logprobs = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logprobs, -1, targets.long()[..., None])[..., 0]
    w = weights.float()
    return (ce * w).sum(), w.sum()


def lm_loss_sums(
    params: Params, tokens, targets, weights, spec: LMSpec = LMSpec(), *,
    attn_fn: AttnFn, pos_offset: int = 0, positions=None, compute_dtype=None,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted next-token cross-entropy as ``(sum_ce, sum_weights)``: the
    caller owns the normalisation."""
    logits = apply_lm(
        params, tokens, spec, attn_fn=attn_fn, pos_offset=pos_offset,
        positions=positions, compute_dtype=compute_dtype, remat=remat,
    )
    return ce_sums(logits, targets, weights)


def lm_correct_sums(
    params: Params, tokens, targets, weights, spec: LMSpec = LMSpec(), *,
    attn_fn: AttnFn, pos_offset: int = 0, positions=None, compute_dtype=None,
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted top-1 next-token hits as ``(sum_correct, sum_weights)``
    (first maximum on ties, as ``jnp.argmax``)."""
    logits = apply_lm(
        params, tokens, spec, attn_fn=attn_fn, pos_offset=pos_offset,
        positions=positions, compute_dtype=compute_dtype, remat=remat,
    )
    hits = (torch.argmax(logits, dim=-1) == targets).float()
    w = weights.float()
    return (hits * w).sum(), w.sum()


class TransformerLM(nn.Module):
    """The LM as an ``nn.Module`` over the same nested tree (``embed``,
    ``blocks.<i>.<name>``, ``lnf_g``, ``lnf_b``, ``head``); ``forward`` is
    :func:`apply_lm`, and :meth:`tree` gives the parameters back in the
    JAX layout."""

    def __init__(self, params: Params, spec: LMSpec, attn_fn: AttnFn):
        super().__init__()
        self.spec = spec
        self.attn_fn = attn_fn
        param = lambda t: nn.Parameter(t.detach().clone())  # noqa: E731
        self.blocks = nn.ModuleList()
        for blk in params["blocks"]:
            mod = nn.Module()
            for k, v in blk.items():
                mod.register_parameter(k, param(v))
            self.blocks.append(mod)
        for k in ("embed", "lnf_g", "lnf_b", "head"):
            self.register_parameter(k, param(params[k]))

    def tree(self) -> dict[str, Any]:
        return {
            "embed": self.embed,
            "blocks": [dict(m.named_parameters()) for m in self.blocks],
            "lnf_g": self.lnf_g, "lnf_b": self.lnf_b, "head": self.head,
        }

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        return apply_lm(self.tree(), tokens, self.spec, attn_fn=self.attn_fn, **kw)
