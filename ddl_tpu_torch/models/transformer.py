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

The serving entry points ``apply_lm_cached`` (per-slot rings) and
``apply_lm_paged`` (the shared page pool) run each layer as
:func:`apply_block` with an attention that writes the layer's k/v rows into
a KV cache, in place, and attends over it (``ops/kv_cache.py``). The int8
pool waits for its slice.

Tensor parallelism (Megatron): handed column-sharded ``wq/wk/wv/w1`` (and
``b1``) and row-sharded ``wo/w2`` (``models/partition.py``), a block's
attention and MLP outputs are partial sums over the tp ranks.
``row_reduce`` (Megatron's ``g``, ``collectives.tp_allreduce``) completes
them before ``b2`` is added; ``col_promote`` (``f``,
``collectives.tp_promote``) marks where the tp-replicated residual stream
enters the column-sharded matmuls, so its backward completes the partial
cotangents. The local head count comes from ``wq``'s width, so each rank
attends its own heads. ``None`` hooks are the tp 1 program, unchanged. The
cached forwards take ``row_reduce`` only: they are never differentiated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import kv_cache
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


def _identity(x):
    return x


def apply_block(
    h: torch.Tensor, blk: Params, spec: LMSpec, *, attn_fn: AttnFn, positions: torch.Tensor,
    row_reduce: Callable | None = None, col_promote: Callable | None = None,
) -> torch.Tensor:
    """One pre-LN transformer block on the residual stream ``h [B, T, E]``;
    ``row_reduce``/``col_promote`` are the tensor-parallel hooks (module
    docstring)."""
    b, t, _ = h.shape
    heads = lambda a: a.reshape(b, t, -1, spec.head_dim)  # noqa: E731
    reduce_ = row_reduce or _identity
    promote = col_promote or _identity
    x = promote(_layernorm(h, blk["ln1_g"], blk["ln1_b"]))
    q = rope(heads(x @ blk["wq"]), positions, spec.rope_base)
    k = rope(heads(x @ blk["wk"]), positions, spec.rope_base)
    v = heads(x @ blk["wv"])
    a = attn_fn(q, k, v)
    h = h + reduce_(a.reshape(b, t, -1) @ blk["wo"])
    x = promote(_layernorm(h, blk["ln2_g"], blk["ln2_b"]))
    mlp = reduce_(F.gelu(x @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"])
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
    row_reduce: Callable | None = None,
    col_promote: Callable | None = None,
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
        return apply_block(h, blk, spec, attn_fn=attn_fn, positions=positions,
                           row_reduce=row_reduce, col_promote=col_promote)

    for blk in params["blocks"]:
        h = checkpoint(block, h, blk, use_reentrant=False) if remat else block(h, blk)
    h = _layernorm(h, params["lnf_g"], params["lnf_b"])
    return (h @ params["head"]).float()


def apply_lm_cached(
    params: Params,
    tokens: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,
    spec: LMSpec = LMSpec(),
    *,
    start: torch.Tensor | None,
    positions: torch.Tensor | None = None,
    rows: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
    row_reduce: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Incremental (KV-cached) forward: int tokens ``[B, T]`` (the NEW
    elements of each slot) -> fp32 logits ``[B, T, vocab]``, updating the
    cache IN PLACE and returning ``(logits, cache_k, cache_v, cache_pos)``.

    ``cache_k``/``cache_v [L, B, C + 1, H, D]`` are the per-layer rings and
    ``cache_pos [B, C + 1]`` (int32) each row's absolute position, row ``C``
    of each slot being the drop row (``ops.kv_cache``). ``start [B]`` is each
    slot's write cursor: token t lands in row ``(start + t) % C`` at position
    ``start + t`` (``None`` when both overrides are given). ``positions [B, T]`` overrides the positions (RoPE and the
    stored mask positions, ``PAD_POS`` at padded tails), ``rows [B, T]`` the
    write rows (``C`` drops the write). One prefill followed by one-token
    decode steps reproduces :func:`apply_lm`'s logits at every position."""
    if compute_dtype is not None:
        params = tree.map(lambda p: p.to(compute_dtype), dict(params))
    h = params["embed"][tokens]  # [B, T, E]
    t = h.shape[1]
    capacity = cache_k.shape[2] - 1
    if rows is None or positions is None:
        if start is None:
            raise ValueError("pass start, or both positions and rows")
        ar = torch.arange(t, dtype=start.dtype, device=h.device)
        if rows is None:
            rows = (start[:, None] + ar) % capacity
        if positions is None:
            positions = start[:, None] + ar
    rows = kv_cache.drop_index(rows, capacity)  # once for every write
    kv_cache.put_rows(cache_pos, positions.to(cache_pos.dtype), rows)
    k_pos = cache_pos[:, :capacity]

    def attn_fn(i):
        # Layer i's attention: write its k/v rows, attend over the ring.
        def attn(q, k, v):
            kv_cache.put_rows(cache_k[i], k.to(cache_k.dtype), rows)
            kv_cache.put_rows(cache_v[i], v.to(cache_v.dtype), rows)
            return kv_cache.attend(q, cache_k[i, :, :capacity].to(q.dtype),
                                   cache_v[i, :, :capacity].to(q.dtype), positions, k_pos)
        return attn

    for i, blk in enumerate(params["blocks"]):
        h = apply_block(h, blk, spec, attn_fn=attn_fn(i), positions=positions,
                        row_reduce=row_reduce)
    h = _layernorm(h, params["lnf_g"], params["lnf_b"])
    return (h @ params["head"]).float(), cache_k, cache_v, cache_pos


def apply_lm_paged(
    params: Params,
    tokens: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    pool_pos: torch.Tensor,
    table: torch.Tensor,
    spec: LMSpec = LMSpec(),
    *,
    positions: torch.Tensor,
    flat_rows: torch.Tensor,
    compute_dtype: torch.dtype | None = None,
    row_reduce: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same layer math as :func:`apply_lm_cached` against the PAGED pool:
    ``pool_k``/``pool_v [L, P + 1, page, H, D]`` and ``pool_pos [P + 1,
    page]`` (page ``P`` is the drop page), read and written through the
    block table ``table [B, TP]`` (page ids, -1 = unmapped; ``TP`` is the
    page-count bucket). New tokens write at ``flat_rows [B, T]``
    (``ops.kv_cache.table_rows``; padded tails and inactive slots map to the
    drop page), and attention gathers each slot's pages into a ``[B, TP *
    page, H, D]`` view whose positions travel with the rows. In place;
    returns ``(logits, pool_k, pool_v, pool_pos)``."""
    if compute_dtype is not None:
        params = tree.map(lambda p: p.to(compute_dtype), dict(params))
    h = params["embed"][tokens]  # [B, T, E]
    rows = kv_cache.flat_drop_index(pool_pos, flat_rows)  # once for every write
    kv_cache.put_flat(pool_pos, positions, rows)
    k_pos = kv_cache.table_positions(pool_pos, table)  # [B, TP * page]

    def attn_fn(i):
        # Layer i's attention: write its k/v rows, attend over the gathered pages.
        def attn(q, k, v):
            kv_cache.put_flat(pool_k[i], k, rows)
            kv_cache.put_flat(pool_v[i], v, rows)
            return kv_cache.attend(q, kv_cache.gather_pages(pool_k[i], table).to(q.dtype),
                                   kv_cache.gather_pages(pool_v[i], table).to(q.dtype),
                                   positions, k_pos)
        return attn

    for i, blk in enumerate(params["blocks"]):
        h = apply_block(h, blk, spec, attn_fn=attn_fn(i), positions=positions,
                        row_reduce=row_reduce)
    h = _layernorm(h, params["lnf_g"], params["lnf_b"])
    return (h @ params["head"]).float(), pool_k, pool_v, pool_pos


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
    remat: bool = False, row_reduce=None, col_promote=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted next-token cross-entropy as ``(sum_ce, sum_weights)``: the
    caller owns the normalisation."""
    logits = apply_lm(
        params, tokens, spec, attn_fn=attn_fn, pos_offset=pos_offset,
        positions=positions, compute_dtype=compute_dtype, remat=remat,
        row_reduce=row_reduce, col_promote=col_promote,
    )
    return ce_sums(logits, targets, weights)


def lm_correct_sums(
    params: Params, tokens, targets, weights, spec: LMSpec = LMSpec(), *,
    attn_fn: AttnFn, pos_offset: int = 0, positions=None, compute_dtype=None,
    remat: bool = False, row_reduce=None, col_promote=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted top-1 next-token hits as ``(sum_correct, sum_weights)``
    (first maximum on ties, as ``jnp.argmax``)."""
    logits = apply_lm(
        params, tokens, spec, attn_fn=attn_fn, pos_offset=pos_offset,
        positions=positions, compute_dtype=compute_dtype, remat=remat,
        row_reduce=row_reduce, col_promote=col_promote,
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
