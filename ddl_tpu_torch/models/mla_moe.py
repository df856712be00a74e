"""The DeepSeek-V3 block (arXiv:2412.19437 §2.1) as the decoder LM's second
kind of block: multi-head latent attention (MLA) and sparse experts with
shared ones, trained by the same step as ``models/transformer.py``'s
(``strategies/seq.py`` picks the functions by the spec's type). It has no
counterpart in the JAX package.

Parameters, ``[in, out]`` weights (``x @ w``) as the dense LM's::

    {"embed": [V, E], "blocks": [block, ...], "lnf_g": [E], "head": [E, V]}

    attention, every block: attn_g [E], wq [E, H (dn + dr)], wkv_a [E, r + dr],
        kv_g [r], wkv_b [r, H (dn + dv)], wo [H dv, E], mlp_g [E]
    the leading dense blocks: w1, w3 [E, F], w2 [F, E]
    the expert blocks: router [E, n_experts] (float32 even under bf16
        compute), w1, w3 [held, E, De], w2 [held, De, E] (the held experts,
        stacked), sw1, sw3 [E, S De], sw2 [S De, E] (the S shared experts,
        one SwiGLU of their summed width)

A block on the residual stream ``h [B, T, E]``, with ``RMSNorm(x; g) = x
rsqrt(mean(x^2) + eps) g`` (fp32 statistics)::

    x = RMSNorm(h; attn_g)
    q = x wq -> [B, T, H, dn + dr]           ckv = x wkv_a -> [B, T, r + dr]
    c = RMSNorm(ckv[:r]; kv_g)               k_pe = RoPE(ckv[r:])  (one head)
    [k_nope | v] = c wkv_b -> [B, T, H, dn + dv]
    q = [q_nope | RoPE(q_pe)]                k = [k_nope | k_pe on every head]
    h += causal softmax(q k^T / sqrt(dn + dr)) v @ wo
    x = RMSNorm(h; mlp_g)
    dense:   h += (silu(x w1) * x w3) w2
    experts: s = sigmoid(x router) (fp32); chosen = top_k(s + bias) over all
             n_experts; w_j = routed_scale s_j / sum_chosen s;
             h += sum over chosen and held j of w_j E_j(x) + E_shared(x)

then ``RMSNorm(h; lnf_g) @ head``. RoPE is the dense LM's (``rope``:
interleaved pairs, angle ``t base^(-2i/dr)``); DeepSeek's checkpoints
permute the pairs to halves first, which gives the same scores.

**The expert layer is told which experts it holds** (``experts_held``, the
chip's share of an expert-parallel deployment): it routes every token over
all ``n_experts``, sorts the (token, slot) assignments that fall on its
experts by expert, gathers those rows, runs its experts' SwiGLUs as grouped
products (``torch._grouped_mm`` on a card that has it, else one product an
expert), and adds ``w_j E_j(x)`` back at each token: no capacity, no token
dropped. On one chip nothing is exchanged: what absent experts would add
is left out, here and in the benchmark's reference alike. Sizing the
gathered rows reads their count on the host: one synchronisation an expert
layer in the forward. The correction ``bias`` selects and does not weigh;
it is a fixed buffer drawn from ``bias_seed`` (:func:`router_bias`): the
balancing rule that moves it in DeepSeek-V3, and its sequence-wise
auxiliary loss, are left out.

Under bf16 compute (``compute_dtype``) every parameter but the router is
cast; the router multiplies the bf16 activations in fp32 against the fp32
masters, as DeepSeek-V3 computes its gate (a bf16 gate flips choices near
ties). Attention is ``attn_fn(q, k, v)`` over ``[B, T, H, D]`` with a ``v``
narrower than ``q`` and ``k`` (the flash kernels' ``(192, 128)`` instance).

Spans (``obs.trace.MOE_PHASES``): ``moe/route`` holds the gate, the top-k
and the sort; ``moe/experts`` the gather, the routed and shared experts'
products and the scatter-add, forward and backward (identity autograd
nodes on the span's output and input open and close it in the backward).
Outside a profiler session neither adds an op. :func:`assignment_counter`
is each device's count of assignments to each held expert, by layer, added
to on the device by every forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..obs.trace import phase
from ..utils import tree
from .transformer import ce_sums, rope

Params = Mapping[str, Any]

ATTN_LEAVES = ("attn_g", "wq", "wkv_a", "kv_g", "wkv_b", "wo", "mlp_g")
DENSE_LEAVES = ("w1", "w3", "w2")
EXPERT_LEAVES = ("router", "w1", "w3", "w2", "sw1", "sw3", "sw2")


@dataclasses.dataclass(frozen=True)
class MLAMoESpec:
    """One DeepSeek-V3-style member. The defaults are Moonlight-16B-A3B's
    published widths (``moonshotai/Moonlight-16B-A3B`` ``config.json``),
    every expert and the whole vocabulary held."""

    vocab: int = 163840
    d_model: int = 2048
    num_heads: int = 16
    num_layers: int = 27
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    d_ff: int = 11264  # the dense blocks' SwiGLU width
    first_dense: int = 1  # leading dense blocks
    n_experts: int = 64  # the experts the router scores
    experts_held: tuple[int, ...] = tuple(range(64))  # the experts this chip computes
    top_k: int = 6
    d_expert: int = 1408
    n_shared: int = 2
    routed_scale: float = 2.446
    rope_base: float = 50000.0
    norm_eps: float = 1e-5
    bias_seed: int = 0
    bias_range: float = 0.01  # the fixed correction bias is uniform in +-bias_range

    def __post_init__(self):
        held = self.experts_held
        if not held or len(set(held)) != len(held) or not all(
                0 <= e < self.n_experts for e in held):
            raise ValueError(f"experts_held must be distinct ids in [0, {self.n_experts}), "
                             f"got {held}")
        if not 0 < self.top_k <= self.n_experts or self.qk_rope_dim % 2:
            raise ValueError("need 0 < top_k <= n_experts and an even qk_rope_dim")

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_dense

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_dense

    def num_params(self) -> int:
        return sum(math.prod(s) for s in leaf_paths(self).values())


# Moonlight-16B-A3B on one chip of an eight-way expert-parallel deployment:
# experts 0-7 of every layer and an eighth of the vocabulary.
MOONLIGHT_EP8 = MLAMoESpec(vocab=20480, experts_held=tuple(range(8)))
# Test-sized member: the same structure at a few thousand parameters.
TINY_SPEC = MLAMoESpec(vocab=32, d_model=64, num_heads=4, num_layers=2, qk_nope_dim=24,
                       qk_rope_dim=8, v_head_dim=16, kv_lora_rank=16, d_ff=96, n_experts=8,
                       experts_held=(0, 1, 2, 3), top_k=2, d_expert=32, n_shared=1)


def _block_shapes(spec: MLAMoESpec, layer: int) -> dict[str, tuple[int, ...]]:
    e, h, r = spec.d_model, spec.num_heads, spec.kv_lora_rank
    blk = {"attn_g": (e,), "wq": (e, h * spec.qk_dim), "wkv_a": (e, r + spec.qk_rope_dim),
           "kv_g": (r,), "wkv_b": (r, h * (spec.qk_nope_dim + spec.v_head_dim)),
           "wo": (h * spec.v_head_dim, e), "mlp_g": (e,)}
    if not spec.is_moe(layer):
        f = spec.d_ff
        return {**blk, "w1": (e, f), "w3": (e, f), "w2": (f, e)}
    n, de, s = len(spec.experts_held), spec.d_expert, spec.n_shared * spec.d_expert
    return {**blk, "router": (e, spec.n_experts), "w1": (n, e, de), "w3": (n, e, de),
            "w2": (n, de, e), "sw1": (e, s), "sw3": (e, s), "sw2": (s, e)}


def param_shapes(spec: MLAMoESpec) -> dict[str, Any]:
    """The parameter tree's shapes (tuples), nested as the parameters."""
    e = spec.d_model
    return {"embed": (spec.vocab, e),
            "blocks": [_block_shapes(spec, i) for i in range(spec.num_layers)],
            "lnf_g": (e,), "head": (e, spec.vocab)}


def _paths(params: Params) -> dict[str, Any]:
    """The tree's leaves by path (``embed``, ``blocks.<i>.<name>``,
    ``lnf_g``, ``head``), in that order."""
    out = {"embed": params["embed"]}
    for i, blk in enumerate(params["blocks"]):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out.update({"lnf_g": params["lnf_g"], "head": params["head"]})
    return out


def leaf_paths(spec: MLAMoESpec) -> dict[str, tuple[int, ...]]:
    """Every leaf's shape by its path, in :func:`_paths`' order."""
    return _paths(param_shapes(spec))


def init_params(gen: torch.Generator, spec: MLAMoESpec, device: str | torch.device = "cpu",
                dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """The dense LM's init rule: Glorot-uniform matrices (an expert's own
    fan-in and fan-out), unit RMSNorm gains; drawn on the CPU from ``gen``
    in :func:`leaf_paths` order, then placed."""

    def make(name, shape):
        if name.endswith("_g"):
            return torch.ones(shape, dtype=dtype)
        limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * limit

    shapes = param_shapes(spec)
    params = {"embed": make("embed", shapes["embed"]),
              "blocks": [{k: make(k, s) for k, s in blk.items()} for blk in shapes["blocks"]],
              "lnf_g": make("lnf_g", shapes["lnf_g"]), "head": make("head", shapes["head"])}
    return tree.map(lambda t: t.to(device), params)


def params_from_numpy(np_tree, spec: MLAMoESpec, device: str | torch.device) -> dict:
    """A numpy tree shaped as :func:`param_shapes` -> float32 tensors on
    ``device``. Raises unless every path and shape is ``spec``'s."""
    want = leaf_paths(spec)
    got = ({k: tuple(np.shape(v)) for k, v in _paths(np_tree).items()}
           if set(np_tree) == {"embed", "blocks", "lnf_g", "head"} else {})
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:4]
        raise ValueError(f"parameter tree does not match the spec: {diff}")
    return tree.map(lambda a: torch.tensor(a, dtype=torch.float32, device=device), np_tree)


def growable_segments(device: str | torch.device) -> None:
    """On a card, before the state is placed: at published widths the
    backward's start and the functional Adam's copies of the parameters and
    moments each come within a few GiB of an 80 GB card, which the caching
    allocator's fixed segments fragment past; growable segments do not.
    The cached fixed segments are released first, so that the state lands
    in growable ones. The setting holds for the rest of the process."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


# ----------------------------------------------------------- buffers, counters


_BUFFERS: dict[tuple, torch.Tensor] = {}
_COUNTERS: dict[tuple, torch.Tensor] = {}
_ROUTES: list | None = None  # while recording_routes() is open
_ROUTER_ROWS: list | None = None  # the same, when asked for the router's rows


def router_bias(spec: MLAMoESpec, device) -> torch.Tensor:
    """The fixed correction bias, float32 ``[num_moe_layers, n_experts]``
    uniform in ``+-bias_range``, drawn from ``bias_seed`` by numpy's PCG64
    (the same values on every device); made once a device."""
    key = ("bias", spec.bias_seed, spec.bias_range, spec.num_moe_layers, spec.n_experts,
           str(device))
    if key not in _BUFFERS:
        rng = np.random.Generator(np.random.PCG64(spec.bias_seed))
        draw = rng.uniform(-spec.bias_range, spec.bias_range,
                           (spec.num_moe_layers, spec.n_experts)).astype(np.float32)
        _BUFFERS[key] = torch.from_numpy(draw).to(device)
    return _BUFFERS[key]


def _slots(spec: MLAMoESpec, device) -> torch.Tensor:
    """Expert id -> its slot among the held experts, or ``len(held)``."""
    key = ("slots", spec.experts_held, spec.n_experts, str(device))
    if key not in _BUFFERS:
        slots = torch.full((spec.n_experts,), len(spec.experts_held), dtype=torch.int64)
        slots[list(spec.experts_held)] = torch.arange(len(spec.experts_held))
        _BUFFERS[key] = slots.to(device)
    return _BUFFERS[key]


def assignment_counter(spec: MLAMoESpec, device) -> torch.Tensor:
    """Assignments to each held expert, int64 ``[num_moe_layers, held]`` on
    ``device``, summed over every forward since it was made or zeroed: read
    it after the steps, never inside one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), spec.num_moe_layers, len(spec.experts_held))
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(key[1:], dtype=torch.int64, device=device)
    return _COUNTERS[key]


@contextlib.contextmanager
def recording_routes(rows: list | None = None):
    """Within, every expert layer's forward appends its chosen experts
    (int16 ``[tokens, top_k]`` on the device) to the list this yields, and
    to ``rows``, if given, the rows its router scored (``[tokens, d_model]``
    in their own type, copied to the host)."""
    global _ROUTES, _ROUTER_ROWS
    saved, _ROUTES, _ROUTER_ROWS = (_ROUTES, _ROUTER_ROWS), [], rows
    try:
        yield _ROUTES
    finally:
        _ROUTES, _ROUTER_ROWS = saved


# ------------------------------------------------------------------ the ops


class _RMSNorm(torch.autograd.Function):
    """``x rsqrt(mean(x^2) + eps) g`` with fp32 statistics, keeping only
    ``x`` and the row scale for the backward."""

    @staticmethod
    def forward(ctx, x, g, eps: float):
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, g, r)
        return (xf * r).to(x.dtype) * g

    @staticmethod
    def backward(ctx, dy):
        x, g, r = ctx.saved_tensors
        xhat = x.float() * r
        dxhat = (dy * g).float()
        dx = r * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdim=True))
        dims = tuple(range(dy.dim() - 1))
        dg = (dy.float() * xhat.to(x.dtype).float()).sum(dims)
        return dx.to(x.dtype), dg.to(g.dtype), None


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return _RMSNorm.apply(x, g, eps)


class _SwiGLU(torch.autograd.Function):
    """``silu(a) * b``, keeping ``a`` and ``b`` (silu recomputed in the
    backward, in fp32)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return F.silu(a) * b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        af, gf = a.float(), g.float()
        sig = torch.sigmoid(af)
        da = gf * b.float() * sig * (1.0 + af * (1.0 - sig))
        return da.to(a.dtype), (gf * af * sig).to(b.dtype)


def swiglu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _SwiGLU.apply(a, b)


class _Gate(torch.autograd.Function):
    """The router's logits ``x @ w`` in fp32 for activations ``x`` of any
    type, keeping ``x`` in its own type for the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (g @ w.t()).to(x.dtype), x.float().t() @ g


class _SpanEdge(torch.autograd.Function):
    """The identity; its backward enters (``opens``) or leaves the range
    that ``holder`` carries from one edge to the other."""

    @staticmethod
    def forward(ctx, x, name: str, holder: list, opens: bool):
        ctx.name, ctx.holder, ctx.opens = name, holder, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            rf = torch.profiler.record_function(ctx.name)
            rf.__enter__()
            ctx.holder.append(rf)
        elif ctx.holder:
            ctx.holder.pop().__exit__(None, None, None)
        return g, None, None, None


def _products(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, sizes: list[int]):
    """Rows ``xs`` grouped by held expert (``sizes`` rows each, ending at
    ``offs``) times that expert's ``w [held, in, out]``: one grouped product
    on a card in bf16, else one product an expert."""
    if xs.is_cuda and xs.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        return torch._grouped_mm(xs, w, offs=offs)
    return torch.cat([part @ w[i] for i, part in enumerate(xs.split(sizes))])


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, spec: MLAMoESpec):
    """``(chosen [N, k], weights [N, k] fp32)`` for rows ``x [N, E]``:
    sigmoid scores in fp32, the top ``k`` of ``score + bias`` over every
    expert, the chosen scores normalised and scaled. The bias only
    selects."""
    s = torch.sigmoid(_Gate.apply(x, router))
    chosen = torch.topk(s.detach() + bias, spec.top_k, dim=-1).indices
    w = s.gather(-1, chosen)
    return chosen, w * (spec.routed_scale / w.sum(-1, keepdim=True))


def expert_layer(x: torch.Tensor, blk: Params, spec: MLAMoESpec, layer: int) -> torch.Tensor:
    """The routed experts this chip holds plus the shared ones, on rows
    ``x [N, E]`` of the ``layer``-th expert block (0-based among them)."""
    n, held, k = x.shape[0], len(spec.experts_held), spec.top_k
    with phase("moe/route"):
        chosen, w = route(x, blk["router"], router_bias(spec, x.device)[layer], spec)
        if _ROUTES is not None:
            _ROUTES.append(chosen.to(torch.int16))
            if _ROUTER_ROWS is not None:
                _ROUTER_ROWS.append(x.detach().cpu())
        slot = _slots(spec, x.device)[chosen].reshape(-1)
        order = torch.argsort(slot, stable=True)  # held experts' assignments first, by slot
        counts = torch.zeros(held + 1, dtype=torch.int64, device=x.device).scatter_add_(
            0, slot, torch.ones_like(slot))
        assignment_counter(spec, x.device)[layer] += counts[:held]
        offs = counts[:held].cumsum(0).to(torch.int32)
        sizes = counts.tolist()[:held]  # the layer's one host synchronisation
    profiled = torch.autograd._profiler_enabled() and torch.is_grad_enabled()
    holder: list = []
    with phase("moe/experts"):
        xe = _SpanEdge.apply(x, "moe/experts", holder, False) if profiled else x
        rows = order[:sum(sizes)]
        tok = rows // k
        xs = xe[tok]
        mid = swiglu(_products(xs, blk["w1"], offs, sizes), _products(xs, blk["w3"], offs, sizes))
        y = _products(mid, blk["w2"], offs, sizes) * w.reshape(-1)[rows, None]
        routed = torch.zeros(n, x.shape[1], dtype=y.dtype, device=x.device).index_add_(0, tok, y)
        out = routed.to(x.dtype) + swiglu(xe @ blk["sw1"], xe @ blk["sw3"]) @ blk["sw2"]
        return _SpanEdge.apply(out, "moe/experts", holder, True) if profiled else out


def _attention(h, blk, spec: MLAMoESpec, attn_fn, positions) -> torch.Tensor:
    b, t, _ = h.shape
    hn, dn, dv, r = spec.num_heads, spec.qk_nope_dim, spec.v_head_dim, spec.kv_lora_rank
    x = rms_norm(h, blk["attn_g"], spec.norm_eps)
    q = (x @ blk["wq"]).view(b, t, hn, spec.qk_dim)
    ckv = x @ blk["wkv_a"]
    kv = (rms_norm(ckv[..., :r], blk["kv_g"], spec.norm_eps) @ blk["wkv_b"]).view(
        b, t, hn, dn + dv)
    k_pe = rope(ckv[..., None, r:], positions, spec.rope_base)  # one head, shared
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, spec.rope_base)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, t, hn, spec.qk_rope_dim)], dim=-1)
    o = attn_fn(q, k, kv[..., dn:])
    return h + o.reshape(b, t, hn * dv) @ blk["wo"]


def apply_block(h, blk: Params, spec: MLAMoESpec, layer: int, *, attn_fn,
                positions) -> torch.Tensor:
    """Block ``layer`` on the residual stream ``h [B, T, E]``."""
    h = _attention(h, blk, spec, attn_fn, positions)
    x = rms_norm(h, blk["mlp_g"], spec.norm_eps)
    if not spec.is_moe(layer):
        return h + swiglu(x @ blk["w1"], x @ blk["w3"]) @ blk["w2"]
    b, t, e = x.shape
    return h + expert_layer(x.reshape(b * t, e), blk, spec, layer - spec.first_dense).view(
        b, t, e)


def _cast(params: Params, dtype: torch.dtype) -> dict:
    """Every parameter in ``dtype`` but the routers, which stay fp32."""
    def block(blk):
        return {k: v if k == "router" else v.to(dtype) for k, v in blk.items()}
    return {k: [block(b) for b in v] if k == "blocks" else v.to(dtype)
            for k, v in params.items()}


def apply_lm(params: Params, tokens: torch.Tensor, spec: MLAMoESpec, *, attn_fn: Callable,
             pos_offset: int = 0, positions: torch.Tensor | None = None,
             compute_dtype: torch.dtype | None = None, remat: bool = False,
             row_reduce: Callable | None = None,
             col_promote: Callable | None = None) -> torch.Tensor:
    """Forward pass: int tokens ``[B, T]`` -> fp32 logits ``[B, T, vocab]``,
    with the dense LM's signature. ``row_reduce`` and ``col_promote`` are
    the tensor-parallel hooks, identities at the one degree (1) the trainer
    runs this block at; they are not called."""
    if compute_dtype is not None:
        params = _cast(params, compute_dtype)
    h = params["embed"][tokens]
    if positions is None:
        positions = pos_offset + torch.arange(h.shape[1], device=h.device)
    for i, blk in enumerate(params["blocks"]):
        def block(h, blk, i=i):
            return apply_block(h, blk, spec, i, attn_fn=attn_fn, positions=positions)
        h = checkpoint(block, h, blk, use_reentrant=False) if remat else block(h, blk)
    return (rms_norm(h, params["lnf_g"], spec.norm_eps) @ params["head"]).float()


def lm_loss_sums(params: Params, tokens, targets, weights, spec: MLAMoESpec, *, attn_fn,
                 pos_offset: int = 0, positions=None, compute_dtype=None, remat: bool = False,
                 row_reduce=None, col_promote=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted next-token cross-entropy as ``(sum_ce, sum_weights)``, as
    ``transformer.lm_loss_sums``."""
    logits = apply_lm(params, tokens, spec, attn_fn=attn_fn, pos_offset=pos_offset,
                      positions=positions, compute_dtype=compute_dtype, remat=remat)
    return ce_sums(logits, targets, weights)


def lm_correct_sums(params: Params, tokens, targets, weights, spec: MLAMoESpec, *, attn_fn,
                    pos_offset: int = 0, positions=None, compute_dtype=None,
                    remat: bool = False, row_reduce=None,
                    col_promote=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted top-1 next-token hits as ``(sum_correct, sum_weights)``."""
    logits = apply_lm(params, tokens, spec, attn_fn=attn_fn, pos_offset=pos_offset,
                      positions=positions, compute_dtype=compute_dtype, remat=remat)
    hits = (torch.argmax(logits, dim=-1) == targets).float()
    w = weights.float()
    return (hits * w).sum(), w.sum()
