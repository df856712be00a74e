"""Plain-PyTorch reference of the latent-attention and expert block (the
DeepSeek-V3 block, arXiv:2412.19437 §2.1, at Moonlight-16B-A3B's widths):
forward pass, loss, gradients by autograd and TF1 Adam, in float32 with
TF32 off, written out from the layer equations with no kernel, cache or
fused op of the program under test. Its plain helpers (the float8 control,
RoPE, Adam's constants) are ``reference/lm.py``'s.

The block, on the residual stream ``h [T, E]`` of one sequence::

    x = RMSNorm(h; attn_g)                    RMSNorm(x; g) = x rsqrt(mean(x^2) + eps) g
    q = x wq -> [T, H, dn + dr]               ckv = x wkv_a -> [T, r + dr]
    [k_nope | v] = RMSNorm(ckv[:r]; kv_g) wkv_b -> [T, H, dn + dv]
    q = [q_nope | RoPE(q_pe)]                 k = [k_nope | RoPE(ckv[r:]) on every head]
    h += causal softmax(q k^T / sqrt(dn + dr)) v @ wo
    x = RMSNorm(h; mlp_g)
    dense layers:  h += (silu(x w1) * x w3) w2
    expert layers: s = sigmoid(x router); chosen = top-k of s + bias over every
                   expert; w_j = routed_scale s_j / sum over chosen of s;
                   h += sum over chosen, held j of w_j E_j(x) + E_shared(x)

then ``RMSNorm(h; lnf_g) @ head`` and cross-entropy summed over the scored
positions and divided by their count.

It is given the same share as the program: the held experts only (the
others' outputs are left out, their weights still in the normalisation)
and the vocabulary slice, the loss over the slice. Departures from the
published model (each configuration's ``departures`` repeats them):

- RoPE on interleaved pairs (DeepSeek permutes the pairs to halves first:
  the same scores);
- the correction bias is fixed, uniform in ``+-bias_range`` from the
  configuration's seed (DeepSeek-V3 moves it by a balancing rule), and
  there is no sequence-wise auxiliary loss;
- TF1 Adam (Moonlight trains with Muon), the dense LM's Glorot init;
- only the held experts and the vocabulary slice, as above.

``quant=True`` rounds the operands of every product (the projections, the
router, the experts, both attention products, the head) to float8 e4m3
with one scale per tensor: the control below bf16.

``routes``: given the program's chosen experts (a step's list of
``[B T, k]`` tensors, one an expert layer), the reference takes those
choices instead of its own and weighs them by its own scores; it counts,
layer by layer, how many of them its own top-k also chose (``agreement``).
``router_replay`` routes the program's own router rows of a step again,
which holds the program's choices to the router's rule without the drift
of the layers below.

To fit beside the fp32 state at T 8192, the reference runs one sequence at
a time, each layer under activation checkpointing, attention in blocks of
queries, each block under checkpointing too.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lm import B1, B2, EPS, Follow, _mm, _no_tf32, _norms, _rope

Q_BLOCK = 1024  # query rows of one attention block


@dataclasses.dataclass(frozen=True)
class MoEDims:
    vocab: int
    d_model: int
    num_heads: int
    num_layers: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    kv_lora_rank: int
    d_ff: int
    first_dense: int
    n_experts: int  # the router's outputs
    held: tuple[int, ...]  # the experts computed here
    top_k: int
    d_expert: int
    n_shared: int
    routed_scale: float
    rope_base: float
    norm_eps: float

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_dense


def dims_from_config(c: dict) -> MoEDims:
    """A configuration file's sizes (the published config.json's keys)."""
    return MoEDims(vocab=c["vocab_size"], d_model=c["hidden_size"],
                   num_heads=c["num_attention_heads"], num_layers=c["num_hidden_layers"],
                   qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
                   v_head_dim=c["v_head_dim"], kv_lora_rank=c["kv_lora_rank"],
                   d_ff=c["intermediate_size"], first_dense=c["first_k_dense_replace"],
                   n_experts=c["router_experts"], held=tuple(c["experts_held"]),
                   top_k=c["num_experts_per_tok"], d_expert=c["moe_intermediate_size"],
                   n_shared=c["n_shared_experts"], routed_scale=float(c["routed_scaling_factor"]),
                   rope_base=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]))


def leaf_shapes(d: MoEDims) -> dict[str, tuple[int, ...]]:
    """Every parameter by its path (``embed``, ``blocks.<i>.<name>``,
    ``lnf_g``, ``head``), in that order."""
    e, h, r = d.d_model, d.num_heads, d.kv_lora_rank
    out = {"embed": (d.vocab, e)}
    for i in range(d.num_layers):
        blk = {"attn_g": (e,), "wq": (e, h * d.qk_dim), "wkv_a": (e, r + d.qk_rope_dim),
               "kv_g": (r,), "wkv_b": (r, h * (d.qk_nope_dim + d.v_head_dim)),
               "wo": (h * d.v_head_dim, e), "mlp_g": (e,)}
        if i < d.first_dense:
            blk.update(w1=(e, d.d_ff), w3=(e, d.d_ff), w2=(d.d_ff, e))
        else:
            n, s = len(d.held), d.n_shared * d.d_expert
            blk.update(router=(e, d.n_experts), w1=(n, e, d.d_expert), w3=(n, e, d.d_expert),
                       w2=(n, d.d_expert, e), sw1=(e, s), sw3=(e, s), sw2=(s, e))
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out.update({"lnf_g": (e,), "head": (e, d.vocab)})
    return out


def router_bias(d: MoEDims, seed: int, bias_range: float) -> np.ndarray:
    """The fixed correction bias, ``[expert layers, n_experts]`` float32,
    uniform in ``+-bias_range`` by numpy's PCG64 from ``seed``."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.uniform(-bias_range, bias_range, (d.moe_layers, d.n_experts)).astype(np.float32)


def _rmsnorm(x, g, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def _swiglu(x, w1, w3, w2, quant: bool):
    return _mm(F.silu(_mm(x, w1, quant)) * _mm(x, w3, quant), w2, quant)


def _attention(q, k, v, quant: bool):
    """Causal softmax attention of one sequence, ``q, k [T, H, Dqk]``, ``v
    [T, H, Dv]``, in blocks of :data:`Q_BLOCK` queries against the keys up
    to the block's last."""
    t, dq = q.shape[0], q.shape[-1]

    def block(qb, kb, vb, lo):
        s = _mm(qb.transpose(0, 1), kb.permute(1, 2, 0), quant) / math.sqrt(dq)  # [H, n, m]
        qpos = lo + torch.arange(qb.shape[0], device=q.device)
        kpos = torch.arange(kb.shape[0], device=q.device)
        p = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf")).softmax(-1)
        return _mm(p, vb.transpose(0, 1), quant).transpose(0, 1)

    outs = []
    for lo in range(0, t, Q_BLOCK):
        hi = min(t, lo + Q_BLOCK)
        outs.append(checkpoint(block, q[lo:hi], k[:hi], v[:hi], lo, use_reentrant=False))
    return torch.cat(outs)


def _experts(x, blk, d: MoEDims, bias, routes, quant: bool):
    """The held experts' part and the shared experts' output for rows
    ``x [T, E]``, and how many of the chosen experts the reference's own
    top-k chose."""
    s = torch.sigmoid(_mm(x, blk["router"], quant))
    own = torch.topk(s.detach() + bias, d.top_k, dim=-1).indices
    chosen = own if routes is None else routes.long()
    agree = (own[:, :, None] == chosen[:, None, :]).any(-1).sum()
    w = s.gather(-1, chosen)
    w = w * d.routed_scale / w.sum(-1, keepdim=True)
    out = _swiglu(x, blk["sw1"], blk["sw3"], blk["sw2"], quant)
    for i, e in enumerate(d.held):
        on = (chosen == e).any(-1)
        rows = on.nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        wt = (w * (chosen == e)).sum(-1)[rows]
        y = _swiglu(x[rows], blk["w1"][i], blk["w3"][i], blk["w2"][i], quant)
        out = out.index_add(0, rows, y * wt[:, None])
    return out, agree


def _layer(h, blk, d: MoEDims, i: int, bias, routes, quant: bool):
    t, hn = h.shape[0], d.num_heads
    dn, dv, r = d.qk_nope_dim, d.v_head_dim, d.kv_lora_rank
    x = _rmsnorm(h, blk["attn_g"], d.norm_eps)
    q = _mm(x, blk["wq"], quant).view(t, hn, d.qk_dim)
    ckv = _mm(x, blk["wkv_a"], quant)
    kv = _mm(_rmsnorm(ckv[:, :r], blk["kv_g"], d.norm_eps), blk["wkv_b"], quant).view(
        t, hn, dn + dv)
    rope = lambda a: _rope(a[None], d.rope_base)[0]  # noqa: E731  (positions 0..T-1)
    k_pe = rope(ckv[:, None, r:]).expand(t, hn, d.qk_rope_dim)
    q = torch.cat([q[..., :dn], rope(q[..., dn:])], -1)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    h = h + _mm(_attention(q, k, kv[..., dn:], quant).reshape(t, hn * dv), blk["wo"], quant)
    x = _rmsnorm(h, blk["mlp_g"], d.norm_eps)
    if i < d.first_dense:
        return (h + _swiglu(x, blk["w1"], blk["w3"], blk["w2"], quant),
                h.new_zeros((), dtype=torch.long))
    out, agree = _experts(x, blk, d, bias[i - d.first_dense], routes, quant)
    return h + out, agree


def forward(p: dict, tokens, d: MoEDims, bias, routes=None, quant: bool = False):
    """``(logits [T, V], agreement counts [expert layers])`` for one
    sequence ``tokens [T]``; ``routes`` is that sequence's chosen experts,
    one ``[T, k]`` tensor an expert layer, or None."""
    h = p["embed"][tokens]
    agree = []
    for i in range(d.num_layers):
        blk = {k[len(f"blocks.{i}."):]: v for k, v in p.items() if k.startswith(f"blocks.{i}.")}
        r = None if routes is None or i < d.first_dense else routes[i - d.first_dense]
        h, a = checkpoint(_layer, h, blk, d, i, bias, r, quant, use_reentrant=False)
        if i >= d.first_dense:
            agree.append(a)
    return _mm(_rmsnorm(h, p["lnf_g"], d.norm_eps), p["head"], quant), torch.stack(agree)


def loss_sum(p: dict, tokens, targets, weights, d: MoEDims, bias, routes=None,
             quant: bool = False):
    """``(sum of weights * cross-entropy, agreement counts)`` for one
    sequence (:func:`forward`'s arguments)."""
    logits, agree = forward(p, tokens, d, bias, routes, quant)
    ce = torch.logsumexp(logits, -1) - logits.gather(-1, targets[:, None])[:, 0]
    return (ce * weights).sum(), agree


def router_replay(rows, routers, bias, chosen, d: MoEDims, quant: bool = False) -> list[float]:
    """Each expert layer's share of the program's chosen experts that this
    router makes again from the program's own router rows, so that no
    drift of the layers below enters: ``rows`` (``[B T, E]``), ``routers``
    (the float32 ``[E, n_experts]`` weights the program routed with),
    ``bias`` and ``chosen`` (``[B T, k]``), one of each an expert layer.
    Sigmoid scores in float32, the top-k of score + bias."""
    shares = []
    with _no_tf32(), torch.no_grad():
        for x, w, b, c in zip(rows, routers, bias, chosen):
            s = torch.sigmoid(_mm(x.to(w.device).float(), w, quant))
            own = torch.topk(s + b, d.top_k, dim=-1).indices
            c = c.to(w.device).long()
            shares.append(float((own[:, :, None] == c[:, None, :]).any(-1).sum()) / c.numel())
    return shares


def follow(draw, batches, d: MoEDims, lr: float, bias, *, routes=None,
           quant: bool = False) -> tuple[Follow, float | None]:
    """Train from the float32 parameters ``draw()`` returns (path ->
    tensor; called again at the end for the change) on ``batches``, a
    sequence of ``(tokens [B, T], targets, weights)`` tensors on the
    parameters' device, one Adam step each. ``bias``: the router bias
    ``[expert layers, n_experts]`` on that device. ``routes``: the
    program's chosen experts, a list a step of ``[expert layers, B T, k]``
    tensors, or None. Returns the readings and, with ``routes``, each
    expert layer's share of the program's choices that the reference's
    own top-k agrees with."""
    with _no_tf32():
        p = {k: v.requires_grad_(True) for k, v in draw().items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, grad_norms, agree, choices = [], None, 0, 0  # agree: a count a layer
        for step, (tokens, targets, weights) in enumerate(batches, start=1):
            den = weights.sum()
            total = torch.zeros((), dtype=torch.float64, device=den.device)
            t = tokens.shape[1]
            for b in range(tokens.shape[0]):
                r = None if routes is None else [x[b * t:(b + 1) * t] for x in routes[step - 1]]
                part, a = loss_sum(p, tokens[b], targets[b], weights[b], d, bias, r, quant)
                (part / den).backward()
                total += (part / den).detach().double()
                agree = agree + a.cpu()
                choices += t * d.top_k
            losses.append(float(total))
            with torch.no_grad():
                grads = {k: x.grad for k, x in p.items()}
                if grad_norms is None:
                    grad_norms = _norms(grads)
                lr_t = lr * math.sqrt(1.0 - B2 ** step) / (1.0 - B1 ** step)
                for k, g in grads.items():
                    m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                    v2[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                    p[k].sub_(lr_t * m[k] / (v2[k].sqrt() + EPS))
                    p[k].grad = None
                del grads
        del m, v2
        with torch.no_grad():
            p = {k: x.detach() for k, x in p.items()}
            for k, x in draw().items():
                p[k].sub_(x)
            change = _norms(p)
        shares = (agree.double() / choices).tolist() if routes is not None else None
        return Follow(losses=losses, grad_norms=grad_norms, change_norms=change), shares
