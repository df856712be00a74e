"""Plain-PyTorch reference of the decoder LM that the training cells run:
forward pass, loss, gradients by autograd and TF1 Adam, in float32 with
TF32 off, written out from the layer equations with no kernel, cache or
fused op of the program under test.

The block (what each configuration's ``departures`` list states against
GPT-NeoX):

- pre-LN: ``LayerNorm(x) = (x - mean) * rsqrt(var + 1e-6) * g + b``;
- q, k, v and o projections without biases, ``[in, out]`` weights;
- RoPE over the whole head on interleaved pairs ``(x[2i], x[2i+1])``,
  angle ``t * base**(-2i/D)`` at absolute position ``t``;
- causal softmax attention with the scores materialised, scale
  ``1/sqrt(D)``;
- a sequential residual: ``h += attn``, then ``h += mlp``;
- MLP ``gelu_tanh(x @ w1 + b1) @ w2 + b2``;
- final LayerNorm, untied head, cross-entropy summed over the scored
  positions and divided by their count.

Adam is TF1's: ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, ``p -= lr_t *
m / (sqrt(v) + eps)`` with eps outside the root of the uncorrected moment.

``quant=True`` computes every matrix product (projections, both attention
products, the head) on operands rounded to float8 e4m3 with one scale per
tensor: the precision below the bf16 the configurations state, which the
benchmark's control runs to show that its comparison can fail.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8
LN_EPS = 1e-6
BLOCK_LEAVES = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b", "w1", "b1",
                "w2", "b2")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    num_heads: int
    num_layers: int
    d_ff: int
    rope_base: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def leaf_shapes(d: Dims) -> dict[str, tuple[int, ...]]:
    """Every parameter by its path (``embed``, ``blocks.<i>.<name>``,
    ``lnf_g``, ``lnf_b``, ``head``), in that order."""
    e, f = d.d_model, d.d_ff
    block = {"ln1_g": (e,), "ln1_b": (e,), "wq": (e, e), "wk": (e, e), "wv": (e, e),
             "wo": (e, e), "ln2_g": (e,), "ln2_b": (e,), "w1": (e, f), "b1": (f,),
             "w2": (f, e), "b2": (e,)}
    out = {"embed": (d.vocab, e)}
    for i in range(d.num_layers):
        out.update({f"blocks.{i}.{k}": block[k] for k in BLOCK_LEAVES})
    out.update({"lnf_g": (e,), "lnf_b": (e,), "head": (e, d.vocab)})
    return out


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with one per-tensor scale; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a: torch.Tensor, b: torch.Tensor, quant: bool) -> torch.Tensor:
    if quant:
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    return a @ b


def _layernorm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * g + b


def _rope(x: torch.Tensor, base: float) -> torch.Tensor:
    t, d = x.shape[1], x.shape[-1]
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def _attention(q, k, v, quant: bool) -> torch.Tensor:
    """Causal softmax attention over ``[B, T, H, D]``."""
    t, dh = q.shape[1], q.shape[-1]
    s = _mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), quant) / math.sqrt(dh)  # [B, H, T, T]
    future = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    p = s.masked_fill(future, float("-inf")).softmax(-1)
    return _mm(p, v.transpose(1, 2), quant).transpose(1, 2)


def loss_sum(p: dict, tokens, targets, weights, d: Dims, quant: bool = False) -> torch.Tensor:
    """Sum over positions of ``weights * cross-entropy`` for ``tokens [B, T]``."""
    bsz, t = tokens.shape
    h = p["embed"][tokens]
    for i in range(d.num_layers):
        blk = {k: p[f"blocks.{i}.{k}"] for k in BLOCK_LEAVES}
        x = _layernorm(h, blk["ln1_g"], blk["ln1_b"])
        heads = lambda a: a.reshape(bsz, t, d.num_heads, d.head_dim)  # noqa: E731
        q = _rope(heads(_mm(x, blk["wq"], quant)), d.rope_base)
        k = _rope(heads(_mm(x, blk["wk"], quant)), d.rope_base)
        v = heads(_mm(x, blk["wv"], quant))
        h = h + _mm(_attention(q, k, v, quant).reshape(bsz, t, -1), blk["wo"], quant)
        x = _layernorm(h, blk["ln2_g"], blk["ln2_b"])
        mid = F.gelu(_mm(x, blk["w1"], quant) + blk["b1"], approximate="tanh")
        h = h + _mm(mid, blk["w2"], quant) + blk["b2"]
    logits = _mm(_layernorm(h, p["lnf_g"], p["lnf_b"]), p["head"], quant)
    ce = torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0]
    return (ce * weights).sum()


def loss_and_grads(p: dict, tokens, targets, weights, d: Dims, *, rows_per_block: int,
                   quant: bool = False) -> tuple[float, dict]:
    """The mean loss over the scored positions of the batch and its
    gradient for every leaf, summed over blocks of ``rows_per_block``
    rows so that the activations of one block at a time are held."""
    den = weights.sum()
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    total = torch.zeros((), dtype=torch.float64, device=den.device)
    for i in range(0, tokens.shape[0], rows_per_block):
        rows = slice(i, i + rows_per_block)
        part = loss_sum(leaves, tokens[rows], targets[rows], weights[rows], d, quant) / den
        for acc, g in zip(grads.values(), torch.autograd.grad(part, list(leaves.values()))):
            acc += g
        total += part.detach().double()
    return float(total), grads


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclasses.dataclass
class Follow:
    """What the reference reads over its steps: each step's loss, each
    leaf's gradient norm at the first step, and each leaf's change from
    the initial parameters after the last step."""

    losses: list[float]
    grad_norms: dict[str, float]
    change_norms: dict[str, float]


def _norms(tensors: dict) -> dict[str, float]:
    stacked = torch.stack([torch.linalg.vector_norm(t.double()) for t in tensors.values()])
    return dict(zip(tensors, stacked.cpu().tolist()))


def follow(p0: dict, batches, d: Dims, lr: float, *, rows_per_block: int,
           quant: bool = False) -> Follow:
    """Train from the float32 parameters ``p0`` (path -> tensor; left
    unchanged) on ``batches``, a sequence of ``(tokens, targets, weights)``
    tensors on the parameters' device, one Adam step each."""
    with _no_tf32(), torch.no_grad():
        p = {k: v.detach().clone().float() for k, v in p0.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v = {k: torch.zeros_like(x) for k, x in p.items()}
        losses, grad_norms = [], None
        for step, (tokens, targets, weights) in enumerate(batches, start=1):
            with torch.enable_grad():
                loss, grads = loss_and_grads(p, tokens, targets, weights, d,
                                             rows_per_block=rows_per_block, quant=quant)
            losses.append(loss)
            if grad_norms is None:
                grad_norms = _norms(grads)
            lr_t = lr * math.sqrt(1.0 - B2 ** step) / (1.0 - B1 ** step)
            for k, g in grads.items():
                m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                v[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                p[k].sub_(lr_t * m[k] / (v[k].sqrt() + EPS))
            del grads
        del m, v
        change = {k: p[k].sub_(p0[k]) for k in p}
        return Follow(losses=losses, grad_norms=grad_norms, change_norms=_norms(change))
