"""The yardstick's arithmetic for the latent-attention and expert block
(``reference/mla_moe.py``): the FLOPs a training step requires, the least
time of the flash kernels at ``(D_qk, D_v)``, and the experts' FLOPs from
their assignment counts. The peaks are ``cost.py``'s.

As there: a product ``[m, k] @ [k, n]`` costs ``2 m k n``; the backward
is twice the forward; no recomputation is counted; attention counts the
causal half of the scores. The routed experts count the expected share of
the ``top_k`` choices that fall on the held experts (``top_k held /
n_experts`` a token), the router and the shared experts every token.
"""

from __future__ import annotations

from ..reference.mla_moe import MoEDims
from .cost import peak_bf16_flops, peak_hbm_bytes


def attention_projection_flops(d: MoEDims) -> int:
    """Forward FLOPs a token of one layer's wq, wkv_a, wkv_b and wo."""
    e, h, r = d.d_model, d.num_heads, d.kv_lora_rank
    return 2 * (e * h * d.qk_dim + e * (r + d.qk_rope_dim)
                + r * h * (d.qk_nope_dim + d.v_head_dim) + h * d.v_head_dim * e)


def swiglu_flops(d: MoEDims, width: int) -> int:
    """Forward FLOPs a token of one SwiGLU of ``width``: three products."""
    return 6 * d.d_model * width


def projection_flops(d: MoEDims, batch: int, seq_len: int) -> float:
    """Forward FLOPs of every weight product of a step: attention's
    projections, the dense MLPs, the routers, the shared experts, the held
    experts at the expected load, and the head."""
    tokens = batch * seq_len
    routed = swiglu_flops(d, d.d_expert) * d.top_k * len(d.held) / d.n_experts
    moe = 2 * d.d_model * d.n_experts + swiglu_flops(d, d.n_shared * d.d_expert) + routed
    per_token = (d.num_layers * attention_projection_flops(d)
                 + d.first_dense * swiglu_flops(d, d.d_ff) + d.moe_layers * moe
                 + 2 * d.d_model * d.vocab)
    return tokens * per_token


def attention_flops(d: MoEDims, batch: int, seq_len: int) -> int:
    """Forward FLOPs of ``Q K^T`` (over D_qk) and ``P V`` (over D_v) over
    the causal half of the scores, all layers."""
    pairs = seq_len * seq_len // 2
    return d.num_layers * batch * d.num_heads * pairs * 2 * (d.qk_dim + d.v_head_dim)


def train_step_flops(d: MoEDims, batch: int, seq_len: int) -> float:
    """FLOPs a training step requires: three times the forward."""
    return 3 * (projection_flops(d, batch, seq_len) + attention_flops(d, batch, seq_len))


def flash_least_seconds(d: MoEDims, batch: int, seq_len: int, kind: str,
                        elem_bytes: int = 2) -> dict[str, float]:
    """The least device seconds a step's calls of each flash kernel can
    take, all layers: the larger of the FLOP bound at the bf16 peak and the
    byte bound at the HBM rate. Products over the causal half, ``B H T^2
    D`` FLOPs each at its own width: forward ``Q K^T`` (D_qk) and ``P V``
    (D_v); dK/dV ``S`` (D_qk), ``dP`` (D_v), ``P^T dO`` (D_v) and ``dS^T
    Q`` (D_qk); dQ ``dS K`` (D_qk). Bytes: each input and output once, the
    activations in the compute type, the log-sum-exp and delta rows in
    float32."""
    b, t, h = batch, seq_len, d.num_heads
    pair = b * h * t * t  # two FLOPs a (query, key) pair of the causal half, per dim
    dk, dv = d.qk_dim, d.v_head_dim
    qk = b * t * h * dk * elem_bytes  # one q-wide tensor
    vv = b * t * h * dv * elem_bytes  # one v-wide tensor
    row = b * h * t * 4
    per_kernel = {  # (FLOPs, bytes)
        "fwd": (pair * (dk + dv), 2 * qk + vv + vv + row),
        "bwd_dkv": (pair * 2 * (dk + dv), 2 * qk + 2 * vv + 2 * row + qk + vv),
        "bwd_dq": (pair * dk, 2 * qk + 2 * vv + 2 * row + qk),
    }
    flops_peak, bytes_peak = peak_bf16_flops(kind), peak_hbm_bytes(kind)
    return {k: d.num_layers * max(f / flops_peak, nbytes / bytes_peak)
            for k, (f, nbytes) in per_kernel.items()}


def expert_flops(d: MoEDims, assignments: float, tokens: int) -> float:
    """FLOPs of a step's experts, forward and backward: ``assignments`` rows
    through the held experts (summed over the expert layers) and every
    token through the shared experts of each expert layer."""
    return 3 * (assignments * swiglu_flops(d, d.d_expert)
                + tokens * d.moe_layers * swiglu_flops(d, d.n_shared * d.d_expert))
