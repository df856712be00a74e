"""The yardstick's arithmetic: the operations a training step requires,
the least time of the flash kernels, and the card's published peaks.

Copied from the port's ``obs/cost.py`` and corrected: that file counts the
whole ``T x T`` score matrix of causal attention, of which a step needs
half. A product ``[m, k] @ [k, n]`` costs ``2 m k n``; the backward pass
is twice the forward; no recomputation is counted.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989.4
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from ..reference.lm import Dims

PEAK_BF16_FLOPS = {"h100 80gb hbm3": 989.4e12}
PEAK_HBM_BYTES = {"h100 80gb hbm3": 3.35e12}


def _peak(table: dict, kind: str) -> float:
    for key, value in table.items():
        if key in kind.lower():
            return value
    raise ValueError(f"no published peak for device {kind!r}")


def peak_bf16_flops(kind: str) -> float:
    return _peak(PEAK_BF16_FLOPS, kind)


def peak_hbm_bytes(kind: str) -> float:
    return _peak(PEAK_HBM_BYTES, kind)


def projection_flops(d: Dims, batch: int, seq_len: int) -> int:
    """Forward FLOPs of every weight product of a step: q, k, v, o
    (``8 e^2`` a token), the MLP (``4 e f``) in each layer, and the head
    (``2 e V``)."""
    e, f = d.d_model, d.d_ff
    tokens = batch * seq_len
    return tokens * (d.num_layers * (8 * e * e + 4 * e * f) + 2 * e * d.vocab)


def attention_flops(d: Dims, batch: int, seq_len: int) -> int:
    """Forward FLOPs of ``Q K^T`` and ``P V`` over the causal half of the
    scores, all layers: ``2 T^2 e`` a sequence and layer."""
    return d.num_layers * batch * 2 * seq_len * seq_len * d.d_model


def train_step_flops(d: Dims, batch: int, seq_len: int) -> int:
    """FLOPs a training step requires: three times the forward."""
    return 3 * (projection_flops(d, batch, seq_len) + attention_flops(d, batch, seq_len))


def flash_least_seconds(d: Dims, batch: int, seq_len: int, kind: str,
                        elem_bytes: int = 2) -> dict[str, float]:
    """The least device seconds a step's calls of each flash kernel can
    take, all layers: the larger of the FLOP bound at the bf16 peak and the
    byte bound at the HBM rate. Products over the causal half, ``B H T^2
    D`` FLOPs each: forward ``Q K^T`` and ``P V``; dK/dV the one required
    ``Q K^T``, ``dO V^T``, ``P^T dO`` and ``dS^T Q``; dQ ``dS K`` (the
    second kernel's recomputed ``Q K^T`` and ``dO V^T`` are not required).
    Bytes: each input and output once; ``q, k, v, o, dO, dq, dk, dv`` in
    the compute type, the log-sum-exp and delta rows in float32."""
    b, t, h, dh = batch, seq_len, d.num_heads, d.head_dim
    product = b * h * t * t * dh
    act = b * t * h * dh * elem_bytes
    row = b * h * t * 4
    per_kernel = {  # (products, bytes)
        "fwd": (2, 3 * act + act + row),
        "bwd_dkv": (4, 4 * act + 2 * row + 2 * act),
        "bwd_dq": (1, 4 * act + 2 * row + act),
    }
    flops_peak, bytes_peak = peak_bf16_flops(kind), peak_hbm_bytes(kind)
    return {k: d.num_layers * max(n * product / flops_peak, nbytes / bytes_peak)
            for k, (n, nbytes) in per_kernel.items()}


def matmul_least_seconds(d: Dims, batch: int, seq_len: int, kind: str) -> float:
    """The least device seconds of a step's weight products (forward and
    twice for the backward) at the bf16 peak."""
    return 3 * projection_flops(d, batch, seq_len) / peak_bf16_flops(kind)
