"""Analytic FLOPs accounting and MFU — the port of ``ddl_tpu/obs/cost.py``.

Model-FLOPs utilization is achieved FLOP/s over the hardware's peak. The
numerator is exact and analytic: closed-form matmul FLOPs per train step or
serve token, from the same config dataclasses the programs run, so the
``train_mfu`` gauge is a function of (config, measured span time, device
peak) and nothing else. The FLOP counts are JAX's integers.

Conventions (JAX's): a matmul ``[m, k] @ [k, n]`` costs ``2*m*k*n``; only
matmul-shaped work counts; attention counts the full ``T x T`` score matrix
(causal masking discards half the result, not the work: ``4*B*T*T*e`` a
layer); backward is 2x forward, a train step 3x, ``remat`` adds one BLOCK
forward; the parallel modes re-shard the same math, so the FLOPs are
topology-invariant and :func:`mfu` divides by ``n_devices * peak``; serving
counts per token over the attended width (``pages * page_size`` paged,
``capacity`` contiguous).

Peaks (:data:`PEAK_FLOPS_BY_KIND`): NVIDIA's published dense rates for the
H100 SXM5, per precision row: bf16 989.4e12 FLOP/s on the tensor cores, and
fp32 66.9e12 FLOP/s. The fp32 row is the right one for the port's fp32
policy because it runs fp32 matmuls with TF32 off (``cli.py``); JAX's
``FP32_PEAK_FRACTION`` (a TPU MXU fact) has no counterpart. ``--peak-flops``
overrides; a CPU falls back to :data:`CPU_NOMINAL_PEAK_FLOPS` (JAX's 5e10
anchor, not a measurement), and an unknown accelerator warns once and takes
that anchor too.
"""

from __future__ import annotations

# Per-device peak dense FLOP/s by device-name substring (lowercase), most
# specific first: {precision row: FLOP/s}. NVIDIA H100 SXM5 data sheet.
PEAK_FLOPS_BY_KIND: tuple[tuple[str, dict[str, float]], ...] = (
    ("h100", {"bf16": 989.4e12, "fp32": 66.9e12}),
)

# Nominal single-CPU-core fp32 peak: JAX's documented fallback that keeps
# MFU defined on CPU smoke runs. An anchor, not a measurement.
CPU_NOMINAL_PEAK_FLOPS = 5e10


_warned_kinds: set = set()


def device_kind(device) -> tuple[str, str]:
    """``(kind, platform)`` of a ``torch.device`` (or its string): the
    card's name for a CUDA device, ``"cpu"`` otherwise."""
    import torch

    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).lower(), "gpu"
    return device.type, device.type


def peak_flops_per_device(device=None, override: float | None = None,
                          precision: str = "bf16") -> float:
    """Peak FLOP/s for one device at the matmul ``precision`` ("bf16" or
    "fp32", the resolved policy's ``mfu_kind``): ``override`` wins (taken
    as the peak at the active precision); else the device-name table's row;
    else the CPU nominal fallback. An ACCELERATOR the table does not know
    warns once per kind: anchoring its MFU to the CPU nominal would report
    utilizations far above 1.0 as if they were real."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(
            f"unknown peak precision {precision!r} (bf16 or fp32)"
        )
    if override is not None:
        if override <= 0:
            raise ValueError(f"peak flops override must be > 0, got "
                             f"{override}")
        return float(override)
    kind, platform = device_kind(device)
    for key, peaks in PEAK_FLOPS_BY_KIND:
        if key in kind:
            return peaks[precision]
    if platform != "cpu" and kind not in _warned_kinds:
        import warnings

        _warned_kinds.add(kind)
        warnings.warn(
            f"unknown accelerator device_kind {kind!r}: MFU gauges will "
            f"use the CPU nominal anchor ({CPU_NOMINAL_PEAK_FLOPS:.0e} "
            "FLOP/s) and read far above 1.0 — pass --peak-flops (or "
            "peak_flops=) with the chip's real peak",
            stacklevel=2,
        )
    return CPU_NOMINAL_PEAK_FLOPS


def mfu(flops: float, seconds: float, n_devices: int,
        peak_per_device: float) -> float:
    """Model-FLOPs utilization: analytic FLOPs executed over the window
    divided by what ``n_devices`` could have executed at peak."""
    if seconds <= 0 or n_devices < 1 or peak_per_device <= 0:
        return 0.0
    return flops / (seconds * n_devices * peak_per_device)


# -- LM transformer -----------------------------------------------------------


def _lm_block_forward_flops(spec, tokens: int, attend_width: int) -> int:
    """Forward matmul FLOPs of ONE transformer block over ``tokens``
    query rows attending ``attend_width`` key rows: QKV+O projections
    (``8*t*e^2``), attention (``4*t*W*e`` — QK^T + AV), MLP
    (``4*t*e*f``)."""
    e, f = spec.d_model, spec.d_ff
    return (8 * tokens * e * e
            + 4 * tokens * attend_width * e
            + 4 * tokens * e * f)


def lm_forward_flops(spec, batch: int, seq_len: int) -> int:
    """Forward FLOPs of one full-sequence pass: ``num_layers`` blocks
    (full ``T x T`` attention) plus the untied head projection
    (``2*B*T*e*vocab``; the embedding lookup is a gather — no
    matmul)."""
    t = batch * seq_len
    # Per sequence, every one of its T query rows attends its own T key
    # rows: the block helper with tokens=T, width=T, scaled by batch.
    block = batch * _lm_block_forward_flops(spec, seq_len, seq_len)
    return spec.num_layers * block + 2 * t * spec.d_model * spec.vocab


def lm_train_step_flops(spec, batch: int, seq_len: int, *,
                        remat: bool = False) -> int:
    """Forward + backward FLOPs of one LM train step (global batch).
    Backward is 2x forward; ``remat`` adds one extra BLOCK forward per
    layer (the head is not rematerialized). Topology-invariant — see
    the module docstring's mode-awareness note."""
    fwd = lm_forward_flops(spec, batch, seq_len)
    total = 3 * fwd
    if remat:
        total += (spec.num_layers * batch
                  * _lm_block_forward_flops(spec, seq_len, seq_len))
    return total


# -- CNN ----------------------------------------------------------------------

# SAME 5x5 convs at stride 1 keep spatial dims; the 2x2 pool halves them
# (28 -> 14 -> 7 -> 4 -> 2), so each conv stage's output spatial extent
# equals its INPUT extent. The FC input is the 2x2 pooled final stage.
_CNN_SPATIAL = (28, 14, 7, 4)
_CNN_KERNEL = 5 * 5


def cnn_forward_flops(conv_channels=(32, 64, 128, 256),
                      fc_sizes=(1024, 512), num_classes: int = 10,
                      batch: int = 1) -> int:
    """Forward matmul FLOPs of the 4-conv/3-FC MNIST family per
    ``batch`` images: each SAME conv is ``2 * H*W * cout * (25*cin)``
    (identical whether lowered as a conv or a patches-matmul — the
    contraction is the same, which is why ``conv_matmul`` modes need no
    separate accounting), plus the three FC matmuls."""
    cins = (1,) + tuple(conv_channels[:3])
    flops = 0
    for s, cin, cout in zip(_CNN_SPATIAL, cins, conv_channels):
        flops += 2 * s * s * cout * (_CNN_KERNEL * cin)
    f1, f2 = fc_sizes
    flops += 2 * (2 * 2 * conv_channels[3]) * f1
    flops += 2 * f1 * f2
    flops += 2 * f2 * num_classes
    return batch * flops


def cnn_train_step_flops(batch: int, conv_channels=(32, 64, 128, 256),
                         fc_sizes=(1024, 512),
                         num_classes: int = 10) -> int:
    """Forward + backward (2x forward) FLOPs of one CNN train step."""
    return 3 * cnn_forward_flops(conv_channels, fc_sizes, num_classes,
                                 batch)


# -- serving ------------------------------------------------------------------


def serve_decode_flops_per_token(spec, attend_width: int) -> int:
    """Decode FLOPs for ONE token of one slot attending ``attend_width``
    resident rows — the paged-aware width: ``pages * page_size`` of the
    decode bucket on the paged layout, ``capacity`` on the contiguous
    ring."""
    return (spec.num_layers
            * _lm_block_forward_flops(spec, 1, attend_width)
            + 2 * spec.d_model * spec.vocab)


def serve_speculate_verify_flops(spec, fed_rows: int,
                                 attend_width: int) -> int:
    """One speculative verify call: ``fed_rows`` decode-
    shaped rows — the real active slots PLUS every draft lane — each
    attending ``attend_width`` resident rows. The verify is literally
    the decode program with lanes riding in free slots, so its cost is
    per-token decode cost times the rows actually computed; emitted
    tokens can be fewer (rejected lanes) or more (a fully-accepted
    block's bonus token) — the asymmetry IS the speculation trade, so
    the accounting must price rows, not tokens."""
    return fed_rows * serve_decode_flops_per_token(spec, attend_width)


def serve_prefill_flops(spec, tokens: int, attend_width: int) -> int:
    """Prefill FLOPs for a ``tokens``-row block whose attention spans
    ``attend_width`` rows (the compiled bucket width — padding computes
    too; honesty about the bucket is the point)."""
    return (spec.num_layers
            * _lm_block_forward_flops(spec, tokens, attend_width)
            + 2 * tokens * spec.d_model * spec.vocab)
