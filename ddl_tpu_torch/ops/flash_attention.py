"""Flash attention over ``[B, T, H, D]``: the CUDA port of
``ddl_tpu/ops/attention.py::flash_attention_bthd``.

The JAX function routes to the Pallas TPU flash-attention kernels bundled
with JAX (forward, dK/dV and dQ, under a ``custom_vjp``). Here the three
are hand-written CUDA kernels (``csrc/flash_attention.cu``) under a
``torch.autograd.Function``:

- forward: ``O = softmax(Q Kᵀ · scale + causal mask) V`` and one fp32
  log-sum-exp per query row (``lse [B, H, T]``);
- dK/dV and dQ: recompute ``P = exp(S · scale - lse)`` and take
  ``delta = rowsum(dO ∘ O)`` in fp32, computed here in torch ops (the JAX
  code computes it in plain jnp outside its kernels too).

Inputs are float32 or bfloat16 in the model's ``[B, T, H, D]`` layout
(no transpose copies), ``D`` in :data:`HEAD_DIMS`; every sum is fp32, and
outputs and gradients come back in the inputs' type. All three kernels run
their products on the tensor cores and are deterministic. In fp32 they use
the TF32 tensor cores to fp32 accuracy: each fp32 operand is split into two
TF32 parts, three products per product. In bf16 all three use the bf16
tensor cores: the forward with P split into two bf16 parts for ``P V``, the
backward kernels one pass a product, with P and dS rounded to bf16 before
their products (as JAX's TPU kernel feeds its matmuls).

:func:`flash_attention_bthd` dispatches on the tensors' device: on CUDA it
launches the kernels (built from ``csrc/flash_attention.cu`` at first use),
on the CPU it runs :func:`flash_attention_reference`, the plain version
with materialised fp32 scores and autograd gradients (the counterpart of
the JAX package's off-TPU fallback, ``mha_reference_no_custom_vjp``). Any
other device raises, and so does an unsupported head dim, a failed build
or a failed launch on CUDA: nothing falls back to the plain version on the
card. :func:`flash_fwd_reference`, :func:`flash_bwd_dkv_reference` and
:func:`flash_bwd_dq_reference` are the plain versions of each kernel, on
the kernels' own inputs and outputs.

``launches`` counts kernel launches by kernel (CPU calls are not counted),
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The JAX reference's additive mask value (DEFAULT_MASK_VALUE of the
# bundled flash-attention module): finite, so masked scores never make
# exp(-inf - -inf).
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

launches = {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0}


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _logits(q, k, causal: bool, scale: float) -> torch.Tensor:
    """Masked fp32 scores ``[B, H, Tq, Tk]``, as the JAX reference forms
    them: ``(Q Kᵀ) · scale``, plus ``MASK_VALUE`` where the key follows the
    query."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s + torch.where(keep, 0.0, MASK_VALUE)
    return s


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain softmax attention over ``[B, T, H, D]`` with materialised fp32
    scores: ``mha_reference_no_custom_vjp`` on fp32 copies of the inputs,
    cast back to ``q``'s type. Differentiable by autograd."""
    p = torch.softmax(_logits(q, k, causal, _scale(q, scale)), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_fwd_reference(q, k, v, causal: bool, scale: float):
    """The forward kernel's function in torch ops: ``(o, lse)``."""
    s = _logits(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def _probs_and_dscores(q, k, v, do, lse, delta, causal, scale):
    p = torch.exp(_logits(q, k, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dK/dV kernel's function in torch ops: ``(dk, dv)``."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dQ kernel's function in torch ops."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO ∘ O)`` in fp32, ``[B, H, T]`` (the backward kernels'
    row layout)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first time) and load the kernel library without launching
    anything."""
    lib = build.load("flash_attention")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # B, T, H, D; batch, row and head strides; scale, causal, device, stream.
    tail = [i32] * 4 + [i64] * 3 + [ctypes.c_float, i32, i32, ptr]
    for name, n_ptrs in (("ddl_flash_fwd", 5), ("ddl_flash_bwd_dkv", 8), ("ddl_flash_bwd_dq", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [i32] + [ptr] * n_ptrs + tail
        fn.restype = ctypes.c_int
    lib.ddl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(*ts: torch.Tensor) -> None:
    """Same ``[B, T, H, D]`` shape, type and device for every operand."""
    q = ts[0]
    if q.dim() != 4:
        raise ValueError(f"flash attention takes [B, T, H, D] tensors, got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    for t in ts[1:]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                "flash attention needs q, k and v alike: "
                f"{tuple(t.shape)} {t.dtype} {t.device} vs {tuple(q.shape)} {q.dtype} {q.device}"
            )


def _device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    """The CUDA device index of ``t`` and PyTorch's current stream on it."""
    if t.device.type != "cuda":
        raise RuntimeError(f"flash attention: no kernel for device {t.device}")
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _launch(key: str, name: str, tensors, q: torch.Tensor, causal: bool, scale: float) -> None:
    """One launch of ``name`` on the tensors' device, counted under
    ``launches[key]``. Every tensor must be contiguous (the kernels take
    one set of [B, T, H, D] strides for all operands). With B, T or H = 0
    there is nothing to compute: no launch, no count."""
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {HEAD_DIMS}, got {d}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash attention kernels take contiguous tensors")
    dev, stream = _device_and_stream(q)
    if q.numel() == 0:
        return
    lib = load_kernel()
    s_b, s_t, s_h, _ = q.stride()
    err = getattr(lib, name)(
        _DTYPE_CODES[q.dtype], *(x.data_ptr() for x in tensors),
        b, t, h, d, s_b, s_t, s_h, scale, int(causal), dev, stream,
    )
    if err != 0:
        msg = lib.ddl_cuda_error_string(err).decode()
        raise RuntimeError(f"flash attention: {name} launch failed: {msg} ({err})")
    launches[key] += 1


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy when its data does not start on a 16-byte boundary:
    the kernels stage tiles in 16-byte ``cp.async`` chunks (their launcher
    refuses a misaligned operand)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_fwd(q, k, v, causal: bool, scale: float):
    """The forward kernel: ``(o, lse)`` for contiguous CUDA ``q, k, v``."""
    q, k, v = (_aligned16(x) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32, device=q.device)
    _launch("fwd", "ddl_flash_fwd", (q, k, v, o, lse), q, causal, scale)
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dK/dV kernel: ``(dk, dv)``."""
    q, k, v, do = (_aligned16(x) for x in (q, k, v, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("bwd_dkv", "ddl_flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q, causal, scale)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """The dQ kernel."""
    q, k, v, do = (_aligned16(x) for x in (q, k, v, do))
    dq = torch.empty_like(q)
    _launch("bwd_dq", "ddl_flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, causal, scale)
    return dq


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = (x.contiguous() for x in (q, k, v))
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = attention_delta(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bthd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention over ``[B, T, H, D]`` (the JAX function's signature,
    minus ``platform``: the tensors' device decides). Causality is aligned
    from position 0; ``scale`` defaults to ``1/sqrt(D)``. Output in ``q``'s
    type; differentiable in ``q``, ``k`` and ``v``."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: no kernel for device {q.device}")
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
