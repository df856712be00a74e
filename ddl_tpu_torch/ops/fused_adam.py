"""Fused TF1 Adam over flat float32 vectors: the CUDA port of the Pallas
TPU kernel ``ddl_tpu/ops/pallas_adam.py::adam_flat_fused``.

One pass over device memory: reads g, m, v, p and writes p', m', v' in
place (28 bytes an element; the kernel is bound by bytes, see
``csrc/fused_adam.cu``). The JAX kernel returns new arrays; the port
updates its buffers in place, which saves the three output allocations,
and returns them.

``adam_flat_fused`` dispatches on the tensors' device: on CUDA it launches
the hand-written kernel (built from ``csrc/fused_adam.cu`` at first use),
on the CPU it runs :func:`adam_flat_reference`, the same formula in torch
ops. Any other device raises, and so does a CUDA build or launch failure:
nothing falls back to the plain version on the card.

``launches`` counts kernel launches (CPU calls are not counted), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

launches = 0


def adam_flat_reference(
    p: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    lr_t: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch chain (``_adam_kernel``, pallas_adam.py:43-51):
    returns new ``(p', m', v')``; the inputs are not modified."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    return p - lr_t * m2 / (torch.sqrt(v2) + eps), m2, v2


@functools.cache
def _max_blocks(device_index: int) -> int:
    # Enough resident blocks of 256 threads to fill every SM; the kernel's
    # grid-stride loop covers the rest.
    return torch.cuda.get_device_properties(device_index).multi_processor_count * 8


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first time) and load the kernel library without launching
    anything; trainers call it before their clock starts."""
    lib = build.load("fused_adam")
    fn = lib.ddl_adam_flat_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.ddl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(p, m, v, g, lr_t) -> None:
    n = p.numel()
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"adam_flat_fused: {name} must be float32, got {t.dtype}")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"adam_flat_fused: {name} must be flat [{n}], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adam_flat_fused: {name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"adam_flat_fused: {name} is on {t.device}, p on {p.device}")
    if lr_t.dtype != torch.float32 or lr_t.numel() != 1 or lr_t.device != p.device:
        raise ValueError(
            "adam_flat_fused: lr_t must be a one-element float32 tensor on "
            f"{p.device}, got {lr_t.dtype} {tuple(lr_t.shape)} on {lr_t.device}"
        )
    if len({p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr()}) < 4 and n:
        raise ValueError("adam_flat_fused: p, m, v and g must be distinct buffers")


def adam_flat_fused(
    p: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    lr_t: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TF1 Adam step over flat float32 ``[n]`` vectors, updating ``p``,
    ``m`` and ``v`` in place; returns them. ``lr_t`` is the bias-corrected
    learning rate as a one-element float32 tensor on the same device (the
    step counter stays outside the kernel, as in the JAX package)."""
    _check(p, m, v, g, lr_t)
    if p.device.type == "cpu":
        p2, m2, v2 = adam_flat_reference(p, m, v, g, lr_t.reshape(()), b1=b1, b2=b2, eps=eps)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
        return p, m, v
    if p.device.type != "cuda":
        raise RuntimeError(f"adam_flat_fused: no kernel for device {p.device}")
    global launches
    lib = load_kernel()
    ptrs = [t.data_ptr() for t in (p, m, v, g)]
    vec4 = all(ptr % 16 == 0 for ptr in ptrs)
    dev = p.device.index if p.device.index is not None else torch.cuda.current_device()
    err = lib.ddl_adam_flat_f32(
        *ptrs, lr_t.data_ptr(), p.numel(),
        b1, 1.0 - b1, b2, 1.0 - b2, eps,
        int(vec4), _max_blocks(dev), dev,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.ddl_cuda_error_string(err).decode()
        raise RuntimeError(f"adam_flat_fused: kernel launch failed: {msg} ({err})")
    launches += 1
    return p, m, v
