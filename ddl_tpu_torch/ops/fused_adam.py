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

The grid is planned here, not in the kernel: :func:`launch_plan` is a pure
function of n, the path (float4 or scalar) and the occupancy the compiled
kernel gets on the card (asked of the CUDA runtime once, :func:`occupancy`),
so the CPU tests can check that a plan covers every element exactly once.

``launches`` counts kernel launches (CPU calls are not counted), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


# Units (float4s, or floats on the scalar path) of a tile: one a consumer
# thread (kThreads in csrc/fused_adam.cu).
THREADS = 256


class LaunchPlan(NamedTuple):
    """How one launch covers ``n`` elements: ``blocks`` blocks (at most one
    resident wave), the grid sweeping the ``units`` (float4s or floats)
    together in tiles of ``THREADS``; on the float4 path the ``tail`` = n %
    4 elements past the last float4 are block 0's."""

    blocks: int
    units: int
    tail: int

    def block_span(self, b: int) -> tuple[int, int, int]:
        """(first unit, step, bound) of block ``b``'s tiles, the kernels' own
        index formula: tile t takes the units first + t * step + [0,
        THREADS) below the bound."""
        return b * THREADS, self.blocks * THREADS, self.units


def launch_plan(n: int, vec4: bool, sms: int, blocks_per_sm: int) -> LaunchPlan:
    """The grid for ``n`` elements on a card of ``sms`` SMs that holds
    ``blocks_per_sm`` blocks of the kernel each: one block a tile up to one
    full wave (``sms * blocks_per_sm``), so blocks differ by at most one
    tile. ``blocks`` is 0 only for ``n == 0`` (nothing to launch)."""
    if n < 0 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"launch_plan: n={n}, sms={sms}, blocks_per_sm={blocks_per_sm}")
    units, tail = (n // 4, n % 4) if vec4 else (n, 0)
    if n == 0:
        return LaunchPlan(0, 0, 0)
    return LaunchPlan(max(1, min(sms * blocks_per_sm, -(-units // THREADS))), units, tail)


def full_wave_n(sms: int, blocks_per_sm: int) -> int:
    """The n (float4 path) at which every block of one full wave takes
    exactly one tile: the plan's boundary, where n + 4 gives block 0 a
    second tile."""
    return 4 * sms * blocks_per_sm * THREADS


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first time) and load the kernel library without launching
    anything; trainers call it before their clock starts."""
    lib = build.load("fused_adam")
    fn = lib.ddl_adam_flat_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.ddl_adam_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.ddl_adam_blocks_per_sm.restype = ctypes.c_int
    lib.ddl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ddl_cuda_error_string.restype = ctypes.c_char_p
    lib.ddl_adam_threads.argtypes = []
    lib.ddl_adam_threads.restype = ctypes.c_int
    if lib.ddl_adam_threads() != THREADS:
        raise RuntimeError(f"csrc/fused_adam.cu takes tiles of {lib.ddl_adam_threads()} "
                           f"units, the wrapper plans for {THREADS}")
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ddl_cuda_error_string(err).decode()
        raise RuntimeError(f"adam_flat_fused: {what} failed: {msg} ({err})")


@functools.cache
def occupancy(device_index: int, vec4: bool) -> tuple[int, int]:
    """(SMs, resident blocks an SM) of the compiled float4 (``vec4``) or
    scalar kernel on the card, asked of the CUDA runtime once."""
    lib = load_kernel()
    out = ctypes.c_int(0)
    _raise_on(lib, lib.ddl_adam_blocks_per_sm(int(vec4), device_index, ctypes.byref(out)),
              "occupancy query")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    if out.value < 1:
        raise RuntimeError(f"adam_flat_fused: the kernel fits no block on an SM ({out.value})")
    return sms, out.value


@functools.lru_cache(maxsize=64)
def _plan(n: int, vec4: bool, device_index: int) -> LaunchPlan:
    """The launch plan of one call, kept: a train step asks for the same n
    every step, and the host's time per call is the step's."""
    return launch_plan(n, vec4, *occupancy(device_index, vec4))


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
    _launch(p, m, v, g, lr_t, b1, b2, eps)
    return p, m, v


def _launch(p, m, v, g, lr_t, b1: float, b2: float, eps: float) -> None:
    """Launch the kernel on CUDA tensors that :func:`_check` passed: the
    TMA ring when all four buffers are 16-byte aligned, else the scalar
    kernel. Raises if the launch fails."""
    global launches
    lib = load_kernel()
    ptrs = [t.data_ptr() for t in (p, m, v, g)]
    vec4 = all(ptr % 16 == 0 for ptr in ptrs)
    dev = p.device.index if p.device.index is not None else torch.cuda.current_device()
    plan = _plan(p.numel(), vec4, dev)
    if plan.blocks == 0:
        return
    _raise_on(lib, lib.ddl_adam_flat_f32(
        *ptrs, lr_t.data_ptr(), p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
        int(vec4), plan.blocks, dev, torch.cuda.current_stream(dev).cuda_stream,
    ), "kernel launch")
    launches += 1
