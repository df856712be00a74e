"""The precision policy — the port of ``ddl_tpu/precision.py``: one named
contract for every dtype decision.

- ``precision="fp32"`` (or ``None`` with ``compute_dtype`` None or
  ``"float32"``): everything in float32; every hook is a Python-level
  identity, so each step body runs exactly the pre-policy program.
- the legacy ``compute_dtype="bfloat16"`` thread (``precision=None``):
  parameters and activations cast to bf16 inside the loss (the flash
  kernels then run on bf16 inputs with fp32 sums), gradient reductions in
  fp32.
- ``precision="bf16"``: the same bf16 compute, and :meth:`cast_grads` /
  :meth:`upcast_grads` bracket each step body's explicit gradient sum, so
  the wire moves bf16 and the optimizer boundary upcasts back to fp32.

The casts are explicit, as JAX's are (no autocast): the in-loss
``p.to(bfloat16)`` casts' backward upcasts the cotangents, so the
gradients that reach Adam are fp32 leaves against fp32 master weights
under every policy. LayerNorm statistics, logits, the loss, the master
weights and the Adam moments stay fp32 under every policy, so optimizer
state and checkpoint forms do not depend on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .utils import tree as _tree

POLICIES = ("fp32", "bf16")

# The compute dtype of each policy (None = fp32, the models' no-cast path).
_COMPUTE = {"fp32": None, "bf16": torch.bfloat16}


def dtype_name(compute_dtype) -> str:
    """The canonical name of a ``compute_dtype`` string, as ``jnp.dtype``
    reads it: ``TypeError`` for a name no dtype has."""
    if compute_dtype == "bfloat16" or compute_dtype is torch.bfloat16:
        return "bfloat16"
    if isinstance(compute_dtype, torch.dtype):
        return str(compute_dtype).removeprefix("torch.")
    return np.dtype(compute_dtype).name


def make_to_dtype_fn(dtype: torch.dtype | None):
    """A per-leaf caster: floating-point tensors convert to ``dtype``,
    everything else (ints, bools: step counters, token ids) passes through
    untouched. ``dtype=None`` is the identity."""
    if dtype is None:
        return lambda x: x
    return lambda x: x.to(dtype) if x.is_floating_point() else x


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One resolved precision contract (see the module docstring). ``name``
    is ``"fp32"`` or ``"bf16"``; ``legacy`` marks bf16 compute from a bare
    ``compute_dtype="bfloat16"`` (fp32 gradient reductions)."""

    name: str
    legacy: bool = False

    @property
    def compute_dtype(self) -> torch.dtype | None:
        """The dtype the models cast parameters and activations to (None =
        fp32, the no-cast path)."""
        return _COMPUTE[self.name]

    @property
    def is_mixed(self) -> bool:
        return self.name == "bf16"

    @property
    def reduces_in_bf16(self) -> bool:
        """Whether the step bodies cast gradients to bf16 for their
        cross-device sums. False for fp32 and for the legacy bf16 thread."""
        return self.is_mixed and not self.legacy

    @property
    def mfu_kind(self) -> str:
        """The peak-rate row this policy's matmuls run at."""
        return "bf16" if self.compute_dtype is not None else "fp32"

    def cast_grads(self, grads):
        """Gradients (a tree of tensors) to the wire dtype, just before the
        step body's explicit sum. The identity (the same object) unless
        :attr:`reduces_in_bf16`."""
        if not self.reduces_in_bf16:
            return grads
        return _tree.map(make_to_dtype_fn(torch.bfloat16), grads)

    def upcast_grads(self, grads):
        """Summed gradients back to fp32 at the optimizer boundary. The
        identity (the same object) unless :attr:`reduces_in_bf16`."""
        if not self.reduces_in_bf16:
            return grads
        return _tree.map(make_to_dtype_fn(torch.float32), grads)


def resolve(precision: str | None, compute_dtype: str | None) -> PrecisionPolicy:
    """The JAX package's one resolution rule (``precision.resolve``), with
    its exceptions:

    - ``precision=None, compute_dtype=None`` (or ``"float32"``): fp32;
    - ``precision=None, compute_dtype="bfloat16"``: the LEGACY bf16 (bf16
      compute, fp32 gradient reductions);
    - ``precision="fp32"|"bf16"``: the named policy; a ``compute_dtype``
      that disagrees with it raises ``ValueError``.

    An unknown policy or an unsupported dtype is a ``ValueError``; a
    ``compute_dtype`` that names no dtype at all a ``TypeError``."""
    if precision is None:
        if compute_dtype is None:
            return PrecisionPolicy("fp32")
        name = dtype_name(compute_dtype)
        if name == "bfloat16":
            return PrecisionPolicy("bf16", legacy=True)
        if name == "float32":
            return PrecisionPolicy("fp32")
        raise ValueError(
            f"unsupported compute_dtype {compute_dtype!r} (fp32 or bfloat16; int8 is a "
            "KV-STORAGE dtype — ServeConfig.kv_dtype)"
        )
    if precision not in POLICIES:
        raise ValueError(
            f"unknown precision policy {precision!r} (choices: {', '.join(POLICIES)})"
        )
    want = _COMPUTE[precision]
    if compute_dtype is not None and (want is None or dtype_name(compute_dtype) != "bfloat16"):
        raise ValueError(
            f"precision={precision!r} conflicts with compute_dtype={compute_dtype!r}: "
            "the policy owns the compute dtype — drop the compute_dtype flag"
        )
    return PrecisionPolicy(precision)


def mfu_kind(compute_dtype: str | None) -> str:
    """The peak-rate row of a bare ``compute_dtype`` string (the serve
    path's only knob)."""
    return ("bf16" if compute_dtype is not None and dtype_name(compute_dtype) == "bfloat16"
            else "fp32")
