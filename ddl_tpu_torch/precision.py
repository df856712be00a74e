"""The precision contract of the LM trainer — the subset of
``ddl_tpu/precision.py`` this slice carries.

Two configurations are ported:

- fp32 (``precision=None`` with ``compute_dtype`` None or ``"float32"``,
  or ``precision="fp32"`` alone): everything in float32;
- the legacy ``compute_dtype="bfloat16"`` thread: parameters and
  activations cast to bf16 inside the loss (the flash kernels then run on
  bf16 inputs with fp32 sums), while LayerNorm statistics, logits, the
  loss, the gradients that reach Adam, the master weights and the moments
  stay fp32.

``precision="bf16"``, the policy that also casts gradients to bf16 for
their cross-device reduction, raises ``NotImplementedError``: it is ROADMAP
queue 1, item 4.
"""

from __future__ import annotations

import dataclasses

import torch

POLICIES = ("fp32", "bf16")
_COMPUTE = {"bfloat16": torch.bfloat16, "float32": None}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One resolved precision contract. ``legacy`` marks bf16 compute
    from a bare ``compute_dtype="bfloat16"`` (fp32 gradient reductions)."""

    name: str
    legacy: bool = False

    @property
    def compute_dtype(self) -> torch.dtype | None:
        """The dtype the model casts parameters and activations to (None =
        fp32, the no-cast path)."""
        return torch.bfloat16 if self.name == "bf16" else None


def resolve(precision: str | None, compute_dtype: str | None) -> PrecisionPolicy:
    """The JAX package's resolution rule (``precision.resolve``) for the
    ported configurations; raises ``NotImplementedError`` for the bf16
    policy and ``ValueError`` where the JAX package does."""
    if precision is None:
        if compute_dtype is None:
            return PrecisionPolicy("fp32")
        if compute_dtype not in _COMPUTE:
            raise ValueError(
                f"unsupported compute_dtype {compute_dtype!r} (fp32 or bfloat16)"
            )
        return PrecisionPolicy("fp32") if _COMPUTE[compute_dtype] is None else (
            PrecisionPolicy("bf16", legacy=True))
    if precision not in POLICIES:
        raise ValueError(
            f"unknown precision policy {precision!r} (choices: {', '.join(POLICIES)})"
        )
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' (bf16 gradient reductions) is not ported yet: "
            "ROADMAP queue 1, item 4 (bf16 precision); compute_dtype='bfloat16' "
            "gives bf16 compute with fp32 reductions"
        )
    if compute_dtype is not None:
        raise ValueError(
            f"precision={precision!r} conflicts with compute_dtype={compute_dtype!r}: "
            "the policy owns the compute dtype"
        )
    return PrecisionPolicy("fp32")
