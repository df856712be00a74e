"""Training configuration — the port of ``ddl_tpu/train/config.py``.

Same field names and defaults as the JAX package's ``TrainConfig``, so a
config (or its ``dataclasses.asdict``) reads the same in both.

Compat flags quarantine the reference's accidental semantics (default =
correct, flag = reproduce): ``grad_reduction="sum"`` sums worker gradients
without dividing (mnist_sync/parameter_server.py:36-37); ``shard_data=False``
trains every worker on the same batches (worker.py:27-30).
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # Reference defaults (worker.py:41-42, model.py:93).
    epochs: int = 1
    batch_size: int = 100  # global batch size
    learning_rate: float = 1e-4
    keep_prob: float = 0.5
    eval_every: int = 10  # batches between full-test-set evals (worker.py:71)
    seed: int = 0

    # Topology.
    num_workers: int = 1  # data-parallel degree (world size)
    num_ps: int = 1  # parameter-shard count (sharded strategies)

    # Strategy knobs.
    layout: Literal["block", "zigzag", "lpt", "flat"] = "block"
    grad_reduction: Literal["mean", "sum"] = "mean"
    shard_data: bool = True

    # Async: the seed of the arrival schedule (strategies/async_ps.py).
    staleness_seed: int = 0

    # Compute dtype of the forward/backward pass: None = fp32; "bfloat16"
    # casts parameters and activations inside the loss (logits and loss
    # stay fp32).
    compute_dtype: str | None = None
    # Precision policy (ddl_tpu_torch.precision): "fp32" or "bf16" (bf16
    # compute, fp32 master weights and moments). None defers to
    # compute_dtype above.
    precision: str | None = None

    def policy(self):
        """The resolved precision policy, the one compute-dtype authority
        every trainer reads (``precision.resolve`` rejects a conflicting
        precision/compute_dtype pair)."""
        from .. import precision as _precision

        return _precision.resolve(self.precision, self.compute_dtype)

    # Sharded update: run the hand-written CUDA fused-Adam kernel
    # (ops/fused_adam.py) instead of the plain PyTorch chain.
    fused_adam: bool = False

    # Which conv stages run as explicit patches-matmuls (im2col and a
    # matmul, models/cnn.py CONV_MATMUL_MODES): "none", "first", "tail"
    # (convs 3-4), "first+tail" or "all". conv1_matmul is the older alias
    # of "first" and composes with the mode (conv_matmul_mode).
    conv1_matmul: bool = False
    conv_matmul: Literal["none", "first", "tail", "first+tail", "all"] = "none"

    def conv_matmul_mode(self) -> str:
        """The effective patches-matmul selection the trainers pass to
        ``cnn.apply_fn``: ``conv1_matmul`` composes with the mode ("none"
        -> "first", "tail" -> "first+tail"); a mode that keeps the first
        conv as a convolution and has no rule raises ``ValueError``."""
        mode = self.conv_matmul
        if self.conv1_matmul:
            if mode == "none":
                return "first"
            if mode == "tail":
                return "first+tail"
            if mode not in ("first", "first+tail", "all"):
                raise ValueError(
                    f"conv_matmul mode {mode!r} does not include the first stage and "
                    "has no conv1_matmul composition rule"
                )
        return mode

    # Early stop at the first eval reaching this accuracy (None = run all).
    target_accuracy: float | None = None

    # Model family widths (defaults reproduce the reference exactly).
    conv_channels: tuple[int, int, int, int] = (32, 64, 128, 256)
    fc_sizes: tuple[int, int] = (1024, 512)

    def __post_init__(self):
        if self.grad_reduction not in ("mean", "sum"):
            raise ValueError(f"grad_reduction must be mean or sum, got {self.grad_reduction!r}")
        # A bad policy, dtype or conv1_matmul composition raises here.
        self.policy()
        self.conv_matmul_mode()

    def model_specs(self):
        """(name, shape) specs for this config's model-family instance."""
        from ..models import cnn

        return cnn.make_param_specs(
            conv_channels=tuple(self.conv_channels),
            fc_sizes=tuple(self.fc_sizes),
        )

    def per_worker_batch(self) -> int:
        if self.batch_size % self.num_workers:
            raise ValueError(
                f"global batch {self.batch_size} not divisible by "
                f"{self.num_workers} workers"
            )
        return self.batch_size // self.num_workers
