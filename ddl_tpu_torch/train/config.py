"""Training configuration — the port of ``ddl_tpu/train/config.py``.

Same field names and defaults as the JAX package's ``TrainConfig``, so a
config (or its ``dataclasses.asdict``) reads the same in both. Fields whose
feature is not ported yet are kept, and a value that would need that
feature raises ``NotImplementedError`` naming the ROADMAP item, rather than
being ignored.

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

    # Precision: only fp32 is ported (bf16 is ROADMAP queue 1, item 4).
    compute_dtype: str | None = None
    precision: str | None = None

    # Sharded update: run the hand-written CUDA fused-Adam kernel
    # (ops/fused_adam.py) instead of the plain PyTorch chain.
    fused_adam: bool = False

    # Patches-matmul conv lowering: only "none" is ported (ROADMAP queue 1,
    # item 6: the CNN's conv_matmul modes).
    conv1_matmul: bool = False
    conv_matmul: Literal["none", "first", "tail", "first+tail", "all"] = "none"

    # Early stop at the first eval reaching this accuracy (None = run all).
    target_accuracy: float | None = None

    # Model family widths (defaults reproduce the reference exactly).
    conv_channels: tuple[int, int, int, int] = (32, 64, 128, 256)
    fc_sizes: tuple[int, int] = (1024, 512)

    def __post_init__(self):
        if self.compute_dtype not in (None, "float32") or self.precision not in (None, "fp32"):
            raise NotImplementedError(
                "only fp32 compute is ported; bf16 waits for ROADMAP queue 1 "
                "(precision in the port)"
            )
        if self.conv1_matmul or self.conv_matmul != "none":
            raise NotImplementedError(
                "conv_matmul modes other than 'none' are not ported yet "
                "(ROADMAP queue 1, item 6: the CNN's conv_matmul modes)"
            )
        if self.grad_reduction not in ("mean", "sum"):
            raise ValueError(f"grad_reduction must be mean or sum, got {self.grad_reduction!r}")

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
