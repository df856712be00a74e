from .fused_adam import adam_flat_fused, adam_flat_reference
from .optimizers import AdamState, ShardedAdam, adam_init, adam_update

__all__ = [
    "AdamState",
    "ShardedAdam",
    "adam_flat_fused",
    "adam_flat_reference",
    "adam_init",
    "adam_update",
]
