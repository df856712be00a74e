"""The Megatron tensor-parallel partition of the LM's parameters — the port of
``ddl_tpu/models/partition.py::lm_param_specs``, shared by training
(``strategies/seq.py``) and serving (``serve/engine.py``), so the two can
never shard a checkpoint differently.

A spec names, for each leaf of the parameter tree, the dimension that is
split over the tp ranks (``None``: replicated). Column shards (``wq``,
``wk``, ``wv``, ``w1`` and ``b1``) split their last dimension, so a rank
holds ``H/tp`` whole heads and ``d_ff/tp`` hidden units; row shards (``wo``,
``w2``) split their first, consuming them; everything touching the
full-width residual stream (the LayerNorms, ``embed``, ``head``, ``b2``)
is replicated. Rank ``t`` holds the ``t``-th contiguous block of each split
dimension: what JAX's ``NamedSharding`` over ``P(None, "tp")`` /
``P("tp", None)`` / ``P("tp")`` places on tp position ``t``.

The pipeline's ``StagePartition`` waits for its slice (ROADMAP queue 1,
item 3: the pipeline).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils import tree
from .transformer import LMSpec

# The split dimension of each tp-sharded block leaf.
COLUMN, ROW = 1, 0
BLOCK_SPLITS = {"wq": COLUMN, "wk": COLUMN, "wv": COLUMN, "w1": COLUMN, "b1": 0,
                "wo": ROW, "w2": ROW}


def lm_param_specs(spec: LMSpec, tensor_parallel: int):
    """The spec tree for the LM's parameters: ``None`` (every leaf
    replicated) at tp 1, as JAX's single ``P()``; otherwise the parameter
    tree's nesting with each leaf's split dimension, or ``None``."""
    if tensor_parallel == 1:
        return None
    blk = {"ln1_g": None, "ln1_b": None, "ln2_g": None, "ln2_b": None, "b2": None,
           **BLOCK_SPLITS}
    return {
        "embed": None,
        "blocks": [dict(blk) for _ in range(spec.num_layers)],
        "lnf_g": None, "lnf_b": None, "head": None,
    }


def _block(leaf, axis: int | None, tp: int, t: int):
    if axis is None:
        return leaf
    n = leaf.shape[axis]
    if n % tp:
        raise ValueError(f"dimension {axis} of {tuple(leaf.shape)} does not split into {tp}")
    size = n // tp
    index = [slice(None)] * len(leaf.shape)
    index[axis] = slice(t * size, (t + 1) * size)
    return leaf[tuple(index)]


def shard_lm_params(full: Any, specs, tensor_parallel: int, tp_index: int) -> Any:
    """Rank ``tp_index``'s shard of the full tree ``full`` (numpy arrays or
    tensors): each split leaf's ``tp_index``-th contiguous block, the
    replicated leaves whole. Blocks are views where the leaf type makes
    them views."""
    if specs is None:
        return full
    return tree.map(lambda leaf, axis: _block(leaf, axis, tensor_parallel, tp_index), full,
                    specs)


def gather_lm_params(shards: list, specs) -> Any:
    """Inverse of :func:`shard_lm_params`: the full tree from every rank's
    shard, in tp order (split leaves concatenated, replicated leaves taken
    from the first)."""
    if specs is None:
        return shards[0]

    def join(axis, *leaves):
        if axis is None:
            return leaves[0]
        if isinstance(leaves[0], torch.Tensor):
            return torch.cat(leaves, dim=axis)
        return np.concatenate(leaves, axis=axis)

    return tree.map(lambda *leaves: join(leaves[-1], *leaves[:-1]), *shards, specs)
