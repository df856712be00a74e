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

Pipeline parallelism (``StagePartition``, JAX's ``models/partition.py``
lines 51-151) splits the ``blocks`` list into ``pp`` contiguous stages: stage
``s`` holds layers ``[s*L/pp, (s+1)*L/pp)``, tp-sharded inside as above, and
``embed``, ``lnf_g``, ``lnf_b`` and ``head`` (``SHARED_LEAVES``) are
replicated on every stage. A rank's live stage tree is the standard tree
with its stage's ``L/pp`` block dicts (:func:`shard_stage_params`); JAX's
stacked form (``[L, ...]`` block leaves sharded over pp,
:func:`pipeline_param_specs`) is kept for conversions
(:func:`stack_blocks` / :func:`unstack_blocks`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..parallel.mesh import PP_AXIS, TP_AXIS
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


# ---------------------------------------------------------------------------
# Pipeline parallelism: contiguous layer stages
# ---------------------------------------------------------------------------

# The pp-replicated leaves: stage 0 owns embed, the last stage the final
# LayerNorm and head; their gradients sum over (dp, sp, pp).
SHARED_LEAVES = ("embed", "head", "lnf_g", "lnf_b")


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """Contiguous split of the ``blocks`` list into ``pp`` pipeline stages
    (JAX's ``StagePartition``): stage ``s`` owns layers ``[s * L/pp, (s+1)
    * L/pp)``; the embedding belongs with stage 0, the final LayerNorm and
    head with the last stage, and all three stay replicated on every
    stage."""

    num_layers: int
    pp: int

    def __post_init__(self):
        if self.pp < 1:
            raise ValueError(f"pp must be >= 1, got {self.pp}")
        if self.num_layers % self.pp:
            raise ValueError(
                f"pipeline_parallel ({self.pp}) must divide num_layers "
                f"({self.num_layers}) — stages are contiguous equal "
                "layer blocks"
            )

    @property
    def layers_per_stage(self) -> int:
        return self.num_layers // self.pp

    def stage_layers(self, s: int) -> range:
        """The layer indices stage ``s`` owns."""
        return range(s * self.layers_per_stage, (s + 1) * self.layers_per_stage)


def stage_partition(spec: LMSpec, pp: int) -> StagePartition:
    """The contiguous stage split for this model at pipeline degree ``pp``."""
    return StagePartition(num_layers=spec.num_layers, pp=pp)


def pipeline_param_specs(spec: LMSpec, pp: int, tensor_parallel: int = 1):
    """JAX's ``PartitionSpec`` tree for the stacked pipeline form, each spec
    as the tuple of its entries: every block leaf gains a leading
    ``[num_layers]`` dimension split over ``PP_AXIS`` (its trailing
    dimensions keep the Megatron split over ``TP_AXIS`` at tp > 1);
    embed, head and the final LayerNorm are replicated (``()``)."""
    stage_partition(spec, pp)  # validate divisibility loudly
    col, row = (PP_AXIS, None, TP_AXIS), (PP_AXIS, TP_AXIS, None)
    if tensor_parallel == 1:
        col = row = (PP_AXIS,)
    vec = (PP_AXIS,)
    blk = {"ln1_g": vec, "ln1_b": vec, "wq": col, "wk": col, "wv": col,
           "wo": row, "ln2_g": vec, "ln2_b": vec, "w1": col,
           "b1": (PP_AXIS, TP_AXIS) if tensor_parallel > 1 else vec,
           "w2": row, "b2": vec}
    return {"embed": (), "blocks": blk, "lnf_g": (), "lnf_b": (), "head": ()}


def stack_blocks(params):
    """Standard tree (``blocks`` a list of per-layer dicts) -> JAX's
    pipeline form (``blocks`` one dict of ``[num_layers, ...]``-stacked
    numpy leaves). The inverse is :func:`unstack_blocks`."""
    blocks = params["blocks"]
    stacked = {k: np.stack([np.asarray(b[k]) for b in blocks]) for k in blocks[0]}
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = stacked
    return out


def unstack_blocks(params):
    """Inverse of :func:`stack_blocks`: the stacked form back to the
    standard per-layer list, leaf order preserved."""
    stacked = params["blocks"]
    num_layers = next(iter(stacked.values())).shape[0]
    blocks = [{k: np.asarray(v[i]) for k, v in stacked.items()} for i in range(num_layers)]
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def stage_spec(spec: LMSpec, pp: int) -> LMSpec:
    """The model one stage holds: ``spec`` with ``L/pp`` layers."""
    return dataclasses.replace(spec, num_layers=stage_partition(spec, pp).layers_per_stage)


def shard_stage_params(full: Any, spec: LMSpec, pp: int, pp_index: int,
                       tensor_parallel: int = 1, tp_index: int = 0) -> Any:
    """Rank ``(tp_index, pp_index)``'s stage of the full standard tree
    ``full``: the shared leaves whole and stage ``pp_index``'s block dicts,
    each leaf its tp shard (:func:`shard_lm_params` over the stage's
    specs)."""
    layers = stage_partition(spec, pp).stage_layers(pp_index)
    stage = {k: ([v[i] for i in layers] if k == "blocks" else v) for k, v in full.items()}
    specs = lm_param_specs(stage_spec(spec, pp), tensor_parallel)
    return shard_lm_params(stage, specs, tensor_parallel, tp_index)


def gather_stage_params(stages: list) -> Any:
    """Inverse of :func:`shard_stage_params` over tp-whole stage trees in
    stage order: their blocks concatenated, the shared leaves (the same
    on every stage) from stage 0."""
    return {k: ([b for st in stages for b in st["blocks"]] if k == "blocks" else v)
            for k, v in stages[0].items()}
