"""Decoder-LM training — the port of ``ddl_tpu/strategies/seq.py``.

The trainer runs the decoder LM (``models/transformer.py``) over the 3-D
``[data_parallel, num_workers, tensor_parallel]`` process grid
(``parallel/mesh.py::Grid``, JAX's ``make_mesh_3d``, tp minor): the batch
shards over dp and the sequence over sp, each rank holding ``B/dp``
sequences x ``T/sp`` positions, and its tp peers the same tokens. One
process a rank: torchrun on a multi-card host, a world of one on one card,
gloo worlds on the CPU (or on one card); without a world (``world=None``)
the grid is one rank and every collective is an identity.

Tensor parallelism (``tensor_parallel > 1``, Megatron): each rank holds its
column/row shard of the block weights (``models/partition.py``) and its
moments, and the f/g pair (``_col_promote``, ``_row_reduce``) owns every
reduction over the tp group in both directions, so a rank's gradients come
out tp-complete and partial only over ``(dp, sp)``. Every sum (the
gradients, the loss, the weights, the metrics) runs over the ``(dp, sp)``
group, never over tp: summing over the world would count every token tp times.
The init is the full tree from the seed, sliced by tp index, and
``LMResult.params`` is the full tree, gathered over tp.

Schemes (``SeqConfig.scheme``):

- ``ring``: ring attention (``parallel/ring.py``), K/V blocks passed
  around the sp row, layout ``contiguous`` or ``zigzag``; plain torch ops,
  as JAX's is plain jnp;
- ``ulysses``: two all-to-alls around a full-sequence local attention
  over a head subset: ``attn_impl="xla"`` (plain attention) or ``"flash"``
  (the hand-written CUDA flash kernels, ``ops/flash_attention.py``; their
  plain version on the CPU);
- ``full``: no sharding of the sequence (``num_workers`` 1).

A step (``_step_body``) differentiates this rank's scored-token CE sum over
the global weight total (``_local_loss_fn``), all-reduces the flat
gradient once over ``(dp, sp)``, and runs TF1 Adam over the tree. With
``zero1`` (``_zero1_step_body``) the flat gradient is reduce-scattered
over the combined (dp, sp) axes instead (whose rank order is JAX's chunk
order), each rank runs the plain flat Adam chain on its chunk (JAX's LM
ZeRO-1 does not take the fused kernel) and the chunks are all-gathered
back. ``zero1`` with tp is the hybrid (``_zero1_tp_step_body``,
``HybridAdam``): ZeRO-1 over (dp, sp) for the tp-replicated leaves, tree
Adam on the tp shards. The span loop, eval cadence and early stop are the JAX
trainer's (``train/trainer.py::eval_spans``); each span is a host loop of
eager steps closed by a device barrier.

Pipeline parallelism (``pipeline_parallel > 1``, ``pipeline/``) adds the
minor pp axis, the grid ``[dp, 1, tp, pp]``: each rank holds its stage's
blocks (tp-sharded) and the stage-replicated embed, final LayerNorm and
head, and Adam moments placed likewise; the step streams ``microbatches``
through the stages by the GPipe or 1F1B tables and the eval hands one chunk
at a time stage to stage. ``LMResult.params`` is the full tree, gathered
over tp and pp.

Precision (``SeqConfig.policy()``, ``ddl_tpu_torch/precision.py``): under
bf16 compute the loss casts the parameters and activations to bf16; under
``precision="bf16"`` every step body also brackets its explicit gradient
sums with the policy's ``cast_grads`` / ``upcast_grads``, where JAX's do,
so the all-reduce, the ZeRO-1 reduce-scatter and the hybrid's per-leaf
sums move bf16 and Adam sees fp32. Master weights and moments stay fp32.

``SeqConfig`` keeps every JAX field and default, and the JAX trainer's own
checks raise the same ``ValueError``s (:func:`check_config`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Literal

import numpy as np
import torch

from .. import precision as _precision
from ..convert import lm_params_from_numpy, lm_params_to_numpy
from ..data.lm import LMDataset
from ..models import partition, transformer
from ..models.transformer import LMSpec
from ..ops import flash_attention
from ..ops.optimizers import AdamState, ShardedAdam, adam_init, adam_update
from ..parallel import collectives as coll
from ..parallel import ring
from ..parallel.mesh import DP_AXIS, LOCAL, SP_AXIS, Grid, World, default_device, make_grid
from ..pipeline import trainer as pipeline_trainer
from ..pipeline.schedule import SCHEDULES
from ..pipeline.step import PipelineRecord, make_pipeline_eval_body
from ..train.trainer import eval_spans, hit_target
from ..utils import tree
from ..utils.metrics import StepStats, StepTimer, barrier
from .sync import _adam_flat

Scheme = Literal["ring", "ulysses", "full"]

# The axes every sum runs over (the (dp, sp) group), never tp: rank =
# (dp_index * num_workers + sp_index) * tensor_parallel + tp_index.
AXES = (DP_AXIS, SP_AXIS)
LOCAL_GRID = make_grid(None, 1, 1)


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    """The JAX package's ``SeqConfig``: same fields, same defaults."""

    epochs: int = 1
    batch_size: int = 8  # sequences per global batch (shards over dp rows)
    learning_rate: float = 1e-3
    eval_every: int = 10  # batches between test-set evals (0 = end only)
    seed: int = 0
    num_workers: int = 1  # sequence-parallel degree (sp axis)
    data_parallel: int = 1  # dp axis; ranks = data_parallel * num_workers
    tensor_parallel: int = 1  # Megatron tp degree (the grid's minor axis)
    scheme: Scheme = "ring"
    compute_dtype: str | None = None  # None = fp32; "bfloat16" = bf16 compute
    precision: str | None = None  # policy "fp32" or "bf16"; None defers to compute_dtype
    target_accuracy: float | None = None
    zero1: bool = False  # ZeRO-1 over the combined (dp, sp) axes (with tp: the hybrid)
    # Local attention for full and ulysses: "xla" = plain attention
    # (materialises [B, H, T, T] scores); "flash" = the CUDA flash kernels
    # (their plain version on the CPU).
    attn_impl: Literal["xla", "flash"] = "xla"
    # Recompute each block in the backward pass (torch.utils.checkpoint).
    remat: bool = False
    # Position-to-rank layout of the ring: "contiguous" or "zigzag".
    seq_layout: Literal["contiguous", "zigzag"] = "contiguous"
    pipeline_parallel: int = 1
    microbatches: int = 1
    pipeline_schedule: Literal["gpipe", "1f1b"] = "gpipe"
    spec: LMSpec = LMSpec()

    def policy(self) -> _precision.PrecisionPolicy:
        return _precision.resolve(self.precision, self.compute_dtype)

    def dtype(self) -> torch.dtype | None:
        return self.policy().compute_dtype

    def validate_topology(self) -> None:
        """JAX's pipeline topology checks, in its order and with its texts:
        ``check_config`` runs them before anything else, and
        ``pipeline.make_pipeline_program`` builds a step without them."""
        pp, m = self.pipeline_parallel, self.microbatches
        if pp < 1:
            raise ValueError(f"pipeline_parallel must be >= 1, got {pp}")
        if m < 1:
            raise ValueError(f"microbatches must be >= 1, got {m}")
        if m > 1 and pp == 1:
            raise ValueError(
                f"microbatches ({m}) > 1 requires pipeline_parallel > 1 "
                "(microbatching exists to fill the pipeline; without "
                "stages it only re-associates the batch)"
            )
        if pp == 1:
            return
        if self.spec.num_layers % pp:
            raise ValueError(
                f"pipeline_parallel ({pp}) must divide num_layers "
                f"({self.spec.num_layers}) — stages are contiguous "
                "equal layer blocks"
            )
        if m < 2:
            raise ValueError(
                f"pipeline_parallel ({pp}) > 1 requires microbatches > 1 "
                f"— one microbatch leaves (pp-1)/pp = {pp - 1}/{pp} of "
                "every step idle (the GPipe bubble); pass "
                "--microbatches >= 2"
            )
        if self.batch_size % (self.data_parallel * m):
            raise ValueError(
                f"microbatches ({m}) x data_parallel "
                f"({self.data_parallel}) must divide the global batch "
                f"({self.batch_size}) — each dp row streams equal "
                "microbatches through the stages"
            )
        if self.num_workers != 1 or self.scheme != "full":
            raise ValueError(
                "pipeline_parallel composes with data/tensor parallelism "
                "only: use num_workers=1 and scheme='full' (sequence x "
                "pipeline is rejected — README composition matrix)"
            )
        if self.zero1:
            raise ValueError(
                "zero1 x pipeline_parallel is not supported: the "
                "pipeline Adam path keeps stage-local optimizer state "
                "(already sharded pp-fold with the layers); see the "
                "README composition matrix"
            )
        if self.pipeline_schedule not in SCHEDULES:
            raise ValueError(
                f"unknown pipeline_schedule {self.pipeline_schedule!r} "
                f"(choices: {', '.join(SCHEDULES)})"
            )


@dataclasses.dataclass
class LMResult:
    """The JAX ``LMResult`` without the fields of features not ported yet
    (resume, preemption, the non-finite guard), plus the span losses."""

    params: dict  # numpy tree, JAX layout
    final_accuracy: float  # weighted next-token accuracy on the test set
    final_loss: float
    wall_time_s: float
    train_time_s: float  # span time only; evals and warm-up excluded
    history: list[tuple[int, int, float]]  # (epoch, batch, accuracy)
    tokens_per_sec: float  # scored + unscored tokens (B * T) / train_time_s
    compile_time_s: float = 0.0  # warm-up before the clock, kernel build included
    step_stats: StepStats | None = None
    span_losses: list[float] = dataclasses.field(default_factory=list)  # last loss per span


def _attn_for(config: SeqConfig, grid: Grid = LOCAL_GRID) -> Callable:
    """This rank's attention closure over ``[B, T/W, H, D]`` — always causal
    (decoder LM)."""
    W = config.num_workers
    if config.attn_impl not in ("xla", "flash"):
        raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
    flash = config.attn_impl == "flash"
    if flash and config.scheme == "ring":
        raise ValueError(
            "attn_impl='flash' supports schemes full and ulysses; the ring's "
            "travelling-block softmax state cannot route through the flash kernel"
        )
    local = functools.partial(flash_attention.flash_attention_bthd, causal=True) if flash \
        else None
    if config.scheme == "full":
        if W != 1:
            raise ValueError("scheme='full' cannot shard the sequence; "
                             "use ring or ulysses for num_workers > 1")
        return local or functools.partial(ring.full_attention, causal=True)
    if config.scheme == "ring":
        if config.seq_layout not in ring.LAYOUTS:
            raise ValueError(f"unknown layout {config.seq_layout!r}")
        return functools.partial(
            ring.ring_attention_shard, axis_size=W, index=grid.sp_index,
            ring=coll.Ring(grid.sp_group, grid.sp_ranks, grid.sp_index), causal=True,
            layout=config.seq_layout,
        )
    if config.scheme == "ulysses":
        return functools.partial(
            ring.ulysses_attention_shard, axis_size=W, group=grid.sp_group, causal=True,
            local_attn=local,
        )
    raise ValueError(f"unknown scheme {config.scheme!r}")


def check_config(config: SeqConfig, dataset: LMDataset) -> None:
    """Every check of the JAX ``SeqTrainer.__init__``, in its order and with
    its ``ValueError`` texts. Needs no process group."""
    W, dp, tp = config.num_workers, config.data_parallel, config.tensor_parallel
    config.validate_topology()
    if dataset.seq_len % max(W, 1):
        raise ValueError(f"seq_len {dataset.seq_len} not divisible by {W} workers")
    if tp > 1:
        if config.spec.num_heads % tp:
            raise ValueError(
                f"tensor_parallel needs num_heads ({config.spec.num_heads}) "
                f"divisible by tp ({tp})"
            )
        if config.spec.d_ff % tp:
            raise ValueError(
                f"tensor_parallel needs d_ff ({config.spec.d_ff}) divisible by tp ({tp})"
            )
    local_heads = config.spec.num_heads // max(tp, 1)
    if config.scheme == "ulysses" and local_heads % max(W, 1):
        raise ValueError(
            f"ulysses needs per-device num_heads ({local_heads}) "
            f"divisible by num_workers ({W})"
        )
    # Both splits: an out-of-range id would index past the embedding.
    for name, toks in (("train", dataset.tokens), ("test", dataset.test_tokens)):
        if toks.size and toks.max() >= config.spec.vocab:
            raise ValueError(
                f"{name} vocab {toks.max() + 1} exceeds model vocab {config.spec.vocab}"
            )
    if config.batch_size % max(dp, 1):
        raise ValueError(
            f"batch_size {config.batch_size} not divisible by "
            f"data_parallel {dp} (the batch shards over dp rows)"
        )
    if dataset.num_train // config.batch_size == 0:
        raise ValueError(
            f"batch_size {config.batch_size} exceeds {dataset.num_train} train sequences"
        )
    if config.seq_layout == "zigzag":
        if config.scheme != "ring":
            raise ValueError(
                "seq_layout='zigzag' balances the RING's causal sweep; "
                "full/ulysses reassemble the whole sequence locally and "
                "assume contiguous order — use scheme='ring'"
            )
        if dataset.seq_len % (2 * W):
            raise ValueError(
                f"seq_layout='zigzag' needs seq_len % (2 * num_workers)"
                f" == 0, got {dataset.seq_len} % {2 * W}"
            )
    if dp < 1 or W < 1 or tp < 1:
        raise ValueError(
            f"data_parallel ({dp}), num_workers ({W}) and "
            f"tensor_parallel ({tp}) must be >= 1"
        )
    _attn_for(config)  # unknown attn_impl / scheme / layout; full with sharding
    config.policy()  # an unknown policy or dtype, or a conflicting pair, raises


def _shard_positions(config: SeqConfig, t_local: int, grid: Grid,
                     device: torch.device) -> torch.Tensor:
    """This sp shard's absolute token positions ``[t_local]`` per the
    config's layout, made on the device. They feed both RoPE and the
    ring's mask, so the two cannot disagree."""
    return ring.shard_positions(config.seq_layout, grid.sp_index, config.num_workers,
                                t_local, torch, device=device)


def _psum(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """``lax.psum`` over ``AXES``: the sum over the ``(dp, sp)`` group, in
    place."""
    if grid.data_group is LOCAL:
        return t
    return coll.all_reduce_sum(t, grid.world, group=grid.data_group)


def _row_reduce(grid: Grid):
    """Megatron's ``g`` for the row-sharded matmul outputs: all-reduce
    forward, identity backward, over the tp group (an identity at tp 1,
    whose tp group is ``LOCAL``)."""
    return coll.tp_allreduce(grid.tp_group)


def _col_promote(grid: Grid):
    """Megatron's ``f``, :func:`_row_reduce`'s conjugate: identity forward,
    all-reduce backward where the tp-replicated residual stream enters the
    column-sharded matmuls, so the replicated leaves get full gradients.
    An identity at tp 1."""
    return coll.tp_promote(grid.tp_group)


def _shard_sums(config: SeqConfig, grid: Grid, attn, positions, fn) -> Callable:
    """``(params, tokens, targets, weights) -> (num, den)`` of an
    accumulator-form metric ``fn`` (``lm_correct_sums``) over this rank's
    ``[n, T/W]`` shard, in chunks of ``batch_size`` sequences, summed over
    ``(dp, sp)`` in one all-reduce: the global sums, not a mean of shard
    means (the scored tokens sit unevenly across the sequence shards)."""
    hooks = dict(row_reduce=_row_reduce(grid), col_promote=_col_promote(grid))

    def sums(params, tokens, targets, weights):
        out = torch.zeros(2, device=tokens.device)
        bs = config.batch_size
        for i in range(0, tokens.shape[0], bs):
            num, den = fn(params, tokens[i:i + bs], targets[i:i + bs], weights[i:i + bs],
                          config.spec, attn_fn=attn, positions=positions,
                          compute_dtype=config.dtype(), **hooks)
            out += torch.stack([num, den])
        return _psum(out, grid)

    return sums


def _local_loss_fn(config: SeqConfig, grid: Grid, attn, tokens, targets, weights,
                   positions) -> Callable:
    """The loss a step differentiates: this shard's scored-token CE sum
    over the global weight total. The total depends on no parameter, so
    the gradients are this rank's partial sums over ``(dp, sp)``, which the
    step reduces, and tp-complete (the f/g pair inside the model owns every
    tp reduction)."""
    den = _psum(weights.float().sum(), grid)
    hooks = dict(row_reduce=_row_reduce(grid), col_promote=_col_promote(grid))

    def local_loss(p):
        num, _ = transformer.lm_loss_sums(
            p, tokens, targets, weights, config.spec, attn_fn=attn, positions=positions,
            compute_dtype=config.dtype(), remat=config.remat, **hooks,
        )
        return num / den

    return local_loss


def _local_grads(config, grid, attn, positions, params, tokens, targets, weights):
    """``(loss summed over (dp, sp), this rank's gradient leaves)``."""
    leaves = tree.map(lambda t: t.detach().requires_grad_(True), params)
    l_local = _local_loss_fn(config, grid, attn, tokens, targets, weights, positions)(leaves)
    grads = torch.autograd.grad(l_local, tree.leaves(leaves))
    return _psum(l_local.detach(), grid), grads


class _FlatPlan:
    """Static flatten/unflatten plan for the LM parameter tree, in
    ``utils.tree.leaves`` order (``jax.flatten_util.ravel_pytree``'s)."""

    def __init__(self, template):
        self.like = template
        self.shapes = [tuple(t.shape) for t in tree.leaves(template)]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total = sum(self.sizes)

    @staticmethod
    def flatten(t) -> torch.Tensor:
        return torch.cat([x.reshape(-1) for x in tree.leaves(t)])

    def unflatten(self, flat: torch.Tensor):
        """A tree of views of ``flat[:total]``."""
        parts = flat[: self.total].split(self.sizes)
        return tree.unflatten(self.like, [x.view(s) for x, s in zip(parts, self.shapes)])


def _step_body(config: SeqConfig, grid: Grid, positions: torch.Tensor,
               plan: _FlatPlan) -> Callable:
    """One train step: ``(params, opt_state, tokens, targets, weights) ->
    (params', opt_state', loss)`` — local gradients, ONE all-reduce of the
    flat gradient over ``(dp, sp)`` (full gradients for the replicated
    leaves, shard-full ones for the tp-sharded leaves), then TF1 Adam over
    the tree (the moments placed like the parameters). The policy's casts
    bracket the sum (at a world of one too, as JAX's psum over an axis of
    one keeps them)."""
    attn = _attn_for(config, grid)
    pol = config.policy()

    def step(params, opt_state: AdamState, tokens, targets, weights):
        loss, grads = _local_grads(config, grid, attn, positions, params, tokens, targets,
                                   weights)
        grads = pol.cast_grads(tree.unflatten(params, grads))
        if grid.data_group is not LOCAL:
            grads = plan.unflatten(_psum(_FlatPlan.flatten(grads), grid))
        grads = pol.upcast_grads(grads)
        with torch.no_grad():
            params, opt_state = adam_update(params, opt_state, grads, lr=config.learning_rate)
        return params, opt_state, loss

    return step


def _zero1_flat(grid: Grid, flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """This rank's reduced chunk ``data_index`` of the flat gradient: ONE
    reduce-scatter over ``(dp, sp)``, which both sums the partials and
    lands the chunk (JAX's psum_scatter over the combined axes)."""
    if grid.data_group is LOCAL:
        return coll.pad_to(flat, chunk)
    return coll.reduce_scatter_flat(flat, grid.world, mean=False, chunk=chunk,
                                    group=grid.data_group)


def _zero1_gather(grid: Grid, p_new: torch.Tensor) -> torch.Tensor:
    """Every ``(dp, sp)`` rank's updated chunk, in chunk order."""
    if grid.data_group is LOCAL:
        return p_new
    return coll.all_gather_flat(p_new, grid.world, group=grid.data_group)


def _zero1_step_body(config: SeqConfig, grid: Grid, positions: torch.Tensor,
                     plan: _FlatPlan) -> Callable:
    """One ZeRO-1 step: local gradients, the flat gradient reduce-scattered
    over ``(dp, sp)`` (:func:`_zero1_flat`), the plain flat Adam chain on
    this rank's chunk ``dp_index * num_workers + sp_index``, and an
    all-gather of the updated chunks. Under ``precision="bf16"`` the flat
    gradient is cast before the reduce-scatter and this rank's chunk
    upcast after it."""
    attn = _attn_for(config, grid)
    pol = config.policy()
    n_dev = config.data_parallel * config.num_workers
    chunk = coll.chunk_size(plan.total, n_dev)
    mine = slice(grid.data_index * chunk, (grid.data_index + 1) * chunk)

    def step(params, opt: ShardedAdam, tokens, targets, weights):
        loss, grads = _local_grads(config, grid, attn, positions, params, tokens, targets,
                                   weights)
        g_own = pol.upcast_grads(_zero1_flat(grid, _FlatPlan.flatten(pol.cast_grads(grads)),
                                             chunk))
        with torch.no_grad():
            p_own = coll.pad_to(_FlatPlan.flatten(params), chunk * n_dev)[mine]
            p_new, opt = _adam_flat(p_own, opt, g_own, lr=config.learning_rate)
            full = _zero1_gather(grid, p_new)
        return plan.unflatten(full), opt, loss

    return step


@dataclasses.dataclass
class HybridAdam:
    """Optimizer state of ZeRO-1 x tensor parallelism (JAX's
    ``HybridAdam``): the tp-REPLICATED leaves (embed, head, the LayerNorms,
    ``b2``) flattened into this rank's chunk ``m_flat``/``v_flat`` of the
    ``(dp, sp)``-sharded flat moments (the same on every tp peer), and the
    tp-SHARDED leaves' moments ``m_tp``/``v_tp`` as lists shaped like this
    rank's shards. One shared ``step`` drives both parts' bias
    correction."""

    step: torch.Tensor  # int32 scalar on the device
    m_flat: torch.Tensor
    v_flat: torch.Tensor
    m_tp: list
    v_tp: list


class _HybridPlan:
    """Leaf-aligned split of the (local) LM tree for the hybrid: the
    tp-sharded leaves (a split dimension in ``specs``) keep their shapes,
    the replicated rest gets a :class:`_FlatPlan` in ``utils.tree.leaves``
    order (JAX's ``jax.tree.leaves`` order)."""

    def __init__(self, template, specs):
        self.like = template
        self.tp_mask = tuple(s is not None for s in tree.leaves(specs))
        if len(self.tp_mask) != len(tree.leaves(template)):
            raise ValueError("spec and parameter trees differ")
        self._rep = _FlatPlan(self.split(tree.leaves(template))[0])
        self.rep_total = self._rep.total

    def split(self, leaves) -> tuple[list, list]:
        """A tree's leaves -> (replicated leaves, tp-sharded leaves)."""
        rep = [x for x, m in zip(leaves, self.tp_mask) if not m]
        tp = [x for x, m in zip(leaves, self.tp_mask) if m]
        return rep, tp

    def merge(self, rep: list, tp: list):
        """Inverse of :meth:`split`: the tree."""
        rep_it, tp_it = iter(rep), iter(tp)
        return tree.unflatten(self.like, [next(tp_it) if m else next(rep_it)
                                          for m in self.tp_mask])

    flatten_rep = staticmethod(_FlatPlan.flatten)

    def unflatten_rep(self, flat: torch.Tensor) -> list:
        return self._rep.unflatten(flat)


def _zero1_tp_step_body(config: SeqConfig, grid: Grid, positions: torch.Tensor,
                        hplan: _HybridPlan) -> Callable:
    """One hybrid ZeRO-1 x tp step: local gradients (``(dp, sp)``-partial,
    tp-complete), then for the REPLICATED leaves the ZeRO-1 path over
    ``(dp, sp)`` (one reduce-scatter of their flat gradient, the plain flat
    Adam chain on this rank's chunk ``dp_index * num_workers + sp_index``,
    as JAX's ``_adam_flat``, one all-gather; tp peers compute the same
    chunk), and for the tp-SHARDED leaves an all-reduce over ``(dp, sp)``
    per leaf, then tree Adam on the shard with the shared step. Under
    ``precision="bf16"`` both subtrees' sums move bf16 and upcast at their
    Adam boundary."""
    attn = _attn_for(config, grid)
    pol = config.policy()
    n_dev = config.data_parallel * config.num_workers
    chunk = coll.chunk_size(hplan.rep_total, n_dev)
    mine = slice(grid.data_index * chunk, (grid.data_index + 1) * chunk)

    def step(params, opt: HybridAdam, tokens, targets, weights):
        loss, grads = _local_grads(config, grid, attn, positions, params, tokens, targets,
                                   weights)
        g_rep, g_tp = hplan.split(pol.cast_grads(grads))
        g_own = pol.upcast_grads(_zero1_flat(grid, hplan.flatten_rep(g_rep), chunk))
        g_tp = [pol.upcast_grads(_psum(g, grid)) for g in g_tp]
        with torch.no_grad():
            p_rep, p_tp = hplan.split(tree.leaves(params))
            p_own = coll.pad_to(hplan.flatten_rep(p_rep), chunk * n_dev)[mine]
            p_new, flat = _adam_flat(p_own, ShardedAdam(step=opt.step, m=opt.m_flat,
                                                        v=opt.v_flat),
                                     g_own, lr=config.learning_rate)
            rep_new = hplan.unflatten_rep(_zero1_gather(grid, p_new))
            tp_new, tp_state = adam_update(p_tp, AdamState(step=opt.step, m=opt.m_tp,
                                                           v=opt.v_tp),
                                           g_tp, lr=config.learning_rate)
        new_opt = HybridAdam(step=flat.step, m_flat=flat.m, v_flat=flat.v, m_tp=tp_state.m,
                             v_tp=tp_state.v)
        return hplan.merge(rep_new, tp_new), new_opt, loss

    return step


def _clone_state(state):
    """A copy of an optimizer state (any of the three kinds) whose tensors
    the step may replace without touching the original."""
    return dataclasses.replace(state, **{
        f.name: tree.map(torch.clone, getattr(state, f.name))
        for f in dataclasses.fields(state)})


class SeqTrainer:
    """LM trainer over the ``[data_parallel, num_workers, tensor_parallel,
    pipeline_parallel]`` grid of ``world`` (``init_world``; its device is
    the trainer's), or, without a world, on one device (``cuda`` unless
    ``device="cpu"``) with every degree 1. ``init`` is the full numpy
    parameter tree in the JAX layout (e.g. a JAX init); without it, a
    glorot init from ``config.seed``, the same on every rank. Each rank
    holds its stage (all layers at pp 1) of its tp shard of the parameters
    (all of them at tp 1) and Adam moments placed likewise; with ``zero1``
    this rank's flat chunk (at tp > 1 the hybrid, :class:`HybridAdam`).
    At pp > 1, ``pipeline_record`` gathers the steps' saved-input peak and
    hop bytes."""

    def __init__(
        self,
        config: SeqConfig,
        dataset: LMDataset,
        init: dict | None = None,
        device: str | torch.device | None = None,
        world: World | None = None,
    ):
        check_config(config, dataset)
        if world is not None and device is not None:
            raise ValueError("pass device or world, not both (a world has its device)")
        self.config = config
        self.dataset = dataset
        tp, pp = config.tensor_parallel, config.pipeline_parallel
        self.grid = make_grid(world, config.data_parallel, config.num_workers, tp, pp)
        self.device = world.device if world is not None else default_device(device)
        self._specs = partition.lm_param_specs(partition.stage_spec(config.spec, pp), tp)
        if init is None:
            # The full tree from the seed, then this rank's slice of it.
            init = lm_params_to_numpy(transformer.init_lm_params(
                torch.Generator().manual_seed(config.seed), config.spec))
        self.params = lm_params_from_numpy(init, config.spec, self.device, tensor_parallel=tp,
                                           tp_index=self.grid.tp_index, pipeline_parallel=pp,
                                           pp_index=self.grid.pp_index)
        self.pipeline_record = PipelineRecord() if pp > 1 else None
        self._plan = _FlatPlan(self.params)
        self._hplan = _HybridPlan(self.params, self._specs) if config.zero1 and tp > 1 else None
        if self._hplan is not None:
            chunk = coll.chunk_size(self._hplan.rep_total,
                                    config.data_parallel * config.num_workers)
            _, tp_leaves = self._hplan.split(tree.leaves(self.params))
            self.opt_state = HybridAdam(
                step=torch.zeros((), dtype=torch.int32, device=self.device),
                m_flat=torch.zeros(chunk, device=self.device),
                v_flat=torch.zeros(chunk, device=self.device),
                m_tp=[torch.zeros_like(x) for x in tp_leaves],
                v_tp=[torch.zeros_like(x) for x in tp_leaves],
            )
        elif config.zero1:
            chunk = coll.chunk_size(self._plan.total, config.data_parallel * config.num_workers)
            zeros = lambda: torch.zeros(chunk, device=self.device)  # noqa: E731
            self.opt_state = ShardedAdam(
                step=torch.zeros((), dtype=torch.int32, device=self.device), m=zeros(), v=zeros()
            )
        else:
            self.opt_state = adam_init(self.params)
        # Zigzag: one staging-time gather re-orders the sequence so that
        # contiguous sp sharding lands chunk pair (i, 2W-1-i) on rank i.
        self._perm = (ring.zigzag_permutation(config.num_workers, dataset.seq_len)
                      if config.seq_layout == "zigzag" else None)
        t_local = dataset.seq_len // config.num_workers
        self.positions = _shard_positions(config, t_local, self.grid, self.device)
        self._attn = _attn_for(config, self.grid)

    def step_fn(self) -> Callable:
        """This config's train step, ``(params, opt, tokens, targets,
        weights) -> (params', opt', loss)`` on this rank's blocks."""
        if self.config.pipeline_parallel > 1:
            return pipeline_trainer.pipeline_step(self.config, self.grid, self.positions,
                                                  self.pipeline_record)
        if self._hplan is not None:
            return _zero1_tp_step_body(self.config, self.grid, self.positions, self._hplan)
        if self.config.zero1:
            return _zero1_step_body(self.config, self.grid, self.positions, self._plan)
        return _step_body(self.config, self.grid, self.positions, self._plan)

    def _permuted(self, arr: np.ndarray) -> np.ndarray:
        """The layout's sequence permutation (identity when contiguous):
        tokens, targets and weights move together."""
        return arr if self._perm is None else arr[:, self._perm]

    def _local(self, arr: np.ndarray, rows: bool) -> torch.Tensor:
        """This rank's block of ``arr [..., B, T]`` on the device: its sp
        column's ``T/W`` positions and, with ``rows``, its dp row's ``B/dp``
        sequences (token ids as int64). tp peers get the same block."""
        g, cfg = self.grid, self.config
        t = arr.shape[-1] // cfg.num_workers
        block = arr[..., g.sp_index * t:(g.sp_index + 1) * t]
        if rows:
            b = arr.shape[-2] // cfg.data_parallel
            block = block[..., g.dp_index * b:(g.dp_index + 1) * b, :]
        out = torch.as_tensor(np.ascontiguousarray(block))
        return (out.long() if not out.is_floating_point() else out).to(self.device)

    def stage_batches(self, arr: np.ndarray, batches: int, bs: int) -> torch.Tensor:
        """``batches`` x ``bs`` rows of ``arr`` as this rank's ``[nb, B/dp,
        T/W]`` blocks on the device."""
        shaped = self._permuted(np.asarray(arr[: batches * bs])).reshape(
            batches, bs, arr.shape[1])
        return self._local(shaped, rows=True)

    def stage_test(self, arr: np.ndarray) -> torch.Tensor:
        """The whole test set's sp column ``[n, T/W]`` (replicated over
        dp)."""
        return self._local(self._permuted(np.asarray(arr)), rows=False)

    def span_program(self, k: int) -> Callable:
        """``(params, opt, xs, ys, ws, first) -> (params, opt, last_loss)``:
        ``k`` consecutive steps over the staged batches ``first ..
        first + k - 1``."""
        step = self.step_fn()

        def run(params, opt_state, xs, ys, ws, first: int):
            loss = None
            for i in range(first, first + k):
                params, opt_state, loss = step(params, opt_state, xs[i], ys[i], ws[i])
            return params, opt_state, loss

        return run

    @torch.no_grad()
    def evaluate(self, params, tokens, targets, weights) -> float:
        """Weighted next-token accuracy over the test set (``_shard_sums``,
        or the pipeline's eval at pp > 1): the global ``(hits, weight)``
        sums reach the host in one fetch."""
        if self.config.pipeline_parallel > 1:
            sums = make_pipeline_eval_body(self.config, self.grid, self.positions)
        else:
            sums = _shard_sums(self.config, self.grid, self._attn, self.positions,
                               transformer.lm_correct_sums)
        num, den = sums(params, tokens, targets, weights)
        return float(num / den)

    def _warm_up(self, params, opt_state, xs, ys, ws) -> None:
        """Outside the clock (where the JAX trainer compiles): one discarded
        train step of this config on the first batch, which builds the
        flash kernels (flash on CUDA), loads cuBLAS and PyTorch's kernels,
        sets up the process group's communicators and sizes the allocator.
        It launches each flash kernel once per layer (under a pipeline, as
        a step does: per microbatch and stage layer). The step is
        functional: ``params`` and ``opt_state`` are not changed."""
        self.step_fn()(params, opt_state, xs[0], ys[0], ws[0])
        barrier(self.device)

    def full_params(self, params) -> dict:
        """The full numpy tree of this rank's ``params`` in the standard
        form (JAX's global arrays, ``_result_params``): at tp > 1 every tp
        shard, gathered over the tp group in one all-gather of the
        flattened shard; at pp > 1 then every stage, gathered over the pp
        group likewise."""
        g = self.grid
        if g.tp_group is LOCAL:
            stage = lm_params_to_numpy(params)
        else:
            flats = coll.all_gather_list(_FlatPlan.flatten(params), g.tp_group)
            shards = [lm_params_to_numpy(self._plan.unflatten(f)) for f in flats]
            stage = partition.gather_lm_params(shards, self._specs)
        if g.pipeline_parallel == 1:
            return stage
        plan = _FlatPlan(tree.map(torch.from_numpy, stage))
        flat = _FlatPlan.flatten(plan.like).to(self.device)
        stages = [lm_params_to_numpy(plan.unflatten(f)) for f in
                  coll.all_gather_list(flat, g.pp_group)]
        return partition.gather_stage_params(stages)

    def train(self, log: Callable[[str], None] = print) -> LMResult:
        cfg, ds, dev = self.config, self.dataset, self.device
        bs = cfg.batch_size
        batch_num = ds.num_train // bs
        xs = self.stage_batches(ds.tokens, batch_num, bs)
        ys = self.stage_batches(ds.targets, batch_num, bs)
        ws = self.stage_batches(ds.weights, batch_num, bs)
        xte, yte, wte = (self.stage_test(a)
                         for a in (ds.test_tokens, ds.test_targets, ds.test_weights))
        params = tree.map(torch.clone, self.params)
        opt_state = _clone_state(self.opt_state)
        spans = eval_spans(batch_num, cfg.eval_every)
        fns = {k: self.span_program(k) for k in {k for _, k, _ in spans}}
        t0 = time.perf_counter()
        self._warm_up(params, opt_state, xs, ys, ws)
        warmup = time.perf_counter() - t0

        timer = StepTimer()
        history: list[tuple[int, int, float]] = []
        span_losses: list[float] = []
        accuracy = loss = float("nan")
        tokens_per_batch = bs * ds.seq_len
        hit = False
        epoch = 0  # epochs=0: eval-only run
        start = time.perf_counter()
        for epoch in range(cfg.epochs):
            for first, k, eval_after in spans:
                with timer.step(images=k * tokens_per_batch):
                    params, opt_state, l_dev = fns[k](params, opt_state, xs, ys, ws, first)
                    barrier(dev)
                loss = float(l_dev)
                span_losses.append(loss)
                if eval_after:
                    accuracy = self.evaluate(params, xte, yte, wte)
                    history.append((epoch, first + k - 1, accuracy))
                    log(f"epoch {epoch} batch {first + k - 1} "
                        f"loss {loss:.4f} test_accuracy {accuracy:.4f}")
                    hit = hit_target(cfg, accuracy)
                if hit:
                    break
            if hit:
                log(f"target accuracy {cfg.target_accuracy} reached")
                break
        wall = time.perf_counter() - start
        if not (history and history[-1][:2] == (epoch, batch_num - 1)) and not hit:
            accuracy = self.evaluate(params, xte, yte, wte)
            history.append((epoch, batch_num - 1, accuracy))
        stats = timer.stats()
        log(f"final test_accuracy {accuracy:.4f} loss {loss:.4f} "
            f"({stats.tokens_per_sec:.0f} tokens/s)")
        self.params, self.opt_state = params, opt_state
        return LMResult(
            params=self.full_params(params),
            final_accuracy=accuracy,
            final_loss=loss,
            wall_time_s=wall,
            train_time_s=stats.total_s,
            history=history,
            tokens_per_sec=stats.tokens_per_sec,
            compile_time_s=warmup,
            step_stats=stats,
            span_losses=span_losses,
        )
