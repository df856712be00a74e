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

Phases: the three step bodies open ``obs.trace.STEP_PHASES`` in order with
``obs.trace.phase``: the forward, the backward, ``grad_sync`` (the casts
and the ``(dp, sp)`` sum or reduce-scatter), the optimizer (Adam, and
ZeRO-1's all-gather) and the health work. Each is a ``torch.profiler``
range while a session records, a shared null context otherwise; the
pipeline's step opens none.

``SeqConfig`` keeps every JAX field and default, and the JAX trainer's own
checks raise the same ``ValueError``s (:func:`check_config`).

Resilience (JAX's ``SeqTrainer.train`` hooks): checkpoints hold the standard
per-layer params-shaped form of the parameters and Adam moments whatever
the dp, sp, tp or pp (:meth:`SeqTrainer._opt_for_save`), so a save at one
topology resumes at any other, and in the JAX package; resume, preemption,
the dispatch watchdog, and the non-finite guard in every step body (the
replicated all-reduce, ZeRO-1, the hybrid and the pipeline's) with rollback
to the last good checkpoint. The LM has no RNG and its flash kernels are
bit-equal on a repeat, so a resumed or rolled-back run is bitwise the
uninterrupted one. With the guard off every step body does exactly its
unguarded work.
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
from ..convert import (
    lm_hybrid_adam_from_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_pipeline_adam_from_numpy,
    lm_sharded_adam_from_numpy,
    lm_zeros_numpy,
)
from ..data.lm import LMDataset
from ..models import partition, transformer
from ..obs import health as hlt
from ..obs.health import HEALTH_FULL, HEALTH_OFF, flat_grad_sq_nonfinite, nonfinite_count
from ..obs.trace import phase
from ..models.transformer import LMSpec
from ..ops import flash_attention
from ..ops.optimizers import AdamState, ShardedAdam, adam_init, adam_update
from ..parallel import collectives as coll
from ..parallel import ring
from ..parallel.mesh import DP_AXIS, LOCAL, SP_AXIS, Grid, World, default_device, make_grid
from ..parallel.multihost import local_slice
from ..pipeline import trainer as pipeline_trainer
from ..pipeline.schedule import SCHEDULES
from ..pipeline.step import PipelineRecord, make_pipeline_eval_body
from ..train.trainer import (
    CHECKPOINT_KEEP,
    SpanMetrics,
    attributed,
    check_detector,
    check_preempt,
    checkpoint_file,
    eval_spans,
    guarded,
    hit_target,
    resume_plan,
    save_crossed,
    span_health,
    try_resume,
)
from ..utils import tree
from ..utils.checkpoint import save_checkpoint_world
from ..utils.metrics import StepStats, StepTimer, barrier, trace
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
    """The JAX ``LMResult``, plus the span losses."""

    params: dict  # numpy tree, JAX layout
    final_accuracy: float  # weighted next-token accuracy on the test set
    final_loss: float
    wall_time_s: float
    train_time_s: float  # span time only; evals and warm-up excluded
    history: list[tuple[int, int, float]]  # (epoch, batch, accuracy)
    tokens_per_sec: float  # scored + unscored tokens (B * T) / train_time_s
    compile_time_s: float = 0.0  # warm-up before the clock, kernel build included
    step_stats: StepStats | None = None
    resumed_from_step: int = 0  # global batch restored from a checkpoint
    preempted: bool = False  # stopped early by should_stop (e.g. SIGTERM)
    skipped_steps: int = 0  # updates skipped by the non-finite guard
    rollbacks: int = 0  # guard escalations to the last good checkpoint
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
        coll.note("all-reduce", t, LOCAL)
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
    with phase("step/forward"):
        leaves = tree.map(lambda t: t.detach().requires_grad_(True), params)
        l_local = _local_loss_fn(config, grid, attn, tokens, targets, weights,
                                 positions)(leaves)
    with phase("step/backward"):
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


def guard_groups(params, specs, grid: Grid) -> list[tuple]:
    """For each leaf of the parameter tree ``params`` (``utils.tree.leaves``
    order), the groups its non-finite gradient count sums over, as its
    partition spec names them (JAX's ``obs.health`` per-spec psums): the
    tp group for a tp-sharded leaf, and under a pipeline the pp group for
    the stage's blocks. ``specs`` is ``partition.lm_param_specs`` of this
    rank's stage (None at tp 1)."""
    pp = (grid.pp_group,) if grid.pipeline_parallel > 1 else ()
    out = []
    for key in sorted(params):
        n = len(tree.leaves(params[key]))
        for s in (tree.leaves(specs[key]) if specs is not None else [None] * n):
            out.append((pp if key == "blocks" else ()) + ((grid.tp_group,) if s is not None
                                                          else ()))
    return out


def _step_body(config: SeqConfig, grid: Grid, positions: torch.Tensor,
               plan: _FlatPlan, guard: bool = False, specs=None) -> Callable:
    """One train step: ``(params, opt_state, tokens, targets, weights) ->
    (params', opt_state', loss)`` — local gradients, ONE all-reduce of the
    flat gradient over ``(dp, sp)`` (full gradients for the replicated
    leaves, shard-full ones for the tp-sharded leaves), then TF1 Adam over
    the tree (the moments placed like the parameters). The policy's casts
    bracket the sum (at a world of one too, as JAX's psum over an axis of
    one keeps them). ``guard=True`` selects the old state on a non-finite
    gradient and returns the skip flag last; a ``health`` level
    (``obs.health``) returns the health dict after the loss, each leaf's
    sums over the groups its partition ``specs`` name."""
    attn = _attn_for(config, grid)
    pol = config.policy()
    groups = guard_groups(plan.like, specs, grid)

    def step(params, opt_state: AdamState, tokens, targets, weights, health=HEALTH_OFF):
        loss, grads = _local_grads(config, grid, attn, positions, params, tokens, targets,
                                   weights)
        with phase("step/grad_sync"):
            grads = pol.cast_grads(tree.unflatten(params, grads))
            if grid.data_group is not LOCAL:
                grads = plan.unflatten(_psum(_FlatPlan.flatten(grads), grid))
            else:
                coll.note("all-reduce", None, LOCAL,
                          nbytes=plan.total * tree.leaves(grads)[0].element_size())
            grads = pol.upcast_grads(grads)
        with phase("step/optimizer"), torch.no_grad():
            new_params, new_opt = adam_update(params, opt_state, grads,
                                              lr=config.learning_rate)
        with phase("step/health"):
            return hlt.finish_step(
                guard, health, lambda: nonfinite_count(grads, groups),
                lambda new, nf: hlt.health_signals(grads, params, new, groups, nf),
                params, opt_state, new_params, new_opt, loss)

    return step


def _zero1_flat(grid: Grid, flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """This rank's reduced chunk ``data_index`` of the flat gradient: ONE
    reduce-scatter over ``(dp, sp)``, which both sums the partials and
    lands the chunk (JAX's psum_scatter over the combined axes)."""
    if grid.data_group is LOCAL:
        coll.note("reduce-scatter", None, LOCAL, nbytes=chunk * flat.element_size())
        return coll.pad_to(flat, chunk)
    return coll.reduce_scatter_flat(flat, grid.world, mean=False, chunk=chunk,
                                    group=grid.data_group)


def _zero1_gather(grid: Grid, p_new: torch.Tensor) -> torch.Tensor:
    """Every ``(dp, sp)`` rank's updated chunk, in chunk order."""
    if grid.data_group is LOCAL:
        coll.note("all-gather", p_new, LOCAL)
        return p_new
    return coll.all_gather_flat(p_new, grid.world, group=grid.data_group)


def _zero1_step_body(config: SeqConfig, grid: Grid, positions: torch.Tensor,
                     plan: _FlatPlan, guard: bool = False) -> Callable:
    """One ZeRO-1 step: local gradients, the flat gradient reduce-scattered
    over ``(dp, sp)`` (:func:`_zero1_flat`), the plain flat Adam chain on
    this rank's chunk ``dp_index * num_workers + sp_index``, and an
    all-gather of the updated chunks. Under ``precision="bf16"`` the flat
    gradient is cast before the reduce-scatter and this rank's chunk
    upcast after it. ``guard=True`` counts the non-finite elements of the
    flat chunks (disjoint over ``(dp, sp)``: one sum is the global count)
    and returns the skip flag last; a ``health`` level takes the grad norm
    from the chunks likewise and the param and update norms from the full
    (replicated) trees."""
    attn = _attn_for(config, grid)
    pol = config.policy()
    n_dev = config.data_parallel * config.num_workers
    chunk = coll.chunk_size(plan.total, n_dev)
    mine = slice(grid.data_index * chunk, (grid.data_index + 1) * chunk)

    def step(params, opt: ShardedAdam, tokens, targets, weights, health=HEALTH_OFF):
        loss, grads = _local_grads(config, grid, attn, positions, params, tokens, targets,
                                   weights)
        with phase("step/grad_sync"):
            g_own = pol.upcast_grads(_zero1_flat(
                grid, _FlatPlan.flatten(pol.cast_grads(grads)), chunk))
        with phase("step/optimizer"), torch.no_grad():
            p_own = coll.pad_to(_FlatPlan.flatten(params), chunk * n_dev)[mine]
            p_new, new_opt = _adam_flat(p_own, opt, g_own, lr=config.learning_rate)
            full = _zero1_gather(grid, p_new)

        def signals(new, _nf):
            sq, count = flat_grad_sq_nonfinite(g_own, grid.data_group)
            return {"grad_norm": sq.sqrt(), "nonfinite_grads": count,
                    **hlt.norm_signals(params, new)}

        with phase("step/health"):
            return hlt.finish_step(
                guard, health, lambda: flat_grad_sq_nonfinite(g_own, grid.data_group)[1],
                signals, params, opt, plan.unflatten(full), new_opt, loss)

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
                        hplan: _HybridPlan, specs, guard: bool = False) -> Callable:
    """One hybrid ZeRO-1 x tp step: local gradients (``(dp, sp)``-partial,
    tp-complete), then for the REPLICATED leaves the ZeRO-1 path over
    ``(dp, sp)`` (one reduce-scatter of their flat gradient, the plain flat
    Adam chain on this rank's chunk ``dp_index * num_workers + sp_index``,
    as JAX's ``_adam_flat``, one all-gather; tp peers compute the same
    chunk), and for the tp-SHARDED leaves an all-reduce over ``(dp, sp)``
    per leaf, then tree Adam on the shard with the shared step. Under
    ``precision="bf16"`` both subtrees' sums move bf16 and upcast at their
    Adam boundary. ``guard=True`` counts the flat chunks' non-finite
    elements over ``(dp, sp)`` plus the tp shards' over tp, and returns the
    skip flag last; a ``health`` level sums the squares likewise, and the
    param and update norms over each leaf's partition groups."""
    attn = _attn_for(config, grid)
    pol = config.policy()
    n_dev = config.data_parallel * config.num_workers
    chunk = coll.chunk_size(hplan.rep_total, n_dev)
    mine = slice(grid.data_index * chunk, (grid.data_index + 1) * chunk)
    groups = guard_groups(hplan.like, specs, grid)

    def step(params, opt: HybridAdam, tokens, targets, weights, health=HEALTH_OFF):
        loss, grads = _local_grads(config, grid, attn, positions, params, tokens, targets,
                                   weights)
        with phase("step/grad_sync"):
            g_rep, g_tp = hplan.split(pol.cast_grads(grads))
            g_own = pol.upcast_grads(_zero1_flat(grid, hplan.flatten_rep(g_rep), chunk))
            g_tp = [pol.upcast_grads(_psum(g, grid)) for g in g_tp]
        with phase("step/optimizer"), torch.no_grad():
            p_rep, p_tp = hplan.split(tree.leaves(params))
            p_own = coll.pad_to(hplan.flatten_rep(p_rep), chunk * n_dev)[mine]
            p_new, flat = _adam_flat(p_own, ShardedAdam(step=opt.step, m=opt.m_flat,
                                                        v=opt.v_flat),
                                     g_own, lr=config.learning_rate)
            rep_new = hplan.unflatten_rep(_zero1_gather(grid, p_new))
            tp_new, tp_state = adam_update(p_tp, AdamState(step=opt.step, m=opt.m_tp,
                                                           v=opt.v_tp),
                                           g_tp, lr=config.learning_rate)
            new_opt = HybridAdam(step=flat.step, m_flat=flat.m, v_flat=flat.v,
                                 m_tp=tp_state.m, v_tp=tp_state.v)

        def nonfinite():
            _, nf = flat_grad_sq_nonfinite(g_own, grid.data_group)
            return nf + nonfinite_count(g_tp, [(grid.tp_group,)] * len(g_tp))

        def signals(new, nf):
            sq, _ = flat_grad_sq_nonfinite(g_own, grid.data_group)
            sq = sq + hlt.sq_sum(g_tp, (grid.tp_group,))
            return {"grad_norm": sq.sqrt(),
                    "nonfinite_grads": nf if nf is not None else nonfinite(),
                    **hlt.norm_signals(params, new, groups)}

        with phase("step/health"):
            return hlt.finish_step(guard, health, nonfinite, signals, params, opt,
                                   hplan.merge(rep_new, tp_new), new_opt, loss)

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

    def step_fn(self, guard: bool = False) -> Callable:
        """This config's train step, ``(params, opt, tokens, targets,
        weights[, health]) -> (params', opt', loss[, health dict][,
        skipped])`` on this rank's blocks; ``guard=True`` is the non-finite
        guarded step, ``health`` a level of ``obs.health``."""
        if self.config.pipeline_parallel > 1:
            return pipeline_trainer.pipeline_step(
                self.config, self.grid, self.positions, self.pipeline_record,
                groups=guard_groups(self.params, self._specs, self.grid), guard=guard)
        if self._hplan is not None:
            return _zero1_tp_step_body(self.config, self.grid, self.positions, self._hplan,
                                       self._specs, guard=guard)
        if self.config.zero1:
            return _zero1_step_body(self.config, self.grid, self.positions, self._plan,
                                    guard=guard)
        return _step_body(self.config, self.grid, self.positions, self._plan, guard=guard,
                          specs=self._specs)

    def _permuted(self, arr: np.ndarray) -> np.ndarray:
        """The layout's sequence permutation (identity when contiguous):
        tokens, targets and weights move together."""
        return arr if self._perm is None else arr[:, self._perm]

    def _local(self, arr: np.ndarray, rows: bool) -> torch.Tensor:
        """This rank's block of ``arr [..., B, T]`` on the device: its sp
        column's ``T/W`` positions and, with ``rows``, its dp row's ``B/dp``
        sequences (token ids as int64). tp peers get the same block."""
        g, cfg = self.grid, self.config
        block = local_slice(arr, arr.ndim - 1, cfg.num_workers, [g.sp_index])
        if rows:
            block = local_slice(block, arr.ndim - 2, cfg.data_parallel, [g.dp_index])
        out = torch.as_tensor(block)
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

    def span_program(self, k: int, guard: bool = False) -> Callable:
        """``(params, opt, xs, ys, ws, first[, health]) -> (params, opt,
        last_loss[, healths][, skipped])``: ``k`` consecutive steps over
        the staged batches ``first .. first + k - 1``; at a ``health``
        level (``train.trainer.span_health``) the steps' health dicts come
        back as a list; guarded, the steps' skip flags come back stacked,
        ``[k]`` int32 on the device."""
        step = self.step_fn(guard)

        def run(params, opt_state, xs, ys, ws, first: int, health: int = HEALTH_OFF):
            loss, flags, hs = None, [], []
            for i in range(k):
                lvl = span_health(health, i, k)
                j = first + i
                out = (step(params, opt_state, xs[j], ys[j], ws[j], health=lvl) if lvl
                       else step(params, opt_state, xs[j], ys[j], ws[j]))
                params, opt_state, loss = out[:3]
                if lvl:
                    hs.append(out[3])
                flags.extend(out[3 + bool(lvl):])
            return ((params, opt_state, loss) + ((hs,) if hs else ())
                    + ((torch.stack(flags),) if flags else ()))

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

    def _warm_up(self, params, opt_state, xs, ys, ws, guard: bool = False,
                 health: int = HEALTH_OFF) -> None:
        """Outside the clock (where the JAX trainer compiles): one discarded
        train step of this config on the first batch, which builds the
        flash kernels (flash on CUDA), loads cuBLAS and PyTorch's kernels,
        sets up the process group's communicators and sizes the allocator.
        It launches each flash kernel once per layer (under a pipeline, as
        a step does: per microbatch and stage layer). The step is
        functional: ``params`` and ``opt_state`` are not changed. Under
        telemetry (``health`` a level) it is the step the spans run, guard
        (``guard``) and health included, so the collective tally of its
        call is the span program's ledger (``obs.comms``)."""
        step = self.step_fn(guard)
        if health:
            step(params, opt_state, xs[0], ys[0], ws[0], health=health)
        else:
            step(params, opt_state, xs[0], ys[0], ws[0])
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

    # -- checkpoint form: params-shaped m/v in every mode ---------------------

    def _opt_like(self) -> AdamState:
        """Template of the checkpointed optimizer state: Adam ``m``/``v`` as
        params-shaped trees in every mode (the STANDARD per-layer form), so
        a save of a ZeRO-1, hybrid or pipeline run resumes a replicated run,
        and the other way round, at any topology."""
        return AdamState(step=np.zeros((), np.int32), m=lm_zeros_numpy(self.config.spec),
                         v=lm_zeros_numpy(self.config.spec))

    def checkpoint_like(self) -> dict:
        """Template of the whole checkpoint: ``{"params", "opt"}``."""
        return {"params": lm_zeros_numpy(self.config.spec), "opt": self._opt_like()}

    def _params_for_save(self, params) -> dict:
        """Live params -> the checkpoint's standard host form: every tp
        shard and pp stage gathered (:meth:`full_params`, a collective)."""
        return self.full_params(params)

    def _place_params(self, host_tree) -> dict:
        """Standard-form params -> this rank's placement (its tp shard of
        its pp stage), fresh tensors."""
        g = self.grid
        return lm_params_from_numpy(host_tree, self.config.spec, self.device,
                                    tensor_parallel=g.tensor_parallel, tp_index=g.tp_index,
                                    pipeline_parallel=g.pipeline_parallel,
                                    pp_index=g.pp_index)

    def _opt_for_save(self, opt_state) -> AdamState:
        """The live optimizer state -> the checkpoint form: the ZeRO-1 flat
        chunks all-gathered over ``(dp, sp)`` and unflattened (the hybrid's
        merged with its tp shards), then, like the params, every tp shard
        and pp stage gathered (a collective: every rank calls it)."""
        def full(part):
            if self._hplan is not None:
                flat = _zero1_gather(self.grid, getattr(opt_state, f"{part}_flat"))
                local = self._hplan.merge(self._hplan.unflatten_rep(flat),
                                          getattr(opt_state, f"{part}_tp"))
            elif self.config.zero1:
                local = self._plan.unflatten(_zero1_gather(self.grid, getattr(opt_state, part)))
            else:
                local = getattr(opt_state, part)
            return self.full_params(local)

        return AdamState(step=np.asarray(int(opt_state.step), np.int32), m=full("m"),
                         v=full("v"))

    def _place_opt(self, opt_tree):
        """A checkpoint-form optimizer state -> this rank's mode: tree Adam
        placed like the params, this rank's ZeRO-1 chunk, or the hybrid
        split (``convert``'s forms), fresh tensors."""
        cfg, g = self.config, self.grid
        step, m, v = opt_tree.step, opt_tree.m, opt_tree.v
        n_dev = cfg.data_parallel * cfg.num_workers
        if self._hplan is not None:
            return lm_hybrid_adam_from_numpy(step, m, v, cfg.spec, g.rank,
                                             tensor_parallel=cfg.tensor_parallel,
                                             data_ranks=n_dev, device=self.device)
        if cfg.zero1:
            return lm_sharded_adam_from_numpy(step, m, v, cfg.spec, g.data_index, n_dev,
                                              self.device)
        return lm_pipeline_adam_from_numpy(step, m, v, cfg.spec,
                                           pipeline_parallel=g.pipeline_parallel,
                                           pp_index=g.pp_index,
                                           tensor_parallel=g.tensor_parallel,
                                           tp_index=g.tp_index, device=self.device)

    def train(
        self,
        log: Callable[[str], None] = print,
        *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume=False,
        profile_dir: str | None = None,
        should_stop: Callable[[], bool] | None = None,
        dispatch_timeout: float = 0.0,
        metrics=None,
        metrics_interval: int = 10,
        metrics_writer=None,
        tracer=None,
        guard: bool = False,
        max_bad_steps: int = 0,
        max_rollbacks: int = 3,
        fault_injector=None,
        checkpoint_keep: int = CHECKPOINT_KEEP,
        peak_flops: float | None = None,
        ici_bw: float | None = None,
        anomaly_detector=None,
    ) -> LMResult:
        """Train ``config.epochs`` epochs with JAX's persistence contract:
        a rolling checkpoint at every epoch end (and every
        ``checkpoint_every`` batches), keeping the last ``checkpoint_keep``
        step-stamped files; ``resume`` (``True``/``"latest"`` loads the
        rolling file, ``"auto"`` the newest VALID save) realigned onto this
        run's span grid; graceful preemption through ``should_stop``; the
        ``dispatch_timeout`` watchdog. ``guard=True`` (implied by
        ``max_bad_steps > 0``) runs the guarded step in every mode: a
        non-finite gradient applies the identity, and ``max_bad_steps``
        consecutive skips roll back to the last good checkpoint and replay
        from its step (the data stream is indexed by step), at most
        ``max_rollbacks`` times. ``fault_injector`` is the deterministic
        chaos hook (``resilience.faults``).

        Telemetry, JAX's: ``metrics`` (an ``obs.MetricRegistry``) turns on
        the health signals of every step body (the non-finite count every
        step, the norms on the last step of spans crossing
        ``metrics_interval`` global steps), ``train_loss``,
        ``train_tokens_per_sec``, ``train_mfu`` over the grid's devices
        against ``peak_flops`` (default: the device's row of ``obs.cost``),
        the comms roofline from the collective ledger against ``ici_bw``,
        the goodput phases, memory watermarks and ``anomaly_detector``
        (same registry). ``tracer`` spans every dispatch and eval;
        ``metrics_writer`` flushes on its own interval; ``profile_dir``
        runs the span loop, after the warm-up, under ``torch.profiler``.
        With ``metrics=None`` every step does exactly its own work."""
        from ..obs.trace import NULL_TRACER

        cfg, ds, dev = self.config, self.dataset, self.device
        tracer = tracer if tracer is not None else NULL_TRACER
        check_detector(metrics, anomaly_detector)
        bs = cfg.batch_size
        batch_num = ds.num_train // bs
        inj = fault_injector
        guard_on = bool(guard) or max_bad_steps > 0
        monitor = None
        if guard_on:
            from ..resilience.guard import GuardMonitor

            monitor = GuardMonitor(max_bad_steps, max_rollbacks=max_rollbacks,
                                   registry=metrics, tracer=tracer)
        world = self.grid.world
        sm = None
        if metrics is not None:
            from ..obs.cost import lm_train_step_flops

            g = self.grid
            sm = SpanMetrics(
                metrics, tracer, device=dev,
                n_dev=g.data_parallel * g.num_workers * g.tensor_parallel
                * g.pipeline_parallel,
                step_flops=lm_train_step_flops(cfg.spec, bs, ds.seq_len, remat=cfg.remat),
                precision=cfg.policy().mfu_kind, items="tokens", interval=metrics_interval,
                writer=metrics_writer, peak_flops=peak_flops, ici_bw=ici_bw,
                anomaly_detector=anomaly_detector, grid=g)

        def stage_ws() -> torch.Tensor:
            # The grad-fault injection point: one non-finite loss weight
            # makes the loss and every gradient non-finite.
            w = ds.weights
            if inj is not None and inj.poisons_data():
                w = inj.poison_batches(np.asarray(w), batch_num, bs)
            return self.stage_batches(w, batch_num, bs)

        with attributed(sm, "staging"):
            xs = self.stage_batches(ds.tokens, batch_num, bs)
            ys = self.stage_batches(ds.targets, batch_num, bs)
            ws = stage_ws()
            xte, yte, wte = (self.stage_test(a)
                             for a in (ds.test_tokens, ds.test_targets, ds.test_weights))
            if sm is not None:
                barrier(dev)
        params = tree.map(torch.clone, self.params)
        opt_state = _clone_state(self.opt_state)
        ckpt = checkpoint_file(checkpoint_dir)
        like = self.checkpoint_like()
        restored, start_step = try_resume(ckpt, resume, like, log)
        if restored is not None:
            params = self._place_params(restored["params"])
            opt_state = self._place_opt(restored["opt"])
        spans = eval_spans(batch_num, cfg.eval_every)
        fns: dict[int, Callable] = {}

        def fn_for(k: int) -> Callable:
            # On demand: a resume or a rollback realigns the spans.
            if k not in fns:
                fns[k] = self.span_program(k, guard=guard_on)
            return fns[k]

        t0 = time.perf_counter()
        if sm is None:
            self._warm_up(params, opt_state, xs, ys, ws)
        else:
            # Under telemetry the warm-up is the spans' own step (guard and
            # health included) and one eval, each tallied for its ledger.
            with coll.tally() as records:
                self._warm_up(params, opt_state, xs, ys, ws, guard_on, HEALTH_FULL)
            _, resume_spans0 = resume_plan(start_step, batch_num, cfg.eval_every, spans)
            sm.compiled("train_span", records, {k for _, k, _ in spans + resume_spans0},
                        t0=t0, t1=time.perf_counter())
        warmup = time.perf_counter() - t0
        eval_warm = [sm is not None]  # the first eval is the eval program's warm-up

        def evaluate(what: str) -> float:
            """The test accuracy under the watchdog; under telemetry, the
            first call (the eval kernels' first launch) is also the eval
            program's "compile", tallied for its ledger and timed, its time
            left to the ``eval`` phase it runs in."""
            fn = lambda: self.evaluate(params, xte, yte, wte)  # noqa: E731
            if not eval_warm[0]:
                return guarded(fn, dispatch_timeout, what)
            eval_warm[0] = False
            te0 = time.perf_counter()
            with coll.tally() as records:
                acc = guarded(fn, dispatch_timeout, what)
            sm.compiled("eval", records, t0=te0, t1=time.perf_counter(), attribute=False)
            return acc

        def rollback() -> int:
            """Guard escalation: restore the newest valid checkpoint at or
            before the streak's first bad step (pruning the abandoned newer
            saves), heal a transient injected fault (restaging clean
            weights), and return the step to re-enter at."""
            nonlocal params, opt_state, ws
            from ..resilience.guard import rollback_state

            rtree, rstep = rollback_state(checkpoint_dir, monitor, like, log, world)
            params = self._place_params(rtree["params"])
            opt_state = self._place_opt(rtree["opt"])
            if inj is not None and inj.heal():
                ws = stage_ws()
            barrier(dev)
            return rstep

        def dispatch(k: int, first: int, health: int):
            args = (params, opt_state, xs, ys, ws, first)
            out = fn_for(k)(*args, health=health) if health else fn_for(k)(*args)
            barrier(dev)
            return out

        timer = StepTimer()
        history: list[tuple[int, int, float]] = []
        span_losses: list[float] = []
        accuracy = loss = float("nan")
        tokens_per_batch = bs * ds.seq_len
        hit = preempted = False
        epoch = 0  # epochs=0: eval-only run
        span_idx = 0
        resumed_from = start_step
        start = time.perf_counter()
        with trace(profile_dir, dev):
            while True:
                rolled = False
                resume_epoch, resume_spans = resume_plan(start_step, batch_num,
                                                         cfg.eval_every, spans)
                for epoch in range(cfg.epochs):
                    for first, k, eval_after in (resume_spans if epoch == resume_epoch
                                                 else spans):
                        gstep = epoch * batch_num + first
                        if gstep < start_step:
                            continue  # already done by the resumed run
                        span_idx += 1
                        lvl = sm.level(gstep, k, first + k == batch_num) if sm else HEALTH_OFF
                        with timer.step(images=k * tokens_per_batch), \
                                tracer.span("train/span", gstep=gstep, k=k):
                            out = guarded(lambda: dispatch(k, first, lvl), dispatch_timeout,
                                          f"span dispatch at global batch {gstep}")
                        params, opt_state, l_dev = out[:3]
                        if guard_on:
                            # The loss and the span's skip flags in one fetch.
                            host = torch.cat([l_dev.reshape(1).float(),
                                              out[-1].float()]).tolist()
                            loss, skipped = host[0], host[1:]
                        else:
                            loss = float(l_dev)
                        span_losses.append(loss)
                        if sm is not None:
                            sm.span(gstep, k, k * tokens_per_batch, timer._times[-1], 0.0,
                                    int(sum(skipped)) if guard_on else 0,
                                    hlt.fetch_span(out[3]), lvl == HEALTH_FULL, loss=loss)
                        if guard_on and monitor.observe(skipped, gstep):
                            with attributed(sm, "stall"):
                                start_step = rollback()
                                monitor.rolled_back(start_step)
                            rolled = True
                            break
                        if eval_after:
                            with attributed(sm, "eval"), \
                                    tracer.span("train/eval", gstep=gstep + k):
                                accuracy = evaluate(f"eval after batch {first + k - 1}")
                            if metrics is not None:
                                metrics.gauge("train_eval_accuracy").set(accuracy)
                            history.append((epoch, first + k - 1, accuracy))
                            log(f"epoch {epoch} batch {first + k - 1} "
                                f"loss {loss:.4f} test_accuracy {accuracy:.4f}")
                            hit = hit_target(cfg, accuracy)
                        if inj is not None:
                            inj.maybe_sigterm(gstep + k)
                        preempted = preempted or check_preempt(should_stop, log,
                                                               ckpt is not None, span_idx)
                        if ckpt and save_crossed(gstep, k, checkpoint_every,
                                                 first + k == batch_num or hit or preempted):
                            with attributed(sm, "checkpoint_io"):
                                save_checkpoint_world(
                                    ckpt, {"params": self._params_for_save(params),
                                           "opt": self._opt_for_save(opt_state)},
                                    world=world, step=gstep + k, extra={"epoch": epoch},
                                    keep=checkpoint_keep)
                        if hit or preempted:
                            break
                    if hit:
                        log(f"target accuracy {cfg.target_accuracy} reached")
                    if rolled or hit or preempted:
                        break
                if not rolled:
                    break
        wall = time.perf_counter() - start
        if not (history and history[-1][:2] == (epoch, batch_num - 1)) and not hit:
            with attributed(sm, "eval"):
                accuracy = evaluate("final eval")
            if not preempted:
                history.append((epoch, batch_num - 1, accuracy))
        if sm is not None:
            # Final publish: the tail brackets land in the gauges.
            sm.gp.publish()
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
            resumed_from_step=resumed_from,
            preempted=preempted,
            skipped_steps=monitor.skipped_steps if monitor else 0,
            rollbacks=monitor.rollbacks if monitor else 0,
            span_losses=span_losses,
        )
