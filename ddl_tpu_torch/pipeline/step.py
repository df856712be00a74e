"""The pipeline train and eval steps — the port of ``ddl_tpu/pipeline/step.py``.

JAX runs one ``lax.scan`` over schedule TICKS in which every pp position
executes the same masked body (one forward slot, one backward slot, two
``ppermute`` hops) and idle slots compute on junk. A process of the port
runs only its own stage's row of the tick tables (``pipeline/schedule.py``):
at each tick at most one microbatch forward or backward, then one
:func:`~ddl_tpu_torch.parallel.collectives.stage_hop` with its neighbours,
whose sends and receives both sides read off the same tables. The numbers
are JAX's: the masked slots contribute exact zeros there.

- **Forward slot:** under ``torch.no_grad()``; only the stage INPUT is
  saved (stage 0 saves nothing but its tokens, which it embeds again); the
  output goes to stage ``s+1``. The last stage adds its scored-token CE sum
  to the loss.
- **Backward slot:** the stage forward is recomputed from the saved input
  with grad enabled, then ``torch.autograd.backward``: the last stage seeds
  ``d num = 1/global_den``, the others the cotangent of their stage output
  that arrived from ``s+1``; ``d h_in`` goes to ``s-1``. Recomputing from
  the input, never keeping the forward's graph alive, is what makes a
  stage hold at most ``min(pp - s, M)`` inputs under 1F1B.

Gradients accumulate over the microbatches in the leaves' ``.grad``, in
microbatch order, and stay local until one reduction at step end: the
stage's blocks over ``(dp, sp)`` (the grid's ``data_group``), the
stage-replicated ``SHARED_LEAVES`` over ``(dp, sp, pp)`` (``shared_group``;
only their owner stage's are nonzero, so the sum is also the broadcast).
Then TF1 Adam over the rank's tree. The Megatron f/g Functions run inside
the stage unchanged, in lockstep across the tp group at every tick.

Precision, as JAX's: under bf16 compute the stage casts its parameters to
bf16 (their gradients still accumulate in fp32), so the activations and
cotangents the hops carry are bf16; under ``precision="bf16"`` the
policy's ``cast_grads`` / ``upcast_grads`` also bracket the step-end sums.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..models import transformer
from ..models.partition import SHARED_LEAVES
from ..obs import health as hlt
from ..obs.health import HEALTH_OFF
from ..ops.optimizers import adam_update
from ..parallel import collectives as coll
from ..parallel.mesh import LOCAL, Grid
from ..utils import tree
from .schedule import IDLE


@dataclasses.dataclass
class PipelineRecord:
    """What this rank's pipeline steps did: ``peak_saved``, the most stage
    inputs held at once in any step; ``steps``, the steps run; ``hop``, the
    bytes their stage hops moved (eval hops not included)."""

    peak_saved: int = 0
    steps: int = 0
    hop: coll.HopTally = dataclasses.field(default_factory=coll.HopTally)


def _sum(t: torch.Tensor, grid: Grid, group) -> torch.Tensor:
    """``lax.psum`` over ``group`` of ``grid`` (None: the world's; an
    identity over ``LOCAL``), in place."""
    if group is LOCAL:
        coll.note("all-reduce", t, LOCAL)
        return t
    return coll.all_reduce_sum(t, grid.world, group=group)


def _sum_leaves(leaves: list, grid: Grid, group) -> list:
    """Each of ``leaves`` summed over ``group``: one all-reduce of their
    concatenation."""
    if not leaves:
        return leaves
    if group is LOCAL:
        coll.note("all-reduce", None, LOCAL, nbytes=sum(x.numel() * x.element_size()
                                                         for x in leaves))
        return leaves
    flat = _sum(torch.cat([x.reshape(-1) for x in leaves]), grid, group)
    return [x.view_as(like) for x, like in zip(flat.split([x.numel() for x in leaves]), leaves)]


def _compute_params(config, params):
    """``params`` cast to the config's compute dtype (JAX's in-stage cast;
    the identity in fp32)."""
    dtype = config.dtype()
    return params if dtype is None else tree.map(lambda a: a.to(dtype), params)


def make_stage_fn(config, grid: Grid):
    """``(stage_fn, blocks_fwd)`` of this rank's stage.

    ``stage_fn(params, h_in, tokens, targets, weights, positions) -> (h_out,
    num)``: the parameters cast to the compute dtype, stage 0 embeds
    ``tokens`` (``h_in`` unused), every stage applies
    its ``L/pp`` blocks (``transformer.apply_block``, the oracle's layer
    unit; each block checkpointed under ``config.remat`` when grad is on, as
    JAX's ``jax.checkpoint``), and only the last stage runs the final
    LayerNorm, the head and the CE sum (``num`` None elsewhere). The local
    attention is scheme ``full``'s closure of ``strategies.seq._attn_for``
    (the sequence is whole on every stage), so the kernel choice cannot fork
    between the pipeline and its oracle."""
    from ..strategies.seq import _attn_for, _col_promote, _row_reduce

    spec = config.spec
    attn = _attn_for(config, grid)
    hooks = dict(row_reduce=_row_reduce(grid), col_promote=_col_promote(grid))
    first = grid.pp_index == 0
    last = grid.pp_index == grid.pipeline_parallel - 1

    def block(h, blk, positions):
        return transformer.apply_block(h, blk, spec, attn_fn=attn, positions=positions, **hooks)

    def blocks_fwd(blocks, h, positions):
        remat = config.remat and torch.is_grad_enabled()
        for blk in blocks:
            h = (checkpoint(block, h, blk, positions, use_reentrant=False) if remat
                 else block(h, blk, positions))
        return h

    def stage_fn(params, h_in, tokens, targets, weights, positions):
        params = _compute_params(config, params)
        h = params["embed"][tokens] if first else h_in
        h = blocks_fwd(params["blocks"], h, positions)
        if not last:
            return h, None
        hl = transformer._layernorm(h, params["lnf_g"], params["lnf_b"])
        num, _ = transformer.ce_sums((hl @ params["head"]).float(), targets, weights)
        return h, num

    return stage_fn, blocks_fwd


def make_pipeline_step_body(config, grid: Grid, tables, positions: torch.Tensor, *,
                            lr: float, record: PipelineRecord | None = None,
                            groups: list | None = None, guard: bool = False):
    """One pipeline train step on this rank: ``(params, opt_state, tokens,
    targets, weights[, health]) -> (params', opt_state', loss[, health
    dict][, skipped])``,
    ``tokens`` this dp row's ``[B/dp, T]``, split into ``M`` microbatches
    streamed by the ``(f_tab, b_tab)`` pair of ``tables``. ``record``
    (optional) gathers the steps' saved-input peak and hop bytes.

    ``guard`` turns on the non-finite guard (``resilience.guard``, JAX's
    ``pipeline/step.py`` guard) and a ``health`` level the health dict
    (``obs.health``, JAX's ``pipeline/step.py:284``); ``groups`` holds, for
    each parameter leaf, the groups its count and squared sums sum over
    (the stage's blocks over pp and, where tp-sharded, tp), so both are
    global and every stage takes the same branch."""
    f_tab, b_tab = tables
    pp, s = grid.pipeline_parallel, grid.pp_index
    m = int(f_tab.max()) + 1
    first, last = s == 0, s == pp - 1
    prev_rank = None if first else grid.pp_ranks[s - 1]
    next_rank = None if last else grid.pp_ranks[s + 1]
    stage_fn, _ = make_stage_fn(config, grid)
    tally = record.hop if record is not None else None
    pol = config.policy()
    act_dtype = config.dtype() or torch.float32

    def step(params, opt_state, tokens, targets, weights, health=HEALTH_OFF):
        b_loc, t_seq = tokens.shape
        mb = b_loc // m
        xs, ys, ws = (a.reshape(m, mb, t_seq) for a in (tokens, targets, weights))
        # The global scored-weight total: no parameter depends on it, so
        # the gradients stay local until the step-end sums.
        den = _sum(weights.float().sum(), grid, grid.data_group)
        inv_den = 1.0 / den
        leaves = tree.map(lambda t: t.detach().requires_grad_(True), params)
        like = torch.empty((mb, t_seq, config.spec.d_model), dtype=act_dtype,
                           device=tokens.device)
        saved, inbox, ctbox = {}, {}, {}
        num_acc = torch.zeros((), device=tokens.device)
        peak = 0
        for t in range(f_tab.shape[1]):
            fj, bj = int(f_tab[s, t]), int(b_tab[s, t])
            sends = []
            if fj != IDLE:
                h_in = None if first else inbox.pop(fj)
                with torch.no_grad():
                    h_out, num = stage_fn(leaves, h_in, xs[fj], ys[fj], ws[fj], positions)
                saved[fj] = h_in
                peak = max(peak, len(saved))
                if last:
                    num_acc = num_acc + num
                else:
                    sends.append((h_out, next_rank))
            if bj != IDLE:
                h_in = saved.pop(bj)
                if not first:
                    h_in.requires_grad_(True)
                with torch.enable_grad():
                    h_out, num = stage_fn(leaves, h_in, xs[bj], ys[bj], ws[bj], positions)
                    if last:
                        torch.autograd.backward(num, inv_den)
                    else:
                        torch.autograd.backward(h_out, ctbox.pop(bj))
                if not first:
                    sends.append((h_in.grad, prev_rank))
            # What the neighbours' rows send this tick arrives for the next.
            arrivals = []
            if not first and f_tab[s - 1, t] != IDLE:
                arrivals.append((inbox, int(f_tab[s - 1, t]), prev_rank))
            if not last and b_tab[s + 1, t] != IDLE:
                arrivals.append((ctbox, int(b_tab[s + 1, t]), next_rank))
            if sends or arrivals:
                got = coll.stage_hop(sends, [(like, src) for _, _, src in arrivals],
                                     grid.pp_group, tally)
                for (box, j, _), x in zip(arrivals, got):
                    box[j] = x
        loss = _sum(num_acc, grid, grid.shared_group) * inv_den
        grads = pol.cast_grads(tree.map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves))
        shared = _sum_leaves([grads[k] for k in SHARED_LEAVES], grid, grid.shared_group)
        grads.update(zip(SHARED_LEAVES, shared))
        block_grads = tree.leaves(grads["blocks"])
        grads["blocks"] = tree.unflatten(grads["blocks"],
                                         _sum_leaves(block_grads, grid, grid.data_group))
        grads = pol.upcast_grads(grads)
        with torch.no_grad():
            new_params, new_opt = adam_update(params, opt_state, grads, lr=lr)
        if record is not None:
            record.peak_saved = max(record.peak_saved, peak)
            record.steps += 1
        return hlt.finish_step(
            guard, health, lambda: hlt.nonfinite_count(grads, groups),
            lambda new, nf: hlt.health_signals(grads, params, new, groups, nf),
            params, opt_state, new_params, new_opt, loss.detach())

    return step


def make_pipeline_eval_body(config, grid: Grid, positions: torch.Tensor):
    """Forward-only pipeline eval on this rank: ``(params, tokens, targets,
    weights) -> (num, den)``, the weighted top-1 hit sums over the
    dp-replicated test set, in chunks of ``batch_size`` sequences. Per
    chunk, stage 0 embeds, each stage applies its layers and hands the
    activation on, and the last stage scores; ``num`` is summed over
    ``(dp, sp, pp)`` (zero off the last stage), ``den`` over ``(dp, sp)``
    (JAX's eval sums; the test set's dp replication inflates both dp-fold,
    so the ratio is exact)."""
    pp, s = grid.pipeline_parallel, grid.pp_index
    first, last = s == 0, s == pp - 1
    _, blocks_fwd = make_stage_fn(config, grid)
    e = config.spec.d_model
    act_dtype = config.dtype() or torch.float32

    def sums(params, tokens, targets, weights):
        params = _compute_params(config, params)
        num = torch.zeros((), device=tokens.device)
        bs = config.batch_size
        for i in range(0, tokens.shape[0], bs):
            x, y, w = tokens[i:i + bs], targets[i:i + bs], weights[i:i + bs]
            if first:
                h = params["embed"][x]
            else:
                like = torch.empty((*x.shape, e), dtype=act_dtype, device=tokens.device)
                (h,) = coll.stage_hop([], [(like, grid.pp_ranks[s - 1])], grid.pp_group)
            h = blocks_fwd(params["blocks"], h, positions)
            if not last:
                coll.stage_hop([(h, grid.pp_ranks[s + 1])], [], grid.pp_group)
                continue
            hl = transformer._layernorm(h, params["lnf_g"], params["lnf_b"])
            hits = (torch.argmax((hl @ params["head"]).float(), dim=-1) == y).float()
            num = num + (hits * w.float()).sum()
        den = _sum(weights.float().sum(), grid, grid.data_group)
        return _sum(num, grid, grid.shared_group), den

    return sums
