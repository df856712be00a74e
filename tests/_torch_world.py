"""Workers of the spawned gloo worlds: the 2-rank CNN world of
tests/test_torch_sync.py (:func:`world_cases`) and the 4-rank LM world of
tests/test_torch_seq_parallel.py (:func:`lm_world_cases`: training on the
3-D grid and the pipeline's 4-D one, then tp-2 serving as two tp groups of
two ranks, then the checkpoint and resilience cases,
:func:`_resilience_cases`).

Kept apart from the test modules so the spawned children import only
``torch`` and ``ddl_tpu_torch`` (never JAX): ``multiprocessing`` imports this
module, not the test file, to find the target.
"""

import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from ddl_tpu_torch.convert import (
    async_state_to_numpy,
    kv_cache_to_numpy,
    lm_params_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from ddl_tpu_torch.data.lm import synthesize_copy, synthesize_prompts
from ddl_tpu_torch.models import cnn
from ddl_tpu_torch.models import transformer
from ddl_tpu_torch.obs import MetricRegistry
from ddl_tpu_torch.parallel import collectives as coll
from ddl_tpu_torch.parallel.collectives import tp_allreduce, unflatten_params
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world, make_grid
from ddl_tpu_torch.ops.optimizers import adam_init
from ddl_tpu_torch.resilience import FaultInjector, FaultSpec
from ddl_tpu_torch.utils import checkpoint as ck
from ddl_tpu_torch.serve import (
    ClassSpec,
    InferenceEngine,
    Request,
    Router,
    RouterConfig,
    Scheduler,
    ServeConfig,
)
from ddl_tpu_torch.serve.cache import host_cache, host_paged_cache
from ddl_tpu_torch.strategies import async_ps
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.strategies.sync import (
    make_dp_step,
    make_sharded_step,
    resolve_layout,
    sharded_adam_init,
)
from ddl_tpu_torch.train.config import TrainConfig
from ddl_tpu_torch.utils import tree

# Sync cases: name -> (num_ps, layout, grad_reduction). num_ps 1 is DP;
# num_ps 3 at W = 2 folds the block layout onto the two ranks.
SYNC_CASES = {
    "zigzag": (2, "zigzag", "mean"),
    "flat": (2, "flat", "mean"),
    "dp": (1, "block", "mean"),
    "block": (2, "block", "mean"),
    "lpt": (2, "lpt", "mean"),
    "fold3": (3, "block", "mean"),
    "flat_sum": (2, "flat", "sum"),
}
# Async cases: name -> (num_ps, layout). "replicated" is the replicated
# serve (layout None), the oracle of the sharded ones; num_ps 14 at W = 2
# folds the block layout.
ASYNC_CASES = {
    "replicated": (1, "block"),
    "zigzag2": (2, "zigzag"),
    "block14": (14, "block"),
}
ASYNC_ROUNDS = 2
ASYNC_SCHEDULE_SEED = 11
TINY = dict(conv_channels=cnn.TINY_CONV_CHANNELS, fc_sizes=cnn.TINY_FC_SIZES)


def async_layout(name: str, world_size: int, sizes):
    """The serve layout of an async case: None for the replicated serve."""
    num_ps, layout = ASYNC_CASES[name]
    if name == "replicated":
        return None
    cfg = TrainConfig(num_workers=world_size, num_ps=num_ps, layout=layout, **TINY)
    return resolve_layout(cfg, world_size, sizes)


def _sync_case(name, world, init, specs, xs, ys, steps, results):
    num_ps, layout, reduction = SYNC_CASES[name]
    dp = num_ps == 1
    cfg = TrainConfig(num_workers=world.size, num_ps=num_ps, layout=layout,
                      grad_reduction=reduction, batch_size=xs.shape[0] * world.size,
                      keep_prob=1.0, **TINY)
    params = params_from_numpy(init, "cpu", specs)
    if dp:
        step = make_dp_step(cfg, world)
        opt = adam_init(params)
    else:
        lay = resolve_layout(cfg, world.size, cnn.param_sizes(specs))
        step = make_sharded_step(cfg, world, lay, cnn.param_shapes(params))
        opt = sharded_adam_init(world, lay)
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, xs, ys, i)
        losses.append(float(loss))
    for k, v in params_to_numpy(params).items():
        results[f"{name}/{k}"] = v
    if dp:
        for k in params:
            results[f"{name}/m/{k}"] = opt.m[k].numpy()
            results[f"{name}/v/{k}"] = opt.v[k].numpy()
    else:
        results[f"{name}/m"] = opt.m.numpy()
        results[f"{name}/v"] = opt.v.numpy()
    results[f"{name}/step"] = np.asarray(int(opt.step))
    results[f"{name}/loss"] = np.asarray(losses)


def _async_case(name, world, init, specs, xs, ys, x_test, y_test, results):
    """ASYNC_ROUNDS rounds of ``make_async_round`` (one call a round, so
    each round's loss is kept), then this rank's state, the logical ps/m/v
    by variable and the per-worker eval counts."""
    num_ps, layout = ASYNC_CASES[name]
    cfg = TrainConfig(num_workers=world.size, num_ps=num_ps, layout=layout,
                      batch_size=xs.shape[1], keep_prob=1.0, **TINY)
    params = params_from_numpy(init, "cpu", specs)
    shapes = cnn.param_shapes(params)
    lay = async_layout(name, world.size, cnn.param_sizes(specs))
    state = async_ps.async_state_init(cfg, world, lay, params)
    run = async_ps.make_async_round(cfg, world, lay, shapes)
    scheds = async_ps.async_schedule(ASYNC_SCHEDULE_SEED, world.size, ASYNC_ROUNDS)
    losses = []
    for r in range(ASYNC_ROUNDS):
        state, ps_full, loss = run(state, xs[r : r + 1], ys[r : r + 1], scheds[r : r + 1], r)
        losses.append(float(loss))
    for k, v in async_state_to_numpy([state], sharded=lay is not None).items():
        results[f"async/{name}/state/{k}"] = v
    results[f"async/{name}/ps_full"] = ps_full.numpy()
    results[f"async/{name}/loss"] = np.asarray(losses)
    spec = async_ps._flat_spec(lay, shapes)
    reassembly = async_ps._reassembly(lay, world.device)
    for what in ("ps", "m", "v"):
        full = async_ps._gather_full(getattr(state, what), world, reassembly)
        for k, t in unflatten_params(full, spec).items():
            results[f"async/{name}/logical/{what}/{k}"] = t.numpy()
    counts = async_ps.make_worker_eval(world, spec)(state.replica(world.rank), x_test, y_test)
    results[f"async/{name}/worker_counts"] = counts.numpy()


def world_cases(rank: int, world_size: int, store: str, inputs: str, out: str,
                steps: int) -> None:
    """Every sync case for ``steps`` steps on this rank's slice of the
    batch, then every async case for ASYNC_ROUNDS rounds on this worker's
    batches; saves params, optimizer moments, serve state and losses."""
    torch.set_num_threads(1)
    data = np.load(inputs)
    specs = cnn.make_param_specs(cnn.TINY_CONV_CHANNELS, cnn.TINY_FC_SIZES)
    init = {name: data[name] for name, _ in specs}
    x, y = data["x"], data["y"]
    pb = x.shape[0] // world_size
    xs = torch.from_numpy(x[rank * pb:(rank + 1) * pb])
    ys = torch.from_numpy(y[rank * pb:(rank + 1) * pb])
    # Async: [rounds, W, bs, ...], this worker's [rounds, bs, ...].
    axs = torch.from_numpy(np.ascontiguousarray(data["ax"][:, rank]))
    ays = torch.from_numpy(np.ascontiguousarray(data["ay"][:, rank]))
    x_test, y_test = torch.from_numpy(data["x_test"]), torch.from_numpy(data["y_test"])
    world = init_world(world_size, rank, store, "cpu")
    results = {}
    try:
        for name in SYNC_CASES:
            _sync_case(name, world, init, specs, xs, ys, steps, results)
        for name in ASYNC_CASES:
            _async_case(name, world, init, specs, axs, ays, x_test, y_test, results)
    finally:
        destroy_world()
    np.savez(out, **results)


# LM cases of the 4-rank world: name -> SeqConfig fields (num_workers x
# data_parallel x tensor_parallel = 4 ranks).
LM_CASES = {
    "ring": dict(scheme="ring", num_workers=4),
    "ring_zigzag": dict(scheme="ring", seq_layout="zigzag", num_workers=4),
    "ulysses": dict(scheme="ulysses", num_workers=4),
    "ulysses_flash": dict(scheme="ulysses", attn_impl="flash", num_workers=4),
    "ring_zigzag_2x2": dict(scheme="ring", seq_layout="zigzag", num_workers=2,
                            data_parallel=2),
    "full_dp4": dict(scheme="full", num_workers=1, data_parallel=4),
    "zero1_ring": dict(scheme="ring", zero1=True, num_workers=4),
    "zero1_ulysses_2x2": dict(scheme="ulysses", zero1=True, num_workers=2, data_parallel=2),
    # Recomputed blocks re-run the ring's shifts inside the backward pass.
    "ring_zigzag_remat": dict(scheme="ring", seq_layout="zigzag", num_workers=4, remat=True),
    # Tensor parallelism (Megatron), alone and with each other axis.
    "tp4_full": dict(scheme="full", tensor_parallel=4),
    "tp2_ulysses_flash_sp2": dict(scheme="ulysses", attn_impl="flash", num_workers=2,
                                  tensor_parallel=2),
    "tp2_ring_zigzag_sp2": dict(scheme="ring", seq_layout="zigzag", num_workers=2,
                                tensor_parallel=2),
    "tp2_full_dp2": dict(scheme="full", data_parallel=2, tensor_parallel=2),
    # The hybrid ZeRO-1 x tp.
    "hybrid_tp2_dp2": dict(scheme="full", zero1=True, data_parallel=2, tensor_parallel=2),
    "hybrid_tp2_ring_sp2": dict(scheme="ring", zero1=True, num_workers=2, tensor_parallel=2),
    # Pipeline parallelism on the [dp, 1, tp, pp] grid; pp 4 takes the
    # 4-layer variant of the spec (its own init in the world's inputs).
    "dp2_pp2": dict(scheme="full", data_parallel=2, pipeline_parallel=2, microbatches=2),
    "dp2_pp2_1f1b": dict(scheme="full", data_parallel=2, pipeline_parallel=2, microbatches=2,
                         pipeline_schedule="1f1b"),
    "tp2_pp2_flash": dict(scheme="full", attn_impl="flash", tensor_parallel=2,
                          pipeline_parallel=2, microbatches=2, pipeline_schedule="1f1b"),
    "pp4_1f1b": dict(scheme="full", pipeline_parallel=4, microbatches=4,
                     pipeline_schedule="1f1b", spec="LM_SPEC_4L"),
    # The bf16 policy: bf16 compute, and bf16 gradient sums in the
    # replicated body, ZeRO-1, the hybrid and the pipeline (with bf16 hops).
    "ulysses_flash_bf16": dict(scheme="ulysses", attn_impl="flash", num_workers=4,
                               precision="bf16"),
    "zero1_ulysses_2x2_bf16": dict(scheme="ulysses", zero1=True, num_workers=2,
                                   data_parallel=2, precision="bf16"),
    "hybrid_tp2_dp2_bf16": dict(scheme="full", zero1=True, data_parallel=2, tensor_parallel=2,
                                precision="bf16"),
    "dp2_pp2_bf16": dict(scheme="full", data_parallel=2, pipeline_parallel=2, microbatches=2,
                         precision="bf16"),
    # The fp32 policy, each bitwise its precision=None twin (FP32_TWINS).
    "hybrid_tp2_dp2_fp32": dict(scheme="full", zero1=True, data_parallel=2, tensor_parallel=2,
                                precision="fp32"),
    "dp2_pp2_fp32": dict(scheme="full", data_parallel=2, pipeline_parallel=2, microbatches=2,
                         precision="fp32"),
}
FP32_TWINS = {"hybrid_tp2_dp2_fp32": "hybrid_tp2_dp2", "dp2_pp2_fp32": "dp2_pp2"}
# Cases trained with metrics on (a registry): ring + ZeRO-1, the hybrid and
# GPipe at pp 2. Their FP32_TWINS run without, so those pins also hold
# metrics-on params bitwise to metrics-off ones.
OBS_CASES = ("zero1_ring", "hybrid_tp2_dp2", "dp2_pp2")
OBS_KINDS = ("all-reduce", "reduce-scatter", "all-gather", "all-to-all", "collective-permute")
# Each bf16 case's fp32 twin, and the collectives its gradient sums take:
# the replicated body's all-reduce, ZeRO-1's reduce-scatter, the hybrid's
# reduce-scatter (replicated subtree) and per-leaf all-reduce (tp subtree),
# the pipeline's step-end shared and block all-reduces.
BF16_TWINS = {
    "ulysses_flash_bf16": ("ulysses_flash", {"all_reduce_sum"}),
    "zero1_ulysses_2x2_bf16": ("zero1_ulysses_2x2", {"reduce_scatter_flat"}),
    "hybrid_tp2_dp2_bf16": ("hybrid_tp2_dp2_fp32", {"reduce_scatter_flat", "all_reduce_sum"}),
    "dp2_pp2_bf16": ("dp2_pp2_fp32", {"all_reduce_sum"}),
}
# The sum collectives a step's gradients may take; an input of more than 2
# elements is a gradient sum (the loss and metric sums hold 1 and 2).
WIRE_FNS = ("all_reduce_sum", "reduce_scatter_flat")
LM_SPEC = transformer.LMSpec(vocab=16, d_model=32, num_heads=4, num_layers=2, d_ff=64)
LM_SPEC_4L = dataclasses.replace(LM_SPEC, num_layers=4)
LM_DATA = dict(num_train=16, num_test=8, seq_len=32, vocab=16, seed=5)
# 2 steps of batch 8, one span (and one eval) a step.
LM_BASE = dict(epochs=1, batch_size=8, learning_rate=1e-3, eval_every=1, seed=2, spec=LM_SPEC)

# Serving at tp 2 in the same world (two tp groups of two ranks), with the
# LM's spec and init: name -> ServeConfig fields.
SERVE_TP = 2
SERVE_CASES = {
    "contiguous-greedy": dict(slots=3, capacity=64),
    "paged-sampled": dict(slots=3, capacity=64, page_size=8, temperature=0.7, top_k=5),
    "paged-greedy-bf16": dict(slots=3, capacity=64, page_size=8, compute_dtype="bfloat16"),
    "paged-greedy-int8": dict(slots=3, capacity=64, page_size=8, kv_dtype="int8"),
    # 4 slots for 6 requests: the draft lanes ride the slots the queue
    # leaves free; the run keeps its speculation counters (SPEC_COUNTERS).
    "paged-greedy-speculate2": dict(slots=4, capacity=64, page_size=8, speculate_k=2),
}
SPEC_COUNTERS = ("speculate_proposed_total", "speculate_accepted_total")


def program_ledger(reg) -> list[str]:
    """A serve registry's ``xla_compiles_total{kind=}`` counts and each
    program's collective ledger (total bytes, ops and bytes by kind and by
    axis), as sorted strings: either package's registry."""
    out = []
    for name in ("xla_compiles_total", "collective_bytes_total", "collective_ops_total",
                 "collective_bytes", "collective_axis_bytes"):
        m = reg.get(name)
        for ls in m.label_sets():
            labels = ",".join(f"{k}={v}" for k, v in sorted(ls.items()))
            out.append(f"{name}{{{labels}}}={int(m.value(**ls))}")
    return sorted(out)
SERVE_PROMPTS = dict(num=6, min_len=3, max_len=20, vocab=16, seed=0)
SERVE_NEW = 8
SERVE_STATS = ("prefill_tokens", "decode_steps", "decode_tokens", "prefix_lookups",
               "prefix_hits", "prefill_tokens_saved")
# The fleet at tp 2: a 1-replica router against the bare scheduler on the
# paged pool (arrivals staggered one a tick), and request FLEET_MOVED
# preempted after FLEET_PREEMPT_AT ticks on one engine and adopted by another.
FLEET_SERVE = dict(slots=3, capacity=64, page_size=8)
FLEET_PREEMPT_AT = 4
FLEET_MOVED = 0
# The same move between two int8 engines: the (payload, scale) pairs of this
# rank's heads.
FLEET_INT8 = "paged-greedy-int8"


# The checkpoint and resilience family, after the serve cases (outside the
# timed LM cases): a JAX-written standard-form checkpoint placed at each
# topology and written back (RES_ROUND_TRIPS); a preemption that rank 0
# alone asks for, agreed by the world, then resume="auto" (the hybrid); a
# rollback (the pipeline); the guard's skip in the ZeRO-1, hybrid and
# pipeline bodies (RES_GUARD); a preempted ZeRO-1 2x2 save that the parent
# resumes at one rank (elastic); and the tp-2 engine serving the hybrid's
# checkpoint.
RES_ROUND_TRIPS = ("zero1_ulysses_2x2", "hybrid_tp2_dp2", "dp2_pp2", "tp2_pp2_flash")
RES_GUARD = ("zero1_ulysses_2x2", "hybrid_tp2_dp2", "dp2_pp2")
RES_STANDARD = "jax_standard.npz"  # the parent writes it with JAX's save_checkpoint


def res_dir(inputs: str, name: str) -> str:
    return os.path.join(os.path.dirname(inputs), "res", name)


def _guard_skip(trainer, ds) -> tuple[bool, int]:
    """One guarded step on a batch with one NaN loss weight: (params and
    optimizer state bitwise unchanged, the skip flag)."""
    bs = trainer.config.batch_size
    w = np.array(ds.weights, copy=True)
    w[0, 0] = np.nan
    xs, ys, ws = (trainer.stage_batches(a, 1, bs) for a in (ds.tokens, ds.targets, w))
    p, o, _, skipped = trainer.span_program(1, guard=True)(
        trainer.params, trainer.opt_state, xs, ys, ws, 0)
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(p), tree.leaves(trainer.params)))
    for f in dataclasses.fields(o):
        same &= all(torch.equal(a, b) for a, b in zip(
            tree.leaves([getattr(o, f.name)]), tree.leaves([getattr(trainer.opt_state, f.name)])))
    return same, int(skipped[0])


def _resilience_cases(world, inits, ds, inputs, results):
    quiet = lambda s: None  # noqa: E731

    def trainer(name):
        cfg = SeqConfig(**lm_case_config(LM_CASES[name]))
        return SeqTrainer(cfg, ds, init=inits[cfg.spec.num_layers], world=world)

    src = os.path.join(os.path.dirname(inputs), RES_STANDARD)
    for name in RES_ROUND_TRIPS:
        tr = trainer(name)
        host, step, extra = ck.load_checkpoint(src, tr.checkpoint_like())
        back = {"params": tr._params_for_save(tr._place_params(host["params"])),
                "opt": tr._opt_for_save(tr._place_opt(host["opt"]))}
        ck.save_checkpoint_world(os.path.join(res_dir(inputs, name), "ckpt.npz"), back,
                                 world=world, step=step, extra=extra, keep=2)
    for name in RES_GUARD:
        same, flag = _guard_skip(trainer(name), ds)
        results[f"res/guard/{name}"] = np.asarray([same, flag])
    # Preemption agreed by the world though only rank 0 asks, then resume.
    d = res_dir(inputs, "preempt_hybrid")
    pre = trainer("hybrid_tp2_dp2").train(log=quiet, checkpoint_dir=d,
                                          should_stop=lambda: world.rank == 0)
    tr = trainer("hybrid_tp2_dp2")
    res = tr.train(log=quiet, checkpoint_dir=d, resume="auto")
    results["res/preempt_hybrid/flags"] = np.asarray([pre.preempted, res.resumed_from_step])
    for i, leaf in enumerate(tree.leaves(res.params)):
        results[f"res/preempt_hybrid/p/{i}"] = leaf
    for f in ("m_flat", "v_flat", "m_tp", "v_tp"):
        for i, leaf in enumerate(tree.leaves(getattr(tr.opt_state, f))):
            results[f"res/preempt_hybrid/{f}/{i}"] = leaf.numpy()
    # The tp-2 engine serves the hybrid's final checkpoint as its params.
    grid = make_grid(world, world.size // SERVE_TP, 1, SERVE_TP)
    cfg = ServeConfig(spec=LM_SPEC, tensor_parallel=SERVE_TP, slots=2, capacity=48)
    prompts = synthesize_prompts(**{**SERVE_PROMPTS, "num": 3})
    tokens = []
    for eng in (InferenceEngine.from_checkpoint(cfg, os.path.join(d, "ckpt.npz"), grid=grid),
                InferenceEngine(cfg, params=res.params, grid=grid)):
        done, _ = Scheduler(eng).run([Request(id=i, prompt=p, max_new_tokens=SERVE_NEW)
                                      for i, p in enumerate(prompts)])
        tokens.append([done[i].tokens for i in sorted(done)])
    results["res/serve_ckpt_equal"] = np.asarray(tokens[0] == tokens[1])
    # A rollback in the pipeline: NaN at step 1, back to the step-1 save.
    res = trainer("dp2_pp2").train(
        log=quiet, checkpoint_dir=res_dir(inputs, "rollback_pp"), checkpoint_every=1,
        max_bad_steps=1, fault_injector=FaultInjector(FaultSpec(kind="nan_grads", step=1)))
    results["res/rollback_pp/flags"] = np.asarray([res.rollbacks, res.skipped_steps])
    for i, leaf in enumerate(tree.leaves(res.params)):
        results[f"res/rollback_pp/p/{i}"] = leaf
    # A preempted ZeRO-1 2x2 save, for the parent's elastic resume.
    trainer("zero1_ulysses_2x2").train(log=quiet, checkpoint_dir=res_dir(inputs, "elastic"),
                                       should_stop=lambda: True)


def kv_calls():
    """The cached forwards' inputs, as numpy, for both sides: ``cached``, a
    padded prefill of 2 slots (ring capacity 16; tail positions PAD_POS,
    tail rows dropped) then two one-token decodes with slot 1 inactive;
    ``paged``, a prefill of each slot through its block table (pages of 4,
    7 pages), then one decode with slot 0 inactive."""
    pad = 2**31 - 1
    rng = np.random.default_rng(7)
    b, c, bucket, real = 2, 16, 8, np.array([6, 3])
    t = np.arange(bucket)[None]
    base = np.array([[2], [0]])
    cached = [dict(tokens=rng.integers(1, 16, (b, bucket)).astype(np.int32),
                   positions=np.where(t < real[:, None], base + t, pad).astype(np.int32),
                   rows=np.where(t < real[:, None], (base + t) % c, c).astype(np.int32))]
    lengths = base[:, 0] + real
    for _ in range(2):
        active = np.array([True, False])
        cached.append(dict(tokens=rng.integers(1, 16, (b, 1)).astype(np.int32),
                           positions=np.where(active, lengths, pad).astype(np.int32)[:, None],
                           rows=(lengths % c).astype(np.int32)[:, None]))
        lengths = lengths + active
    ps, num_pages, max_pages = 4, 7, 4
    tables = np.array([[3, 1, -1, -1], [0, 5, 2, -1]], np.int32)
    paged = []
    for slot, n, bucket in ((0, 7, 8), (1, 9, 16)):
        t = np.arange(bucket)[None]
        paged.append(dict(tokens=rng.integers(1, 16, (1, bucket)).astype(np.int32),
                          table=tables[slot:slot + 1],
                          positions=np.where(t < n, t, pad).astype(np.int32),
                          logical=np.where(t < n, t, max_pages * ps).astype(np.int32)))
    lengths, active = np.array([7, 9]), np.array([False, True])
    paged.append(dict(tokens=rng.integers(1, 16, (2, 1)).astype(np.int32), table=tables,
                      positions=np.where(active, lengths, pad).astype(np.int32)[:, None],
                      logical=np.where(active, lengths, 4 * ps).astype(np.int32)[:, None]))
    return dict(capacity=c, slots=b, page_size=ps, num_pages=num_pages, cached=cached,
                paged=paged)


def record_margins(engine) -> dict:
    """Wrap an engine's (JAX's or the port's) prefill and decode to keep,
    per request, the top-2 logit margin of each kept sample: the last
    prefill block's, then each decode step's."""
    margins = {}
    prefill, decode = engine.prefill, engine.decode

    def top2(row):
        s = np.sort(np.asarray(row), axis=-1)
        return float(s[..., -1] - s[..., -2])

    def rec_prefill(prompt, *, slot, request_id, base=0, _bucket=None):
        tok, logits = prefill(prompt, slot=slot, request_id=request_id, base=base,
                              _bucket=_bucket)
        margins[request_id] = [top2(np.asarray(logits)[-1])]
        return tok, logits

    def rec_decode(last, lengths, rids, active, **k):
        nxt, logits = decode(last, lengths, rids, active, **k)
        for i in np.nonzero(np.asarray(active, bool))[0]:
            margins[int(rids[i])].append(top2(np.asarray(logits)[i]))
        return nxt, logits

    engine.prefill, engine.decode = rec_prefill, rec_decode
    return margins


def fleet_requests(prompts, request_cls):
    """The fleet case's stream: each prompt arriving one tick after the
    previous, classed ``default``."""
    return [request_cls(id=i, prompt=p, max_new_tokens=SERVE_NEW, arrival=i)
            for i, p in enumerate(prompts)]


def _page_arrays(k, v, pos) -> list:
    """A page dump's arrays, an int8 pool's (payload, scale) pairs
    flattened."""
    return [x for part in (k, v, pos) for x in (part if isinstance(part, tuple) else (part,))]


def _fleet_case(grid, init, prompts, results):
    """The fleet at tp 2: the bare scheduler's tokens and every decode
    step's logits, a 1-replica router's (equal bitwise), and one request's
    preempt -> adopt round trip between two engines of this tp group, fp32
    and int8 (its tokens, the dumped pages' shape: this rank's heads, and
    the adopter's pages equal to the dump)."""
    cfg = ServeConfig(spec=LM_SPEC, tensor_parallel=SERVE_TP, **FLEET_SERVE)
    reqs = fleet_requests(prompts, Request)

    def logged(eng, log):
        decode = eng.decode

        def rec(*a, **k):
            nxt, logits = decode(*a, **k)
            log.append(logits.copy())
            return nxt, logits

        eng.decode = rec
        return eng

    bare_log, router_log = [], []
    done, _ = Scheduler(logged(InferenceEngine(cfg, params=init, grid=grid), bare_log)).run(reqs)
    router = Router(RouterConfig(serve=cfg, replicas=1, classes=(ClassSpec("default"),)),
                    params=init, grid=grid)
    logged(router.engines[0], router_log)
    rdone, _ = router.run(reqs)
    results["fleet/router_equal"] = np.asarray(
        all(rdone[i].tokens == done[i].tokens for i in done) and len(bare_log) == len(router_log)
        and all(np.array_equal(a, b) for a, b in zip(bare_log, router_log)))
    for i, c in rdone.items():
        results[f"fleet/router/{i}/tokens"] = np.asarray(c.tokens, np.int64)
    int8 = ServeConfig(spec=LM_SPEC, tensor_parallel=SERVE_TP, **SERVE_CASES[FLEET_INT8])
    for key, c in (("fleet/moved", cfg), ("fleet/moved_int8", int8)):
        a = Scheduler(InferenceEngine(c, params=init, grid=grid))
        b = Scheduler(InferenceEngine(c, params=init, grid=grid))
        a.begin()
        b.begin()
        a.submit(reqs[FLEET_MOVED])
        for _ in range(FLEET_PREEMPT_AT):
            a.tick()
        pre = a.preempt(FLEET_MOVED)
        slot = b.adopt(pre)
        # The adopter's pages are the dumped bytes.
        results[f"{key}/round_trip"] = np.asarray(all(
            np.array_equal(x, y) for x, y in zip(_page_arrays(*b.engine.dump_slot_pages(slot)),
                                                 _page_arrays(pre.k, pre.v, pre.pos),
                                                 strict=True)))
        while not b.idle:
            b.tick()
        moved, _ = b.collect()
        a.collect()
        results[f"{key}/tokens"] = np.asarray(moved[FLEET_MOVED].tokens, np.int64)
        results[f"{key}/generated_at_preempt"] = np.asarray(len(pre.generated))
        payload = pre.k[0] if isinstance(pre.k, tuple) else pre.k
        results[f"{key}/k_shape"] = np.asarray(payload.shape)
        results[f"{key}/k_dtype"] = np.asarray(str(payload.dtype))
        results[f"{key}/pools_whole"] = np.asarray(all(
            s.engine.pages.free == s.engine.num_pages and s.engine.pages.reserved == 0
            for s in (a, b)))


def _serve_cases(world, init, results):
    """Every serve case on each tp-2 group of the world, then the cached
    and paged forwards call by call: completions, counters and each
    request's top-2 logit margins (prefill, then decode steps); logits and
    this rank's local-head k/v."""
    from ddl_tpu_torch.ops import kv_cache

    grid = make_grid(world, world.size // SERVE_TP, 1, SERVE_TP)
    prompts = synthesize_prompts(**SERVE_PROMPTS)
    for name, kw in SERVE_CASES.items():
        eng = InferenceEngine(ServeConfig(spec=LM_SPEC, tensor_parallel=SERVE_TP, **kw),
                              params=init, grid=grid)
        margins = record_margins(eng)
        reg = MetricRegistry() if kw.get("speculate_k") else None
        done, stats = Scheduler(eng, registry=reg).run(
            [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
        key = f"serve/{name}"
        if reg is not None:
            results[f"{key}/spec_counters"] = np.asarray(
                [int(reg.counter(n).value()) for n in SPEC_COUNTERS])
            results[f"{key}/programs"] = np.asarray(program_ledger(reg))
        for i, c in done.items():
            results[f"{key}/{i}/tokens"] = np.asarray(c.tokens, np.int64)
            results[f"{key}/{i}/steps"] = np.asarray([c.admitted_step, c.finished_step])
            results[f"{key}/{i}/status"] = np.asarray(c.status)
            results[f"{key}/{i}/margins"] = np.asarray(margins[i])
        results[f"{key}/stats"] = np.asarray([getattr(stats, f) for f in SERVE_STATS])
        results[f"{key}/pool_dtype"] = np.asarray(str(eng.cache.k.dtype))
        results[f"{key}/local_heads"] = np.asarray(eng.cache.k.shape[3])
    _fleet_case(grid, init, prompts, results)
    # The cached forwards on this rank's shard and head subset.
    calls = kv_calls()
    params = lm_params_from_numpy(init, LM_SPEC, "cpu", tensor_parallel=SERVE_TP,
                                  tp_index=grid.tp_index)
    reduce_ = tp_allreduce(grid.tp_group)
    cache = host_cache(LM_SPEC, calls["slots"], calls["capacity"], tensor_parallel=SERVE_TP)
    for i, call in enumerate(calls["cached"]):
        logits, *_ = transformer.apply_lm_cached(
            params, torch.from_numpy(call["tokens"]), cache.k, cache.v, cache.pos, LM_SPEC,
            start=None, positions=torch.from_numpy(call["positions"]),
            rows=torch.from_numpy(call["rows"]), row_reduce=reduce_)
        results[f"kv/cached/{i}/logits"] = logits.numpy()
        for k, a in kv_cache_to_numpy(cache).items():
            results[f"kv/cached/{i}/{k}"] = a
    pool = host_paged_cache(LM_SPEC, calls["num_pages"], calls["page_size"],
                            tensor_parallel=SERVE_TP)
    for i, call in enumerate(calls["paged"]):
        table = torch.from_numpy(call["table"])
        flat = kv_cache.table_rows(table, torch.from_numpy(call["logical"]), calls["page_size"],
                                   calls["num_pages"])
        logits, *_ = transformer.apply_lm_paged(
            params, torch.from_numpy(call["tokens"]), pool.k, pool.v, pool.pos, table, LM_SPEC,
            positions=torch.from_numpy(call["positions"]), flat_rows=flat, row_reduce=reduce_)
        results[f"kv/paged/{i}/logits"] = logits.numpy()
        for k, a in kv_cache_to_numpy(pool).items():
            results[f"kv/paged/{i}/{k}"] = a
    results["tp_index"] = np.asarray(grid.tp_index)


@contextlib.contextmanager
def record_wire(log: list):
    """Append ``"fn:dtype:numel"`` to ``log`` for each gradient sum made
    through :data:`WIRE_FNS` while the block runs (the step bodies call
    them through the collectives module, where they are wrapped)."""
    saved = {n: getattr(coll, n) for n in WIRE_FNS}

    def wrap(name, fn):
        def call(t, *args, **kw):
            if t.numel() > 2:
                log.append(f"{name}:{str(t.dtype).removeprefix('torch.')}:{t.numel()}")
            return fn(t, *args, **kw)
        return call

    for n, fn in saved.items():
        setattr(coll, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(coll, n, fn)


def update_rel_diff(got, want, init) -> float:
    """``||got - want|| / ||want - init||`` over all leaves: how far two
    runs' parameter updates from one init part, relative to the update."""
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b)) ** 2))
              for a, b in zip(got, want, strict=True))
    den = sum(float(np.sum((np.asarray(b, np.float64) - np.asarray(c)) ** 2))
              for b, c in zip(want, init, strict=True))
    return math.sqrt(num / den)


def lm_case_config(kw: dict) -> dict:
    """A case's ``SeqConfig`` fields: LM_BASE with the case's, its ``spec``
    named by this module's attribute."""
    kw = dict(kw)
    if "spec" in kw:
        kw["spec"] = globals()[kw["spec"]]
    return {**LM_BASE, **kw}


def _init(data, key: str, spec):
    like = transformer.init_lm_params(torch.Generator().manual_seed(0), spec)
    return tree.unflatten(like, [data[f"{key}/{i}"] for i in range(len(tree.leaves(like)))])


def lm_world_cases(rank: int, world_size: int, store: str, inputs: str, out: str) -> None:
    """Every case of LM_CASES from the init in ``inputs`` (its leaves in
    ``utils.tree.leaves`` order; ``init4`` the 4-layer spec's): params (the
    full tree), span losses, the final loss and accuracy, this rank's Adam
    state (each field's leaves: moments by leaf, its ZeRO-1 chunk, or the
    hybrid's chunk and tp shards; a pipeline stage's moments), a pipeline
    rank's own shared leaves and saved-input peak, and the rank's wall time
    in seconds, and its gradient sums' inputs (:func:`record_wire`); then
    ``out + ".lm_done"`` marks the timed LM cases done, and the serve cases
    run (:func:`_serve_cases`)."""
    start = time.perf_counter()
    torch.set_num_threads(1)
    data = np.load(inputs)
    init = _init(data, "init", LM_SPEC)
    inits = {LM_SPEC.num_layers: init, LM_SPEC_4L.num_layers: _init(data, "init4", LM_SPEC_4L)}
    ds = synthesize_copy(**LM_DATA)
    world = init_world(world_size, rank, store, "cpu")
    results = {}
    try:
        for name, kw in LM_CASES.items():
            cfg = SeqConfig(**lm_case_config(kw))
            reg = MetricRegistry() if name in OBS_CASES else None
            with record_wire([]) as wire:
                trainer = SeqTrainer(cfg, ds, init=inits[cfg.spec.num_layers], world=world)
                res = trainer.train(log=lambda s: None, metrics=reg)
            results[f"{name}/wire"] = np.asarray(wire, dtype=str)
            if reg is not None:
                led = reg.gauge("collective_bytes")
                results[f"obs/{name}"] = np.asarray(
                    [reg.gauge("train_grad_norm").value(),
                     reg.counter("train_nonfinite_grads_total").value()]
                    + [led.value(kind=k, program="train_span[1]") or 0 for k in OBS_KINDS])
            if trainer.pipeline_record is not None:
                for k in ("embed", "head", "lnf_g", "lnf_b"):
                    results[f"{name}/shared/{k}"] = trainer.params[k].numpy()
                results[f"{name}/peak_saved"] = np.asarray(trainer.pipeline_record.peak_saved)
            for i, leaf in enumerate(tree.leaves(res.params)):
                results[f"{name}/p/{i}"] = leaf
            results[f"{name}/span_losses"] = np.asarray(res.span_losses)
            results[f"{name}/final"] = np.asarray([res.final_loss, res.final_accuracy])
            opt = trainer.opt_state
            results[f"{name}/step"] = np.asarray(int(opt.step))
            for f in dataclasses.fields(opt):
                if f.name != "step":
                    for i, leaf in enumerate(tree.leaves(getattr(opt, f.name))):
                        results[f"{name}/{f.name}/{i}"] = leaf.numpy()
        results["lm_seconds"] = np.asarray(time.perf_counter() - start)
        open(out + ".lm_done", "w").close()  # the parent's JAX side may start
        _serve_cases(world, init, results)
        _resilience_cases(world, inits, ds, inputs, results)
    finally:
        destroy_world()
    results["seconds"] = np.asarray(time.perf_counter() - start)
    np.savez(out, **results)
