"""Workers of the spawned gloo worlds: the 2-rank CNN world of
tests/test_torch_sync.py (:func:`world_cases`) and the 4-rank LM world of
tests/test_torch_seq_parallel.py (:func:`lm_world_cases`: training on the
3-D grid and the pipeline's 4-D one, then tp-2 serving as two tp groups of
two ranks).

Kept apart from the test modules so the spawned children import only
``torch`` and ``ddl_tpu_torch`` (never JAX): ``multiprocessing`` imports this
module, not the test file, to find the target.
"""

import contextlib
import dataclasses
import math
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
from ddl_tpu_torch.parallel import collectives as coll
from ddl_tpu_torch.parallel.collectives import tp_allreduce, unflatten_params
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world, make_grid
from ddl_tpu_torch.ops.optimizers import adam_init
from ddl_tpu_torch.serve import InferenceEngine, Request, Scheduler, ServeConfig
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
}
SERVE_PROMPTS = dict(num=6, min_len=3, max_len=20, vocab=16, seed=0)
SERVE_NEW = 8
SERVE_STATS = ("prefill_tokens", "decode_steps", "decode_tokens", "prefix_lookups",
               "prefix_hits", "prefill_tokens_saved")


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
        done, stats = Scheduler(eng).run(
            [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
        key = f"serve/{name}"
        for i, c in done.items():
            results[f"{key}/{i}/tokens"] = np.asarray(c.tokens, np.int64)
            results[f"{key}/{i}/steps"] = np.asarray([c.admitted_step, c.finished_step])
            results[f"{key}/{i}/status"] = np.asarray(c.status)
            results[f"{key}/{i}/margins"] = np.asarray(margins[i])
        results[f"{key}/stats"] = np.asarray([getattr(stats, f) for f in SERVE_STATS])
        results[f"{key}/pool_dtype"] = np.asarray(str(eng.cache.k.dtype))
        results[f"{key}/local_heads"] = np.asarray(eng.cache.k.shape[3])
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
            with record_wire([]) as wire:
                trainer = SeqTrainer(cfg, ds, init=inits[cfg.spec.num_layers], world=world)
                res = trainer.train(log=lambda s: None)
            results[f"{name}/wire"] = np.asarray(wire, dtype=str)
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
    finally:
        destroy_world()
    results["seconds"] = np.asarray(time.perf_counter() - start)
    np.savez(out, **results)
