"""The port's sequence- and tensor-parallel LM (ddl_tpu_torch/strategies/seq.py,
serve/engine.py) in ONE spawned 4-rank gloo world against JAX's
``SeqTrainer`` on the virtual mesh (``make_mesh_2d(dp, W)``, or
``make_mesh_3d(dp, W, tp)`` at tp > 1, over the first 4 of 8 CPU devices)
and JAX's tp-2 serving.

Training cases (``tests/_torch_world.py::LM_CASES``, sp x dp x tp): ring
contiguous 4x1x1, ring zigzag 4x1x1, Ulysses xla 4x1x1, Ulysses flash
4x1x1 (the port's plain flash against JAX's off-TPU reference), ring
zigzag 2x2x1, full 1x4x1, ZeRO-1 ring 4x1x1, ZeRO-1 Ulysses 2x2x1, the
zigzag ring 4x1x1 under ``remat``; tensor parallel: full 1x1x4, Ulysses
flash 2x1x2, zigzag ring 2x1x2, full 1x2x2, and the hybrid ZeRO-1 x tp at
full 1x2x2 and ring 2x1x2; pipeline parallel (dp x tp x pp, scheme full,
JAX's ``make_mesh_4d``): GPipe 2x1x2 and 1F1B 2x1x2 at 2 microbatches,
1F1B + flash 1x2x2 at 2, and 1F1B 1x1x4 at 4 microbatches on a 4-layer
variant of the spec; under ``precision="bf16"`` (bf16 gradient sums)
Ulysses + flash 4x1x1 (the replicated body), ZeRO-1 Ulysses 2x2x1, the
hybrid at full 1x2x2 and GPipe 2x1x2 (bf16 hops); and two cases under
``precision="fp32"``, each bitwise its ``precision=None`` twin; at vocab 16, d_model 32, 4 heads, 2 layers, d_ff 64,
T 32, batch 8, 2 steps from one numpy init (JAX's). The JAX side runs each
config's span program (k = 1) twice once the children's timed LM cases
are done, while they serve.

Tolerances: those ``tests/test_torch_seq.py`` holds the one-device LM to.
Parameters and Adam moments within atol 2e-5 / rtol 1e-3 (the two sides
run the same fp32 math in another order, and Adam moves each parameter by
about lr whatever the gradient's size); span and final losses within rtol
1e-4. The bf16 cases are held to tests/test_torch_precision.py's bf16
tolerances: the parameter updates from the init in norm,
||Δa - Δb|| <= 0.2 ||Δb|| (measured 0.074 at most), losses within rtol
1e-2, and the moments, which carry each side's bf16 rounding of the
gradients, in norm: ||a - b|| <= 0.1 ||b||. Each bf16 case's gradient
sums take bfloat16 inputs where its fp32 twin's take float32 ones
(``_torch_world.BF16_TWINS``). ZeRO-1 moments go through ``convert.lm_sharded_adam_{to,from}_numpy``,
the hybrid's through ``convert.lm_hybrid_adam_{to,from}_numpy`` (JAX's
``_opt_for_save`` form), the tp shards' through
``convert.lm_params_to_numpy``, a pipeline's stages' through
``convert.lm_pipeline_adam_to_numpy``. A pipeline's stage-replicated leaves
are bitwise equal on its pp ranks, and each rank's peak of saved stage
inputs is its tick-table row's.

Serving: the same world as two tp-2 groups ({0, 1} and {2, 3}), each held
to JAX's ``Scheduler.run`` at ``tensor_parallel=2`` (contiguous greedy,
paged sampled: tokens, ``admitted_step``, ``finished_step``, ``status``
and the ``ServeStats`` counters equal; greedy steps' top-2 margins above
1e-5 so a near-tie fails loudly; in bf16, ``compute_dtype="bfloat16"``,
tokens equal up to the first near-tie: a first difference only at a
top-2 margin below 0.0625 on either side, as tests/test_torch_precision.py
holds tp-1 bf16 serving), and to JAX's ``apply_lm_cached`` and
``apply_lm_paged`` under ``shard_map`` on a 2-device tp mesh, call by call:
logits within atol 1e-5 (the cached logits' tolerance of
tests/test_torch_kv_cache.py), each rank's local-head k/v within atol 1e-6
+ rtol 1e-5, positions exact.
"""

import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.data.lm import synthesize_prompts as j_synthesize_prompts
from ddl_tpu.models import transformer as jt
from ddl_tpu.models.partition import lm_param_specs as j_lm_param_specs
from ddl_tpu.ops import kv_cache as jkv
from ddl_tpu.parallel import collectives as jcoll
from ddl_tpu.parallel.mesh import TP_AXIS, make_mesh
from ddl_tpu.serve import InferenceEngine as JEngine
from ddl_tpu.serve import Request as JRequest
from ddl_tpu.serve import Scheduler as JScheduler
from ddl_tpu.serve import ServeConfig as JServeConfig
from ddl_tpu.serve import cache as jcache
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu_torch.convert import (
    lm_hybrid_adam_from_numpy,
    lm_hybrid_adam_to_numpy,
    lm_params_to_numpy,
    lm_pipeline_adam_to_numpy,
    lm_sharded_adam_from_numpy,
    lm_sharded_adam_to_numpy,
)
from ddl_tpu_torch.models import partition
from ddl_tpu_torch.ops.optimizers import AdamState, ShardedAdam
from ddl_tpu_torch.pipeline import schedule_tables
from ddl_tpu_torch.strategies.seq import HybridAdam
from ddl_tpu_torch.utils import tree

import _torch_world

W = 4
ATOL, RTOL = 2e-5, 1e-3
LOSS_RTOL = 1e-4
STEPS = 2
MARGIN = 1e-5
# bf16 cases (tests/test_torch_precision.py): loss rtol, moments' norm
# tolerance, and the top-2 margin under which a token may flip.
BF16_LOSS_RTOL, BF16_MOMENT_NORM_RTOL, BF16_NEAR_TIE = 1e-2, 0.1, 0.0625
BF16_UPDATE_REL = 0.2  # ||Δa - Δb|| / ||Δb|| of the updates; measured 0.074 at most
LOGITS_ATOL = 1e-5
CACHE_ATOL, CACHE_RTOL = 1e-6, 1e-5


def _jax_case(kw, jds):
    """Two steps of JAX's span program for one case: (params, the
    params-shaped Adam state, the per-step losses)."""
    cfg = _torch_world.lm_case_config(kw)
    cfg = JSeqConfig(**{**cfg, "spec": jt.LMSpec(**vars(cfg["spec"]))})
    trainer = JSeqTrainer(cfg, jds)
    bs = cfg.batch_size
    xs, ys, ws = (trainer.stage_batches(a, STEPS, bs)
                  for a in (jds.tokens, jds.targets, jds.weights))
    run = trainer.span_program(1)
    p, o = trainer.params, trainer.opt_state
    losses = []
    for i in range(STEPS):
        p, o, loss = run(p, o, xs, ys, ws, jnp.int32(i))
        losses.append(float(loss))
    return (jax.tree.map(np.asarray, trainer._result_params(p)),
            jax.tree.map(np.asarray, trainer._opt_for_save(o)), losses)


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    """Every rank's results of every LM case, and JAX's."""
    tmp = tmp_path_factory.mktemp("lm_world")
    spec = jt.LMSpec(**vars(_torch_world.LM_SPEC))
    key = jax.random.PRNGKey(_torch_world.LM_BASE["seed"])
    init = jax.tree.map(np.asarray, jt.init_lm_params(key, spec))
    init4 = jax.tree.map(np.asarray, jt.init_lm_params(key, jt.LMSpec(
        **vars(_torch_world.LM_SPEC_4L))))
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{f"init/{i}": a for i, a in enumerate(jax.tree.leaves(init))},
             **{f"init4/{i}": a for i, a in enumerate(jax.tree.leaves(init4))})
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_torch_world.lm_world_cases, args=(
        r, W, f"file://{tmp / 'store'}", str(inputs), str(tmp / f"rank{r}.npz")))
        for r in range(W)]
    for pr in procs:
        pr.start()
    # The ranks' LM cases are timed (test_four_rank_lm_world_ranks_agree_and_
    # finish_in_time): the JAX side waits for them, then runs beside the
    # ranks' serve cases.
    deadline = time.monotonic() + 240
    while not all((tmp / f"rank{r}.npz.lm_done").exists() for r in range(W)):
        assert all(pr.is_alive() or pr.exitcode == 0 for pr in procs), [
            pr.exitcode for pr in procs]
        assert time.monotonic() < deadline, "the ranks' LM cases did not finish"
        time.sleep(0.05)

    jds = j_synthesize_copy(**_torch_world.LM_DATA)
    want = {name: _jax_case(kw, jds) for name, kw in _torch_world.LM_CASES.items()}
    want["serve"] = {name: _jax_serve(init, kw) for name, kw in _torch_world.SERVE_CASES.items()}
    want["kv"] = _jax_kv(init)
    want["init"] = {spec.num_layers: jax.tree.leaves(init),
                    _torch_world.LM_SPEC_4L.num_layers: jax.tree.leaves(init4)}

    for pr in procs:
        pr.join(timeout=240)
        assert not pr.is_alive() and pr.exitcode == 0, f"rank exit code {pr.exitcode}"
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]
    return got, want


def _jax_serve(init, kw):
    """JAX's ``Scheduler.run`` at tp 2 on the LM's spec and init, and each
    request's top-2 margins."""
    spec = jt.LMSpec(**vars(_torch_world.LM_SPEC))
    eng = JEngine(JServeConfig(spec=spec, tensor_parallel=_torch_world.SERVE_TP, **kw),
                  params=init)
    margins = _torch_world.record_margins(eng)
    prompts = j_synthesize_prompts(**_torch_world.SERVE_PROMPTS)
    done, stats = JScheduler(eng).run([JRequest(id=i, prompt=p,
                                                max_new_tokens=_torch_world.SERVE_NEW)
                                       for i, p in enumerate(prompts)])
    return done, stats, margins


def _jax_kv(init):
    """JAX's cached and paged forwards at tp 2 (``shard_map`` over a 2-device
    tp mesh, the head dim of the caches sharded, ``tp_allreduce`` as
    ``row_reduce``, as JAX's engine runs them): each call's logits and
    whole caches."""
    spec = jt.LMSpec(**vars(_torch_world.LM_SPEC))
    tp = _torch_world.SERVE_TP
    mesh = make_mesh(tp, axis=TP_AXIS)
    kv = P(None, None, None, TP_AXIS, None)
    hooks = dict(spec=spec, row_reduce=jcoll.tp_allreduce(TP_AXIS))

    def sharded(fn, n_rest):
        return jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(j_lm_param_specs(spec, tp), kv, kv, P()) + (P(),) * n_rest,
            out_specs=(P(), kv, kv, P()), check_vma=False))

    calls = _torch_world.kv_calls()
    cached = sharded(lambda p, k, v, pos, tok, positions, rows: jt.apply_lm_cached(
        p, tok, k, v, pos, start=jnp.zeros(tok.shape[0], jnp.int32), positions=positions,
        rows=rows, **hooks), 3)
    c = jcache.host_cache(spec, calls["slots"], calls["capacity"])
    state, out = (c.k, c.v, c.pos), {"cached": [], "paged": []}
    for call in calls["cached"]:
        res = cached(init, *state, call["tokens"], call["positions"], call["rows"])
        state = res[1:]
        out["cached"].append(jax.tree.map(np.asarray, res))
    paged = sharded(lambda p, k, v, pos, tok, table, positions, flat: jt.apply_lm_paged(
        p, tok, k, v, pos, table, positions=positions, flat_rows=flat, **hooks), 4)
    c = jcache.host_paged_cache(spec, calls["num_pages"], calls["page_size"])
    state = (c.k, c.v, c.pos)
    for call in calls["paged"]:
        flat = jkv.table_rows(jnp.asarray(call["table"]), jnp.asarray(call["logical"]),
                              calls["page_size"], calls["num_pages"])
        res = paged(init, *state, call["tokens"], call["table"], call["positions"], flat)
        state = res[1:]
        out["paged"].append(jax.tree.map(np.asarray, res))
    return out


def _leaves(rank, name, what):
    n = len([k for k in rank if k.startswith(f"{name}/{what}/")])
    return [rank[f"{name}/{what}/{i}"] for i in range(n)]


def _tree(leaves, like):
    return tree.unflatten(like, [np.asarray(x) for x in leaves])


@pytest.mark.parametrize("name", list(_torch_world.LM_CASES))
def test_four_rank_lm_world_matches_jax(name, lm_world):
    """Every rank's params, span losses and final loss, and the Adam moments
    (replicated: every rank's; ZeRO-1: each rank's chunk and the logical
    trees put together from all four; tp: every tp group's shards put
    together; the hybrid: each rank's state and the logical trees; a
    pipeline: every (dp, sp) cell's stages and tp shards put together),
    match JAX's SeqTrainer."""
    got, want = lm_world
    jparams, jopt, jlosses = want[name]
    kw = _torch_world.LM_CASES[name]
    bf16 = kw.get("precision") == "bf16"
    loss_rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL

    def close(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        if not bf16:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=what)
        else:
            err = np.linalg.norm(a - b)
            assert err <= BF16_MOMENT_NORM_RTOL * np.linalg.norm(b), (what, err)

    zero1, tp = kw.get("zero1", False), kw.get("tensor_parallel", 1)
    pp = kw.get("pipeline_parallel", 1)
    spec = _torch_world.lm_case_config(kw)["spec"]
    for r, rank in enumerate(got):
        mine, theirs = _leaves(rank, name, "p"), jax.tree.leaves(jparams)
        if bf16:
            rel = _torch_world.update_rel_diff(mine, theirs, want["init"][spec.num_layers])
            assert rel <= BF16_UPDATE_REL, (r, name, rel)
        else:
            for a, b in zip(mine, theirs, strict=True):
                close(a, b, f"rank {r} {name}")
        np.testing.assert_allclose(rank[f"{name}/span_losses"], jlosses, rtol=loss_rtol)
        np.testing.assert_allclose(rank[f"{name}/final"][0], jlosses[-1], rtol=loss_rtol)
        assert int(rank[f"{name}/step"]) == STEPS
        if zero1 and tp > 1:
            mine = lm_hybrid_adam_from_numpy(jopt.step, jopt.m, jopt.v, spec, r,
                                             tensor_parallel=tp, data_ranks=W // tp, device="cpu")
            for k in ("m_flat", "v_flat", "m_tp", "v_tp"):
                for a, b in zip(_leaves(rank, name, k), tree.leaves(getattr(mine, k)),
                                strict=True):
                    close(a, b.numpy(), f"rank {r} {name} {k}")
        elif zero1:
            mine = lm_sharded_adam_from_numpy(jopt.step, jopt.m, jopt.v, spec, r, W, "cpu")
            close(rank[f"{name}/m/0"], mine.m.numpy(), f"rank {r} {name} m")
            close(rank[f"{name}/v/0"], mine.v.numpy(), f"rank {r} {name} v")
        elif tp == 1 and pp == 1:
            for k in ("m", "v"):
                for a, b in zip(_leaves(rank, name, k), jax.tree.leaves(getattr(jopt, k)),
                                strict=True):
                    close(a, b, f"rank {r} {name} {k}")
    if zero1 and tp > 1:
        states = [HybridAdam(step=torch.tensor(int(rank[f"{name}/step"])),
                             **{k: [torch.as_tensor(x) for x in _leaves(rank, name, k)]
                                for k in ("m_tp", "v_tp")},
                             **{k: torch.as_tensor(rank[f"{name}/{k}/0"])
                                for k in ("m_flat", "v_flat")}) for rank in got]
        logical = lm_hybrid_adam_to_numpy(states, spec, tensor_parallel=tp)
    elif zero1:
        states = [ShardedAdam(step=torch.tensor(int(rank[f"{name}/step"])),
                              m=torch.as_tensor(rank[f"{name}/m/0"]),
                              v=torch.as_tensor(rank[f"{name}/v/0"])) for rank in got]
        logical = lm_sharded_adam_to_numpy(states, spec)
    if zero1:
        assert int(logical["step"]) == int(jopt.step) == STEPS
        for k in ("m", "v"):
            for a, b in zip(tree.leaves(logical[k]), jax.tree.leaves(getattr(jopt, k)),
                            strict=True):
                close(a, b, f"{name} {k}")
    elif pp > 1:
        # Each (dp, sp) cell's ranks: rank t * pp + p of it holds tp shard
        # t of stage p.
        full = jax.tree.map(np.asarray, want[name][0])
        n = tp * pp
        for cell in range(W // n):
            states = []
            for i in range(n):
                like = partition.shard_stage_params(full, spec, pp, i % pp, tp, i // pp)
                rank = got[cell * n + i]
                states.append(AdamState(step=torch.tensor(int(rank[f"{name}/step"])), **{
                    k: tree.map(torch.as_tensor, _tree(_leaves(rank, name, k), like))
                    for k in ("m", "v")}))
            logical = lm_pipeline_adam_to_numpy(states, spec, pipeline_parallel=pp,
                                                tensor_parallel=tp)
            assert int(logical["step"]) == int(jopt.step) == STEPS
            for k in ("m", "v"):
                for a, b in zip(tree.leaves(logical[k]), jax.tree.leaves(getattr(jopt, k)),
                                strict=True):
                    close(a, b, f"{name} cell {cell} {k}")
    elif tp > 1:
        # Each (dp, sp) cell's tp group: its ranks' shards put together.
        specs = partition.lm_param_specs(spec, tp)
        full = jax.tree.map(np.asarray, want[name][0])
        like = partition.shard_lm_params(tree.map(np.asarray, full), specs, tp, 0)
        for cell in range(W // tp):
            for k in ("m", "v"):
                shards = [tree.map(torch.as_tensor, _tree(_leaves(got[cell * tp + t], name, k),
                                                          like)) for t in range(tp)]
                logical = partition.gather_lm_params([lm_params_to_numpy(s) for s in shards],
                                                     specs)
                for a, b in zip(tree.leaves(logical), jax.tree.leaves(getattr(jopt, k)),
                                strict=True):
                    close(a, b, f"{name} cell {cell} {k}")


@pytest.mark.parametrize("name", list(_torch_world.BF16_TWINS))
def test_four_rank_bf16_gradient_sums_move_bf16(name, lm_world):
    """Every gradient sum of a bf16 case takes a bfloat16 input at each of
    its sites (``BF16_TWINS``), and its fp32 twin makes the same sums, of
    the same sizes in the same order, in float32: the policy's casts
    bracket each sum, and nothing upcasts on the wire."""
    got, _ = lm_world
    twin, fns = _torch_world.BF16_TWINS[name]
    for r, rank in enumerate(got):
        mine = [w.split(":") for w in rank[f"{name}/wire"].tolist()]
        theirs = [w.split(":") for w in rank[f"{twin}/wire"].tolist()]
        assert {f for f, _, _ in mine} == fns, (r, mine)
        assert {d for _, d, _ in mine} == {"bfloat16"}, (r, mine)
        assert {d for _, d, _ in theirs} == {"float32"}, (r, theirs)
        assert [(f, n) for f, _, n in mine] == [(f, n) for f, _, n in theirs], r


@pytest.mark.parametrize("name", list(_torch_world.SERVE_CASES))
def test_four_rank_world_serves_at_tp2_as_jax(name, lm_world):
    """Both tp-2 groups of the world serve every request as JAX's scheduler
    at tp 2 does: tokens, steps, statuses and counters; each rank holds half
    the heads."""
    got, want = lm_world
    jdone, jstats, jmargins = want["serve"][name]
    key = f"serve/{name}"
    kw = _torch_world.SERVE_CASES[name]
    bf16 = kw.get("compute_dtype") == "bfloat16"
    for r, rank in enumerate(got):
        assert int(rank[f"{key}/local_heads"]) == _torch_world.LM_SPEC.num_heads // 2
        assert str(rank[f"{key}/pool_dtype"]) == ("torch.bfloat16" if bf16 else "torch.float32")
        for i, j in jdone.items():
            tokens = rank[f"{key}/{i}/tokens"].tolist()
            if bf16 and tokens != j.tokens:
                step = next(k for k, (x, y) in enumerate(zip(tokens, j.tokens)) if x != y)
                near = min(rank[f"{key}/{i}/margins"][step], jmargins[i][step])
                assert near < BF16_NEAR_TIE, (r, i, step, near)
            else:
                assert tokens == j.tokens, (r, i)
            assert rank[f"{key}/{i}/steps"].tolist() == [j.admitted_step, j.finished_step]
            assert str(rank[f"{key}/{i}/status"]) == j.status
        assert rank[f"{key}/stats"].tolist() == [getattr(jstats, f)
                                                 for f in _torch_world.SERVE_STATS]
        if kw.get("temperature", 0.0) == 0.0 and not bf16:
            margins = np.concatenate([rank[f"{key}/{i}/margins"] for i in jdone])
            assert margins.size and margins.min() > MARGIN, margins.min()


@pytest.mark.parametrize("kind", ["cached", "paged"])
def test_four_rank_world_cached_forwards_at_tp2_match_jax(kind, lm_world):
    """Every rank's cached (or paged) forward at tp 2, call by call: logits
    and its own heads' k/v against JAX's sharded forward."""
    got, want = lm_world
    h = _torch_world.LM_SPEC.num_heads // _torch_world.SERVE_TP
    calls = _torch_world.kv_calls()[kind]
    for r, rank in enumerate(got):
        t = int(rank["tp_index"])
        for i, (call, res) in enumerate(zip(calls, want["kv"][kind], strict=True)):
            logits, k, v, pos = res
            valid = call["positions"] != 2**31 - 1  # PAD_POS rows: nothing attended
            np.testing.assert_allclose(rank[f"kv/{kind}/{i}/logits"][valid], logits[valid],
                                       atol=LOGITS_ATOL, err_msg=f"rank {r} call {i}")
            for name, full in (("k", k), ("v", v)):
                np.testing.assert_allclose(rank[f"kv/{kind}/{i}/{name}"],
                                           full[..., t * h:(t + 1) * h, :], atol=CACHE_ATOL,
                                           rtol=CACHE_RTOL, err_msg=f"rank {r} call {i} {name}")
            np.testing.assert_array_equal(rank[f"kv/{kind}/{i}/pos"], pos)


def test_four_rank_lm_world_ranks_agree_and_finish_in_time(lm_world):
    """Every rank ends with the same params, losses and accuracy (they are
    replicated, or at tp > 1 gathered over the tp group), and each rank runs
    every training case in under 30 s."""
    got, _ = lm_world
    for name in _torch_world.LM_CASES:
        for rank in got[1:]:
            for a, b in zip(_leaves(rank, name, "p"), _leaves(got[0], name, "p")):
                np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(rank[f"{name}/final"], got[0][f"{name}/final"])
    seconds = max(float(rank["lm_seconds"]) for rank in got)
    assert seconds < 30, f"the 4-rank world took {seconds:.1f} s"


@pytest.mark.parametrize("name", list(_torch_world.FP32_TWINS))
def test_four_rank_fp32_policy_is_bitwise_the_default(name, lm_world):
    """``precision="fp32"`` gives every rank the same bits as its
    ``precision=None`` twin: params, losses and the optimizer state (the
    policy's hooks are the identity off bf16)."""
    got, _ = lm_world
    twin = _torch_world.FP32_TWINS[name]
    for rank in got:
        ours = sorted(k for k in rank if k.startswith(f"{name}/"))
        theirs = sorted(k for k in rank if k.startswith(f"{twin}/"))
        assert [k[len(name):] for k in ours] == [k[len(twin):] for k in theirs]
        for k in ours:
            np.testing.assert_array_equal(rank[k], rank[twin + k[len(name):]], err_msg=k)


@pytest.mark.parametrize("name", [n for n, kw in _torch_world.LM_CASES.items()
                                  if kw.get("pipeline_parallel", 1) > 1])
def test_four_rank_pipeline_ranks_share_leaves_and_hold_their_row(name, lm_world):
    """A pipeline's stage-replicated leaves (embed, head, the final
    LayerNorm) are bitwise equal on every rank, and each rank's peak of
    saved stage inputs is what its row of the tick tables implies (GPipe:
    M on every stage; 1F1B: min(pp - s, M))."""
    got, _ = lm_world
    kw = _torch_world.LM_CASES[name]
    pp, m = kw["pipeline_parallel"], kw["microbatches"]
    f_tab, b_tab = schedule_tables(kw.get("pipeline_schedule", "gpipe"), pp, m)
    for r, rank in enumerate(got):
        for k in ("embed", "head", "lnf_g", "lnf_b"):
            np.testing.assert_array_equal(rank[f"{name}/shared/{k}"], got[0][f"{name}/shared/{k}"],
                                          err_msg=f"rank {r} {name} {k}")
        s = r % pp
        live = [int(sum(f_tab[s, :t + 1] >= 0) - sum(b_tab[s, :t] >= 0))
                for t in range(f_tab.shape[1])]
        assert int(rank[f"{name}/peak_saved"]) == max(live), (r, name)
