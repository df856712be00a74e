"""The port's sequence-parallel LM trainer (ddl_tpu_torch/strategies/seq.py)
in ONE spawned 4-rank gloo world against JAX's ``SeqTrainer`` on the
virtual mesh (``make_mesh_2d(dp, W)`` over the first 4 of 8 CPU devices).

Cases (``tests/_torch_world.py::LM_CASES``, sp x dp): ring contiguous 4x1,
ring zigzag 4x1, Ulysses xla 4x1, Ulysses flash 4x1 (the port's plain flash
against JAX's off-TPU reference), ring zigzag 2x2, full 1x4, ZeRO-1 ring
4x1, ZeRO-1 Ulysses 2x2 and the zigzag ring 4x1 under ``remat``, at vocab
16, d_model 32, 4 heads, 2 layers, d_ff 64, T 32, batch 8, 2 steps from one
numpy init (JAX's). The JAX side runs each config's span program (k = 1)
twice while the children run.

Tolerances: those ``tests/test_torch_seq.py`` holds the one-device LM to.
Parameters and Adam moments within atol 2e-5 / rtol 1e-3 (the two sides
run the same fp32 math in another order, and Adam moves each parameter by
about lr whatever the gradient's size); span and final losses within rtol
1e-4. ZeRO-1 moments go through ``convert.lm_sharded_adam_{to,from}_numpy``.
"""

import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.models import transformer as jt
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu_torch.convert import lm_sharded_adam_from_numpy, lm_sharded_adam_to_numpy
from ddl_tpu_torch.ops.optimizers import ShardedAdam
from ddl_tpu_torch.utils import tree

import _torch_world

W = 4
ATOL, RTOL = 2e-5, 1e-3
LOSS_RTOL = 1e-4
STEPS = 2


def _jax_case(kw, jds):
    """Two steps of JAX's span program for one case: (params, the
    params-shaped Adam state, the per-step losses)."""
    cfg = JSeqConfig(**{**_torch_world.LM_BASE, "spec": jt.LMSpec(
        **vars(_torch_world.LM_SPEC))}, **kw)
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
    init = jax.tree.map(np.asarray, jt.init_lm_params(
        jax.random.PRNGKey(_torch_world.LM_BASE["seed"]), spec))
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **{f"init/{i}": a for i, a in enumerate(jax.tree.leaves(init))})
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_torch_world.lm_world_cases, args=(
        r, W, f"file://{tmp / 'store'}", str(inputs), str(tmp / f"rank{r}.npz")))
        for r in range(W)]
    for pr in procs:
        pr.start()

    jds = j_synthesize_copy(**_torch_world.LM_DATA)
    want = {name: _jax_case(kw, jds) for name, kw in _torch_world.LM_CASES.items()}

    for pr in procs:
        pr.join(timeout=180)
        assert not pr.is_alive() and pr.exitcode == 0, f"rank exit code {pr.exitcode}"
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]
    return got, want


def _leaves(rank, name, what):
    n = len([k for k in rank if k.startswith(f"{name}/{what}/")])
    return [rank[f"{name}/{what}/{i}"] for i in range(n)]


@pytest.mark.parametrize("name", list(_torch_world.LM_CASES))
def test_four_rank_lm_world_matches_jax(name, lm_world):
    """Every rank's params, span losses and final loss, and the Adam moments
    (replicated: every rank's; ZeRO-1: each rank's chunk and the logical
    trees put together from all four), match JAX's SeqTrainer."""
    got, want = lm_world
    jparams, jopt, jlosses = want[name]
    zero1 = _torch_world.LM_CASES[name].get("zero1", False)
    spec = _torch_world.LM_SPEC
    for r, rank in enumerate(got):
        for a, b in zip(_leaves(rank, name, "p"), jax.tree.leaves(jparams), strict=True):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"rank {r} {name}")
        np.testing.assert_allclose(rank[f"{name}/span_losses"], jlosses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(rank[f"{name}/final"][0], jlosses[-1], rtol=LOSS_RTOL)
        assert int(rank[f"{name}/step"]) == STEPS
        if zero1:
            mine = lm_sharded_adam_from_numpy(jopt.step, jopt.m, jopt.v, spec, r, W, "cpu")
            np.testing.assert_allclose(rank[f"{name}/m/0"], mine.m.numpy(), atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(rank[f"{name}/v/0"], mine.v.numpy(), atol=ATOL, rtol=RTOL)
        else:
            for k in ("m", "v"):
                for a, b in zip(_leaves(rank, name, k), jax.tree.leaves(getattr(jopt, k)),
                                strict=True):
                    np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                               err_msg=f"rank {r} {name} {k}")
    if zero1:
        states = [ShardedAdam(step=torch.tensor(int(rank[f"{name}/step"])),
                              m=torch.as_tensor(rank[f"{name}/m/0"]),
                              v=torch.as_tensor(rank[f"{name}/v/0"])) for rank in got]
        logical = lm_sharded_adam_to_numpy(states, spec)
        assert int(logical["step"]) == int(jopt.step) == STEPS
        for k in ("m", "v"):
            for a, b in zip(tree.leaves(logical[k]), jax.tree.leaves(getattr(jopt, k)),
                            strict=True):
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=f"{name} {k}")


def test_four_rank_lm_world_ranks_agree_and_finish_in_time(lm_world):
    """Every rank ends with the same params, losses and accuracy (they are
    replicated), and each rank runs every case in under 30 s."""
    got, _ = lm_world
    for name in _torch_world.LM_CASES:
        for rank in got[1:]:
            for a, b in zip(_leaves(rank, name, "p"), _leaves(got[0], name, "p")):
                np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(rank[f"{name}/final"], got[0][f"{name}/final"])
    seconds = max(float(rank["seconds"]) for rank in got)
    assert seconds < 30, f"the 4-rank world took {seconds:.1f} s"
