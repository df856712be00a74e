"""The port's pipeline parallelism (ddl_tpu_torch/pipeline, the stage split in
models/partition.py, the 4-D grid in parallel/mesh.py) against the JAX
package, without a spawned world:

- the schedule tables, ``max_in_flight``, ``buffer_slots``,
  ``bubble_fraction`` and ``predicted_bubble`` identical to JAX's;
- ``StagePartition``, ``pipeline_param_specs``, ``stack_blocks`` and
  ``unstack_blocks`` as JAX's, and each rank's stage
  (``shard_stage_params``) what JAX's ``NamedSharding`` places on its
  device of ``make_mesh_4d``;
- the grid's rank <-> (dp, sp, tp, pp) mapping as ``make_mesh_4d``'s device
  order, and at pp 1 the 3-D grid's groups, made by the same ``new_group``
  calls in the same order;
- ``SeqConfig.validate_topology``'s error texts as JAX's;
- the conversions of a stage's params and Adam moments, round trips;
- the pipeline step itself on one rank (pp 1, one or two microbatches,
  which ``make_pipeline_program`` builds past the topology checks; also
  under ``remat``) against
  JAX's ``make_pipeline_program`` from one init: parameters within atol
  2e-5 / rtol 1e-3 and the loss within rtol 1e-4 (the LM parity tolerances
  of tests/test_torch_seq.py).

Exact elsewhere: tables, slicing and gathering move integers and bits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ddl_tpu.models import partition as jpart
from ddl_tpu.models import transformer as jt
from ddl_tpu.parallel.mesh import make_mesh_4d
from ddl_tpu.pipeline import schedule as jsched
from ddl_tpu.pipeline.trainer import make_pipeline_program as j_make_pipeline_program
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig
from ddl_tpu_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_pipeline_adam_from_numpy,
    lm_pipeline_adam_to_numpy,
)
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.models import partition
from ddl_tpu_torch.models.transformer import LMSpec, TINY_SPEC
from ddl_tpu_torch.parallel import mesh
from ddl_tpu_torch.parallel.mesh import LOCAL, Grid, World, make_grid
from ddl_tpu_torch.pipeline import make_pipeline_program, schedule
from ddl_tpu_torch.strategies.seq import SeqConfig
from ddl_tpu_torch.utils import tree

SPEC_KW = dict(vocab=16, d_model=32, num_heads=4, num_layers=4, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)
ATOL, RTOL = 2e-5, 1e-3
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def full():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(3), JSPEC))


@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
@pytest.mark.parametrize("pp,m", [(2, 1), (2, 4), (4, 2), (4, 8), (3, 5)])
def test_schedules_are_jax_tables(kind, pp, m):
    """The tick tables and every number derived from them equal JAX's."""
    f_tab, b_tab = schedule.schedule_tables(kind, pp, m)
    jf, jb = jsched.schedule_tables(kind, pp, m)
    assert f_tab.dtype == jf.dtype and b_tab.dtype == jb.dtype
    np.testing.assert_array_equal(f_tab, jf)
    np.testing.assert_array_equal(b_tab, jb)
    assert schedule.max_in_flight(f_tab, b_tab) == jsched.max_in_flight(jf, jb)
    assert schedule.buffer_slots(f_tab, b_tab) == jsched.buffer_slots(jf, jb)
    assert schedule.bubble_fraction(f_tab, b_tab) == jsched.bubble_fraction(jf, jb)
    assert schedule.predicted_bubble(pp, m) == jsched.predicted_bubble(pp, m)
    assert schedule.IDLE == jsched.IDLE and schedule.SCHEDULES == jsched.SCHEDULES


@pytest.mark.parametrize("call", [
    lambda s: s.schedule_tables("zigzag", 2, 2),
    lambda s: s.gpipe_tables(0, 2),
    lambda s: s.one_f1b_tables(2, 0),
    lambda s: s.predicted_bubble(1, 0),
])
def test_schedule_errors_are_jax_texts(call):
    with pytest.raises(ValueError) as ours:
        call(schedule)
    with pytest.raises(ValueError) as theirs:
        call(jsched)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_stage_partition_and_placement_are_jax(full, pp, tp):
    """The stage split, the stacked form's specs and its stack/unstack
    equal JAX's, and rank (tp t, pp p)'s stage, stacked, is what JAX's
    ``NamedSharding`` over ``make_mesh_4d(1, 1, tp, pp)`` places on mesh
    position (0, 0, t, p)."""
    ours, theirs = partition.stage_partition(TSPEC, pp), jpart.stage_partition(JSPEC, pp)
    assert (ours.num_layers, ours.pp, ours.layers_per_stage) == (
        theirs.num_layers, theirs.pp, theirs.layers_per_stage)
    assert [list(ours.stage_layers(s)) for s in range(pp)] == [
        list(theirs.stage_layers(s)) for s in range(pp)]
    jspecs = jpart.pipeline_param_specs(JSPEC, pp, tp)
    specs = partition.pipeline_param_specs(TSPEC, pp, tp)
    assert specs.keys() == jspecs.keys() and specs["blocks"].keys() == jspecs["blocks"].keys()
    for k, spec in specs.items():
        want = jspecs[k]
        assert (spec == {n: tuple(p) for n, p in want.items()} if k == "blocks"
                else spec == tuple(want)), k
    stacked, jstacked = partition.stack_blocks(full), jpart.stack_blocks(full)
    for a, b in zip(tree.leaves(stacked), jax.tree.leaves(jstacked), strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree.leaves(partition.unstack_blocks(stacked)),
                    jax.tree.leaves(jpart.unstack_blocks(jstacked)), strict=True):
        np.testing.assert_array_equal(a, b)
    mesh4 = make_mesh_4d(1, 1, tp, pp)
    placed = jax.tree.map(lambda a, p: jax.device_put(a, NamedSharding(mesh4, p)), jstacked,
                          jspecs, is_leaf=lambda x: isinstance(x, np.ndarray))
    for t in range(tp):
        for p in range(pp):
            mine = partition.stack_blocks(partition.shard_stage_params(full, TSPEC, pp, p, tp, t))
            dev = mesh4.devices[0, 0, t, p]
            for got, arr in zip(tree.leaves(mine), jax.tree.leaves(placed), strict=True):
                shard = next(s for s in arr.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(got, np.asarray(shard.data))


@pytest.mark.parametrize("pp", [0, 3])
def test_stage_partition_errors_are_jax_texts(pp):
    with pytest.raises(ValueError) as ours:
        partition.stage_partition(TSPEC, pp)
    with pytest.raises(ValueError) as theirs:
        jpart.stage_partition(JSPEC, pp)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("dp,sp,tp,pp", [(2, 1, 2, 2), (1, 1, 2, 4), (2, 2, 1, 2),
                                         (1, 2, 2, 2), (1, 1, 1, 8)])
def test_grid_rank_order_is_make_mesh_4d(dp, sp, tp, pp):
    """Rank ((d * sp + s) * tp + t) * pp + p sits at mesh position (d, s, t,
    p) of JAX's ``make_mesh_4d`` (pp minor); its data index is (d, s)'s."""
    mesh4 = make_mesh_4d(dp, sp, tp, pp)
    ids = {dev.id: pos for pos, dev in np.ndenumerate(mesh4.devices)}
    n = dp * sp * tp * pp
    for rank in range(n):
        g = Grid(World(rank, n, torch.device("cpu")), dp, sp, tp, LOCAL, (rank,), LOCAL, LOCAL,
                 pipeline_parallel=pp)
        d, s, t, p = ids[jax.devices()[rank].id]
        assert (g.dp_index, g.sp_index, g.tp_index, g.pp_index) == (d, s, t, p)
        assert g.data_index == d * sp + s


def _recorded_grids(monkeypatch, dp, sp, tp, pp):
    """Every rank's grid, with ``dist.new_group`` recording its calls (each
    returns the tuple of its ranks)."""
    calls = []

    def new_group(ranks):
        calls.append(tuple(ranks))
        return tuple(ranks)

    monkeypatch.setattr(mesh.dist, "new_group", new_group)
    n = dp * sp * tp * pp
    grids = []
    for rank in range(n):
        calls.clear()
        grids.append(make_grid(World(rank, n, torch.device("cpu")), dp, sp, tp, pp))
        if rank == 0:
            first = list(calls)
        assert calls == first, rank  # every rank, the same calls in one order
    return grids, first


@pytest.mark.parametrize("dp,sp,tp", [(2, 2, 2), (1, 4, 2), (2, 1, 4), (4, 2, 1), (1, 1, 1)])
def test_grid_at_pp1_is_the_3d_grid(monkeypatch, dp, sp, tp):
    """At pp 1 the grid makes the 3-D grid's ``new_group`` calls (the tp
    groups at tp > 1, the (dp, sp) groups, the sp rows; a group of one rank
    or of the whole world makes none) and hands each rank the same groups;
    no pp group is made."""
    grids, calls = _recorded_grids(monkeypatch, dp, sp, tp, 1)
    n = dp * sp * tp
    rank = lambda d, s, t: (d * sp + s) * tp + t  # noqa: E731
    cells = [(i, j) for i in range(dp) for j in range(sp)]
    rows = [tuple(rank(i, j, u) for u in range(tp)) for i, j in cells] if tp > 1 else []
    rows += [tuple(rank(i, j, u) for i, j in cells) for u in range(tp)]
    rows += [tuple(rank(i, j, u) for j in range(sp)) for i in range(dp) for u in range(tp)]
    assert calls == [r for r in rows if 1 < len(r) < n]
    for r, g in enumerate(grids):
        d, s, t = r // (sp * tp), r // tp % sp, r % tp
        want = {"tp_group": tuple(rank(d, s, u) for u in range(tp)),
                "data_group": tuple(rank(i, j, t) for i, j in cells),
                "sp_group": tuple(rank(d, j, t) for j in range(sp))}
        for field, row in want.items():
            group = getattr(g, field)
            if field == "tp_group" and tp == 1:
                assert group is LOCAL
            else:
                assert group == (None if len(row) == n else LOCAL if len(row) == 1 else row)
        assert g.sp_ranks == want["sp_group"] and g.shared_group is g.data_group
        assert (g.pipeline_parallel, g.pp_group, g.pp_ranks, g.pp_index) == (1, LOCAL, (r,), 0)


@pytest.mark.parametrize("dp,tp,pp", [(2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4)])
def test_grid_pp_groups(monkeypatch, dp, tp, pp):
    """At pp > 1 each rank's pp group holds its (dp, sp, tp) cell's stages in
    stage order, its shared group the ranks of its tp index, and its tp and
    (dp, sp) groups one pp index each."""
    grids, _ = _recorded_grids(monkeypatch, dp, 1, tp, pp)
    n = dp * tp * pp
    as_row = lambda group, me: (tuple(range(n)) if group is None  # noqa: E731
                                else (me,) if group is LOCAL else group)
    for r, g in enumerate(grids):
        d, t, p = r // (tp * pp), r // pp % tp, r % pp
        assert (g.dp_index, g.tp_index, g.pp_index) == (d, t, p)
        assert g.pp_ranks == tuple((d * tp + t) * pp + q for q in range(pp))
        assert as_row(g.pp_group, r) == g.pp_ranks
        assert as_row(g.shared_group, r) == tuple(
            (i * tp + t) * pp + q for i in range(dp) for q in range(pp))
        assert as_row(g.data_group, r) == tuple((i * tp + t) * pp + p for i in range(dp))
        want_tp = tuple((d * tp + u) * pp + p for u in range(tp))
        assert (g.tp_group is LOCAL) if tp == 1 else as_row(g.tp_group, r) == want_tp


OK = dict(num_workers=1, scheme="full", batch_size=16)


@pytest.mark.parametrize("kw", [
    dict(pipeline_parallel=3, microbatches=3),
    dict(pipeline_parallel=2, microbatches=1),
    dict(pipeline_parallel=1, microbatches=2),
    dict(pipeline_parallel=2, microbatches=3),
    dict(pipeline_parallel=2, microbatches=4, data_parallel=3),
    dict(pipeline_parallel=2, microbatches=2, zero1=True),
    dict(pipeline_parallel=2, microbatches=2, pipeline_schedule="zigzag"),
    dict(pipeline_parallel=0),
    dict(microbatches=0),
    dict(num_workers=2, scheme="ring", pipeline_parallel=2, microbatches=2),
    dict(scheme="ulysses", pipeline_parallel=2, microbatches=2),
])
def test_validate_topology_raises_jax_texts(kw):
    """Every rejected composition of JAX's tests/test_pipeline.py raises
    JAX's text (at TINY_SPEC: 2 layers); the valid baseline passes."""
    spec_kw = dataclasses.asdict(TINY_SPEC)
    SeqConfig(pipeline_parallel=2, microbatches=2, spec=TINY_SPEC, **OK).validate_topology()
    with pytest.raises(ValueError) as ours:
        SeqConfig(**{**OK, **kw}, spec=TINY_SPEC).validate_topology()
    with pytest.raises(ValueError) as theirs:
        JSeqConfig(**{**OK, **kw}, spec=jt.LMSpec(**spec_kw)).validate_topology()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_stage_params_round_trip_through_convert(full, pp, tp):
    """``lm_params_from_numpy`` at each (tp, pp) index, then the tp shards
    gathered and the stages put together, gives the full tree back bit for
    bit; a stage holds L/pp blocks and the whole shared leaves."""
    specs = partition.lm_param_specs(partition.stage_spec(TSPEC, pp), tp)
    stages = []
    for p in range(pp):
        shards = [lm_params_from_numpy(full, TSPEC, "cpu", tensor_parallel=tp, tp_index=t,
                                       pipeline_parallel=pp, pp_index=p) for t in range(tp)]
        assert len(shards[0]["blocks"]) == TSPEC.num_layers // pp
        assert shards[-1]["embed"].shape == full["embed"].shape
        stages.append(partition.gather_lm_params([lm_params_to_numpy(s) for s in shards], specs))
    back = partition.gather_stage_params(stages)
    for a, b in zip(tree.leaves(back), jax.tree.leaves(full), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pp,tp", [(2, 2), (4, 1)])
def test_pipeline_adam_state_round_trip(full, pp, tp):
    """The logical (params-shaped) m/v -> every rank's stage state of one
    (dp, sp) cell -> back, bit for bit."""
    rng = np.random.default_rng(0)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), full)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), full)
    states = [lm_pipeline_adam_from_numpy(5, m, v, TSPEC, pipeline_parallel=pp,
                                          pp_index=r % pp, tensor_parallel=tp,
                                          tp_index=r // pp, device="cpu")
              for r in range(tp * pp)]
    assert len(states[0].m["blocks"]) == TSPEC.num_layers // pp
    back = lm_pipeline_adam_to_numpy(states, TSPEC, pipeline_parallel=pp, tensor_parallel=tp)
    assert int(back["step"]) == 5
    for k, want in (("m", m), ("v", v)):
        for a, b in zip(tree.leaves(back[k]), jax.tree.leaves(want), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,kind,remat", [(1, "gpipe", False), (2, "gpipe", False),
                                          (2, "1f1b", False), (2, "1f1b", True)])
def test_one_rank_pipeline_step_matches_jax(full, m, kind, remat):
    """One step of ``make_pipeline_program`` at pp 1 (its microbatches
    summed by the step's own backward slots; with ``remat`` each block
    checkpointed inside the recompute) from JAX's init: parameters and the
    loss as JAX's ``make_pipeline_program``."""
    ds = synthesize_copy(num_train=4, num_test=0, seq_len=32, vocab=16, seed=1)
    kw = dict(batch_size=4, learning_rate=1e-3, seed=3, scheme="full", microbatches=m,
              pipeline_schedule=kind, remat=remat)
    fn, state = make_pipeline_program(SeqConfig(spec=TSPEC, **kw), ds.tokens, ds.targets,
                                      ds.weights, device="cpu", init=full)
    params, opt, loss = fn(*state)
    jfn, jstate = j_make_pipeline_program(JSeqConfig(spec=JSPEC, **kw), ds.tokens, ds.targets,
                                          ds.weights)
    jparams, jopt, jloss = jfn(*jstate)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert int(opt.step) == int(jopt.step) == 1
    want = jpart.unstack_blocks(jax.tree.map(np.asarray, jparams))
    for a, b in zip(tree.leaves(lm_params_to_numpy(params)), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
