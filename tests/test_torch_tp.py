"""Tensor parallelism in the port without a spawned world: the Megatron
partition (ddl_tpu_torch/models/partition.py) against JAX's
``lm_param_specs`` and the shards JAX's ``NamedSharding`` places, the
conversions of the shards and of the hybrid ZeRO-1 x tp Adam state, the
3-D grid's rank order against ``make_mesh_3d``, the f/g Functions in a gloo
world of one (where both are identities), and JAX's tp ``ValueError``
texts. The f/g pair's cross-rank rule (tp-complete gradients, equal to
JAX's) is held by the 4-rank world of tests/test_torch_seq_parallel.py.

Exact throughout: slicing, gathering and identity collectives move bits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.models import transformer as jt
from ddl_tpu.models.partition import lm_param_specs as j_lm_param_specs
from ddl_tpu.parallel.mesh import TP_AXIS, make_mesh, make_mesh_3d
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu_torch.convert import (
    lm_hybrid_adam_from_numpy,
    lm_hybrid_adam_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.models import partition
from ddl_tpu_torch.models.transformer import LMSpec
from ddl_tpu_torch.parallel import collectives as coll
from ddl_tpu_torch.parallel.mesh import (
    LOCAL, Grid, World, destroy_world, init_world, make_grid,
)
from ddl_tpu_torch.strategies.seq import SeqConfig, check_config
from ddl_tpu_torch.utils import tree

SPEC_KW = dict(vocab=16, d_model=32, num_heads=4, num_layers=2, d_ff=64)
JSPEC, TSPEC = jt.LMSpec(**SPEC_KW), LMSpec(**SPEC_KW)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full():
    return jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(3), JSPEC))


def _axis(p) -> int | None:
    """The dimension a JAX PartitionSpec splits over tp (None: replicated)."""
    return next((i for i, a in enumerate(p) if a == TP_AXIS), None)


@pytest.mark.parametrize("tp", [2, 4])
def test_specs_and_shards_are_jax_placements(full, tp):
    """The port's spec tree names JAX's split dimensions, and rank t's shard
    is what ``NamedSharding`` over a ``tp``-device mesh places on device t."""
    theirs = j_lm_param_specs(JSPEC, tp)
    ours = partition.lm_param_specs(TSPEC, tp)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    assert tree.leaves(ours) == [_axis(p) for p in jax.tree.leaves(theirs, is_leaf=is_spec)]
    mesh = make_mesh(tp, axis=TP_AXIS)
    placed = jax.tree.map(lambda a, p: jax.device_put(a, NamedSharding(mesh, p)), full, theirs,
                          is_leaf=lambda x: isinstance(x, np.ndarray))
    for t in range(tp):
        mine = partition.shard_lm_params(full, ours, tp, t)
        for got, arr in zip(tree.leaves(mine), jax.tree.leaves(placed), strict=True):
            shard = next(s for s in arr.addressable_shards if s.device == mesh.devices[t])
            np.testing.assert_array_equal(got, np.asarray(shard.data))
    assert partition.lm_param_specs(TSPEC, 1) is None and j_lm_param_specs(JSPEC, 1) == \
        jax.sharding.PartitionSpec()


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_and_gather_round_trip_through_convert(full, tp):
    """``lm_params_from_numpy`` at each tp index, then ``lm_params_to_numpy``
    of each shard and ``gather_lm_params`` over them, gives the full tree
    back bit for bit; each shard holds H/tp heads' columns and d_ff/tp
    hidden units."""
    shards = [lm_params_from_numpy(full, TSPEC, "cpu", tensor_parallel=tp, tp_index=t)
              for t in range(tp)]
    blk = shards[-1]["blocks"][1]
    e, f = SPEC_KW["d_model"], SPEC_KW["d_ff"]
    assert blk["wq"].shape == (e, e // tp) and blk["wo"].shape == (e // tp, e)
    assert blk["w1"].shape == (e, f // tp) and blk["b1"].shape == (f // tp,)
    assert blk["w2"].shape == (f // tp, e) and blk["b2"].shape == (e,)
    back = partition.gather_lm_params([lm_params_to_numpy(s) for s in shards],
                                      partition.lm_param_specs(TSPEC, tp))
    for a, b in zip(tree.leaves(back), jax.tree.leaves(full), strict=True):
        np.testing.assert_array_equal(a, b)


def test_hybrid_adam_state_round_trip(full):
    """The hybrid's logical (params-shaped) m/v -> every rank's state of a
    2 x 2 grid ((dp, sp) ranks x tp) -> back, bit for bit; the flat chunk
    covers exactly the tp-replicated leaves and the tp lists the shards."""
    rng = np.random.default_rng(0)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), full)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), full)
    states = [lm_hybrid_adam_from_numpy(3, m, v, TSPEC, r, tensor_parallel=2, data_ranks=2,
                                        device="cpu") for r in range(4)]
    e, f, voc, L = SPEC_KW["d_model"], SPEC_KW["d_ff"], SPEC_KW["vocab"], SPEC_KW["num_layers"]
    replicated = 2 * voc * e + 2 * e + L * 5 * e
    assert states[0].m_flat.numel() == -(-replicated // 2)
    assert len(states[0].m_tp) == 7 * L
    torch.testing.assert_close(states[0].m_flat, states[1].m_flat, rtol=0, atol=0)
    back = lm_hybrid_adam_to_numpy(states, TSPEC, tensor_parallel=2)
    assert int(back["step"]) == 3
    for k, want in (("m", m), ("v", v)):
        for a, b in zip(tree.leaves(back[k]), jax.tree.leaves(want), strict=True):
            np.testing.assert_array_equal(a, b)


def test_grid_rank_order_is_make_mesh_3d():
    """Rank (d * sp + s) * tp + t sits at mesh position (d, s, t) of JAX's
    ``make_mesh_3d`` (tp minor), and its data index is the chunk JAX's
    ZeRO-1 hands position (d, s)."""
    dp, sp, tp = 2, 2, 2
    mesh = make_mesh_3d(dp, sp, tp)
    ids = {dev.id: pos for pos, dev in np.ndenumerate(mesh.devices)}
    for rank in range(dp * sp * tp):
        g = Grid(World(rank, dp * sp * tp, torch.device("cpu")), dp, sp, tp, LOCAL, (rank,),
                 LOCAL, LOCAL)
        d, s, t = ids[jax.devices()[rank].id]
        assert (g.dp_index, g.sp_index, g.tp_index) == (d, s, t)
        assert g.data_index == d * sp + s


def test_f_and_g_are_identities_in_a_world_of_one(tmp_path):
    """In a gloo world of one both Functions are identities, forward and
    backward, over the world's group; over ``LOCAL`` no collective is
    called at all. The grid of a world of one at tp 1 has a ``LOCAL`` tp
    group (the f/g pair inserts nothing) and sums over the world's group."""
    x = torch.randn(3, 5, dtype=torch.float64, requires_grad=True)
    ct = torch.randn(3, 5, dtype=torch.float64)
    for make in (coll.tp_allreduce, coll.tp_promote):
        assert make(LOCAL)(x) is x
    world = init_world(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    try:
        for make in (coll.tp_allreduce, coll.tp_promote):
            y = make(None)(x * 2.0)
            assert torch.equal(y, x * 2.0)
            (g,) = torch.autograd.grad(y, x, ct)
            assert torch.equal(g, ct * 2.0)
        grid = make_grid(world, 1, 1)
        assert grid.tp_group is LOCAL and grid.data_group is None and grid.sp_group is None
    finally:
        destroy_world()


@pytest.mark.parametrize("change", [
    dict(tensor_parallel=3),
    dict(tensor_parallel=2, spec=dict(SPEC_KW, d_ff=65)),
    dict(tensor_parallel=2, num_workers=4, scheme="ulysses"),
])
def test_tp_checks_raise_jax_texts(change):
    """The trainer's tp checks raise JAX's ``ValueError`` texts, in JAX's
    order: heads % tp, d_ff % tp, Ulysses on the per-device heads."""
    change = dict(change)
    spec_kw = change.pop("spec", SPEC_KW)
    base = dict(batch_size=8, **change)
    ds = synthesize_copy(num_train=16, num_test=8, seq_len=32, vocab=16, seed=0)
    jds = j_synthesize_copy(num_train=16, num_test=8, seq_len=32, vocab=16, seed=0)
    with pytest.raises(ValueError) as ours:
        check_config(SeqConfig(spec=LMSpec(**spec_kw), **base), ds)
    with pytest.raises(ValueError) as theirs:
        JSeqTrainer(JSeqConfig(spec=jt.LMSpec(**spec_kw), **base), jds)
    assert str(ours.value) == str(theirs.value)
    assert "tensor_parallel needs" in str(ours.value) or "per-device" in str(ours.value)


def test_seq_config_keeps_the_jax_fields():
    ours = {f.name: f.default for f in dataclasses.fields(SeqConfig) if f.name != "spec"}
    theirs = {f.name: f.default for f in dataclasses.fields(JSeqConfig) if f.name != "spec"}
    assert ours == theirs
