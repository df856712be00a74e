"""The port's layout and collective plans (ddl_tpu_torch/parallel) against
the JAX package's: every ``LayoutAssignment`` field, for every policy and
shard count, folded included, on the full-width and tiny size tables; and
the ``FlatSpec`` flatten/unflatten order, ``reassembly_index``,
``owner_slices`` and ``to_logical``/``from_logical``, all exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

from ddl_tpu.parallel import collectives as jcoll
from ddl_tpu.parallel import layout as jlayout
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.parallel import collectives as tcoll
from ddl_tpu_torch.parallel import layout as tlayout

TABLES = {
    "full": tcnn.param_sizes(),
    "tiny": tcnn.param_sizes(tcnn.make_param_specs(tcnn.TINY_CONV_CHANNELS, tcnn.TINY_FC_SIZES)),
}
SHARDS = (1, 2, 3, 4, 7, 14)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(a):
    return dataclasses.asdict(a) | {"max_shard": a.max_shard, "balance": a.balance}


def test_constants_match():
    assert tlayout.LANE == jlayout.LANE == 128
    assert tlayout.POLICIES == jlayout.POLICIES
    assert [tlayout.align_lane(n) for n in (0, 1, 128, 129)] == \
        [jlayout.align_lane(n) for n in (0, 1, 128, 129)]


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("policy", tlayout.POLICIES)
def test_assignment_identical(policy, shards, table):
    sizes = TABLES[table]
    names = list(sizes)
    got = tlayout.assign_layout(policy, shards, names, sizes)
    want = jlayout.assign_layout(policy, shards, names, sizes)
    assert _fields(got) == _fields(want)
    assert got.summary() == want.summary()
    if policy != "flat":
        # Folded onto fewer owner devices, as resolve_layout does.
        for devices in {1, 2, 3, max(1, shards // 2)}:
            assert _fields(tlayout.fold_shards(got, devices, sizes)) == \
                _fields(jlayout.fold_shards(want, devices, sizes))


def test_zigzag_reference_order():
    sizes = TABLES["full"]
    assert tlayout.zigzag_order(list(sizes), sizes) == [
        "v13", "v8", "v1", "v6", "v3", "v10", "v5", "v4", "v7", "v2", "v11", "v12", "v0", "v9"
    ]


@pytest.mark.parametrize("policy,shards", [("flat", 2), ("zigzag", 2), ("lpt", 3), ("block", 4)])
def test_flat_plans_identical(policy, shards):
    specs = tcnn.make_param_specs(tcnn.TINY_CONV_CHANNELS, tcnn.TINY_FC_SIZES)
    shapes = dict(specs)
    sizes = TABLES["tiny"]
    tl = tlayout.assign_layout(policy, shards, list(sizes), sizes)
    jl = jlayout.assign_layout(policy, shards, list(sizes), sizes)
    tspec = tcoll.FlatSpec.from_layout(tl, shapes)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jcoll.FlatSpec.from_layout(jl, shapes))

    rng = np.random.default_rng(shards)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    flat_t = tcoll.flatten_params({k: torch.from_numpy(v) for k, v in params.items()}, tspec)
    flat_j = np.asarray(jcoll.flatten_params(params, jcoll.FlatSpec.from_layout(jl, shapes)))
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    back = tcoll.unflatten_params(flat_t, tspec)
    assert all(np.array_equal(back[k].numpy(), params[k]) for k in params)

    np.testing.assert_array_equal(tcoll.reassembly_index(tl), jcoll.reassembly_index(jl))
    for W in (shards, shards + 1):
        a, b = tcoll.owner_slices(tl, W), jcoll.owner_slices(jl, W)
        np.testing.assert_array_equal(a.starts, b.starts)
        np.testing.assert_array_equal(a.slice_idx, b.slice_idx)
        assert a.pad_len == b.pad_len
        rows = tcoll.owner_rows(flat_t, a).numpy()
        np.testing.assert_array_equal(rows, np.asarray(jcoll.owner_rows(flat_j, b)))

    n = shards * tl.max_shard
    padded = tcoll.from_logical(flat_j, tl, n)
    np.testing.assert_array_equal(padded, jcoll.from_logical(flat_j, jl, n))
    np.testing.assert_array_equal(tcoll.to_logical(padded, tl), flat_j)
    assert tcoll.chunk_size(1001, 4) == jcoll.chunk_size(1001, 4)
