"""The port's sequence-parallel attention (ddl_tpu_torch/parallel/ring.py)
against the JAX package's (ddl_tpu/parallel/ring.py), and its schemes in a
gloo world of one.

- ``zigzag_positions``, ``zigzag_permutation`` and ``causal_work_profile``
  equal JAX's exactly, at several (P, T).
- ``causal_skip_plan`` (the ring's host-decided causal skip) holds the
  predicate of JAX's ``lax.cond(kmin > qmaxs[a])`` for every (rank, ring
  step, k-sub-chunk, q-sub-chunk), with JAX's own positions.
- In a gloo world of one, ``SeqTrainer`` with ring (both layouts, and the
  zigzag ring under ``remat``) and Ulysses (xla, and flash on its plain
  version) trains to what ``full`` trains: 4 steps from one init,
  parameters within atol 2e-5 / rtol 1e-3 and the final loss within rtol
  1e-4 (tests/test_torch_seq.py's tolerances: the same fp32 math in another
  order). Ulysses is bit-equal to full: the all-to-alls of one rank are
  copies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.parallel import ring as jring
from ddl_tpu_torch.convert import lm_params_to_numpy
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.parallel import ring
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.utils import tree

SIZES = [(1, 8), (2, 16), (3, 24), (4, 32), (8, 64), (4, 128)]


@pytest.mark.parametrize("P,T", SIZES)
def test_zigzag_layout_equals_jax(P, T):
    t_local = T // P
    for i in range(P):
        got = ring.zigzag_positions(i, P, t_local)
        np.testing.assert_array_equal(got, np.asarray(jring.zigzag_positions(i, P, t_local)))
    want = jring.zigzag_permutation(P, T)
    got = ring.zigzag_permutation(P, T)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for fn in (ring.zigzag_permutation, jring.zigzag_permutation):
        with pytest.raises(ValueError, match="zigzag layout needs"):
            fn(P, T + 1)


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_causal_work_profile_equals_jax(P, layout):
    got, want = ring.causal_work_profile(P, layout), jring.causal_work_profile(P, layout)
    assert got.shape == want.shape == (P, P)
    np.testing.assert_array_equal(got, want)


def _jax_positions(layout, i, P, t_local):
    if layout == "zigzag":
        return jring.zigzag_positions(i, P, t_local)
    return i * t_local + jnp.arange(t_local)


@pytest.mark.parametrize("P,t_local,layout,nsub", [
    (1, 16, "contiguous", 1), (1, 16, "contiguous", 2), (4, 8, "contiguous", 1),
    (4, 8, "contiguous", 2), (4, 8, "zigzag", None), (3, 12, "zigzag", 2),
    (4, 16, "zigzag", 4), (8, 4, "zigzag", 1),
])
def test_causal_skip_plan_is_jax_cond_predicate(P, t_local, layout, nsub):
    """JAX's ring skips sub-tile (a, b) at ring step r on device i when
    ``kpos_sub.min() > qpos_sub[a].max()``, kpos travelling with its block
    (ring.py:283-296); the port's host plan says the same."""
    n = nsub or ring.default_nsub(layout, True)
    ns = t_local // n
    for i in range(P):
        plan = ring.causal_skip_plan(i, P, t_local, layout, nsub)
        assert plan.shape == (P, n, n)
        qpos = _jax_positions(layout, i, P, t_local)
        for r in range(P):
            kpos = _jax_positions(layout, (i - r) % P, P, t_local)
            for b in range(n):
                kmin = kpos[b * ns:(b + 1) * ns].min()
                for a in range(n):
                    want = bool(kmin > qpos[a * ns:(a + 1) * ns].max())
                    assert plan[r, b, a] == want, (i, r, b, a)


@pytest.fixture
def world1(tmp_path):
    world = init_world(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    yield world
    destroy_world()


BASE = dict(epochs=1, batch_size=4, learning_rate=1e-3, eval_every=2, seed=3, spec=tt.TINY_SPEC)


@pytest.mark.parametrize("scheme,layout,impl,remat", [
    ("ring", "contiguous", "xla", False), ("ring", "zigzag", "xla", False),
    ("ulysses", "contiguous", "xla", False), ("ulysses", "contiguous", "flash", False),
    ("ring", "zigzag", "xla", True),
])
def test_schemes_in_a_world_of_one_match_full(scheme, layout, impl, remat, world1):
    ds = synthesize_copy(num_train=16, num_test=8, seq_len=32, vocab=tt.TINY_SPEC.vocab, seed=9)
    init = lm_params_to_numpy(tt.init_lm_params(torch.Generator().manual_seed(3), tt.TINY_SPEC))
    ref = SeqTrainer(SeqConfig(scheme="full", attn_impl=impl, **BASE), ds, init=init,
                     world=world1).train(log=lambda s: None)
    res = SeqTrainer(SeqConfig(scheme=scheme, seq_layout=layout, attn_impl=impl, remat=remat,
                               **BASE), ds, init=init, world=world1).train(log=lambda s: None)
    assert np.isclose(res.final_loss, ref.final_loss, rtol=1e-4), (res.final_loss, ref.final_loss)
    assert [b for _, b, _ in res.history] == [0, 2, 3]
    for a, b in zip(tree.leaves(res.params), tree.leaves(ref.params), strict=True):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3)
        if scheme == "ulysses":
            np.testing.assert_array_equal(a, b)
