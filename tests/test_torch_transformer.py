"""The port's decoder LM (ddl_tpu_torch/models/transformer.py) against
``ddl_tpu.models.transformer`` on the same weights (JAX init, carried over
by ``convert.lm_params_from_numpy``) and the same numpy inputs.

Both sides compute in fp32 with another summation order, so values agree
to rounding: ``rope`` and ``_layernorm`` within atol 1e-6, a block and the
logits within rtol 1e-4 / atol 1e-5, and ``lm_loss_sums`` with the gradient
of every leaf within rtol 1e-4 / atol 1e-5. Also pinned: ``init_lm_params``
shapes and ``num_params`` equal JAX's, and ``utils.tree.leaves`` gives
``jax.tree.leaves`` order (the order the JAX package's flat ZeRO-1 plans
use).
"""

import dataclasses
import functools

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.models import transformer as jt
from ddl_tpu.ops import adam_init as j_adam_init, adam_update as j_adam_update
from ddl_tpu.ops.attention import flash_attention_bthd as j_flash
from ddl_tpu.parallel import ring as jring
from ddl_tpu_torch.convert import adam_state_from_numpy, lm_params_from_numpy, lm_params_to_numpy
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.ops.flash_attention import flash_attention_bthd as t_flash
from ddl_tpu_torch.ops.optimizers import adam_update
from ddl_tpu_torch.parallel.ring import full_attention as t_full
from ddl_tpu_torch.utils import tree

TOL = dict(rtol=1e-4, atol=1e-5)
WIDE = dict(vocab=48, d_model=64, num_heads=4, num_layers=2, d_ff=128)
SPECS = {"tiny": dict(dataclasses.asdict(tt.TINY_SPEC)), "d64": WIDE}
ATTN = {  # (jax, port) attention closures, causal
    "xla": (functools.partial(jring.full_attention, causal=True),
            functools.partial(t_full, causal=True)),
    "flash": (functools.partial(j_flash, causal=True), functools.partial(t_flash, causal=True)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(name):
    return jt.LMSpec(**SPECS[name]), tt.LMSpec(**SPECS[name])


def _weights(jspec, seed=0):
    """JAX's init, perturbed so that gains and biases are not 1 and 0."""
    p = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(seed), jspec))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)


def _tokens(spec, b=2, t=32, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, spec.vocab, size=(b, t)).astype(np.int32)
    tgt = rng.integers(0, spec.vocab, size=(b, t)).astype(np.int32)
    w = (rng.random((b, t)) < 0.6).astype(np.float32)
    return tok, tgt, w


def test_rope_and_layernorm_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    for positions in (np.arange(40), 100 + np.arange(40), rng.integers(0, 4000, (2, 40))):
        want = np.asarray(jt.rope(jnp.asarray(x), jnp.asarray(positions), 10000.0))
        got = tt.rope(torch.from_numpy(x), torch.from_numpy(positions), 10000.0).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)  # cos/sin of angles up to 4000
    h = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3 + 1
    g, b = rng.standard_normal(24).astype(np.float32), rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jt._layernorm(*(jnp.asarray(a) for a in (h, g, b))))
    got = tt._layernorm(*(torch.from_numpy(a) for a in (h, g, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="even"):
        tt.rope(torch.zeros(1, 2, 1, 3), torch.arange(2), 10000.0)


# Each width with one attention (both are held to JAX in test_torch_attention.py).
@pytest.mark.parametrize("spec_name,attn", [("tiny", "flash"), ("d64", "xla")])
def test_block_and_logits_match_jax(spec_name, attn):
    jspec, tspec = _specs(spec_name)
    w = _weights(jspec)
    tp = lm_params_from_numpy(w, tspec, "cpu")
    jattn, tattn = ATTN[attn]
    tok, _, _ = _tokens(tspec)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 32, tspec.d_model)).astype(np.float32)
    pos = np.arange(32)
    # jit: one compile instead of one per op (seconds on the CPU).
    want = jax.jit(lambda h, blk: jt.apply_block(h, blk, jspec, attn_fn=jattn,
                                                 positions=jnp.asarray(pos)))(h, w["blocks"][0])
    got = tt.apply_block(torch.from_numpy(h), tp["blocks"][0], tspec, attn_fn=tattn,
                         positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax.jit(lambda p, t: jt.apply_lm(p, t, jspec, attn_fn=jattn))(w, tok)
    got = tt.apply_lm(tp, torch.from_numpy(tok), tspec, attn_fn=tattn)
    assert got.dtype == torch.float32 and got.shape == (2, 32, tspec.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    module = tt.TransformerLM(tp, tspec, tattn)
    np.testing.assert_allclose(module(torch.from_numpy(tok)).detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("spec_name,attn", [("tiny", "xla"), ("d64", "flash")])
def test_loss_sums_and_every_gradient_match_jax(spec_name, attn):
    jspec, tspec = _specs(spec_name)
    w = _weights(jspec, seed=2)
    jattn, tattn = ATTN[attn]
    tok, tgt, wt = _tokens(tspec, seed=3)
    jloss = lambda p: jt.lm_loss_sums(p, tok, tgt, wt, jspec, attn_fn=jattn)  # noqa: E731
    (jnum, jden), jgrads = jax.jit(lambda p: (jloss(p), jax.grad(lambda q: jloss(q)[0])(p)))(w)
    leaves = tree.map(lambda t: t.requires_grad_(True), lm_params_from_numpy(w, tspec, "cpu"))
    num, den = tt.lm_loss_sums(leaves, *(torch.from_numpy(a) for a in (tok, tgt, wt)), tspec,
                               attn_fn=tattn)
    np.testing.assert_allclose(float(num.detach()), float(jnum), **TOL)
    assert float(den) == float(jden)
    grads = torch.autograd.grad(num, tree.leaves(leaves))
    want = jax.tree.leaves(jgrads)
    assert len(grads) == len(want) == 4 + 12 * tspec.num_layers
    for g, jg in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    hits, hden = tt.lm_correct_sums(leaves, *(torch.from_numpy(a) for a in (tok, tgt, wt)),
                                    tspec, attn_fn=tattn)
    jhits, _ = jax.jit(lambda p: jt.lm_correct_sums(p, tok, tgt, wt, jspec, attn_fn=jattn))(w)
    assert float(hits) == float(jhits) and float(hden) == float(jden)


@pytest.mark.parametrize("spec_name", ["tiny", "d64"])
def test_init_shapes_and_num_params_match_jax(spec_name):
    jspec, tspec = _specs(spec_name)
    jp = jt.init_lm_params(jax.random.PRNGKey(0), jspec)
    tp = tt.init_lm_params(torch.Generator().manual_seed(0), tspec)
    assert jax.tree.map(np.shape, jp) == tree.map(lambda t: tuple(t.shape), tp)
    assert tspec.num_params() == jspec.num_params() == sum(t.numel() for t in tree.leaves(tp))
    assert tspec.head_dim == jspec.head_dim
    assert all(t.dtype == torch.float32 for t in tree.leaves(tp))
    for blk in tp["blocks"]:
        assert torch.equal(blk["ln1_g"], torch.ones(tspec.d_model))
        assert torch.equal(blk["b1"], torch.zeros(tspec.d_ff))
        limit = (6.0 / (2 * tspec.d_model)) ** 0.5
        assert 0 < float(blk["wq"].abs().max()) <= limit
    # Full width of the LM benchmark (benchmarks/lm_bench.py).
    full = tt.LMSpec(vocab=256, d_model=512, num_heads=8, num_layers=4, d_ff=2048)
    assert full.num_params() == 12_864_512 and full.head_dim == 64


def test_leaf_order_is_jax_tree_leaves_order():
    """The order the JAX package's ZeRO-1 LM plan (``_FlatPlan``,
    ``ravel_pytree``) flattens in: a later ZeRO-1 slice lays its flat
    vector out by it."""
    jspec, tspec = _specs("tiny")
    w = _weights(jspec)
    tp = lm_params_from_numpy(w, tspec, "cpu")
    names = [k for k in sorted(tt.param_shapes(tspec)["blocks"][0])]
    assert names == ["b1", "b2", "ln1_b", "ln1_g", "ln2_b", "ln2_g", "w1", "w2", "wk", "wo",
                     "wq", "wv"]
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(w)):
        np.testing.assert_array_equal(a.numpy(), b)
    flat, _ = jax.flatten_util.ravel_pytree(w)
    ours = torch.cat([t.reshape(-1) for t in tree.leaves(tp)])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(flat))
    # The round trip keeps the JAX layout; unflatten inverts leaves.
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(w)
    again = tree.unflatten(tp, tree.leaves(tp))
    assert all(a is b for a, b in zip(tree.leaves(again), tree.leaves(tp)))


def test_convert_rejects_wrong_names_and_shapes():
    jspec, tspec = _specs("tiny")
    w = _weights(jspec)
    bad = dict(w, head=w["head"][:, :-1])
    with pytest.raises(ValueError, match="head"):
        lm_params_from_numpy(bad, tspec, "cpu")
    with pytest.raises(ValueError, match="names"):
        lm_params_from_numpy({k: v for k, v in w.items() if k != "lnf_b"}, tspec, "cpu")
    with pytest.raises(ValueError, match="list of 2"):
        lm_params_from_numpy(dict(w, blocks=w["blocks"][:1]), tspec, "cpu")


def test_adam_over_the_lm_tree_matches_jax():
    """TF1 Adam over the nested tree, from a JAX state carried over by
    ``adam_state_from_numpy``: one more step on both sides agrees to
    rounding (atol 2e-7, as tests/test_torch_adam.py)."""
    jspec, tspec = _specs("tiny")
    w = _weights(jspec)
    rng = np.random.default_rng(4)
    g1, g2 = (jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), w)
              for _ in range(2))
    jp, jst = j_adam_update(w, j_adam_init(w), g1, lr=1e-3)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tspec, "cpu")
    tst = adam_state_from_numpy(jst.step, jax.tree.map(np.asarray, jst.m),
                                jax.tree.map(np.asarray, jst.v), tspec, "cpu")
    jp, jst = j_adam_update(jp, jst, g2, lr=1e-3)
    tp, tst = adam_update(tp, tst, lm_params_from_numpy(g2, tspec, "cpu"), lr=1e-3)
    assert int(tst.step) == int(jst.step) == 2
    for ours, theirs in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        for a, b in zip(tree.leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-7)
