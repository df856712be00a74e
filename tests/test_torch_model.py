"""The port's CNN (ddl_tpu_torch/models/cnn.py) against the JAX package's
``ddl_tpu.models.cnn`` on the same weights and inputs (numpy, from a
seed): logits, loss and all 14 gradients at rtol 1e-4 (the bar of
tests/test_model.py), with JAX at ``Precision.HIGHEST`` so both sides
compute in full fp32. Dropout is held to its TF semantics (jax.random and
torch generators give different masks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu.models import cnn as jcnn
from ddl_tpu_torch.convert import params_from_numpy
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.train.trainer import value_and_grad

SPECS = {
    "small": tcnn.make_param_specs(tcnn.TINY_CONV_CHANNELS, tcnn.TINY_FC_SIZES),
    "full": tcnn.PARAM_SPECS,
}
RTOL = 1e-4
# Absolute floor for elements that cancel to ~0 (float32 sums of a few
# hundred terms of size ~1e-2 leave ~1e-8 of rounding).
ATOL = 1e-7


def _inputs(specs, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in specs:
        fan = shape[-2] * int(np.prod(shape[:-2])) if len(shape) > 1 else shape[0]
        params[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
    x = rng.random((batch, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=batch)]
    return params, x, y


def test_param_specs_match_jax():
    assert tcnn.PARAM_SPECS == jcnn.PARAM_SPECS
    assert tcnn.TINY_CONV_CHANNELS == jcnn.TINY_CONV_CHANNELS
    assert tcnn.TINY_FC_SIZES == jcnn.TINY_FC_SIZES
    assert sum(tcnn.param_sizes().values()) == jcnn.num_params() == 2_656_010
    assert tcnn.param_sizes() == jcnn.param_sizes()


@pytest.mark.parametrize("width", ["small", "full"])
def test_logits_loss_grads_match_jax(width):
    specs = SPECS[width]
    params, x, y = _inputs(specs)
    hi = jax.lax.Precision.HIGHEST
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    logits_j = np.asarray(jcnn.apply_fn(jp, jnp.asarray(x), precision=hi))
    loss_j, grads_j = jax.value_and_grad(jcnn.loss_fn)(
        jp, jnp.asarray(x), jnp.asarray(y), dropout_rng=None, precision=hi
    )

    tp = params_from_numpy(params, "cpu", specs)
    logits_t = tcnn.apply_fn(tp, torch.from_numpy(x)).numpy()
    loss_t, grads_t = value_and_grad(tp, torch.from_numpy(x), torch.from_numpy(y), None, 1.0)

    np.testing.assert_allclose(logits_t, logits_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    assert sorted(grads_t) == sorted(grads_j) and len(grads_t) == 14
    for name in grads_t:
        np.testing.assert_allclose(
            grads_t[name].numpy(), np.asarray(grads_j[name]), rtol=RTOL, atol=ATOL,
            err_msg=f"grad {name}",
        )


def test_module_is_apply_fn():
    params, x, _ = _inputs(SPECS["small"], seed=1)
    tp = params_from_numpy(params, "cpu", SPECS["small"])
    model = tcnn.MnistCNN(tp)
    assert list(dict(model.named_parameters())) == [f"params.v{i}" for i in range(14)]
    with torch.no_grad():
        np.testing.assert_array_equal(
            model(torch.from_numpy(x)).numpy(), tcnn.apply_fn(tp, torch.from_numpy(x)).numpy()
        )


def test_dropout_keep_probability_and_scale():
    """TF dropout: each unit kept with prob keep_prob, kept values scaled by
    1/keep_prob, the rest zero; two sites draw independent masks; the
    stream is a pure function of (seed, step, worker)."""
    x = torch.ones(400, 1000)
    gen = tcnn.dropout_generator(0, 5, 1, torch.device("cpu"))
    a = tcnn._dropout(x, gen, 0.5)
    b = tcnn._dropout(x, gen, 0.5)
    vals = set(np.unique(a.numpy()).tolist())
    assert vals == {0.0, 2.0}
    kept = float((a != 0).float().mean())
    # 400k Bernoulli(0.5) draws: 5 standard deviations is 0.004.
    assert abs(kept - 0.5) < 0.004
    assert 0.4 < float(((a != 0) == (b != 0)).float().mean()) < 0.6  # independent sites
    again = tcnn._dropout(x, tcnn.dropout_generator(0, 5, 1, torch.device("cpu")), 0.5)
    np.testing.assert_array_equal(again.numpy(), a.numpy())
    other = tcnn._dropout(x, tcnn.dropout_generator(0, 5, 2, torch.device("cpu")), 0.5)
    assert not torch.equal(other, a)
    np.testing.assert_allclose(
        float(tcnn._dropout(x, tcnn.dropout_generator(0, 0, 0, torch.device("cpu")), 0.8)
              .sum()) / x.numel(),
        1.0, atol=0.01,
    )  # E[dropout(x)] = x
    assert tcnn._dropout(x, None, 0.5) is x  # eval mode


def test_glorot_init_stats_and_shapes():
    p = tcnn.init_params(torch.Generator().manual_seed(3), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == dict(jcnn.PARAM_SPECS)
    w = p["v8"].numpy()
    limit = np.sqrt(6.0 / (1024 + 1024))
    assert np.abs(w).max() <= limit
    assert w.std() == pytest.approx(limit / np.sqrt(3), rel=0.05)
    q = tcnn.init_params(torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
