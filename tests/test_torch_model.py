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


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("width", ["small", "full"])
def test_num_params_and_accuracy_match_jax(width):
    """``num_params`` of each width and ``accuracy`` on the same weights and
    batch (a batch of 64, so the hit count is not trivially 0 or all)."""
    specs = SPECS[width]
    assert tcnn.num_params(specs) == jcnn.num_params(specs)
    params, x, y = _inputs(specs, batch=64, seed=3)
    tp = params_from_numpy(params, "cpu", specs)
    y[::2] = np.eye(10, dtype=np.float32)[tcnn.apply_fn(tp, torch.from_numpy(x[::2]))
                                          .argmax(-1).numpy()]
    want = float(jcnn.accuracy({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                               jnp.asarray(y)))
    got = tcnn.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and float(got) == want and 0.5 <= want < 1.0


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


# Patches-matmul lowering: JAX's tests/test_model.py tolerances for the
# conv_matmul modes (logits atol 1e-5, gradients atol 2e-5 / rtol 1e-4).
CM_LOGITS_ATOL = 1e-5
CM_GRAD_ATOL, CM_GRAD_RTOL = 2e-5, 1e-4


@pytest.mark.parametrize("mode", list(tcnn.CONV_MATMUL_MODES))
def test_conv_matmul_modes_match_jax(mode):
    """Each mode's logits and 14 gradients against JAX's ``apply_fn`` and
    ``grad(loss_fn)`` with the same mode (JAX at Precision.HIGHEST), and
    against the port's conv lowering."""
    assert tcnn.CONV_MATMUL_MODES == jcnn.CONV_MATMUL_MODES
    specs = SPECS["small"]
    params, x, y = _inputs(specs, seed=4)
    hi = jax.lax.Precision.HIGHEST
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    logits_j = np.asarray(jcnn.apply_fn(jp, jnp.asarray(x), precision=hi, conv_matmul=mode))
    grads_j = jax.grad(jcnn.loss_fn)(jp, jnp.asarray(x), jnp.asarray(y), precision=hi,
                                     conv_matmul=mode)
    tp = params_from_numpy(params, "cpu", specs)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    logits_t = tcnn.apply_fn(tp, xt, conv_matmul=mode).numpy()
    _, grads_t = value_and_grad(tp, xt, yt, None, 1.0, conv_matmul=mode)
    _, grads_conv = value_and_grad(tp, xt, yt, None, 1.0)
    np.testing.assert_allclose(logits_t, logits_j, atol=CM_LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(logits_t, tcnn.apply_fn(tp, xt).numpy(), atol=CM_LOGITS_ATOL,
                               rtol=0)
    for name in grads_t:
        for want in (np.asarray(grads_j[name]), grads_conv[name].numpy()):
            np.testing.assert_allclose(grads_t[name].numpy(), want, atol=CM_GRAD_ATOL,
                                       rtol=CM_GRAD_RTOL, err_msg=f"{mode} grad {name}")
    first = tcnn.apply_fn(tp, xt, first_conv_matmul=True).numpy()
    np.testing.assert_array_equal(first, tcnn.apply_fn(tp, xt, conv_matmul="first").numpy())


@pytest.mark.parametrize("conv1", [False, True])
@pytest.mark.parametrize("mode", list(tcnn.CONV_MATMUL_MODES) + ["half"])
def test_conv_matmul_mode_composes_as_jax(conv1, mode):
    """``conv1_matmul`` composes with the mode as JAX's
    ``TrainConfig.conv_matmul_mode`` (none -> first, tail -> first+tail),
    and a mode with no rule raises the same ``ValueError``."""
    from ddl_tpu.train.config import TrainConfig as JConfig
    from ddl_tpu_torch.train.config import TrainConfig

    def run(cls):
        try:  # the port's config raises at construction, JAX's at the call
            return cls(conv1_matmul=conv1, conv_matmul=mode).conv_matmul_mode()
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(TrainConfig) == run(JConfig)


@pytest.mark.parametrize("mode", ["none", "first+tail"])
def test_bf16_compute_logits_match_jax(mode):
    """``compute_dtype=bfloat16``: fp32 logits from bf16 convs and matmuls
    within 2 bf16 ulps of the largest logit of JAX's (both round every op
    to bf16, in another order), and fp32 gradients of the fp32 leaves."""
    specs = SPECS["small"]
    params, x, y = _inputs(specs, seed=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    logits_j = np.asarray(jcnn.apply_fn(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16,
                                        conv_matmul=mode))
    tp = params_from_numpy(params, "cpu", specs)
    logits_t = tcnn.apply_fn(tp, torch.from_numpy(x), compute_dtype=torch.bfloat16,
                             conv_matmul=mode)
    assert logits_t.dtype == torch.float32
    scale = float(np.abs(logits_j).max())
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=2 * 2.0**-8 * scale, rtol=0)
    _, grads = value_and_grad(tp, torch.from_numpy(x), torch.from_numpy(y), None, 1.0,
                              compute_dtype=torch.bfloat16, conv_matmul=mode)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
