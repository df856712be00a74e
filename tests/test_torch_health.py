"""The port's in-step health signals (ddl_tpu_torch/obs/health.py) and the
step bodies' health outputs, held to JAX's ``ddl_tpu/obs/health.py`` on the
same seeded numpy trees.

- ``health_signals`` (and its parts: ``grad_signals``, ``norm_signals``,
  ``nonfinite_count``, ``flat_grad_sq_nonfinite``): the same keys, in the
  same order, and values within rtol 1e-5 / atol 1e-6 (both sum float32
  squares, in another order), the counts exact, on the CNN's flat tree and
  the LM's nested one, healthy and with non-finite gradient elements;
- ``record_health`` / ``record_nonfinite``: the same registry text for the
  same fetched stacks;
- the step bodies: a single-device step at every health level leaves the
  parameters bitwise those of the step without health, its full dict
  equals ``health_signals`` of its own update, and the guard's skipped
  step reports ``update_norm`` 0 with the tripwire count;
- with telemetry off a span runs no health op (no ``isfinite``, no norm).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from ddl_tpu.obs import MetricRegistry as JRegistry
from ddl_tpu.obs import health as jh
from ddl_tpu_torch.models import cnn
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.obs import MetricRegistry
from ddl_tpu_torch.obs import health as th
from ddl_tpu_torch.ops.optimizers import adam_init
from ddl_tpu_torch.train import TrainConfig
from ddl_tpu_torch.train import trainer as ttrainer
from ddl_tpu_torch.utils import tree

RTOL, ATOL = 1e-5, 1e-6
TINY = dict(conv_channels=cnn.TINY_CONV_CHANNELS, fc_sizes=cnn.TINY_FC_SIZES)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cnn_tree(rng, scale=1.0):
    specs = cnn.make_param_specs(cnn.TINY_CONV_CHANNELS, cnn.TINY_FC_SIZES)
    return {name: (scale * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in specs}


def _lm_tree(rng, scale=1.0):
    like = tt.init_lm_params(torch.Generator().manual_seed(0), tt.TINY_SPEC)
    return tree.map(lambda t: (scale * rng.standard_normal(tuple(t.shape))).astype(np.float32),
                    like)


def _trees(family, seed, poison):
    """(grads, params, new_params) as numpy trees; ``poison`` puts a NaN
    and two infs into the gradients."""
    rng = np.random.default_rng(seed)
    make = _cnn_tree if family == "cnn" else _lm_tree
    grads, params = make(rng), make(rng)
    new = tree.map(lambda p, d: p + d, params, make(rng, 1e-3))
    if poison:
        leaves = tree.leaves(grads)
        leaves[0].reshape(-1)[3] = np.nan
        leaves[-1].reshape(-1)[:2] = np.inf
    return grads, params, new


def _torch(t):
    return tree.map(torch.from_numpy, t)


def _jax(t):
    return tree.map(jnp.asarray, t)


@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("family", ["cnn", "lm"])
def test_health_signals_match_jax(family, poison):
    grads, params, new = _trees(family, 3, poison)
    got = th.health_signals(_torch(grads), _torch(params), _torch(new))
    want = jh.health_signals(_jax(grads), _jax(params), _jax(new), None)
    assert list(got) == list(want) == jh.health_keys(_jax(params)) == th.health_keys(params)
    assert th.subtree_keys(params) == jh.subtree_keys(_jax(params))
    assert int(got["nonfinite_grads"]) == int(want["nonfinite_grads"]) == 3 * poison
    for k in got:
        if poison and k == "grad_norm":
            assert not np.isfinite(float(got[k])) and not np.isfinite(float(want[k]))
            continue
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("poison", [False, True], ids=["finite", "nonfinite"])
def test_counts_and_flat_chunk_sums_match_jax(poison):
    grads, _, _ = _trees("lm", 5, poison)
    assert int(th.nonfinite_count(_torch(grads))) == int(jh.nonfinite_count(_jax(grads), None))
    flat = np.concatenate([x.reshape(-1) for x in tree.leaves(grads)])
    # One rank: no collective (the chunk is the whole vector).
    sq, nf = th.flat_grad_sq_nonfinite(torch.from_numpy(flat), th.LOCAL)
    jsq = float(jnp.sum(jnp.square(jnp.asarray(flat))))
    assert int(nf) == 3 * poison
    if not poison:
        np.testing.assert_allclose(float(sq), jsq, rtol=RTOL)


def test_record_health_writes_jax_registry_text():
    rng = np.random.default_rng(9)
    keys = jh.health_keys(_jax(_lm_tree(rng)))
    stacks = []
    for _ in range(3):
        h = {k: rng.random(4).astype(np.float32) for k in keys}
        h["nonfinite_grads"] = rng.integers(0, 3, 4).astype(np.int32)
        stacks.append(h)
    regs = MetricRegistry(), JRegistry()
    for rec, reg in ((th, regs[0]), (jh, regs[1])):
        for i, h in enumerate(stacks):
            rec.record_nonfinite(reg, h["nonfinite_grads"])
            rec.record_health(reg, h, include_nonfinite=bool(i % 2))
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    assert regs[0].snapshot() == regs[1].snapshot()


def test_fetch_span_stacks_counts_and_keeps_the_last_dict():
    full = {"grad_norm": torch.tensor(2.5), "nonfinite_grads": torch.tensor(1, dtype=torch.int32),
            "param_norm": torch.tensor(3.0)}
    hs = [{"nonfinite_grads": torch.tensor(4, dtype=torch.int32)}, full]
    out = th.fetch_span(hs)
    assert out["nonfinite_grads"].tolist() == [4, 1]
    assert out["grad_norm"].tolist() == [2.5] and out["param_norm"].tolist() == [3.0]


def _step_inputs(seed=0):
    cfg = TrainConfig(batch_size=8, keep_prob=1.0, **TINY)
    params = ttrainer.initial_params(cfg, None, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((8, 784), dtype=np.float32))
    y = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 10, 8)), 10).float()
    return cfg, params, adam_init(params), x, y


@pytest.mark.parametrize("guard", [False, True])
def test_single_step_health_levels_leave_the_update_bitwise(guard):
    cfg, params, opt, x, y = _step_inputs()
    step = ttrainer.make_train_step(cfg, guard=guard)
    base = step(params, opt, x, y, 0)
    for level in (th.HEALTH_COUNT, th.HEALTH_FULL):
        out = step(params, opt, x, y, 0, health=level)
        assert len(out) == len(base) + 1
        for a, b in zip(tree.leaves(base[0]), tree.leaves(out[0])):
            assert torch.equal(a, b)
        h = out[3]
        if level == th.HEALTH_COUNT:
            assert list(h) == ["nonfinite_grads"] and int(h["nonfinite_grads"]) == 0
            continue
        assert list(h) == th.health_keys(params)
        # The update norm is that of the applied update.
        want = th.norm_signals(params, out[0])
        for k, v in want.items():
            assert torch.equal(h[k], v), k


def test_guarded_skip_reports_a_zero_update_and_the_count():
    cfg, params, opt, x, y = _step_inputs()
    x = x.clone()
    x[0, 0] = float("nan")
    out = ttrainer.make_train_step(cfg, guard=True)(params, opt, x, y, 0,
                                                    health=th.HEALTH_FULL)
    h, skipped = out[3], out[4]
    assert int(skipped) == 1 and int(h["nonfinite_grads"]) > 0
    assert float(h["update_norm"]) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(out[0]), tree.leaves(params)))


def test_span_health_levels():
    assert [ttrainer.span_health(th.HEALTH_FULL, i, 3) for i in range(3)] == [1, 1, 2]
    assert [ttrainer.span_health(th.HEALTH_COUNT, i, 2) for i in range(2)] == [1, 1]
    assert ttrainer.span_health(th.HEALTH_OFF, 0, 1) == 0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def test_telemetry_off_runs_no_health_op():
    cfg, params, opt, x, y = _step_inputs()
    xs, ys = x[None], y[None]
    run = ttrainer.make_epoch_chunk(cfg, 1)
    counted = {}
    for level in (th.HEALTH_OFF, th.HEALTH_FULL):
        with _Ops() as ops:
            run(params, opt, xs, ys, 0, 0, health=level)
        counted[level] = ops.names
    health_ops = {"logical_not", "_foreach_norm"}
    assert not health_ops & set(counted[th.HEALTH_OFF])
    assert health_ops <= set(counted[th.HEALTH_FULL])
    # Off, the span runs the plain step's op sequence, op for op.
    with _Ops() as ops:
        ttrainer.make_train_step(cfg)(params, opt, xs[0], ys[0], 0)
    assert " ".join(ops.names) in " ".join(counted[th.HEALTH_OFF])
