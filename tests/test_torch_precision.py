"""The port's precision policy (ddl_tpu_torch/precision.py) and its threads
through the trainers and the engine, against ``ddl_tpu.precision`` and the
JAX package's trainers and scheduler on the same inputs (numpy, from
seeds).

- **Resolution.** Every ``(precision, compute_dtype)`` pair of the matrix,
  bad ones included, resolves to the same ``name``, ``legacy``,
  ``reduces_in_bf16``, ``is_mixed``, ``mfu_kind`` and compute dtype, or
  raises the same exception type, as JAX's ``resolve``; ``mfu_kind`` of a
  bare dtype likewise.
- **Cast hooks.** ``cast_grads`` / ``upcast_grads`` convert float leaves
  only (ints and bools pass through), to the same values as JAX's casts;
  off the bf16 policy both are the identity (the same object).
- **fp32 is the identity.** ``precision="fp32"`` is BITWISE equal to
  ``precision=None`` for the CNN's single-device and sync ZeRO-1 steps and
  the LM's ``full`` step (plain and ZeRO-1): the port's counterpart of
  JAX's HLO byte-identity pins.
- **bf16 training against JAX's bf16.** Five CNN steps and a four-step LM
  span from the same converted init. Both sides round every bf16 op, in
  another order, so their trajectories separate by bf16 noise: losses are
  held at rtol 1e-2 (2.5 bf16 ulps; measured 2e-3), the Adam moments,
  which carry each step's gradients, in norm at 5e-2 (measured 0.018 at
  most), and the parameter updates from the init in norm at 0.2 of the
  update (measured 0.081 at most); a CNN batch with one sample of eight
  swapped gives 0.30 and 0.39. The
  port's bf16 run also meets JAX's own contract against the fp32 run
  (tests/test_precision.py: losses rtol 0.1 / atol 0.05, masters atol
  5e-2), and its master weights and moments stay fp32.
- **No bf16 gradient reaches the fused-Adam kernel**: its wrapper raises
  on a non-fp32 input, and a bf16 sync ZeRO-1 run with ``fused_adam``
  keeps fp32 flat state.
- **bf16 serving** against JAX's ``Scheduler.run`` under
  ``compute_dtype="bfloat16"``, contiguous and paged: tokens equal up to
  the first near-tie. bf16 logits carry about 2^-8 relative error on each
  side (they differed by up to 0.0273 on equal prefixes here), so a token
  may flip only where its step's top-2 margin is below NEAR_TIE on either
  side; the pool is bf16 and a row costs half its fp32 bytes.

The multi-rank bf16 cases (Ulysses + ZeRO-1, the hybrid at tp 2, GPipe at
pp 2, the replicated Ulysses body) ride in the 4-rank world of
tests/test_torch_seq_parallel.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddl_tpu import precision as jp
from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.data.lm import synthesize_prompts as j_synthesize_prompts
from ddl_tpu.models import cnn as jcnn
from ddl_tpu.models import transformer as jt
from ddl_tpu.ops.optimizers import adam_init as j_adam_init
from ddl_tpu.serve import InferenceEngine as JEngine
from ddl_tpu.serve import Request as JRequest
from ddl_tpu.serve import Scheduler as JScheduler
from ddl_tpu.serve import ServeConfig as JServeConfig
from ddl_tpu.serve.cache import kv_row_bytes as j_kv_row_bytes
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu.train.config import TrainConfig as JTrainConfig
from ddl_tpu.train.trainer import make_train_step as j_make_train_step
from ddl_tpu_torch import precision as tp
from ddl_tpu_torch.convert import lm_sharded_adam_to_numpy, params_from_numpy
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.ops import fused_adam
from ddl_tpu_torch.ops.optimizers import adam_init
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.serve import InferenceEngine, Request, Scheduler, ServeConfig
from ddl_tpu_torch.serve.cache import kv_row_bytes
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.strategies.sync import make_sharded_step, resolve_layout, sharded_adam_init
from ddl_tpu_torch.train.config import TrainConfig
from ddl_tpu_torch.train.trainer import make_train_step
from ddl_tpu_torch.utils import tree

from _torch_world import record_margins, update_rel_diff

QUIET = lambda s: None  # noqa: E731
PRECISIONS = (None, "fp32", "bf16", "fp16", "")
DTYPES = (None, "bfloat16", "float32", "float16", "int8", "float64", "bf16", "foo")
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)
SPECS = tcnn.make_param_specs(tcnn.TINY_CONV_CHANNELS, tcnn.TINY_FC_SIZES)
LR = 1e-3
CNN_STEPS = 5
LOSS_RTOL = 1e-2
# bf16 against JAX's bf16, set from readings on this file's inputs: the
# parameter updates part by ||Δa - Δb|| / ||Δb|| <= UPDATE_REL (measured
# 0.081 at most) and the Adam moments by ||a - b|| / ||b|| <=
# MOMENT_NORM_RTOL (0.018 at most). One CNN sample of eight swapped for
# another gives 0.39 and 0.30, while its losses stay within LOSS_RTOL.
UPDATE_REL, MOMENT_NORM_RTOL = 0.2, 0.05
# JAX's own bf16-against-fp32 contract (tests/test_precision.py).
CONTRACT_RTOL, CONTRACT_ATOL, MASTERS_ATOL = 0.1, 0.05, 5e-2
NEAR_TIE = 0.0625


def _outcome(fn):
    """A resolved policy's observable fields, or the exception's type."""
    try:
        p = fn()
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return type(e).__name__
    dtype = None if p.compute_dtype is None else str(p.compute_dtype).split(".")[-1]
    return (p.name, p.legacy, p.reduces_in_bf16, p.is_mixed, p.mfu_kind, dtype)


@pytest.mark.parametrize("prec,dtype", list(itertools.product(PRECISIONS, DTYPES)))
def test_resolution_matrix_matches_jax(prec, dtype):
    assert _outcome(lambda: tp.resolve(prec, dtype)) == _outcome(lambda: jp.resolve(prec, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mfu_kind_matches_jax(dtype):
    def run(mod):
        try:
            return mod.mfu_kind(dtype)
        except Exception as e:  # noqa: BLE001 - the type is the outcome
            return type(e).__name__

    assert run(tp) == run(jp)


def test_cast_hooks_touch_only_float_leaves():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    grads = {"w": torch.from_numpy(w), "blocks": [torch.from_numpy(b)],
             "step": torch.tensor(7, dtype=torch.int32), "ids": torch.arange(4),
             "mask": torch.tensor([True, False])}
    for pol in (tp.resolve(None, None), tp.resolve("fp32", None), tp.resolve(None, "bfloat16")):
        assert pol.cast_grads(grads) is grads and pol.upcast_grads(grads) is grads
    pol = tp.resolve("bf16", None)
    down = pol.cast_grads(grads)
    assert (down["w"].dtype, down["blocks"][0].dtype) == (torch.bfloat16, torch.bfloat16)
    assert (down["step"].dtype, down["ids"].dtype, down["mask"].dtype) == (
        torch.int32, torch.int64, torch.bool)
    up = pol.upcast_grads(down)
    assert up["w"].dtype == torch.float32 and up["step"] is grads["step"]
    jdown = jax.tree.map(jp.make_to_dtype_fn(jnp.bfloat16), {"w": w, "b": b})
    jup = jax.tree.map(jp.make_to_dtype_fn(jnp.float32), jdown)
    np.testing.assert_array_equal(up["w"].numpy(), np.asarray(jup["w"]))
    np.testing.assert_array_equal(up["blocks"][0].numpy(), np.asarray(jup["b"]))
    assert tp.make_to_dtype_fn(None)(grads["w"]) is grads["w"]


# -- fp32 is the identity ------------------------------------------------------


def _cnn_inputs(n=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


@pytest.fixture(scope="module")
def cnn_init():
    return jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(2), specs=SPECS))


def _port_cnn(cfg, init, x, y, steps, kind="single", store=None):
    """``steps`` port steps on one batch: (losses, params, the flat Adam
    moments m and v in parameter order); ``kind`` "single" (the
    single-device step) or the ZeRO-1 sync step in a world of one over the
    file ``store``."""
    params = params_from_numpy(init, "cpu", SPECS)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if cfg.policy().compute_dtype is not None:
        xt = xt.to(torch.bfloat16)  # the staging dtype
    losses = []
    if kind == "single":
        step, opt = make_train_step(cfg), adam_init(params)
        for i in range(steps):
            params, opt, loss = step(params, opt, xt, yt, i)
            losses.append(float(loss))
        return losses, params, *(torch.cat([t[k].reshape(-1) for k in params])
                                 for t in (opt.m, opt.v))
    world = init_world(1, 0, f"file://{store}", "cpu")
    try:
        lay = resolve_layout(cfg, 1, tcnn.param_sizes(SPECS))
        step = make_sharded_step(cfg, world, lay, tcnn.param_shapes(params))
        opt = sharded_adam_init(world, lay)
        for i in range(steps):
            params, opt, loss = step(params, opt, xt, yt, i)
            losses.append(float(loss))
    finally:
        destroy_world()
    total = sum(p.numel() for p in params.values())
    return losses, params, opt.m[:total], opt.v[:total]


@pytest.mark.parametrize("kind", ["single", "sync_zero1_fused"])
def test_fp32_policy_is_bitwise_the_default_cnn(kind, cnn_init, tmp_path):
    """Dropout on (keep_prob 0.5): the masks come from the same streams."""
    x, y = _cnn_inputs()
    kw = dict(batch_size=16, learning_rate=LR, keep_prob=0.5, **TINY)
    if kind != "single":
        kw.update(num_ps=2, layout="flat", fused_adam=True)
    runs = [_port_cnn(TrainConfig(precision=prec, **kw), cnn_init, x, y, 3, kind,
                      tmp_path / f"store_{prec}") for prec in (None, "fp32")]
    (la, pa, ma, va), (lb, pb, mb, vb) = runs
    assert la == lb
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert torch.equal(ma, mb) and torch.equal(va, vb)


@pytest.mark.parametrize("variant", [dict(attn_impl="flash"), dict(zero1=True)])
def test_fp32_policy_is_bitwise_the_default_lm(variant):
    ds = synthesize_copy(num_train=8, num_test=4, seq_len=32, vocab=tt.TINY_SPEC.vocab, seed=1)
    base = dict(epochs=1, batch_size=4, learning_rate=LR, eval_every=0, seed=3, scheme="full",
                spec=tt.TINY_SPEC, **variant)
    res = [SeqTrainer(SeqConfig(precision=prec, **base), ds, device="cpu").train(log=QUIET)
           for prec in (None, "fp32")]
    assert res[0].span_losses == res[1].span_losses
    for a, b in zip(tree.leaves(res[0].params), tree.leaves(res[1].params)):
        np.testing.assert_array_equal(a, b)


# -- bf16 training against JAX --------------------------------------------------


def _jax_cnn(jcfg, init, x, y, steps):
    """(losses, params, the Adam state's m and v trees)."""
    step = jax.jit(j_make_train_step(jcfg))
    p = jax.tree.map(jnp.asarray, init)
    o = j_adam_init(p)
    losses = []
    for i in range(steps):
        p, o, loss = step(p, o, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, *(jax.tree.map(np.asarray, t) for t in (p, o.m, o.v))


def _moment_rel(got, want) -> float:
    """``||got - want|| / ||want||`` over flat moments."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind,mode", [("single", "none"), ("single", "all"),
                                       ("sync_zero1_fused", "none")])
def test_bf16_cnn_matches_jax(kind, mode, cnn_init, tmp_path):
    x, y = _cnn_inputs(8)
    kw = dict(batch_size=8, learning_rate=LR, keep_prob=1.0, conv_matmul=mode, **TINY)
    jlosses, jparams, jm, jv = _jax_cnn(JTrainConfig(precision="bf16", **kw), cnn_init, x, y,
                                        CNN_STEPS)
    ref_losses, ref_params, _, _ = _jax_cnn(JTrainConfig(**kw), cnn_init, x, y, CNN_STEPS)
    if kind != "single":
        kw.update(num_ps=2, layout="flat", fused_adam=True)
    losses, params, m, v = _port_cnn(TrainConfig(precision="bf16", **kw), cnn_init, x, y,
                                     CNN_STEPS, kind, tmp_path / "store")
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, ref_losses, rtol=CONTRACT_RTOL, atol=CONTRACT_ATOL)
    assert (m.dtype, v.dtype) == (torch.float32, torch.float32)
    assert all(p.dtype == torch.float32 for p in params.values())
    for got, want in ((m, jm), (v, jv)):
        rel = _moment_rel(got.numpy(), np.concatenate([want[k].reshape(-1) for k in params]))
        assert rel <= MOMENT_NORM_RTOL, rel
    keys = list(params)
    rel = update_rel_diff([params[k].numpy() for k in keys], [jparams[k] for k in keys],
                          [cnn_init[k] for k in keys])
    assert rel <= UPDATE_REL, rel
    for k in keys:
        np.testing.assert_allclose(params[k].numpy(), ref_params[k], atol=MASTERS_ATOL,
                                   rtol=0, err_msg=k)


def test_fused_adam_refuses_a_bf16_gradient():
    p, m, v = (torch.zeros(8) for _ in range(3))
    with pytest.raises(TypeError, match="g must be float32"):
        fused_adam.adam_flat_fused(p, m, v, torch.zeros(8, dtype=torch.bfloat16),
                                   torch.tensor([1e-3]))


def _jax_span(trainer, jds, steps):
    """JAX's trainer's span program run ``steps`` steps from its init, one
    step a span, as ``train`` runs them: (param leaves, the checkpoint form
    of the Adam state), which ``train`` does not return."""
    bs = trainer.config.batch_size
    xs, ys, ws = (trainer.stage_batches(a, steps, bs) for a in (jds.tokens, jds.targets,
                                                               jds.weights))
    run, p, o = trainer.span_program(1), trainer.params, trainer.opt_state
    for i in range(steps):
        p, o, _ = run(p, o, xs, ys, ws, jnp.int32(i))
    return jax.tree.leaves(trainer._result_params(p)), trainer._opt_for_save(o)


LM_BASE = dict(epochs=1, batch_size=4, learning_rate=LR, eval_every=2, seed=3, scheme="full")
LM_STEPS = 4


@pytest.mark.parametrize("variant", [dict(attn_impl="flash"), dict(attn_impl="xla"),
                                     dict(zero1=True), dict(scheme="ring", seq_layout="zigzag"),
                                     dict(attn_impl="flash", remat=True)])
def test_bf16_lm_matches_jax(variant):
    kw = dict(num_train=16, num_test=8, seq_len=32, vocab=tt.TINY_SPEC.vocab, seed=9)
    ds, jds = synthesize_copy(**kw), j_synthesize_copy(**kw)
    init = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(3), jt.TINY_SPEC))
    jtrainer = JSeqTrainer(JSeqConfig(spec=jt.TINY_SPEC, precision="bf16",
                                      **{**LM_BASE, **variant}), jds)
    jres = jtrainer.train(log=QUIET)
    ref = JSeqTrainer(JSeqConfig(spec=jt.TINY_SPEC, **{**LM_BASE, **variant}),
                      jds).train(log=QUIET)
    trainer = SeqTrainer(SeqConfig(spec=tt.TINY_SPEC, precision="bf16", **{**LM_BASE, **variant}),
                         ds, init=init, device="cpu")
    res = trainer.train(log=QUIET)
    assert np.isfinite(res.final_loss)
    np.testing.assert_allclose(res.final_loss, jres.final_loss, rtol=LOSS_RTOL)
    assert abs(res.final_loss - ref.final_loss) < CONTRACT_RTOL * abs(ref.final_loss) \
        + CONTRACT_ATOL
    rel = update_rel_diff(tree.leaves(res.params), jax.tree.leaves(jres.params),
                          jax.tree.leaves(init))
    assert rel <= UPDATE_REL, rel
    opt = trainer.opt_state
    assert all(t.dtype == torch.float32 for t in tree.leaves([trainer.params, opt.m, opt.v]))
    if variant.get("zero1"):
        logical = lm_sharded_adam_to_numpy([opt], tt.TINY_SPEC)
        got = [logical["m"], logical["v"]]
    else:
        got = [tree.map(lambda t: t.numpy(), x) for x in (opt.m, opt.v)]
    jparams, jopt = _jax_span(jtrainer, jds, LM_STEPS)
    for a, b in zip(jax.tree.leaves(jres.params), jparams, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))  # train()'s trajectory
    for a, b in zip(got, (jopt.m, jopt.v)):
        rel = _moment_rel(np.concatenate([x.reshape(-1) for x in tree.leaves(a)]),
                          np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(b)]))
        assert rel <= MOMENT_NORM_RTOL, rel


# -- bf16 serving ---------------------------------------------------------------

SERVE_SPEC = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
SERVE_NEW = 8


@pytest.mark.parametrize("page_size", [0, 8])
def test_bf16_serving_matches_jax_up_to_a_near_tie(page_size):
    jspec, spec = jt.LMSpec(**SERVE_SPEC), tt.LMSpec(**SERVE_SPEC)
    init = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), jspec))
    prompts = j_synthesize_prompts(num=6, min_len=3, max_len=20, vocab=32, seed=0)
    kw = dict(slots=3, capacity=64, page_size=page_size, compute_dtype="bfloat16")
    jeng = JEngine(JServeConfig(spec=jspec, **kw), params=init)
    jmargins = record_margins(jeng)
    jdone, _ = JScheduler(jeng).run(
        [JRequest(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
    eng = InferenceEngine(ServeConfig(spec=spec, **kw), params=init, device="cpu")
    margins = record_margins(eng)
    done, _ = Scheduler(eng).run(
        [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
    assert eng.cache.k.dtype == torch.bfloat16 and eng.cache.v.dtype == torch.bfloat16
    assert sorted(done) == sorted(jdone)
    equal = 0
    for i in jdone:
        assert done[i].status == jdone[i].status == "ok"
        a, b = done[i].tokens, jdone[i].tokens
        step = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if step is None:
            assert a == b
            equal += 1
            continue
        near = min(margins[i][step], jmargins[i][step])
        assert near < NEAR_TIE, (i, step, margins[i][step], jmargins[i][step])
    assert equal >= len(jdone) // 2, f"only {equal} of {len(jdone)} requests equal"


@pytest.mark.parametrize("spec_kw", [SERVE_SPEC, dict(vocab=256, d_model=512, num_heads=8,
                                                      num_layers=4, d_ff=2048)])
def test_bf16_pool_row_bytes_halve(spec_kw):
    """serve_main's LM: 2·L·H·D·2 = 8,192 bytes a row in bf16, 16,384 in
    fp32, as JAX's ``kv_row_bytes`` prices them."""
    spec, jspec = tt.LMSpec(**spec_kw), jt.LMSpec(**spec_kw)
    bf16 = kv_row_bytes(spec, None, torch.bfloat16)
    assert bf16 * 2 == kv_row_bytes(spec, None, torch.float32)
    assert bf16 == j_kv_row_bytes(jspec, None, jnp.bfloat16)
    if spec_kw["d_model"] == 512:
        assert bf16 == 8192
    cfg = ServeConfig(spec=spec, slots=2, capacity=16, page_size=8, compute_dtype="bfloat16")
    if spec_kw["d_model"] == 32:
        eng = InferenceEngine(cfg, device="cpu")
        assert eng.handoff_bytes(3) == 3 * 8 * bf16
        assert eng.cache.k.dtype == torch.bfloat16
