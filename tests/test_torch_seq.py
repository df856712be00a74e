"""The port's LM trainer (ddl_tpu_torch/strategies/seq.py) and copy-task
data against the JAX package.

- ``synthesize_copy``: byte-equal arrays for the same arguments.
- ``SeqTrainer`` against ``ddl_tpu.strategies.seq.SeqTrainer`` (scheme
  ``full``, one device) from one JAX init, 4 steps at ``TINY_SPEC`` and
  T = 32, for ``attn_impl`` flash and xla and for ``remat``: the final loss
  within rtol 1e-4 and the parameters within atol 2e-5 / rtol 1e-3 (the
  tolerances of tests/test_lm.py's flash-vs-xla pin: the two sides run the
  same fp32 math in another order, and Adam moves each parameter by about
  lr whatever the gradient's size), and the same accuracy history.
- The options the sequence-parallel slice ported (ring, Ulysses, zigzag,
  ZeRO-1) and the bf16 policy train on one device without a world; W, dp,
  tp or pp above 1 without a world raises; the JAX trainer's own checks
  raise the same ``ValueError``s. (The bf16 policy's parity with JAX is
  tests/test_torch_precision.py's.)
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.models import transformer as jt
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.utils import tree

QUIET = lambda s: None  # noqa: E731
BASE = dict(epochs=1, batch_size=4, learning_rate=1e-3, eval_every=2, seed=3, scheme="full")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_train=10, num_test=3, seq_len=32, vocab=16, seed=4),
    dict(num_train=5, num_test=0, seq_len=2048, vocab=256, seed=0),
])
def test_synthesize_copy_byte_equal(kw):
    got, want = synthesize_copy(**kw), j_synthesize_copy(**kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name
    with pytest.raises(ValueError):
        synthesize_copy(seq_len=31)
    with pytest.raises(ValueError):
        synthesize_copy(vocab=2)


def _datasets(seed=9):
    kw = dict(num_train=16, num_test=8, seq_len=32, vocab=tt.TINY_SPEC.vocab, seed=seed)
    return synthesize_copy(**kw), j_synthesize_copy(**kw)


@pytest.mark.parametrize("variant", [
    dict(attn_impl="flash"),
    dict(attn_impl="xla"),
    dict(attn_impl="flash", remat=True),
])
def test_seq_trainer_matches_jax(variant):
    ds, jds = _datasets()
    init = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(BASE["seed"]), jt.TINY_SPEC))
    jres = JSeqTrainer(JSeqConfig(spec=jt.TINY_SPEC, **BASE, **variant), jds).train(log=QUIET)
    tres = SeqTrainer(SeqConfig(spec=tt.TINY_SPEC, **BASE, **variant), ds, init=init,
                      device="cpu").train(log=QUIET)
    assert np.isclose(tres.final_loss, jres.final_loss, rtol=1e-4), (tres.final_loss, jres.final_loss)
    assert tres.history == [(e, b, float(a)) for e, b, a in jres.history]
    assert len(tres.history) == 3  # after batches 0 and 2, and at the end
    got, want = tree.leaves(tres.params), jax.tree.leaves(jres.params)
    assert len(got) == len(want) == 4 + 12 * tt.TINY_SPEC.num_layers
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=1e-3)


def test_seq_trainer_bf16_compute_keeps_fp32_masters():
    ds, _ = _datasets(seed=2)
    trainer = SeqTrainer(SeqConfig(spec=tt.TINY_SPEC, compute_dtype="bfloat16", attn_impl="flash",
                                   **BASE), ds, device="cpu")
    res = trainer.train(log=QUIET)
    assert np.isfinite(res.final_loss) and 0.0 <= res.final_accuracy <= 1.0
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for t in tree.leaves([trainer.params, trainer.opt_state.m, trainer.opt_state.v]))
    assert int(trainer.opt_state.step) == 4
    assert res.tokens_per_sec > 0 and res.step_stats.steps == 3


@pytest.mark.parametrize("change,outcome", [
    (dict(scheme="ring"), "trains"),
    (dict(scheme="ulysses"), "trains"),
    (dict(num_workers=2, scheme="ring"), "needs a world"),
    (dict(data_parallel=2), "needs a world"),
    # Tensor parallelism is ported: tp 2 needs a world of 2 ranks (the id
    # is the case's name from when it still raised).
    pytest.param(dict(tensor_parallel=2), "needs a world",
                 id="change4-ROADMAP queue 1, item 3: tensor parallelism"),
    # The pipeline is ported: pp 2 needs a world of 2 ranks (the id is the
    # case's name from when it still raised).
    pytest.param(dict(pipeline_parallel=2, microbatches=2), "needs a world",
                 id="change5-ROADMAP queue 1, item 3: the pipeline"),
    (dict(zero1=True), "trains"),
    (dict(scheme="ring", seq_layout="zigzag"), "trains"),
    # The bf16 policy is ported: it trains on one device, and bf16 under a
    # pipeline needs a world of 2 ranks (the ids are the cases' names from
    # when they still raised).
    pytest.param(dict(precision="bf16"), "trains", id="change8-ROADMAP queue 1, item 4"),
    pytest.param(dict(pipeline_parallel=2, microbatches=2, compute_dtype="bfloat16"),
                 "needs a world", id="change9-ROADMAP queue 1, item 4"),
])
def test_out_of_slice_options_raise(change, outcome):
    """Before the sequence-parallel slice every one of these raised. Now the
    ported ones train on one device (ZeRO-1 keeps one flat chunk of the
    whole vector, the bf16 policy fp32 masters and moments), and a grid of
    more than one rank (sequence, data, tensor or pipeline parallel) needs
    a world."""
    ds, _ = _datasets()
    kw = {**BASE, "spec": tt.TINY_SPEC, **change}
    if outcome == "needs a world":
        with pytest.raises(ValueError, match="needs a world of 2 ranks"):
            SeqTrainer(SeqConfig(**kw), ds, device="cpu")
    else:
        trainer = SeqTrainer(SeqConfig(**kw), ds, device="cpu")
        res = trainer.train(log=QUIET)
        assert np.isfinite(res.final_loss) and int(trainer.opt_state.step) == 4
        assert all(t.dtype == torch.float32 for t in tree.leaves(
            [trainer.params, trainer.opt_state.m, trainer.opt_state.v]))
        if change.get("zero1"):
            assert trainer.opt_state.m.shape == (tt.TINY_SPEC.num_params(),)


@pytest.mark.parametrize("change,match", [
    (dict(attn_impl="pallas"), "unknown attn_impl"),
    (dict(scheme="ring", attn_impl="flash"), "flash"),
    (dict(scheme="full", num_workers=2), "cannot shard"),
    (dict(batch_size=32), "exceeds 16 train sequences"),
    (dict(spec=dataclasses.replace(tt.TINY_SPEC, vocab=8)), "exceeds model vocab"),
    (dict(scheme="ulysses", num_workers=4), "ulysses needs per-device num_heads"),
    (dict(data_parallel=3), "not divisible by data_parallel 3"),
    (dict(scheme="ring", seq_layout="zigzag", num_workers=3), "not divisible by 3 workers"),
    (dict(scheme="ring", seq_layout="zigzag", num_workers=32), "needs seq_len % \\(2"),
    (dict(scheme="ulysses", seq_layout="zigzag"), "balances the RING"),
    (dict(microbatches=2), "requires pipeline_parallel > 1"),
    (dict(data_parallel=0), "must be >= 1"),
])
def test_jax_checks_raise_the_same_value_errors(change, match):
    ds, jds = _datasets()
    kw = {**BASE, "spec": tt.TINY_SPEC, **change}
    with pytest.raises(ValueError, match=match):
        SeqTrainer(SeqConfig(**kw), ds, device="cpu")
    jkw = dict(kw, spec=jt.LMSpec(**dataclasses.asdict(kw["spec"])))
    with pytest.raises(ValueError, match=match):
        JSeqTrainer(JSeqConfig(**jkw), jds)


@pytest.mark.parametrize("prec,dtype", [
    (None, None), (None, "bfloat16"), (None, "float32"), ("fp32", None),
])
def test_precision_resolves_as_jax(prec, dtype):
    from ddl_tpu import precision as jp
    from ddl_tpu_torch import precision as tp

    got, want = tp.resolve(prec, dtype), jp.resolve(prec, dtype)
    assert (got.name, got.legacy) == (want.name, want.legacy)
    assert (got.compute_dtype is None) == (want.compute_dtype is None)


@pytest.mark.parametrize("prec,dtype,error", [
    # The bf16 policy is ported (the id is the case's name from when it
    # still raised); its refusal is a conflicting compute dtype.
    pytest.param("bf16", "float32", ValueError, id="bf16-None-NotImplementedError"),
    (None, "float16", ValueError),
    ("fp16", None, ValueError), ("fp32", "bfloat16", ValueError), ("fp32", "float32", ValueError),
])
def test_precision_refusals(prec, dtype, error):
    from ddl_tpu_torch import precision as tp

    with pytest.raises(error):
        tp.resolve(prec, dtype)


def test_config_fields_and_defaults_match_jax():
    got = {f.name: f.default for f in dataclasses.fields(SeqConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JSeqConfig)}
    assert got.keys() == want.keys()
    got["spec"], want["spec"] = dataclasses.asdict(got["spec"]), dataclasses.asdict(want["spec"])
    assert got == want


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds, _ = _datasets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeqTrainer(SeqConfig(spec=tt.TINY_SPEC, **BASE), ds)
