"""The port's resilience layer (ddl_tpu_torch/resilience, obs/health.py, the
trainers' resume, preemption, guard and rollback hooks, serving from a
checkpoint, the CLI's flags) against the JAX package's
(tests/test_resilience.py and tests/test_checkpoint_resume.py, whose cases
these are, less the serve-fleet ones, in tests/test_torch_fleet.py; the
observability ones are in tests/test_torch_obs.py, and ``GuardMonitor``'s
registry and tracer hooks here).

What JAX pins by value is held to JAX here: the fault specs ``parse_fault``
reads and its errors, the data a ``FaultInjector`` poisons, the order a
``FaultStorm`` fires, ``GuardMonitor``'s decisions on the same seeded flag
streams, the CLI's refusal texts, a guarded step's skip flag on the same
poisoned batch, and fp16 serving (tokens equal up to the first near-tie, as
tests/test_torch_precision.py holds bf16 serving). The rest is the port's
own contract, with JAX's tests' shapes: a skipped step leaves params,
moments and the step counter bitwise unchanged; a rollback run is bitwise
the port's own clean run (never JAX's rollback run, whose test is
intermittent: ROADMAP queue 3); a resumed run is bitwise the uninterrupted
one; with the guard off a step runs exactly its unguarded operations.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ddl_tpu import cli as jcli
from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.data.lm import synthesize_prompts as j_synthesize_prompts
from ddl_tpu.models import transformer as jt
from ddl_tpu.resilience import faults as jfaults
from ddl_tpu.resilience.guard import GuardMonitor as JGuardMonitor
from ddl_tpu.serve import InferenceEngine as JEngine
from ddl_tpu.serve import Request as JRequest
from ddl_tpu.serve import Scheduler as JScheduler
from ddl_tpu.serve import ServeConfig as JServeConfig
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu_torch import cli
from ddl_tpu_torch.data.lm import synthesize_copy, synthesize_prompts
from ddl_tpu_torch.data.mnist import load_mnist
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.parallel import multihost
from ddl_tpu_torch.parallel.mesh import AcceleratorTimeout, destroy_world, init_world, run_within
from ddl_tpu_torch.resilience import (
    FaultInjector,
    FaultSpec,
    GuardMonitor,
    corrupt_checkpoint,
)
from ddl_tpu_torch.resilience import faults
from ddl_tpu_torch.serve import InferenceEngine, Request, Scheduler, ServeConfig
from ddl_tpu_torch.strategies.async_ps import AsyncTrainer
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.strategies.sync import SyncTrainer
from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig
from ddl_tpu_torch.train import trainer as ttrainer
from ddl_tpu_torch.utils import checkpoint as ck
from ddl_tpu_torch.utils import tree

from _torch_world import record_margins

QUIET = lambda s: None  # noqa: E731
SPEC = tt.TINY_SPEC
T = 32
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)
NEAR_TIE = 0.0625  # tests/test_torch_precision.py's


def _copy_ds(seed, num_train=64, num_test=16):
    return synthesize_copy(num_train=num_train, num_test=num_test, seq_len=T,
                           vocab=SPEC.vocab, seed=seed)


def _lm(**kw) -> SeqConfig:
    return SeqConfig(**{**dict(epochs=1, eval_every=1, batch_size=16, num_workers=1,
                               scheme="full", spec=SPEC, seed=3), **kw})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: intra-op threads gain nothing, and when
    the suite runs in parallel they only contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mnist():
    return load_mnist(path=None, synthetic_train=1024, synthetic_test=64, seed=7)


@pytest.fixture
def world(tmp_path):
    w = init_world(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    yield w
    destroy_world()


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                      for x, y in zip(la, lb))


def _state_equal(a, b) -> bool:
    """Two optimizer states (dataclasses of tensors or trees) bitwise."""
    return all(_equal([getattr(a, f.name)], [getattr(b, f.name)])
               for f in dataclasses.fields(a))


class StopAfter:
    """A ``should_stop`` that turns true at its ``n``-th poll."""

    def __init__(self, n: int):
        self.n, self.polls = n, 0

    def __call__(self) -> bool:
        self.polls += 1
        return self.polls >= self.n


# -- fault specs, the injector, the monitor: held to JAX's -------------------------


@pytest.mark.parametrize("text", [
    "nan_grads@3x2", "nan_grads@3x2!", "inf_grads@0", "sigterm@5", "corrupt_ckpt",
    "truncate_ckpt", "stall@7", "replica_crash@4:2", "replica_crash", "bogus@1",
    "nan_grads@x", "nan_grads@1x0", "replica_crash@a:1", "sigterm@-1",
])
def test_parse_fault_matches_jax(text):
    def run(mod):
        try:
            return dataclasses.asdict(mod.parse_fault(text))
        except ValueError as e:
            return str(e)

    assert run(faults) == run(jfaults)


def test_injector_poisons_and_heals_as_jax():
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((12, 5)).astype(np.float32)
    for spec in (dict(kind="nan_grads", step=5, count=3), dict(kind="inf_grads", step=1),
                 dict(kind="nan_grads", step=2, once=False), dict(kind="sigterm", step=1)):
        ours, theirs = FaultInjector(FaultSpec(**spec)), jfaults.FaultInjector(
            jfaults.FaultSpec(**spec))
        for _ in range(2):
            a, b = ours.poison_batches(arr, 4, 3), theirs.poison_batches(arr, 4, 3)
            assert a.tobytes() == b.tobytes() and ours.poisons_data() == theirs.poisons_data()
            assert ours.heal() == theirs.heal()
    specs = [faults.parse_fault(t) for t in ("replica_crash@9:2", "replica_crash@3:1",
                                             "replica_crash@3:0")]
    storm = faults.parse_fault_storm("replica_crash@9:2;replica_crash@3:1;replica_crash@3:0")
    jstorm = jfaults.parse_fault_storm("replica_crash@9:2;replica_crash@3:1;replica_crash@3:0")
    assert [storm.crashes_replica(t) for t in range(12)] == [
        jstorm.crashes_replica(t) for t in range(12)]
    assert len(specs) == 3 and not storm.crash_pending
    with pytest.raises(ValueError, match="replica_crash faults only"):
        faults.FaultStorm([FaultSpec(kind="stall")])


@pytest.mark.parametrize("seed", range(4))
def test_guard_monitor_decides_as_jax(seed):
    """The same seeded skip-flag streams, cut into the same spans: every
    ``observe`` answer, streak start, count and rollback outcome equal."""
    rng = np.random.default_rng(seed)
    kw = dict(max_bad_steps=int(rng.integers(0, 4)), max_rollbacks=int(rng.integers(1, 3)))
    ours, theirs = GuardMonitor(**kw), JGuardMonitor(**kw)
    gstep = 0
    for _ in range(12):
        k = int(rng.integers(1, 5))
        flags = (rng.random(k) < 0.5).astype(np.int32)
        out = []
        for mon in (ours, theirs):
            tripped = mon.observe(flags, gstep)
            state = (tripped, mon.streak_start, mon.consecutive, mon.skipped_steps)
            if tripped:
                try:
                    mon.rolled_back(gstep)
                    state += (mon.rollbacks,)
                except RuntimeError as e:
                    state += (str(e),)
            out.append(state)
        assert out[0] == out[1]
        gstep += k


def test_guard_monitor_escalation_policy_and_hooks():
    mon = GuardMonitor(max_bad_steps=3, max_rollbacks=1)
    assert not mon.observe([0, 1, 1], first_gstep=0) and mon.streak_start == 1
    assert not mon.observe([0], first_gstep=3) and mon.streak_start is None
    assert mon.observe([1, 1, 1], first_gstep=4) and mon.streak_start == 4
    assert mon.skipped_steps == 5
    mon.rolled_back(2)
    assert mon.consecutive == 0 and mon.rollbacks == 1
    mon.observe([1, 1, 1], first_gstep=2)
    with pytest.raises(RuntimeError, match="max_rollbacks"):
        mon.rolled_back(2)
    # A healthy flag after the trip belongs to the abandoned timeline.
    mon = GuardMonitor(max_bad_steps=3)
    assert mon.observe([0, 0, 1, 1, 1, 0, 0, 0], first_gstep=10)
    assert mon.streak_start == 12 and mon.skipped_steps == 3
    with pytest.raises(ValueError):
        GuardMonitor(max_bad_steps=-1)
    # The registry and tracer hooks: JAX's counters and events on one stream.
    from ddl_tpu.obs import MetricRegistry as JRegistry, Tracer as JTracer
    from ddl_tpu_torch.obs import MetricRegistry, Tracer

    sides = []
    for mon_cls, reg, tr in ((GuardMonitor, MetricRegistry(), Tracer()),
                             (JGuardMonitor, JRegistry(), JTracer())):
        mon = mon_cls(2, max_rollbacks=2, registry=reg, tracer=tr)
        assert mon.observe([0, 1, 1, 0], first_gstep=5)
        mon.rolled_back(4)
        mon.observe([1, 0], first_gstep=4)
        sides.append((reg.prometheus_text(), [(r["name"], r["attrs"]) for r in tr.records]))
    assert sides[0] == sides[1]
    assert "train_skipped_steps_total 3" in sides[0][0]


def test_run_within_and_agree_flag():
    assert run_within(lambda: 7, 5.0) == 7
    with pytest.raises(KeyError):
        run_within(lambda: {}["x"], 5.0)
    with pytest.raises(AcceleratorTimeout, match="slow op did not complete"):
        run_within(lambda: __import__("time").sleep(2), 0.05, what="slow op")
    with pytest.raises(AcceleratorTimeout, match="rerun with --resume"):
        ttrainer.guarded(lambda: __import__("time").sleep(2), 0.05, "span")
    assert multihost.agree_flag(True) and not multihost.agree_flag(False)


# -- the non-finite guard in the step bodies -------------------------------------


def _poisoned(tr, ds, batch, bs=16, bn=4):
    w = np.array(ds.weights, copy=True)
    w[batch * bs, 0] = np.nan
    return (tr.stage_batches(ds.tokens, bn, bs), tr.stage_batches(ds.targets, bn, bs),
            tr.stage_batches(w, bn, bs))


@pytest.mark.parametrize("zero1", [False, True])
def test_seq_guard_skips_nan_step_state_unchanged(zero1):
    """A poisoned batch: params, moments and the step counter bitwise
    unchanged, the flag up (JAX's replicated body's flag on the same batch
    too); a clean batch: flag down, params move."""
    ds = _copy_ds(8)
    tr = SeqTrainer(_lm(zero1=zero1), ds, device="cpu")
    xs, ys, ws = _poisoned(tr, ds, batch=1)
    prog = tr.span_program(1, guard=True)
    p1, o1, _, skipped = prog(tr.params, tr.opt_state, xs, ys, ws, 1)
    assert skipped.tolist() == [1]
    assert _equal(tr.params, p1) and _state_equal(tr.opt_state, o1)
    p2, o2, loss, sk2 = prog(tr.params, tr.opt_state, xs, ys, ws, 0)
    assert sk2.tolist() == [0] and np.isfinite(float(loss)) and not _equal(tr.params, p2)
    assert int(o2.step) == 1 and int(o1.step) == 0
    if zero1:
        return
    jds = j_synthesize_copy(num_train=64, num_test=16, seq_len=T, vocab=SPEC.vocab, seed=8)
    jtr = JSeqTrainer(JSeqConfig(epochs=1, eval_every=1, batch_size=16, num_workers=1,
                                 scheme="full", spec=jt.TINY_SPEC), jds)
    w = np.array(jds.weights, copy=True)
    w[16, 0] = np.nan
    jx, jy, jw = (jtr.stage_batches(a, 4, 16) for a in (jds.tokens, jds.targets, w))
    out = jtr.span_program(1, guard=True)(jtr.params, jtr.opt_state, jx, jy, jw, jnp.int32(1))
    assert np.asarray(out[-1]).tolist() == skipped.tolist()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops(step, *args) -> list[str]:
    with _Ops() as rec:
        step(*args)
    return rec.ops


@pytest.mark.parametrize("body", ["cnn", "lm_replicated", "lm_zero1"])
def test_guard_off_runs_exactly_the_unguarded_ops(body, mnist):
    """With the guard off a step body runs no ``isfinite``, no ``where``,
    no count (at one rank its groups are ``LOCAL``: no collective either):
    its operations are exactly the first part of the guarded step's,
    whose rest is the guard."""
    if body == "cnn":
        cfg = TrainConfig(batch_size=16, keep_prob=1.0, **TINY)
        tr = SingleChipTrainer(cfg, mnist, device="cpu")
        x = torch.as_tensor(mnist.x_train[:16])
        y = torch.nn.functional.one_hot(torch.as_tensor(mnist.y_train[:16]).long(), 10).float()
        args = (tr.params, tr.opt_state, x, y, 0)
        off, on = (_ops(ttrainer.make_train_step(cfg, guard=g), *args) for g in (False, True))
    else:
        ds = _copy_ds(8)
        tr = SeqTrainer(_lm(zero1=body == "lm_zero1"), ds, device="cpu")
        xs, ys, ws = _poisoned(tr, ds, batch=3)
        args = (tr.params, tr.opt_state, xs[0], ys[0], ws[0])
        off, on = (_ops(tr.step_fn(g), *args) for g in (False, True))
    # isfinite reaches the dispatcher as abs/ne/eq/mul, then logical_not.
    assert not [op for op in off if op.startswith("aten.logical_not")]
    assert on[:len(off)] == off
    tail = on[len(off):]
    assert all(any(op.startswith(g) for op in tail) for g in ("aten.where", "aten.logical_not"))


def test_single_chip_guard_skips_and_converges(mnist):
    cfg = TrainConfig(epochs=1, batch_size=128, eval_every=0, seed=5, **TINY)
    inj = FaultInjector(FaultSpec(kind="nan_grads", step=2))
    r = SingleChipTrainer(cfg, mnist, device="cpu").train(log=QUIET, guard=True,
                                                          fault_injector=inj)
    assert r.skipped_steps == 1 and r.rollbacks == 0
    assert all(np.isfinite(v).all() for v in r.params.values())


def test_seq_guard_converges_with_injected_inf():
    ds = _copy_ds(11)
    cfg = _lm(epochs=2, eval_every=0)
    clean = SeqTrainer(cfg, ds, device="cpu").train(log=QUIET)
    inj = FaultInjector(FaultSpec(kind="inf_grads", step=1))
    faulted = SeqTrainer(cfg, ds, device="cpu").train(log=QUIET, guard=True, fault_injector=inj)
    assert faulted.skipped_steps == 2  # batch 1 on both epoch passes
    assert np.isfinite(faulted.final_loss)
    assert abs(faulted.final_loss - clean.final_loss) < 0.15 * clean.final_loss


@pytest.mark.parametrize("zero1", [False, True])
def test_seq_rollback_is_bitwise_the_clean_run(zero1, tmp_path):
    """Two consecutive NaN steps roll back to the last good save; the fault
    heals and the replay finishes bitwise the port's own clean run."""
    ds = _copy_ds(8)
    cfg = _lm(zero1=zero1)
    clean = SeqTrainer(cfg, ds, device="cpu").train(log=QUIET)
    inj = FaultInjector(FaultSpec(kind="nan_grads", step=1, count=2))
    logs = []
    r = SeqTrainer(cfg, ds, device="cpu").train(
        log=logs.append, checkpoint_dir=str(tmp_path), checkpoint_every=1, max_bad_steps=2,
        fault_injector=inj)
    assert (r.rollbacks, r.skipped_steps) == (1, 2)
    assert _equal(clean.params, r.params) and r.final_accuracy == clean.final_accuracy
    assert any("[guard] rolled back to checkpoint step 1" in s for s in logs)
    assert ck.find_latest_valid(tmp_path)[1] == 4


def test_guard_rollback_needs_a_checkpoint_and_a_bound():
    ds = _copy_ds(8, num_train=32)
    with pytest.raises(RuntimeError, match="no checkpoint_dir"):
        SeqTrainer(_lm(), ds, device="cpu").train(
            log=QUIET, max_bad_steps=1, fault_injector=FaultInjector(
                FaultSpec(kind="nan_grads", step=0)))


def test_persistent_fault_exhausts_rollbacks(tmp_path):
    ds = _copy_ds(8, num_train=32)
    inj = FaultInjector(FaultSpec(kind="nan_grads", step=1, once=False))
    with pytest.raises(RuntimeError, match="max_rollbacks"):
        SeqTrainer(_lm(), ds, device="cpu").train(
            log=QUIET, checkpoint_dir=str(tmp_path), checkpoint_every=1, max_bad_steps=1,
            max_rollbacks=1, fault_injector=inj)


# -- preemption, resume, corrupt saves ---------------------------------------------


@contextlib.contextmanager
def _cli_signal_flag():
    """The CLI's SIGTERM/SIGINT flag, the process's handlers restored after
    (the flag handler resets itself on delivery)."""
    saved = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        yield cli._install_sigterm_flag(True)
    finally:
        signal.signal(signal.SIGTERM, saved[0])
        signal.signal(signal.SIGINT, saved[1])


def test_sigterm_resume_auto_bit_identical(tmp_path):
    """A REAL SIGTERM after step 1 drains the span, saves and stops;
    ``resume="auto"`` finishes bitwise the uninterrupted run."""
    ds = _copy_ds(12)
    cfg = _lm(epochs=2, eval_every=2, seed=4)
    golden = SeqTrainer(cfg, ds, device="cpu").train(log=QUIET)
    d = str(tmp_path / "ck")
    with _cli_signal_flag() as term:
        pre = SeqTrainer(cfg, ds, device="cpu").train(
            log=QUIET, checkpoint_dir=d, should_stop=lambda: term["flag"],
            fault_injector=FaultInjector(FaultSpec(kind="sigterm", step=1)))
    assert pre.preempted and ck.find_latest_valid(d) is not None
    resumed = SeqTrainer(cfg, ds, device="cpu").train(log=QUIET, checkpoint_dir=d,
                                                      resume="auto")
    assert 0 < resumed.resumed_from_step < 8 and not resumed.preempted
    assert _equal(golden.params, resumed.params)
    assert resumed.final_accuracy == golden.final_accuracy


def test_corrupt_latest_checkpoint_resume_auto_falls_back(tmp_path):
    ds = _copy_ds(14)
    golden = SeqTrainer(_lm(epochs=2, eval_every=2), ds, device="cpu").train(log=QUIET)
    d = str(tmp_path / "ck")
    SeqTrainer(_lm(eval_every=2), ds, device="cpu").train(log=QUIET, checkpoint_dir=d,
                                                          checkpoint_every=1)
    assert ck.find_latest_valid(d)[1] == 4
    corrupt_checkpoint(os.path.join(d, "ckpt.npz"))
    fallback = ck.find_latest_valid(d)
    assert fallback is not None and fallback[1] < 4
    logs = []
    resumed = SeqTrainer(_lm(epochs=2, eval_every=2), ds, device="cpu").train(
        log=logs.append, checkpoint_dir=d, resume="auto")
    assert resumed.resumed_from_step == fallback[1]
    assert any("skipping corrupt" in s for s in logs)
    assert _equal(golden.params, resumed.params)


class Killer:
    """A log callback that raises at the ``after``-th eval line: a crash."""

    def __init__(self, after: int):
        self.after, self.seen = after, 0

    def __call__(self, msg: str) -> None:
        if msg.startswith("epoch:"):
            self.seen += 1
            if self.seen >= self.after:
                raise KeyboardInterrupt(msg)


def test_single_killed_and_resumed_mid_epoch(mnist, tmp_path):
    """8 batches, spans (0,1)(1,2)(3,2)(5,2)(7,1), a save every 3 steps:
    a crash at the 4th eval leaves step 3, and the resume is bitwise the
    uninterrupted run."""
    cfg = TrainConfig(epochs=1, batch_size=128, eval_every=2, seed=5, **TINY)
    ref = SingleChipTrainer(cfg, mnist, device="cpu").train(log=QUIET)
    d = str(tmp_path / "ck")
    with pytest.raises(KeyboardInterrupt):
        SingleChipTrainer(cfg, mnist, device="cpu").train(log=Killer(4), checkpoint_dir=d,
                                                          checkpoint_every=3)
    resumed = SingleChipTrainer(cfg, mnist, device="cpu").train(log=QUIET, checkpoint_dir=d,
                                                                resume=True)
    assert resumed.resumed_from_step == 3
    assert _equal(ref.params, resumed.params) and resumed.final_accuracy == ref.final_accuracy


def test_resume_without_checkpoint_starts_fresh_and_wrong_width_is_diagnosed(mnist, tmp_path):
    cfg = TrainConfig(epochs=1, batch_size=512, eval_every=0, **TINY)
    d = str(tmp_path / "ck")
    r = SingleChipTrainer(cfg, mnist, device="cpu").train(log=QUIET, checkpoint_dir=d,
                                                          resume=True)
    assert r.resumed_from_step == 0 and os.path.exists(os.path.join(d, "ckpt.npz"))
    wide = TrainConfig(epochs=1, batch_size=512, eval_every=0, conv_channels=(2, 4, 4, 4),
                       fc_sizes=(16, 8))
    with pytest.raises(RuntimeError, match="incompatible"):
        SingleChipTrainer(wide, mnist, device="cpu").train(log=QUIET, checkpoint_dir=d,
                                                           resume=True)


@pytest.mark.parametrize("kind", ["single", "sync_zero1", "async"])
def test_preempted_run_saves_and_resumes_bitwise(kind, mnist, world, tmp_path):
    """should_stop stops after the 3rd span WITH a checkpoint; a resume
    finishes bitwise the uninterrupted run (the ZeRO-1 chunk and the async
    serve come back into their buffers)."""
    if kind == "single":
        cfg = TrainConfig(epochs=1, batch_size=128, eval_every=2, seed=5, **TINY)
        make = lambda: SingleChipTrainer(cfg, mnist, device="cpu")  # noqa: E731
    elif kind == "sync_zero1":
        cfg = TrainConfig(epochs=1, batch_size=128, eval_every=2, seed=5, num_ps=2,
                          layout="zigzag", fused_adam=True, **TINY)
        make = lambda: SyncTrainer(cfg, mnist, world)  # noqa: E731
    else:
        cfg = TrainConfig(epochs=1, batch_size=128, eval_every=2, seed=5, num_ps=2,
                          layout="block", **TINY)
        make = lambda: AsyncTrainer(cfg, mnist, world)  # noqa: E731
    ref = make().train(log=QUIET)
    d = str(tmp_path / "ck")
    pre = make().train(log=QUIET, checkpoint_dir=d, should_stop=StopAfter(3))
    assert pre.preempted
    trainer = make()
    resumed = trainer.train(log=QUIET, checkpoint_dir=d, resume=True)
    assert resumed.resumed_from_step == (6 if kind == "async" else 5)  # async: 2-round chunks
    assert _equal(ref.params, resumed.params) and not resumed.preempted


def test_elastic_and_cross_strategy_resume(mnist, world, tmp_path):
    """The params-shaped moments resume across layouts and families: an
    epoch of ZeRO-1 flat, then one of zigzag over 3 shards; an epoch of the
    single-device trainer, then one of ZeRO-1. keep_prob 1 and the mean
    make them step-equivalent to the single-device 2-epoch run."""
    base = dict(batch_size=256, eval_every=0, keep_prob=1.0, seed=2, **TINY)
    ref = SingleChipTrainer(TrainConfig(epochs=2, **base), mnist, device="cpu").train(log=QUIET)
    for first, second in (
            (SyncTrainer(TrainConfig(epochs=1, num_ps=2, layout="flat", **base), mnist, world),
             SyncTrainer(TrainConfig(epochs=2, num_ps=3, layout="zigzag", **base), mnist,
                         world)),
            (SingleChipTrainer(TrainConfig(epochs=1, **base), mnist, device="cpu"),
             SyncTrainer(TrainConfig(epochs=2, num_ps=2, layout="flat", **base), mnist,
                         world))):
        d = str(tmp_path / type(first).__name__)
        first.train(log=QUIET, checkpoint_dir=d)
        resumed = second.train(log=QUIET, checkpoint_dir=d, resume=True)
        assert resumed.resumed_from_step == 4
        for k in ref.params:
            np.testing.assert_allclose(ref.params[k], resumed.params[k], atol=2e-5, err_msg=k)


def test_cross_cadence_resume_trains_every_batch(mnist, world, tmp_path):
    """A save landing mid-span of the resumed run's grid: the spans (and the
    async chunks) realign so that every remaining step runs once (the Adam
    step counter and the push counter count them)."""
    cfg_a = TrainConfig(epochs=1, batch_size=128, eval_every=2, seed=5, **TINY)
    d = str(tmp_path / "single")
    with pytest.raises(KeyboardInterrupt):
        SingleChipTrainer(cfg_a, mnist, device="cpu").train(log=Killer(4), checkpoint_dir=d,
                                                            checkpoint_every=3)
    trainer = SingleChipTrainer(TrainConfig(epochs=1, batch_size=128, eval_every=5, seed=5,
                                            **TINY), mnist, device="cpu")
    resumed = trainer.train(log=QUIET, checkpoint_dir=d, resume=True)
    assert resumed.resumed_from_step == 3 and int(trainer.opt_state.step) == 8
    ref = SingleChipTrainer(cfg_a, mnist, device="cpu").train(log=QUIET)
    assert _equal(ref.params, resumed.params)
    kw = dict(batch_size=128, seed=4, num_ps=2, layout="block", **TINY)
    d = str(tmp_path / "async")
    with pytest.raises(KeyboardInterrupt):
        AsyncTrainer(TrainConfig(epochs=1, eval_every=3, **kw), mnist, world).train(
            log=Killer(2), checkpoint_dir=d, checkpoint_every=2)
    trainer = AsyncTrainer(TrainConfig(epochs=1, eval_every=2, **kw), mnist, world)
    resumed = trainer.train(log=QUIET, checkpoint_dir=d, resume=True)
    assert resumed.resumed_from_step == 3 and int(trainer.state.t) == 8


# -- serving from a checkpoint, fp16 serving ---------------------------------------


def test_engine_serves_a_training_checkpoint(tmp_path):
    """``from_checkpoint`` and ``load_params`` on an LM checkpoint (the
    ZeRO-1 trainer's, whose moments the engine ignores): the same tokens as
    an engine built from the run's params."""
    ds = _copy_ds(5, num_train=32)
    r = SeqTrainer(_lm(zero1=True), ds, device="cpu").train(log=QUIET,
                                                            checkpoint_dir=str(tmp_path))
    cfg = ServeConfig(spec=SPEC, slots=2, capacity=48, page_size=8)
    prompts = synthesize_prompts(num=3, min_len=3, max_len=12, vocab=SPEC.vocab, seed=1)
    runs = []
    for eng in (InferenceEngine.from_checkpoint(cfg, tmp_path / "ckpt.npz", device="cpu"),
                InferenceEngine(cfg, params=r.params, device="cpu")):
        done, _ = Scheduler(eng).run([Request(id=i, prompt=p, max_new_tokens=6)
                                      for i, p in enumerate(prompts)])
        runs.append({i: done[i].tokens for i in done})
    assert runs[0] == runs[1]
    eng = InferenceEngine(cfg, device="cpu")
    eng.load_params(tmp_path / "ckpt.npz")
    assert _equal(eng.params, r.params)


SERVE_SPEC = dict(vocab=32, d_model=32, num_heads=2, num_layers=2, d_ff=64)
SERVE_NEW = 8


def test_fp16_serving_matches_jax_up_to_a_near_tie():
    """``compute_dtype="float16"`` serves, as JAX's engine does: fp16
    weights, activations and pools; tokens equal to JAX's fp16 engine up to
    the first near-tie."""
    jspec, spec = jt.LMSpec(**SERVE_SPEC), tt.LMSpec(**SERVE_SPEC)
    init = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(0), jspec))
    prompts = j_synthesize_prompts(num=6, min_len=3, max_len=20, vocab=32, seed=0)
    kw = dict(slots=3, capacity=64, page_size=8, compute_dtype="float16")
    jeng = JEngine(JServeConfig(spec=jspec, **kw), params=init)
    jmargins = record_margins(jeng)
    jdone, _ = JScheduler(jeng).run(
        [JRequest(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
    eng = InferenceEngine(ServeConfig(spec=spec, **kw), params=init, device="cpu")
    margins = record_margins(eng)
    done, _ = Scheduler(eng).run(
        [Request(id=i, prompt=p, max_new_tokens=SERVE_NEW) for i, p in enumerate(prompts)])
    assert eng.cache.k.dtype == torch.float16
    equal = 0
    for i in jdone:
        assert done[i].status == jdone[i].status == "ok"
        a, b = done[i].tokens, jdone[i].tokens
        step = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if step is None:
            equal += 1
            continue
        assert min(margins[i][step], jmargins[i][step]) < NEAR_TIE, (i, step)
    assert equal >= len(jdone) // 2


# -- the CLI ---------------------------------------------------------------------


LM_ONE = ["--seq-scheme", "full", "--num-workers", "1"]


@pytest.mark.parametrize("argv", [
    ["sync", "--max-bad-steps", "2", "--checkpoint-dir", "ck"],
    ["single", "--max-bad-steps", "0", "--checkpoint-dir", "ck"],
    ["lm", "--max-bad-steps", "2"],
    ["lm", "--resume"],
    ["sync", "--inject-fault", "nan_grads@1"],
    ["lm", "--inject-fault", "stall@1"] + LM_ONE,
    ["lm", "--inject-fault", "bogus@1"] + LM_ONE,
    ["lm", "--inject-fault", "truncate_ckpt"] + LM_ONE,
    ["serve", "--resume"],
])
def test_cli_resilience_flags_exit_with_jax_texts(argv, tmp_path, monkeypatch):
    """Each refusal's text is the JAX CLI's; the port also takes sigterm and
    the checkpoint kinds on sync and async, which JAX's refuses."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    want = str(theirs.value)
    if argv[:2] == ["sync", "--inject-fault"]:
        want = "--inject-fault nan_grads applies to the single/lm variants (the guarded trainers)"
    assert str(ours.value) == want


def _cli_json(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_preempt_truncate_and_resume_on_sync(tmp_path, monkeypatch):
    """The chip smoke's cli_preempt on the CPU: sigterm@10 stops after step
    11 with saves at 10 and 11; truncate_ckpt damages the newest; --resume
    auto falls back to step 10 and finishes bitwise the uninterrupted
    run's final checkpoint."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    base = ["sync_sharding", "--device", "cpu", "--tiny", "--num-ps", "2", "--layout", "flat",
            "--fused-adam", "--synthetic-train", "1600", "--synthetic-test", "32",
            "--eval-every", "1", "--batch-size", "80", "--json"]
    d, ref = str(tmp_path / "ck"), str(tmp_path / "ref")
    _cli_json(base + ["--checkpoint-dir", ref])
    with _cli_signal_flag():
        out = _cli_json(base + ["--checkpoint-dir", d, "--checkpoint-every", "10",
                                "--inject-fault", "sigterm@10"])
    assert out["preempted"] and sorted(os.listdir(d))[:4:2] == [
        "ckpt-00000010.npz", "ckpt-00000011.npz"]
    with _cli_signal_flag():
        out = _cli_json(base + ["--checkpoint-dir", d, "--inject-fault", "truncate_ckpt",
                                "--resume", "auto"])
    assert out["resumed_from_step"] == 10 and not out["preempted"]
    with np.load(os.path.join(d, "ckpt.npz")) as a, np.load(os.path.join(ref, "ckpt.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].tobytes() == b[k].tobytes(), k


def test_cli_lm_guard_chaos_and_serve_from_checkpoint(tmp_path):
    """nan_grads@1x2 with --max-bad-steps 2 rolls back once and finishes
    finite; serve --checkpoint-dir then serves those params; a serve stall
    reaches the scheduler: without a deadline the run is refused, as JAX's,
    and with one the stalled request alone is evicted with no tokens."""
    lm = ["lm", "--device", "cpu", "--seq-scheme", "full", "--seq-len", "32", "--vocab", "16",
          "--d-model", "32", "--heads", "2", "--layers", "2", "--d-ff", "64",
          "--train-seqs", "64", "--test-seqs", "16", "--batch-size", "16", "--eval-every", "1",
          "--json"]
    d = str(tmp_path / "ck")
    with _cli_signal_flag():
        out = _cli_json(lm + ["--checkpoint-dir", d, "--checkpoint-every", "1",
                              "--max-bad-steps", "2", "--inject-fault", "nan_grads@1x2"])
    assert (out["skipped_steps"], out["rollbacks"]) == (2, 1) and np.isfinite(out["final_loss"])
    serve = ["serve", "--device", "cpu", "--vocab", "16", "--d-model", "32", "--heads", "2",
             "--layers", "2", "--d-ff", "64", "--slots", "2", "--capacity", "48",
             "--max-new-tokens", "4", "--num-prompts", "2", "--prompt-max", "12", "--json"]
    got = _cli_json(serve + ["--checkpoint-dir", d])
    assert all(c["status"] == "ok" for c in got["completions"].values())
    with pytest.raises(SystemExit, match="no checkpoint at"):
        cli.main(serve + ["--checkpoint-dir", str(tmp_path / "none")])
    with pytest.raises(ValueError, match="stall fault injected but no TTFT/total deadline"):
        cli.main(serve + ["--inject-fault", "stall@1"])
    # A deadline the unstalled request meets with room to spare under load.
    got = _cli_json(serve + ["--inject-fault", "stall@1", "--request-deadline", "1.0"])
    assert got["completions"]["1"]["status"] == "deadline_exceeded"
    assert got["completions"]["1"]["tokens"] == []
    assert got["completions"]["0"]["status"] == "ok"
