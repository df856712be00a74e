"""The port's checkpoint module (ddl_tpu_torch/utils/checkpoint.py) against
the JAX package's (ddl_tpu/utils/checkpoint.py): the file is the contract
between the two packages.

- Key paths: the port's flatten names every leaf as ``jax.tree_util.keystr``
  does (dict keys sorted, ``[i]`` items, ``.field`` of dataclasses and
  NamedTuples).
- Cross-package round trips, bitwise, for each trainer family's checkpoint
  form: the single-device ``AdamState``, the sync ZeRO-1 ``ShardedAdam``
  (params-shaped moments), the async ``AsyncState`` and the LM's standard
  form at the replicated and ZeRO-1 modes. JAX writes a seeded tree; the
  port reads it into its trainer's template, places it on its state (the
  ZeRO-1 chunk, the async serve), takes it back to the checkpoint form and
  writes it; JAX reads that file back equal to what it wrote, and the two
  manifests are equal as JSON. (The hybrid and the pipeline need tp and pp
  ranks: tests/test_torch_seq_parallel.py runs their round trips in the
  4-rank world.)
- The file mechanics held to JAX's on the same inputs: retention and the
  rolling hardlink, the damaged files the fault helpers make (byte for
  byte), verification, ``find_latest_valid``, ``discard_newer``, and the
  refusal texts of a mismatched load.
- Resume parity: one package trains N steps and saves, the other resumes to
  2N, in both orders, held to JAX's uninterrupted 2N run at the port
  trainer tests' tolerances (tests/test_torch_sync.py for the CNN at
  keep_prob 1, tests/test_torch_seq.py for the LM).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ddl_tpu.data import load_mnist as j_load_mnist
from ddl_tpu.data.lm import synthesize_copy as j_synthesize_copy
from ddl_tpu.models import transformer as jt
from ddl_tpu.ops import AdamState as JAdamState
from ddl_tpu.resilience import faults as jfaults
from ddl_tpu.strategies.async_ps import AsyncState as JAsyncState
from ddl_tpu.strategies.seq import SeqConfig as JSeqConfig, SeqTrainer as JSeqTrainer
from ddl_tpu.strategies.sync import ShardedAdam as JShardedAdam
from ddl_tpu.train import SingleChipTrainer as JSingle, TrainConfig as JConfig
from ddl_tpu.utils import checkpoint as jck
from ddl_tpu_torch.convert import lm_zeros_numpy
from ddl_tpu_torch.data.lm import synthesize_copy
from ddl_tpu_torch.data.mnist import load_mnist
from ddl_tpu_torch.models import cnn as tcnn
from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.ops.optimizers import AdamState, ShardedAdam
from ddl_tpu_torch.parallel.mesh import destroy_world, init_world
from ddl_tpu_torch.resilience import faults
from ddl_tpu_torch.strategies.async_ps import AsyncState, AsyncTrainer
from ddl_tpu_torch.strategies.seq import SeqConfig, SeqTrainer
from ddl_tpu_torch.strategies.sync import SyncTrainer
from ddl_tpu_torch.train import SingleChipTrainer, TrainConfig
from ddl_tpu_torch.utils import checkpoint as ck
from ddl_tpu_torch.utils import tree

QUIET = lambda s: None  # noqa: E731
TINY = dict(conv_channels=tcnn.TINY_CONV_CHANNELS, fc_sizes=tcnn.TINY_FC_SIZES)
LM_BASE = dict(batch_size=4, learning_rate=1e-3, eval_every=2, seed=3, scheme="full")
LM_DATA = dict(num_train=16, num_test=8, seq_len=32, vocab=tt.TINY_SPEC.vocab, seed=4)
CNN_ATOL = 1e-5  # lr / 10 (tests/test_torch_sync.py's PARAMS_ATOL)
LM_ATOL, LM_RTOL = 2e-5, 1e-3  # tests/test_torch_seq.py's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are tiny: intra-op threads gain nothing, and when
    the suite runs in parallel they only contend with the other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return load_mnist(path=None, synthetic_train=512, synthetic_test=64, seed=7)


@pytest.fixture
def world(tmp_path):
    """A gloo world of one in this process (the sync and async trainers
    take a world)."""
    w = init_world(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    yield w
    destroy_world()


def _leaves_equal(a, b) -> None:
    la, lb = ck.flatten_with_paths(a), ck.flatten_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


def _manifest(path) -> dict:
    with open(ck.manifest_path(path)) as f:
        return json.load(f)


def test_key_paths_are_jax_keystr():
    rng = np.random.default_rng(0)
    leaf = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    step = np.asarray(3, np.int32)
    jtree = {"params": {"b": leaf(2), "a": [{"y": leaf(1), "x": leaf(3)}], "t": (leaf(1), leaf(2))},
             "opt": JAdamState(step=step, m={"w1": leaf(2)}, v={"w1": leaf(2)}),
             "state": JAsyncState(ps=leaf(4), m=leaf(4), v=leaf(4), workers=leaf(1, 4), t=step),
             "s": JShardedAdam(step=step, m=leaf(3), v=leaf(3)), "none": None}
    ttree = {"params": jtree["params"],
             "opt": AdamState(step=step, m=jtree["opt"].m, v=jtree["opt"].v),
             "state": AsyncState(**dataclasses.asdict(jtree["state"])),
             "s": ShardedAdam(step=step, m=jtree["s"].m, v=jtree["s"].v), "none": None}
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [k for k, _ in ck.flatten_with_paths(ttree)] == want
    assert [k for k, _ in ck.flatten_with_paths(jtree)] == want  # NamedTuples too


def _rand_like(template, rng):
    """Seeded float32 arrays (int32 for int leaves) in the shapes of a
    numpy template tree, same structure."""
    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return np.asarray(rng.integers(1, 50), np.int32)
        return rng.standard_normal(a.shape).astype(np.float32)
    return ck._rebuild(template, iter([fill(x) for _, x in ck.flatten_with_paths(template)]))


def _cnn_np(specs, rng):
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in specs}


def _family(name, ds, world, rng):
    """(the JAX checkpoint tree, the port's StateIO-like triple (like,
    place, for_save)) of one trainer family, seeded."""
    specs = tcnn.make_param_specs(tcnn.TINY_CONV_CHANNELS, tcnn.TINY_FC_SIZES)
    step = np.asarray(7, np.int32)
    if name in ("single", "sync_zero1"):
        params, m, v = (_cnn_np(specs, rng) for _ in range(3))
        if name == "single":
            jtree = {"params": params, "opt": JAdamState(step=step, m=m, v=v)}
            io = SingleChipTrainer(TrainConfig(**TINY), ds, device="cpu").state_io()
        else:
            jtree = {"params": params, "opt": JShardedAdam(step=step, m=m, v=v)}
            io = SyncTrainer(TrainConfig(num_ps=2, layout="zigzag", fused_adam=True, **TINY), ds,
                             world).state_io()
        return jtree, (io.like, io.place, lambda s: io.for_save(*s))
    if name == "async":
        tr = AsyncTrainer(TrainConfig(num_ps=2, layout="block", **TINY), ds, world)
        host = _rand_like(tr._state_like(), rng)
        jtree = {"state": JAsyncState(**dataclasses.asdict(host))}
        return jtree, ({"state": tr._state_like()}, lambda t: tr._place_state(t["state"]),
                       lambda s: {"state": tr._state_for_save(s)})
    zero1 = name == "lm_zero1"
    tr = SeqTrainer(SeqConfig(spec=tt.TINY_SPEC, zero1=zero1, **LM_BASE),
                    synthesize_copy(**LM_DATA), device="cpu")
    p, m, v = (_rand_like(lm_zeros_numpy(tt.TINY_SPEC), rng) for _ in range(3))
    jtree = {"params": p, "opt": JAdamState(step=step, m=m, v=v)}
    return jtree, (tr.checkpoint_like(),
                   lambda t: (tr._place_params(t["params"]), tr._place_opt(t["opt"])),
                   lambda s: {"params": tr._params_for_save(s[0]),
                              "opt": tr._opt_for_save(s[1])})


@pytest.mark.parametrize("family", ["single", "sync_zero1", "async", "lm_replicated",
                                    "lm_zero1"])
def test_checkpoint_round_trips_between_packages(family, ds, world, tmp_path):
    """JAX writes -> the port reads, places and writes back -> JAX reads:
    bitwise, with equal manifests."""
    jtree, (like, place, for_save) = _family(family, ds, world,
                                             np.random.default_rng(hash(family) % 2**32))
    a, b = tmp_path / "jax" / "ckpt.npz", tmp_path / "port" / "ckpt.npz"
    jck.save_checkpoint(a, jtree, step=7, extra={"epoch": 0}, keep=2)
    host, step, extra = ck.load_checkpoint(a, like)
    assert (step, extra) == (7, {"epoch": 0})
    ck.save_checkpoint(b, for_save(place(host)), step=7, extra={"epoch": 0}, keep=2)
    assert ck.verify_checkpoint(b) and jck.verify_checkpoint(b)
    back, _, _ = jck.load_checkpoint(b, jtree)
    _leaves_equal(back, jtree)
    assert _manifest(a) == _manifest(b)
    assert sorted(os.listdir(a.parent)) == sorted(os.listdir(b.parent))


def _save_steps(mod, d, steps, keep):
    for s in steps:
        mod.save_checkpoint(d / "ckpt.npz", {"a": np.full(4, float(s), np.float32)},
                            step=s, keep=keep)


def test_retention_and_rolling_file_as_jax(tmp_path):
    """keep=N keeps the last N step-stamped saves and the rolling file is
    the newest; the port's directory equals JAX's file for file."""
    jd, td = tmp_path / "j", tmp_path / "t"
    _save_steps(jck, jd, range(1, 6), 3)
    _save_steps(ck, td, range(1, 6), 3)
    names = sorted(os.listdir(td))
    assert names == sorted(os.listdir(jd))
    assert [n for n in names if n.endswith(".npz")] == [
        "ckpt-00000003.npz", "ckpt-00000004.npz", "ckpt-00000005.npz", "ckpt.npz"]
    assert os.path.samefile(td / "ckpt.npz", td / "ckpt-00000005.npz")
    for n in names:
        if n.endswith(".npz"):
            assert _manifest(td / n) == _manifest(jd / n)
            assert ck.verify_checkpoint(td / n)
    tree_, step, _ = ck.load_checkpoint(td / "ckpt.npz", {"a": np.zeros(4, np.float32)})
    assert step == 5 and tree_["a"][0] == 5.0
    assert ck.find_latest_valid(td)[1] == 5 and ck.find_latest_valid(td, max_step=4)[1] == 4


def test_damaged_files_and_discovery_match_jax(tmp_path):
    """corrupt/truncate make the same bytes as JAX's; verification,
    ``checkpoint_step`` and ``find_latest_valid`` (with its log lines) then
    agree with JAX's on every file."""
    for mod, d in ((jck, tmp_path / "j"), (ck, tmp_path / "t")):
        _save_steps(mod, d, (1, 2), 3)
        _save_steps(mod, d / "bare", (1,), 0)
        os.unlink(ck.manifest_path(d / "bare" / "ckpt.npz"))  # an older, manifest-less save
    jfaults.corrupt_checkpoint(tmp_path / "j" / "ckpt.npz", seed=3)
    faults.corrupt_checkpoint(tmp_path / "t" / "ckpt.npz", seed=3)
    for n in os.listdir(tmp_path / "j"):
        if n.endswith(".npz"):
            assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    logs = {}
    for key, mod, fm, d in (("j", jck, jfaults, tmp_path / "j"), ("t", ck, faults, tmp_path / "t")):
        seen = []
        found = mod.find_latest_valid(d, log=seen.append)
        logs[key] = ([s.replace(str(d), "D") for s in seen], found[1],
                     [(n, mod.verify_checkpoint(d / n), mod.checkpoint_step(d / n))
                      for n in sorted(os.listdir(d)) if n.endswith(".npz")],
                     mod.verify_checkpoint(d / "bare" / "ckpt.npz"))
        fm.truncate_checkpoint(found[0])
        assert mod.find_latest_valid(d) is None
    assert logs["t"] == logs["j"]
    assert logs["t"][1] == 1 and len(logs["t"][0]) == 2 and logs["t"][3]
    assert (tmp_path / "t" / "ckpt-00000001.npz").read_bytes() == \
        (tmp_path / "j" / "ckpt-00000001.npz").read_bytes()


@pytest.mark.parametrize("template,kind", [
    ({"a": np.zeros(2, np.float32), "c": np.zeros(2, np.float32)}, KeyError),
    ({"a": np.zeros(3, np.float32)}, ValueError),
    ({"a": np.zeros(2, np.float16)}, ValueError),
])
def test_mismatched_loads_raise_jax_texts(template, kind, tmp_path):
    path = tmp_path / "ckpt.npz"
    jck.save_checkpoint(path, {"a": np.zeros(2, np.float32), "b": np.ones(2, np.float32)})
    with pytest.raises(kind) as ours:
        ck.load_checkpoint(path, template)
    with pytest.raises(kind) as theirs:
        jck.load_checkpoint(path, template)
    assert str(ours.value) == str(theirs.value)
    tree_, _, _ = ck.load_checkpoint(path, {"b": np.zeros(2, np.float32)})  # a subset loads
    assert tree_["b"][0] == 1.0


def test_load_params_nested_bare_and_mismatched_as_jax(tmp_path):
    nested, bare = tmp_path / "n.npz", tmp_path / "b.npz"
    ck.save_checkpoint(nested, {"params": {"w": np.arange(3.0, dtype=np.float32)},
                                "opt": np.zeros(1, np.float32)}, step=4)
    ck.save_checkpoint(bare, {"w": np.arange(3.0, dtype=np.float32)})
    for path in (nested, bare):
        got, step, _ = ck.load_params(path, {"w": torch.zeros(3)})
        want, jstep, _ = jck.load_params(path, {"w": np.zeros(3, np.float32)})
        assert step == jstep and got["w"].tobytes() == np.asarray(want["w"]).tobytes()
    bad = {"w": np.zeros(3, np.float32), "missing": np.zeros(2, np.float32)}
    with pytest.raises(KeyError) as ours:
        ck.load_params(nested, bad)
    with pytest.raises(KeyError) as theirs:
        jck.load_params(nested, bad)
    assert str(ours.value) == str(theirs.value)


def test_discard_newer_prunes_abandoned_timeline_as_jax(tmp_path):
    """A rollback prunes the retained saves newer than its step and points
    the rolling file at the newest survivor, as JAX's does."""
    for mod, d in ((jck, tmp_path / "j"), (ck, tmp_path / "t")):
        _save_steps(mod, d, (1, 2, 3), 3)
        seen = []
        mod.discard_newer(d, 1, log=seen.append)
        assert len(seen) == 2
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert [n for n in names if n.endswith(".npz")] == ["ckpt-00000001.npz", "ckpt.npz"]
    tree_, step, _ = ck.load_checkpoint(tmp_path / "t" / "ckpt.npz",
                                        {"a": np.zeros(4, np.float32)})
    assert step == 1 and tree_["a"][0] == 1.0 and ck.verify_checkpoint(tmp_path / "t" / "ckpt.npz")
    assert _manifest(tmp_path / "t" / "ckpt.npz") == _manifest(tmp_path / "j" / "ckpt.npz")


# -- resume parity: N steps in one package, N more in the other ---------------------


@pytest.fixture(scope="module")
def cnn_golden(small_params):
    """JAX's uninterrupted 2-epoch single-device run (8 steps), and its
    inputs."""
    jds = j_load_mnist(path=None, synthetic_train=512, synthetic_test=64, seed=7)
    init = {k: np.asarray(v) for k, v in small_params.items()}
    cfg = dict(batch_size=128, eval_every=0, keep_prob=1.0, seed=5, **TINY)
    ref = JSingle(JConfig(epochs=2, **cfg), jds, init=init).train(log=QUIET)
    return jds, init, cfg, ref


@pytest.mark.parametrize("first", ["jax", "port"])
def test_cnn_resume_parity_across_packages(first, cnn_golden, ds, tmp_path):
    jds, init, cfg, ref = cnn_golden
    d = str(tmp_path / "ck")
    if first == "jax":
        JSingle(JConfig(epochs=1, **cfg), jds, init=init).train(log=QUIET, checkpoint_dir=d)
        res = SingleChipTrainer(TrainConfig(epochs=2, **cfg), ds, init=init, device="cpu").train(
            log=QUIET, checkpoint_dir=d, resume=True)
    else:
        SingleChipTrainer(TrainConfig(epochs=1, **cfg), ds, init=init, device="cpu").train(
            log=QUIET, checkpoint_dir=d)
        res = JSingle(JConfig(epochs=2, **cfg), jds, init=init).train(
            log=QUIET, checkpoint_dir=d, resume=True)
    assert res.resumed_from_step == 4
    for k in ref.params:
        np.testing.assert_allclose(np.asarray(res.params[k]), ref.params[k], atol=CNN_ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def lm_golden():
    jds = j_synthesize_copy(**LM_DATA)
    init = jax.tree.map(np.asarray, jt.init_lm_params(jax.random.PRNGKey(3), jt.TINY_SPEC))
    ref = JSeqTrainer(JSeqConfig(epochs=2, spec=jt.TINY_SPEC, **LM_BASE), jds).train(log=QUIET)
    return jds, init, ref


@pytest.mark.parametrize("first", ["jax", "port"])
def test_lm_resume_parity_across_packages(first, lm_golden, tmp_path):
    jds, init, ref = lm_golden
    d = str(tmp_path / "ck")
    ds = synthesize_copy(**LM_DATA)
    port = lambda epochs: SeqTrainer(  # noqa: E731
        SeqConfig(epochs=epochs, spec=tt.TINY_SPEC, **LM_BASE), ds, init=init, device="cpu")
    jax_ = lambda epochs: JSeqTrainer(  # noqa: E731
        JSeqConfig(epochs=epochs, spec=jt.TINY_SPEC, **LM_BASE), jds)
    if first == "jax":
        jax_(1).train(log=QUIET, checkpoint_dir=d)
        res = port(2).train(log=QUIET, checkpoint_dir=d, resume=True)
    else:
        port(1).train(log=QUIET, checkpoint_dir=d)
        res = jax_(2).train(log=QUIET, checkpoint_dir=d, resume=True)
    assert res.resumed_from_step == 4
    for a, b in zip(tree.leaves(jax.tree.map(np.asarray, res.params)),
                    jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=LM_ATOL, rtol=LM_RTOL)
    np.testing.assert_allclose(res.final_loss, ref.final_loss, rtol=1e-4)
