"""The multi-host launch of the port (``ddl_tpu_torch/parallel/multihost.py``
and the CLI's ``--multihost``, ``--coordinator``, ``--num-processes``,
``--process-id`` and ``--platform``), held to ``ddl_tpu``'s on the CPU.

- The pure functions against JAX's: ``local_slice`` on seeded arrays, the
  rank blocks a host owns, ``free_port``; the five flags' dests and defaults
  against JAX's parser; the refusals, with JAX's words where JAX has them;
  ``sim`` takes ``--platform`` and ignores it, as JAX's.
- The launcher on stand-in ranks (tiny Python processes): a failing rank
  takes its siblings down, SIGTERM reaches every rank, a signal to the
  host's whole group reaches each rank once, and no rank outlives its host
  process.
- Worlds, each launched once and read by several tests: ``sync``,
  ``sync_sharding``, ``async_sharding`` and ``lm`` as two host processes on
  this box (one gloo rank each for the CNN, two for the LM's 1x2x2 ``[dp,
  sp, tp]`` grid, as ``tests/test_multihost.py``'s two-devices-a-process
  world) against one host of the same world: every host prints JAX's
  ``multihost: process p/N, G global devices`` line and the same payload,
  bit for bit the one-host payload; the LM's one-host payload is bit for
  bit that of the same line run as torchrun runs it, without the launcher,
  so a fault shared by every launched world would show. The trainers the
  ranks run are held to JAX's by ``tests/test_torch_sync.py``,
  ``tests/test_torch_async.py`` and ``tests/test_torch_seq_parallel.py``;
  JAX's own multi-process world is not run again here.
- Preemption (JAX's ``test_preemption_agreement_across_processes``):
  SIGTERM to host 0 only stops both hosts at one span, both exit 0
  preempted over one shared ``--checkpoint-dir``, the newest save and its
  manifest load, and a resume of both hosts finishes.
"""

import concurrent.futures
import contextlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from ddl_tpu import cli as jcli
from ddl_tpu.parallel import multihost as jmultihost
from ddl_tpu_torch import cli
from ddl_tpu_torch.parallel import mesh, multihost
from ddl_tpu_torch.utils import checkpoint as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("multihost", "coordinator", "num_processes", "process_id", "platform")
# The payload's keys that read a clock.
TIMED = ("train_time_s", "images_per_sec", "tokens_per_sec", "compile_time_s", "step_stats")
# Every world runs under the dispatch watchdog: a rank whose peer died
# stops with a diagnosis instead of waiting in a collective.
WATCHDOG = ["--dispatch-timeout", "120"]
CNN = ["--platform", "cpu", "--tiny", "--synthetic-train", "64", "--synthetic-test", "64",
       "--batch-size", "16", "--eval-every", "2", "--lr", "1e-2", "--json", *WATCHDOG]
# tests/test_multihost.py's 1x2x2 [dp, sp, tp] world at its widths.
LM = ["lm", "--platform", "cpu", "--num-workers", "2", "--tensor-parallel", "2", "--zero1",
      "--seq-scheme", "ring", "--seq-len", "32", "--vocab", "16", "--d-model", "32", "--heads",
      "2", "--layers", "2", "--d-ff", "64", "--train-seqs", "32", "--test-seqs", "16",
      "--batch-size", "16", "--eval-every", "0", "--json", *WATCHDOG]
# name -> (argv, host processes, global ranks); no host process: the
# ranks started as torchrun starts them, without --multihost.
WORLDS = {
    "sync/2": (["sync", *CNN], 2, 2),
    "sync/1": (["sync", "--num-workers", "2", *CNN], 1, 2),
    "sync_sharding/2": (["sync_sharding", "--num-ps", "2", "--layout", "flat", *CNN], 2, 2),
    "sync_sharding/1": (["sync_sharding", "--num-ps", "2", "--layout", "flat",
                         "--num-workers", "2", *CNN], 1, 2),
    "async_sharding/2": (["async_sharding", "--num-ps", "2", *CNN], 2, 2),
    "async_sharding/1": (["async_sharding", "--num-ps", "2", "--num-workers", "2", *CNN], 1, 2),
    "lm/2": (LM, 2, 4),
    "lm/1": (LM, 1, 4),
    "lm/torchrun": (LM, None, 4),
}
VARIANTS = ("sync", "sync_sharding", "async_sharding", "lm")
TIMEOUT_S = 240
# Worlds run at once: their ranks share this box's cores with the rest of
# the test run.
CONCURRENT_WORLDS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "WORLD_SIZE", "RANK", multihost.ENV)}
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _start(argv: list[str], hosts: int) -> list[subprocess.Popen]:
    """One ``python -m ddl_tpu_torch ... --multihost`` a host: over a TCP
    rendezvous on a free port, or at one host the self-hosted one."""
    if hosts == 1:
        extra = [["--num-processes", "1"]]
    else:
        port = multihost.free_port()
        extra = [["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(hosts),
                  "--process-id", str(i)] for i in range(hosts)]
    return [subprocess.Popen([sys.executable, "-m", "ddl_tpu_torch", *argv, "--multihost", *e],
                             cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for e in extra]


def _start_torchrun(argv: list[str], ranks: int) -> list[subprocess.Popen]:
    """``ranks`` processes of ``python -m ddl_tpu_torch ...`` (no
    ``--multihost``) with torchrun's variables, one thread each: the world
    the CLI formed before the launcher existed."""
    port = multihost.free_port()
    return [subprocess.Popen([sys.executable, "-m", "ddl_tpu_torch", *argv], cwd=ROOT,
                             env={**_env(), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                                  "WORLD_SIZE": str(ranks), "RANK": str(r), "LOCAL_RANK": str(r),
                                  "OMP_NUM_THREADS": "1"},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(ranks)]


def _finish(procs: list[subprocess.Popen], timeout_s: float = TIMEOUT_S) -> list[tuple]:
    """``(exit code, stdout, stderr)`` of each host; a host still running at
    the deadline is killed (its ranks die with it)."""
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def _payload(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _untimed(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k not in TIMED}


@pytest.fixture(scope="module")
def worlds():
    """Every world of ``WORLDS`` run to the end, the largest first, at most
    ``CONCURRENT_WORLDS`` at once."""

    def run(name):
        argv, hosts, ranks = WORLDS[name]
        return _finish(_start(argv, hosts) if hosts else _start_torchrun(argv, ranks))

    order = sorted(WORLDS, key=lambda name: -WORLDS[name][2])
    with concurrent.futures.ThreadPoolExecutor(CONCURRENT_WORLDS) as pool:
        return dict(zip(order, pool.map(run, order)))


def _ok(runs) -> list[dict]:
    for rc, out, err in runs:
        assert rc == 0, f"host exited {rc}:\n{out[-2000:]}\n{err[-4000:]}"
    return [_payload(out) for _, out, _ in runs]


# --- pure functions ---------------------------------------------------------


@pytest.mark.parametrize("shape,dim,shards,rows", [
    ((16, 3), 0, 8, [2, 3]),
    ((2, 8, 5), 1, 8, [7]),
    ((4, 6, 32), 2, 4, [1]),
    ((3, 8, 10), 1, 2, [0, 1]),
])
def test_local_slice_matches_jax(shape, dim, shards, rows):
    a = np.random.default_rng(len(shape) * 10 + dim).standard_normal(shape).astype(np.float32)
    got = multihost.local_slice(a, dim, shards, np.array(rows))
    want = jmultihost.local_slice(a, dim, shards, np.array(rows))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_local_ranks_are_the_host_blocks():
    """Host p owns [p * n, (p + 1) * n); the hosts' blocks tile the world, as
    JAX's process-local rows tile its mesh."""
    for hosts, n in ((1, 4), (2, 1), (2, 2), (4, 3)):
        blocks = [multihost.local_ranks(p, n) for p in range(hosts)]
        assert [r for b in blocks for r in b] == list(range(hosts * n))
        host = multihost.initialize("h:1", hosts, hosts - 1, hosts * n)
        assert host.n_local == n and list(multihost.local_ranks(hosts - 1, n)) == [
            int(host.rank_env(i, {})["RANK"]) for i in range(n)]


def test_free_port_and_the_rank_environment():
    port = multihost.free_port()
    assert 0 < port < 65536
    import socket

    with socket.socket() as s:
        s.bind(("localhost", port))
    host = multihost.initialize("10.0.0.1:8476", 2, 1, 4)
    env = host.rank_env(1, {"OMP_NUM_THREADS": "3", "PYTHONPATH": "x"})
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "LOCAL_WORLD_SIZE", multihost.ENV)} == {
        "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "8476", "WORLD_SIZE": "4", "RANK": "3",
        "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2", multihost.ENV: "1/2"}
    assert env["OMP_NUM_THREADS"] == "3" and env["PYTHONPATH"] == f"{ROOT}{os.pathsep}x"
    assert host.rank_env(0, {})["OMP_NUM_THREADS"] == "1"
    # One process, no coordinator: self-hosted on a free local port, as JAX's.
    own = multihost.initialize(None, 1, None, 2)
    assert own.coordinator.startswith("localhost:") and own.process_id == 0
    assert own.n_local == 2
    multihost.shutdown()  # no world joined: a no-op


def test_world_lead_and_the_launched_join(monkeypatch):
    """Each host's local rank 0 leads; with no local rank, rank 0.
    ``_join_world`` hands a torchrun rank and a launched rank alike their
    local rank and the rendezvous timeout."""
    cpu = torch.device("cpu")
    assert [mesh.World(r, 4, cpu, r % 2).lead for r in range(4)] == [True, False, True, False]
    assert [mesh.World(r, 4, cpu).lead for r in range(4)] == [True, False, False, False]
    seen = []
    monkeypatch.setattr(mesh, "init_world", lambda *a, **kw: seen.append((a, kw)))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.delenv(multihost.ENV, raising=False)
    assert multihost.launched() is None and multihost.process_count() == 1
    cli._join_world(4, "cpu", "unused")
    monkeypatch.setenv(multihost.ENV, "1/2")
    assert multihost.launched() == (1, 2) and multihost.process_count() == 2
    cli._join_world(4, "cpu", "unused")
    monkeypatch.delenv("LOCAL_RANK")
    cli._join_world(4, "cpu", "unused")
    timeout = multihost.RENDEZVOUS_TIMEOUT_S
    assert seen == [((4, 3, "env://", "cpu"), dict(local_rank=1, timeout_s=timeout))] * 2 + [
        ((4, 3, "env://", "cpu"), dict(local_rank=None, timeout_s=timeout))]


def test_two_writers_leave_one_valid_newest_save(tmp_path):
    """Two hosts' leads saving the same steps into one directory at once:
    the newest save and every manifest verify, the retained chain holds the
    newest ``keep``, and no temp file is left."""
    path = str(tmp_path / "ckpt.npz")
    gate = threading.Barrier(2)
    errors = []

    def writer():
        try:
            for step in range(1, 7):
                tree = {"w": np.full((64, 64), step, np.float32), "s": np.int32(step)}
                gate.wait()
                ck.save_checkpoint(path, tree, step=step, keep=2)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            gate.abort()

    threads = [threading.Thread(target=writer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert ck.verify_checkpoint(path) and ck.checkpoint_step(path) == 6
    assert ck.find_latest_valid(str(tmp_path))[1] == 6
    assert [s for s, _ in ck._retained_files(path)] == [5, 6]
    for _, p in ck._retained_files(path):
        assert ck.verify_checkpoint(p)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


# --- the parser and the refusals --------------------------------------------


def test_multihost_flags_keep_the_jax_spellings_and_defaults():
    ours, theirs = cli.build_parser(), jcli.build_parser()
    for dest in FLAGS:
        assert ours.get_default(dest) == theirs.get_default(dest), dest
    argv = ["lm", "--multihost", "--coordinator", "h:8476", "--num-processes", "2",
            "--process-id", "1", "--platform", "cpu"]
    got, want = ours.parse_args(argv), theirs.parse_args(argv)
    assert {d: getattr(got, d) for d in FLAGS} == {d: getattr(want, d) for d in FLAGS}
    assert ours._option_string_actions["--coordinator"].metavar == "HOST:PORT"


MULTI = ["--multihost", "--coordinator", "127.0.0.1:1", "--num-processes", "2"]


@pytest.mark.parametrize("argv,env,match", [
    (["sync", *MULTI, "--process-id", "0", "--platform", "cpu", "--num-workers", "3"], {},
     "^total devices 3 .* is not divisible by --num-processes 2$"),
    (["lm", *MULTI, "--process-id", "1", "--platform", "cpu", "--num-workers", "3",
      "--data-parallel", "1", "--tensor-parallel", "1"], {}, "not divisible by --num-processes 2"),
    (["sync", *MULTI, "--process-id", "2", "--platform", "cpu"], {}, r"\[0, 2\), got 2"),
    (["sync", *MULTI, "--platform", "cpu"], {}, r"\[0, 2\), got None"),
    (["sync", "--multihost", "--num-processes", "2", "--process-id", "0", "--platform", "cpu"],
     {}, "needs --coordinator HOST:PORT"),
    (["sync", "--multihost", "--platform", "cpu"], {}, "needs --num-processes"),
    (["sync", *MULTI, "--process-id", "0", "--platform", "cpu"], {"WORLD_SIZE": "2"},
     "not under torchrun"),
    (["single", "--multihost", "--num-processes", "1", "--platform", "cpu"], {},
     "--multihost does not apply"),
    (["sync", "--platform", "tpu"], {}, "no TPU backend"),
    (["lm", "--platform", "cpu", "--device", "cuda"], {}, "conflicts with --device cuda"),
    (["sim", "--scenario", "bulk_burst", "--multihost"], {},
     "^--multihost does not apply to the sim variant$"),
])
def test_refusals(monkeypatch, argv, env, match):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_refusals_in_jax_words(monkeypatch):
    """``serve --multihost`` and a world that does not split over the
    processes exit with JAX's own text."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as theirs:
        jcli._run_serve(jcli.build_parser().parse_args(["serve", "--multihost"]))
    with pytest.raises(SystemExit) as ours:
        cli.main(["serve", "--multihost", "--num-processes", "1", "--platform", "cpu"])
    assert str(ours.value) == str(theirs.value)
    argv = ["sync", *MULTI, "--process-id", "0", "--platform", "cpu", "--num-workers", "3"]
    from ddl_tpu.parallel import mesh as jmesh

    monkeypatch.setattr(jmesh, "set_cpu_device_count", lambda n: None)
    with pytest.raises(SystemExit) as theirs:
        jcli.main(argv)
    with pytest.raises(SystemExit) as ours:
        cli.main(argv)
    assert str(ours.value) == str(theirs.value)


def test_nccl_takes_one_card_a_rank(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="2 ranks over NCCL, which takes one card a rank"):
        cli.main(["sync", "--multihost", "--num-processes", "1", "--num-workers", "2"])


def test_sim_takes_platform_and_ignores_it(capsys):
    argv = ["sim", "--scenario", "bulk_burst:horizon=8", "--json"]
    outs = []
    for extra in ([], ["--platform", "cpu"], ["--platform", "tpu"]):
        assert cli.main(argv + extra) == 0
        out = _payload(capsys.readouterr().out)
        for row in out["router"]["per_class"].values():
            for key in ("ttft_ms", "itl_ms", "ttft_slo_attained", "itl_slo_attained"):
                row.pop(key)
        outs.append(out)
    assert outs[0] == outs[1] == outs[2] and outs[0]["engine_kind"] == "sim"


# --- the launcher on stand-in ranks -----------------------------------------


@contextlib.contextmanager
def _host_script(tmp_path, rank_code: str, n_local: int = 2):
    """A host process running ``multihost.launch`` over ``n_local`` stand-in
    ranks, each ``python -c rank_code`` writing into ``tmp_path``; killed on
    the way out if still running."""
    code = textwrap.dedent(f"""
        import sys
        from ddl_tpu_torch.parallel import multihost
        host = multihost.Host("127.0.0.1:1", 1, 0, {n_local})
        sys.exit(multihost.launch(host, [sys.executable, "-c", {rank_code!r}]))
    """)
    env = _env()
    env["OUT"] = str(tmp_path)
    # A group of its own, which a test may signal whole.
    host = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            start_new_session=True)
    try:
        yield host
    finally:
        if host.poll() is None:
            host.kill()
            host.wait()


RANK_PRELUDE = """
import os, pathlib, signal, sys, time
out = pathlib.Path(os.environ["OUT"])
me = os.environ["LOCAL_RANK"]
"""


def _wait_for(pred, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return any(line.split()[:2] == ["State:", "Z"] for line in f)
    except FileNotFoundError:
        return True


def test_a_failing_rank_takes_the_host_down(tmp_path):
    """Local rank 1 exits 3 while rank 0 sleeps: the host kills rank 0 and
    exits 3."""
    with _host_script(tmp_path, RANK_PRELUDE + textwrap.dedent("""
        (out / f"pid{me}").write_text(str(os.getpid()))
        if me == "1":
            time.sleep(0.5)
            sys.exit(3)
        time.sleep(120)
    """)) as host:
        assert host.wait(timeout=60) == 3
    _wait_for(lambda: _gone(int((tmp_path / "pid0").read_text())), 10)


def test_sigterm_reaches_every_rank(tmp_path):
    """SIGTERM to the host reaches both ranks, whose handler exits 0: so
    does the host."""
    with _host_script(tmp_path, RANK_PRELUDE + textwrap.dedent("""
        signal.signal(signal.SIGTERM, lambda s, f: ((out / f"term{me}").write_text("1"),
                                                    sys.exit(0)))
        (out / f"ready{me}").write_text("1")
        time.sleep(120)
        sys.exit(5)
    """)) as host:
        _wait_for(lambda: all((tmp_path / f"ready{i}").exists() for i in (0, 1)))
        host.send_signal(signal.SIGTERM)
        assert host.wait(timeout=60) == 0
    assert all((tmp_path / f"term{i}").exists() for i in (0, 1))


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["term", "int"])
def test_a_group_signal_reaches_each_rank_once(tmp_path, sig):
    """A signal to the host's whole process group (a terminal's Ctrl-C, a
    batch scheduler's cancel) reaches each rank once, through the host's
    forward. The ranks run the CLI's preemption handler, which takes a
    second delivery as "stop now, without a save": each rank counts one
    delivery and stops cleanly, so the host exits 0. Two deliveries that
    land before the handler runs merge into one, so the count alone can
    miss a direct one: each rank's process group is checked too."""
    with _host_script(tmp_path, RANK_PRELUDE + textwrap.dedent(f"""
        stop = []
        def on_sig(s, f):
            stop.append(s)
            signal.signal({int(sig)}, signal.SIG_DFL)
        signal.signal({int(sig)}, on_sig)
        (out / f"ready{{me}}").write_text("1")
        while not stop:
            time.sleep(0.01)
        time.sleep(1.0)  # room for a second delivery, which would kill
        (out / f"got{{me}}").write_text(f"{{len(stop)}} {{os.getpgid(0)}}")
        sys.exit(0)
    """)) as host:
        _wait_for(lambda: all((tmp_path / f"ready{i}").exists() for i in (0, 1)))
        os.killpg(host.pid, sig)
        assert host.wait(timeout=60) == 0
    got = [(tmp_path / f"got{i}").read_text().split() for i in (0, 1)]
    assert [n for n, _ in got] == ["1", "1"]
    assert host.pid not in [int(g) for _, g in got]


def test_no_rank_outlives_its_host(tmp_path):
    with _host_script(tmp_path, RANK_PRELUDE + textwrap.dedent("""
        (out / f"pid{me}").write_text(str(os.getpid()))
        time.sleep(120)
    """)) as host:
        _wait_for(lambda: all((tmp_path / f"pid{i}").exists() for i in (0, 1)))
        pids = [int((tmp_path / f"pid{i}").read_text()) for i in (0, 1)]
        host.kill()
        host.wait(timeout=60)
    try:
        _wait_for(lambda: all(_gone(p) for p in pids), 10)
    finally:
        for p in pids:
            if not _gone(p):
                os.kill(p, signal.SIGKILL)


# --- worlds -----------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_host_prints_the_jax_line_and_one_payload(worlds, variant):
    for hosts in (1, 2):
        name = f"{variant}/{hosts}"
        runs, ranks = worlds[name], WORLDS[name][2]
        payloads = _ok(runs)
        for p, (_, out, _) in enumerate(runs):
            assert out.startswith(
                f"[ddl_tpu_torch] multihost: process {p}/{hosts}, {ranks} global devices\n")
        assert all(_untimed(x) == _untimed(payloads[0]) for x in payloads)
        assert payloads[0]["config"]["num_workers"] == 2


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_hosts_equal_one_host(worlds, variant):
    """The same world as two host processes and as one: the payloads are
    bit-equal (history, accuracy, the LM's final loss)."""
    two, one = _ok(worlds[f"{variant}/2"])[0], _ok(worlds[f"{variant}/1"])[0]
    assert _untimed(two) == _untimed(one)
    assert two["history"] and two["final_accuracy"] == one["final_accuracy"]
    if variant == "lm":
        assert np.isfinite(two["final_loss"]) and two["final_loss"] == one["final_loss"]
        assert (two["config"]["tensor_parallel"], two["config"]["zero1"]) == (2, True)


def test_a_launch_equals_the_torchrun_world(worlds):
    """The LM world launched by one host equals, bit for bit, the same
    command line run without ``--multihost`` as torchrun runs it (four
    processes with torchrun's variables, rank 0 printing): the launcher
    changes no number of the path the port had before it."""
    launched = _ok(worlds["lm/1"])[0]
    runs = worlds["lm/torchrun"]
    plain = _ok(runs[:1])[0]
    assert [(rc, out.strip()) for rc, out, _ in runs[1:]] == [(0, "")] * 3
    assert "multihost" not in runs[0][1]
    assert _untimed(launched) == _untimed(plain)
    assert np.isfinite(plain["final_loss"]) and launched["final_loss"] == plain["final_loss"]


def test_preemption_agreement_across_hosts(tmp_path):
    """SIGTERM to host 0 only of a two-host ``sync_sharding`` world over one
    shared checkpoint directory: both hosts stop at one span and exit 0
    preempted with equal payloads, the newest save and its manifest load,
    and a resume of both hosts finishes the run."""
    d = str(tmp_path / "ck")
    argv = ["sync_sharding", "--num-ps", "2", "--layout", "flat", "--platform", "cpu",
            "--tiny", "--batch-size", "16", "--synthetic-train", "480", "--synthetic-test",
            "64", "--eval-every", "2", "--epochs", "4", "--checkpoint-dir", d, "--json",
            *WATCHDOG]
    procs = _start(argv, 2)
    try:
        for line in procs[0].stdout:
            if line.startswith("epoch:"):
                procs[0].send_signal(signal.SIGTERM)  # host 0 ONLY
                break
    finally:
        runs = _finish(procs)
    payloads = _ok(runs)
    assert all(p["preempted"] is True for p in payloads)
    assert _untimed(payloads[0]) == _untimed(payloads[1])
    found = ck.find_latest_valid(d)
    assert found is not None and ck.verify_checkpoint(found[0])
    rolling = os.path.join(d, "ckpt.npz")
    assert ck.verify_checkpoint(rolling) and ck.checkpoint_step(rolling) == found[1]
    step = found[1]
    assert 0 < step < 4 * 30
    resumed = _ok(_finish(_start(argv + ["--resume", "auto"], 2)))
    assert all(p["resumed_from_step"] == step and p["preempted"] is False for p in resumed)
    assert _untimed(resumed[0]) == _untimed(resumed[1])
    assert resumed[0]["history"][-1][0] == 3 and ck.checkpoint_step(rolling) == 4 * 30
