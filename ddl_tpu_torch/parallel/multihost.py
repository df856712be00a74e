"""Multi-host launch — the port of ``ddl_tpu/parallel/multihost.py``.

JAX runs one controller process per host over all of that host's chips, and
``jax.distributed.initialize`` joins the processes into one global device
world. The port runs one process per rank (``parallel/mesh.py``), so the
same command line becomes a launcher: each host runs

    python -m ddl_tpu_torch lm --multihost --coordinator host0:8476 \\
        --num-processes 2 --process-id $P ...

and that process starts this host's ``n_local = world / num_processes``
ranks (:func:`launch`), global ranks ``[p * n_local, (p + 1) * n_local)``
(:func:`local_ranks`), and waits for them. Each rank gets torchrun's
variables (``MASTER_ADDR``/``MASTER_PORT`` = the coordinator, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and so joins the world
through the CLI's ``env://`` branch, the rendezvous it already takes under
torchrun: global rank 0, on host 0, serves the TCP store at the coordinator
and every other rank connects to it. One join path for both launchers keeps
a launched rank a torchrun rank, with no second way to form a world;
``init_method="tcp://<coordinator>"`` would make the same TCP store through
another branch. Each host's local rank 0 prints the run's lines and writes
its checkpoints (``mesh.World.lead``), as every JAX process prints and
writes its own. A launched rank also carries :data:`ENV` (``"p/N"``), by
which the CLI knows that it is a rank and not a host to launch again.

JAX's functions without a counterpart here, and why:

- ``put`` and ``put_tree`` assemble a global ``jax.Array`` from the blocks
  each process's devices own (``make_array_from_process_local_data``). A
  port rank holds only its own tensors: each trainer stages its block
  itself (``strategies/seq.py::SeqTrainer._local`` through
  :func:`local_slice`), and there is no global array to assemble.
- ``replicate_for_host`` makes every leaf addressable from every process
  before a save. The port's trainers gather their shards with collectives
  on every rank already (``utils/checkpoint.py::save_checkpoint_world``).
- ``_sharded_dims``, ``_lex_index``, ``_local_lex_tuples``,
  ``_axis_positions`` and ``_check_rectangular`` read which mesh positions a
  process's devices cover, for ``put``. A port rank's position on the grid
  is arithmetic on its rank (``mesh.Grid``), and a host's ranks are one
  contiguous block (:func:`local_ranks`), rectangular by construction.
- ``local_worker_rows`` is :func:`local_ranks`: the ranks a host owns are
  the mesh rows it feeds.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys

import numpy as np

# "p/N" in a launched rank's environment: its host process and their count.
ENV = "DDL_TPU_TORCH_MULTIHOST"
# How long a rank of an env:// world (a launch's or torchrun's) waits for
# the whole world to join; also that world's collective timeout.
RENDEZVOUS_TIMEOUT_S = 300.0


def free_port() -> int:
    """An OS-assigned free TCP port (single-process coordinator default)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@dataclasses.dataclass(frozen=True)
class Host:
    """This host process's part of a world of ``world_size`` ranks spread
    evenly over ``num_processes`` hosts, which meet at ``coordinator``
    (``HOST:PORT``)."""

    coordinator: str
    num_processes: int
    process_id: int
    world_size: int

    @property
    def n_local(self) -> int:
        return self.world_size // self.num_processes

    def rank_env(self, local_rank: int, base: dict[str, str]) -> dict[str, str]:
        """The environment of local rank ``local_rank``: ``base`` with
        torchrun's variables, :data:`ENV`, one intra-op thread unless
        ``base`` sets ``OMP_NUM_THREADS`` (torchrun's rule), and this
        package's root first on ``PYTHONPATH``."""
        addr, _, port = self.coordinator.rpartition(":")
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(base)
        env.setdefault("OMP_NUM_THREADS", "1")
        env.update(
            MASTER_ADDR=addr, MASTER_PORT=port, WORLD_SIZE=str(self.world_size),
            RANK=str(local_ranks(self.process_id, self.n_local)[local_rank]),
            LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(self.n_local),
            PYTHONPATH=os.pathsep.join(p for p in (root, base.get("PYTHONPATH")) if p),
            **{ENV: f"{self.process_id}/{self.num_processes}"},
        )
        return env


def initialize(
    coordinator_address: str | None,
    num_processes: int,
    process_id: int | None,
    world_size: int,
) -> Host:
    """This host's part of the world: ``world_size`` ranks over
    ``num_processes`` hosts, this one ``process_id``; a world that does not
    split evenly is refused in the words of JAX's CLI. As JAX's, only the
    explicit ``num_processes == 1`` case with no coordinator self-hosts one
    on a free local port (process 0). Nothing joins a world here: the
    ranks :func:`launch` starts do."""
    if num_processes < 1:
        raise ValueError(f"--num-processes must be >= 1, got {num_processes}")
    if world_size % num_processes:
        raise ValueError(
            f"total devices {world_size} (num-workers x data-parallel x tensor-parallel x "
            f"pipeline-parallel) is not divisible by --num-processes {num_processes}")
    if num_processes == 1:
        if coordinator_address is None:
            coordinator_address = f"localhost:{free_port()}"
        process_id = 0 if process_id is None else process_id
    if coordinator_address is None:
        raise ValueError(
            f"--num-processes {num_processes} needs --coordinator HOST:PORT (process 0's "
            "host): the port has no TPU environment to infer the world from")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator wants HOST:PORT, got {coordinator_address!r}")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must be in [0, {num_processes}), got {process_id}")
    return Host(coordinator_address, num_processes, process_id, world_size)


def local_ranks(process_id: int, n_local: int) -> range:
    """The global ranks host ``process_id`` owns when every host runs
    ``n_local``: one contiguous block, the mesh rows it feeds (JAX's
    ``local_worker_rows``)."""
    return range(process_id * n_local, (process_id + 1) * n_local)


def local_slice(host_array, dim: int, num_shards: int, rows) -> np.ndarray:
    """The blocks of ``host_array`` along ``dim`` owned by mesh positions
    ``rows`` when that dim splits into ``num_shards`` equal blocks — the
    per-process data-feeding math, pure so it is unit-testable without a
    second process."""
    per = host_array.shape[dim] // num_shards
    idx = np.concatenate([np.arange(r * per, (r + 1) * per) for r in rows])
    return np.take(np.asarray(host_array), idx, axis=dim)


def launched() -> tuple[int, int] | None:
    """``(process_id, num_processes)`` in a rank :func:`launch` started,
    else None."""
    value = os.environ.get(ENV)
    if value is None:
        return None
    p, n = value.split("/")
    return int(p), int(n)


def process_count() -> int:
    """The number of host processes in this rank's world (1 outside a
    multi-host launch)."""
    where = launched()
    return 1 if where is None else where[1]


def shutdown() -> None:
    """Leave the world this rank joined (a no-op outside one)."""
    from .mesh import destroy_world

    destroy_world()


def _die_with_parent() -> None:  # pragma: no cover - runs in the child
    """In a started rank before its exec: have the kernel SIGKILL it when
    the host process dies, so no rank outlives its launcher."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def launch(host: Host, cmd: list[str], base_env: dict[str, str] | None = None) -> int:
    """Run ``cmd`` once for each of ``host``'s local ranks, each in its
    :meth:`Host.rank_env`, and wait for them. SIGTERM and SIGINT are
    forwarded to every live rank (each rank's own handler decides what a
    signal means: the CLI's preemption flag). Each rank runs in a session
    of its own, so a signal sent to this process's group (a terminal's
    Ctrl-C, a batch scheduler's cancel) reaches a rank once, through the
    forward, and not a second time directly: the CLI takes a second
    delivery as "stop now, without a save". When a rank fails, the others
    are killed and its exit code returned (128 + the signal for a rank a
    signal ended); 0 when every rank exits 0. No rank outlives this call,
    nor, on Linux, this process."""
    import signal
    import subprocess
    import time

    base = dict(os.environ if base_env is None else base_env)
    procs: list[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    rc = 0
    try:
        for local in range(host.n_local):
            procs.append(subprocess.Popen(
                cmd, env=host.rank_env(local, base), start_new_session=True,
                preexec_fn=_die_with_parent if sys.platform.startswith("linux") else None))
        while True:
            codes = [p.poll() for p in procs]
            rc = next((c for c in codes if c), 0)
            if rc or None not in codes:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for s, h in previous.items():
            signal.signal(s, h)
    return rc if rc >= 0 else 128 - rc


def agree_flag(flag: bool) -> bool:
    """World-wide agreement (logical OR over the ranks) on a rank-local
    flag. Preemption must stop every rank at the SAME span: if one rank acts
    on its local SIGTERM while another starts the next span's collectives,
    the world deadlocks. Every rank must call this at the same point (it is
    itself a collective: one MAX all-reduce); without a world, or in a
    world of one, it returns ``flag`` and makes no call."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
