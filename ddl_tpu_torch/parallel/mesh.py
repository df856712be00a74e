"""Process worlds and the device rule — the port of ``ddl_tpu/parallel/mesh.py``.

The JAX package builds a 1-D ``Mesh`` and runs one program over it; the port
runs one process per worker, joined by ``torch.distributed``: NCCL on CUDA,
gloo on the CPU (the test worlds). A world of one is a real process group,
so the single-card path runs the same collective calls as a larger world.

The LM's 2-D ``[data_parallel, num_workers]`` mesh (JAX's
``make_mesh_2d``) is a :class:`Grid` over the world: rank ``dp_index *
num_workers + sp_index`` (dp-major, the lex order of JAX's ``(dp, sp)``
axes), with one process group a dp row for the sequence axis.

Device rule: entry points run on ``cuda`` unless the caller asks for
``cpu``. Without a card they raise; they never fall back quietly.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# The JAX package's names for the data-parallel and sequence axes.
DP_AXIS = "dp"
SP_AXIS = "sp"
LOCAL = "local"  # no process group: collectives over it are identities


def default_device(requested: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``requested`` is
    ``cpu``. Raises when CUDA is asked for (or defaulted to) and no card is
    present."""
    dev = torch.device(requested if requested is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--device cpu) to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (want cuda or cpu)")


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the data-parallel world."""

    rank: int
    size: int
    device: torch.device


def init_world(
    world_size: int,
    rank: int,
    init_method: str,
    device: str | torch.device | None = None,
) -> World:
    """Join (or create) the process group: NCCL when ``device`` is CUDA,
    gloo on the CPU. ``init_method`` is any ``torch.distributed`` URL
    (``file://...``, ``tcp://localhost:<port>``, ``env://``). On CUDA,
    rank ``r`` of a host uses card ``r % device_count``."""
    dev = default_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank
    )
    return World(rank=rank, size=world_size, device=dev)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the ``[data_parallel, num_workers]`` grid.
    ``world`` None is the grid of one without a process group (every
    collective an identity). ``sp_group`` is this rank's dp row (None: the
    whole world, when ``data_parallel`` is 1) and ``sp_ranks`` its global
    ranks in sequence order."""

    world: World | None
    data_parallel: int
    num_workers: int
    sp_group: object
    sp_ranks: tuple[int, ...]

    @property
    def rank(self) -> int:
        return 0 if self.world is None else self.world.rank

    @property
    def dp_index(self) -> int:
        return self.rank // self.num_workers

    @property
    def sp_index(self) -> int:
        return self.rank % self.num_workers


def make_grid(world: World | None, data_parallel: int, num_workers: int) -> Grid:
    """The 2-D grid over ``world`` (``data_parallel * num_workers`` ranks).
    Every rank creates every dp row's group, in row order, as
    ``dist.new_group`` requires. ``world`` None: the grid of one."""
    n = data_parallel * num_workers
    if world is None:
        if n != 1:
            raise ValueError(f"a {data_parallel} x {num_workers} grid needs a world of {n} ranks")
        return Grid(None, 1, 1, LOCAL, (0,))
    if world.size != n:
        raise ValueError(
            f"data_parallel ({data_parallel}) x num_workers ({num_workers}) = {n} "
            f"!= world size {world.size}"
        )
    rows = [tuple(range(d * num_workers, (d + 1) * num_workers)) for d in range(data_parallel)]
    groups = [dist.new_group(list(r)) for r in rows] if data_parallel > 1 else [None]
    d = world.rank // num_workers
    return Grid(world, data_parallel, num_workers, groups[d], rows[d])


def destroy_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
