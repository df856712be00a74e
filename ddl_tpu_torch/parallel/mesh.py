"""Process worlds and the device rule — the port of ``ddl_tpu/parallel/mesh.py``.

The JAX package builds a 1-D ``Mesh`` and runs one program over it; the port
runs one process per worker, joined by ``torch.distributed``: NCCL on CUDA,
gloo on the CPU (the test worlds). A world of one is a real process group,
so the single-card path runs the same collective calls as a larger world.

The LM's 3-D ``[data_parallel, num_workers, tensor_parallel]`` mesh (JAX's
``make_mesh_3d``; ``make_mesh_2d`` at tp 1) is a :class:`Grid` over the
world: rank ``(dp_index * num_workers + sp_index) * tensor_parallel +
tp_index``, tp minor, JAX's device order. Three kinds of process group
split it: the tp group (the ranks of one ``(dp, sp)`` cell), the
``(dp, sp)`` group (the ranks of one tp index, over which every gradient,
loss and metric is summed) and the sp row (one ``(dp, tp)``, in sequence
order: the ring's peers and Ulysses's all-to-all). A group that spans the
whole world is the world's own group, so a world of one makes the same
collective calls as a larger world; any other group of one rank, and the
tp group at tp 1 always, is ``LOCAL``, whose collectives are identities
and are never called (JAX's psum over an axis of size 1). So whether a
collective runs is decided here, by the group, and nowhere else.

Pipeline parallelism (``pipeline_parallel > 1``) adds a minor pp axis, JAX's
``make_mesh_4d`` ``[dp, sp, tp, pp]``: rank ``((dp_index * num_workers +
sp_index) * tensor_parallel + tp_index) * pipeline_parallel + pp_index``.
Each group above then holds one pp index, and two more kinds split the
grid: the pp group (one ``(dp, sp, tp)``, in stage order: a stage's
neighbours) and the shared group (one tp index over ``(dp, sp, pp)``, over
which the stage-replicated leaves' gradients and the loss are summed). At
pp 1 the grid is the 3-D one: the same ranks, groups and ``new_group``
calls.

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
TP_AXIS = "tp"
PP_AXIS = "pp"
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
    *,
    backend: str | None = None,
) -> World:
    """Join (or create) the process group: NCCL when ``device`` is CUDA,
    gloo on the CPU, unless ``backend`` names one. ``init_method`` is any
    ``torch.distributed`` URL (``file://...``, ``tcp://localhost:<port>``,
    ``env://``). On CUDA, rank ``r`` of a host uses card ``r %
    device_count``; NCCL takes one rank a card, while gloo (which copies
    CUDA tensors through the host) lets several ranks share one."""
    dev = default_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank
    )
    return World(rank=rank, size=world_size, device=dev)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the ``[data_parallel, num_workers,
    tensor_parallel, pipeline_parallel]`` grid. ``world`` None is the grid
    of one without a process group (every collective an identity). Each
    group is a process group, None (the whole world's) or ``LOCAL`` (one
    rank; the module docstring says when): ``sp_group`` is this rank's sp
    row, whose global ranks in sequence order are ``sp_ranks``;
    ``tp_group`` its tp group; ``data_group`` its ``(dp, sp)`` group;
    ``pp_group`` its pp group, whose global ranks in stage order are
    ``pp_ranks``; ``shared_group`` its ``(dp, sp, pp)`` group (its
    ``data_group`` at pp 1)."""

    world: World | None
    data_parallel: int
    num_workers: int
    tensor_parallel: int
    sp_group: object
    sp_ranks: tuple[int, ...]
    tp_group: object
    data_group: object
    pipeline_parallel: int = 1
    pp_group: object = LOCAL
    pp_ranks: tuple[int, ...] = (0,)
    shared_group: object = LOCAL

    @property
    def rank(self) -> int:
        return 0 if self.world is None else self.world.rank

    @property
    def pp_index(self) -> int:
        return self.rank % self.pipeline_parallel

    @property
    def tp_index(self) -> int:
        return self.rank // self.pipeline_parallel % self.tensor_parallel

    @property
    def data_index(self) -> int:
        """This rank's place in its ``(dp, sp)`` group: ``dp_index *
        num_workers + sp_index``, the chunk a ZeRO-1 reduce-scatter lands
        here (JAX's lex order over the combined axes)."""
        return self.rank // (self.tensor_parallel * self.pipeline_parallel)

    @property
    def dp_index(self) -> int:
        return self.data_index // self.num_workers

    @property
    def sp_index(self) -> int:
        return self.data_index % self.num_workers


def make_grid(world: World | None, data_parallel: int, num_workers: int,
              tensor_parallel: int = 1, pipeline_parallel: int = 1) -> Grid:
    """The grid over ``world`` (``data_parallel * num_workers *
    tensor_parallel * pipeline_parallel`` ranks). Every rank creates every
    group, in one order (the tp groups, the ``(dp, sp)`` groups, the sp
    rows; at pp > 1 then the pp groups and the shared groups), as
    ``dist.new_group`` requires. ``world`` None: the grid of one."""
    dp, W, tp, pp = data_parallel, num_workers, tensor_parallel, pipeline_parallel
    n = dp * W * tp * pp
    if world is None:
        if n != 1:
            dims = f"{dp} x {W} x {tp}" + (f" x {pp}" if pp > 1 else "")
            raise ValueError(f"a {dims} grid needs a world of {n} ranks")
        return Grid(None, 1, 1, 1, LOCAL, (0,), LOCAL, LOCAL)
    if world.size != n:
        raise ValueError(
            f"data_parallel ({dp}) x num_workers ({W}) x tensor_parallel ({tp}) "
            + (f"x pipeline_parallel ({pp}) " if pp > 1 else "")
            + f"= {n} != world size {world.size}"
        )

    def rank(d, s, t, p=0):
        return ((d * W + s) * tp + t) * pp + p

    def groups(rows):
        # The world's own group, LOCAL for one rank, else a new group.
        return [None if len(r) == n else LOCAL if len(r) == 1 else dist.new_group(list(r))
                for r in rows]

    r = world.rank
    d, s, t, p = r // (W * tp * pp), r // (tp * pp) % W, r // pp % tp, r % pp
    cells = [(i, j) for i in range(dp) for j in range(W)]
    lanes = [(u, q) for u in range(tp) for q in range(pp)]  # (tp, pp) positions
    tp_rows = [tuple(rank(i, j, u, q) for u in range(tp)) for i, j in cells
               for q in range(pp)]
    # At tp 1 the f/g pair is no collective, even in a world of one.
    tp_groups = [LOCAL] * len(tp_rows) if tp == 1 else groups(tp_rows)
    data_groups = groups([tuple(rank(i, j, u, q) for i, j in cells) for u, q in lanes])
    sp_rows = [tuple(rank(i, j, u, q) for j in range(W)) for i in range(dp)
               for u, q in lanes]
    sp_groups = groups(sp_rows)
    lane = t * pp + p
    data_group = data_groups[lane]
    grid = Grid(world, dp, W, tp, sp_groups[d * tp * pp + lane], sp_rows[d * tp * pp + lane],
                tp_groups[(d * W + s) * pp + p], data_group, pp_ranks=(r,),
                shared_group=data_group)
    if pp == 1:
        return grid
    pp_rows = [tuple(rank(i, j, u, q) for q in range(pp)) for i, j in cells for u in range(tp)]
    pp_groups = groups(pp_rows)
    shared_groups = groups([tuple(rank(i, j, u, q) for i, j in cells for q in range(pp))
                            for u in range(tp)])
    row = (d * W + s) * tp + t
    return dataclasses.replace(grid, pipeline_parallel=pp, pp_group=pp_groups[row],
                               pp_ranks=pp_rows[row], shared_group=shared_groups[t])


def destroy_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
