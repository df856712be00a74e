"""Process worlds and the device rule — the port of ``ddl_tpu/parallel/mesh.py``.

The JAX package builds a 1-D ``Mesh`` and runs one program over it; the port
runs one process per worker, joined by ``torch.distributed``: NCCL on CUDA,
gloo on the CPU (the test worlds). A world of one is a real process group,
so the single-card path runs the same collective calls as a larger world.

Device rule: entry points run on ``cuda`` unless the caller asks for
``cpu``. Without a card they raise; they never fall back quietly.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# The JAX package's name for the data-parallel / shard axis, kept as a name.
DP_AXIS = "dp"


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


def destroy_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
