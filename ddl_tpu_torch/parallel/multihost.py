"""World-wide agreement — the part of ``ddl_tpu/parallel/multihost.py`` the
preemption probe needs (:func:`agree_flag`). The multi-host launch flags
(``--multihost``, ``--coordinator``, ``--num-processes``, ``--process-id``)
are ROADMAP queue 1, item 9; the port joins a world from torchrun's
variables or a file store (``cli._join_world``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def agree_flag(flag: bool) -> bool:
    """World-wide agreement (logical OR over the ranks) on a rank-local
    flag. Preemption must stop every rank at the SAME span: if one rank acts
    on its local SIGTERM while another starts the next span's collectives,
    the world deadlocks. Every rank must call this at the same point (it is
    itself a collective: one MAX all-reduce); without a world, or in a
    world of one, it returns ``flag`` and makes no call."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
