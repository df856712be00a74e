"""The three flash kernels' least time at ``(D_qk, D_v)``
(``harness.cost_mla_moe.flash_least_seconds``) over their profiled device
time, found by kernel name, in %. Nothing is read for another block, or
where the trace holds no call of one of the three."""

from portbench.harness import cost_mla_moe
from portbench.harness.trace import FLASH_KERNELS
from portbench.reference.mla_moe import MoEDims


def read(r):
    if not isinstance(r.dims, MoEDims):
        return None
    measured = {k: r.trace.seconds(lambda n, p=p: bool(p.search(n)))
                for k, p in FLASH_KERNELS.items()}
    if not all(v > 0 for v in measured.values()):
        return None
    least = cost_mla_moe.flash_least_seconds(r.dims, r.batch, r.seq_len, r.kind)
    return 100.0 * r.trace.steps * sum(least.values()) / sum(measured.values())
