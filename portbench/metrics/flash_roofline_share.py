"""The three flash kernels' least time (``harness.cost.flash_least_seconds``)
over their profiled device time, found by kernel name, in %. Nothing is
read where the trace holds no call of one of the three."""

from portbench.harness import cost
from portbench.harness.trace import FLASH_KERNELS


def read(r):
    measured = {k: r.trace.seconds(lambda n, p=p: bool(p.search(n)))
                for k, p in FLASH_KERNELS.items()}
    if not all(v > 0 for v in measured.values()):
        return None
    least = cost.flash_least_seconds(r.dims, r.batch, r.seq_len, r.kind)
    return 100.0 * r.trace.steps * sum(least.values()) / sum(measured.values())
