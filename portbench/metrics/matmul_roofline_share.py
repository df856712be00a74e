"""The weight products' FLOPs a step (the projections and the head, forward
and twice for the backward) at the bf16 peak, over the profiled device
time of the matrix-product kernels (family ``matmul``), in %."""

from portbench.harness import cost
from portbench.harness.trace import family


def read(r):
    measured = r.trace.seconds(lambda n: family(n) == "matmul")
    if measured <= 0:
        return None
    least = cost.matmul_least_seconds(r.dims, r.batch, r.seq_len, r.kind)
    return 100.0 * r.trace.steps * least / measured
