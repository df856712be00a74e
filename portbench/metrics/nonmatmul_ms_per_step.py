"""Device ms a step in every operation that is neither a matrix product nor
a flash kernel: LayerNorm, RoPE, GELU, the loss, the casts, Adam, copies."""

from portbench.harness.trace import family


def read(r):
    if not r.trace.ops:
        return None
    return 1e3 * r.trace.seconds(lambda n: family(n) not in ("matmul", "flash")) / r.trace.steps
