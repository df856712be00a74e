"""Model FLOPs a step (``harness.cost.train_step_flops``: the causal half
of attention, no recomputation) over the wall time of a step in the
unprofiled window, as a share of the card's dense bf16 peak, in %."""

from portbench.harness import cost


def read(r):
    if not r.step_s or r.step_s <= 0:
        return None
    flops = cost.train_step_flops(r.dims, r.batch, r.seq_len)
    return 100.0 * flops / r.step_s / cost.peak_bf16_flops(r.kind)
