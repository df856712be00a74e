"""Model FLOPs a step of the latent-attention and expert block
(``harness.cost_mla_moe.train_step_flops``: the causal half of attention
at D_qk and D_v, the held experts at their expected load, no
recomputation) over the wall time of a step in the unprofiled window, as a
share of the card's dense bf16 peak, in %. Nothing is read for another
block."""

from portbench.harness import cost, cost_mla_moe
from portbench.reference.mla_moe import MoEDims


def read(r):
    if not isinstance(r.dims, MoEDims) or not r.step_s or r.step_s <= 0:
        return None
    flops = cost_mla_moe.train_step_flops(r.dims, r.batch, r.seq_len)
    return 100.0 * flops / r.step_s / cost.peak_bf16_flops(r.kind)
