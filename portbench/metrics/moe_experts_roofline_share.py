"""The held and shared experts' FLOPs a profiled step, forward and
backward, from the program's count of assignments to the held experts
(``harness.cost_mla_moe.expert_flops``), at the bf16 peak, over the device
time launched inside the ``moe/experts`` spans a step (gather, products,
scatter-add, both directions), in %. Nothing is read where the trace holds
no such span or the run counted no assignment."""

from portbench.harness import cost, cost_mla_moe


def read(r):
    spans = getattr(r, "moe_spans", None)
    if not spans or spans.get("moe/experts", 0.0) <= 0 or not getattr(r, "assignments", 0):
        return None
    flops = cost_mla_moe.expert_flops(r.dims, r.assignments, r.batch * r.seq_len)
    least = flops / cost.peak_bf16_flops(r.kind)
    return 100.0 * r.trace.steps * least / spans["moe/experts"]
