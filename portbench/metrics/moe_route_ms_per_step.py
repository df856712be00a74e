"""Device ms a step launched inside the ``moe/route`` spans: the router's
fp32 gate, sigmoid, top-k, the weights' normalisation, the sort of the
assignments and their counts. Nothing is read where the trace holds no
such span."""


def read(r):
    spans = getattr(r, "moe_spans", None)
    if not spans or spans.get("moe/route", 0.0) <= 0:
        return None
    return 1e3 * spans["moe/route"] / r.trace.steps
