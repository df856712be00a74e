"""Faults planted under a training step, for the control runs
(``calibrate.py``) and the tests that see ``correct`` come out false.
The benchmark's own runs never plant one. Each wraps the program's step
``(params, opt, tokens, targets, weights) -> (params', opt', loss)``."""

from __future__ import annotations

from .weights import leaf


def unchanged(step):
    """The step computes as usual and hands back the state it was given."""
    def run(params, opt, tokens, targets, weights):
        return (params, opt) + tuple(step(params, opt, tokens, targets, weights)[2:])
    return run


def half_batch(step):
    """Half of the batch left out: the mean is taken over the other half."""
    def run(params, opt, tokens, targets, weights):
        h = tokens.shape[0] // 2
        return step(params, opt, tokens[:h], targets[:h], weights[:h])
    return run


def double_leaf(step, path: str = "blocks.0.wq"):
    """One leaf's update applied twice where the step produces it."""
    def run(params, opt, tokens, targets, weights):
        new, *rest = step(params, opt, tokens, targets, weights)
        old = leaf(params, path)
        twice = old + 2.0 * (leaf(new, path) - old)
        parts = path.split(".")
        if parts[0] == "blocks":
            new = dict(new, blocks=list(new["blocks"]))
            new["blocks"][int(parts[1])] = dict(new["blocks"][int(parts[1])], **{parts[2]: twice})
        else:
            new = dict(new, **{path: twice})
        return (new, *rest)
    return run


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "double_leaf": double_leaf}
