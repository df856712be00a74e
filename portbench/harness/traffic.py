"""The one traffic generator: a mix is a data file under ``traffic/`` that
this module reads, so a new mix is a new file and no new code.

A training mix (``kind`` ``lm_train``) states:

- ``seq_len``: positions per sequence;
- ``ids``: how token ids are drawn; ``uniform`` over the configuration's
  whole vocabulary is the one distribution so far;
- ``distinct_batches``: how many different batches are staged on the
  device; the timed window cycles through them;
- ``checked_steps``: the first steps, each on its own batch, that the
  comparison with the reference follows.

The batch (rows a step) belongs to the cell, since one mix runs on models
of different sizes. The same seed gives the same arrays byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEED_MASK = 2**64 - 1


@dataclasses.dataclass
class Batches:
    tokens: np.ndarray  # int32 [distinct_batches * batch, seq_len]
    targets: np.ndarray  # int32, the next token of each position
    weights: np.ndarray  # float32: every position is scored


def generate(mix: dict, batch: int, vocab: int, seed: int) -> Batches:
    if mix["kind"] != "lm_train":
        raise ValueError(f"the generator has no traffic kind {mix['kind']!r}")
    if mix["ids"] != "uniform":
        raise ValueError(f"unknown id distribution {mix['ids']!r}")
    if mix["distinct_batches"] < mix["checked_steps"]:
        raise ValueError("each checked step needs a batch of its own: distinct_batches "
                         f"{mix['distinct_batches']} < checked_steps {mix['checked_steps']}")
    rows, t = mix["distinct_batches"] * batch, mix["seq_len"]
    rng = np.random.Generator(np.random.PCG64(seed & SEED_MASK))
    ids = rng.integers(0, vocab, size=(rows, t + 1), dtype=np.int32)
    return Batches(tokens=np.ascontiguousarray(ids[:, :-1]),
                   targets=np.ascontiguousarray(ids[:, 1:]),
                   weights=np.ones((rows, t), np.float32))
