"""Procedural language-modeling data: the copy task — a numpy copy of
``ddl_tpu/data/lm.py`` (``LMDataset``, ``synthesize_copy``), byte-equal for
the same arguments.

Each sequence is ``[BOS, prefix, prefix]`` with loss only on the repeated
half, so every scored target is a token that appeared exactly
``seq_len//2 - 2`` positions earlier: a model that cannot attend that far
back cannot beat chance ``1/vocab``. The serving prompt sets
(``synthesize_prompts*``) wait for the serving slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataset:
    """Next-token prediction triples, train/test split.

    ``tokens``: int32 ``[N, T]`` model input; ``targets``: int32 ``[N, T]``
    with ``targets[:, t] = tokens[:, t+1]`` (last position padded 0);
    ``weights``: float32 ``[N, T]``, 1.0 where the cross-entropy is scored.
    """

    tokens: np.ndarray
    targets: np.ndarray
    weights: np.ndarray
    test_tokens: np.ndarray
    test_targets: np.ndarray
    test_weights: np.ndarray

    @property
    def num_train(self) -> int:
        return self.tokens.shape[0]

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]


def synthesize_copy(
    num_train: int = 2048,
    num_test: int = 256,
    seq_len: int = 128,
    vocab: int = 64,
    seed: int = 0,
) -> LMDataset:
    """Sequences ``[BOS, a_1..a_{h-1}, a_1..a_h]`` with ``h = seq_len//2``:
    token 0 is reserved as BOS/pad, payload tokens are uniform in
    ``[1, vocab)``. Targets shift by one; weights score exactly the
    positions whose target has appeared before — ``t`` in
    ``[h-1, seq_len-2)``, each a copy of the token ``h-2`` positions back."""
    if seq_len % 2:
        raise ValueError(f"seq_len {seq_len} must be even")
    if vocab < 3:
        raise ValueError(f"vocab {vocab} too small for payload + BOS")
    half = seq_len // 2
    rng = np.random.default_rng(seed)

    def make(n: int, r: np.random.Generator):
        payload = r.integers(1, vocab, size=(n, half), dtype=np.int32)
        tokens = np.concatenate(
            [np.zeros((n, 1), np.int32), payload[:, :-1], payload], axis=1
        )
        targets = np.concatenate(
            [tokens[:, 1:], np.zeros((n, 1), np.int32)], axis=1
        )
        weights = np.zeros((n, seq_len), np.float32)
        # target[t] = tokens[t+1] = a_{t-h+2}, seen at position t-h+2 —
        # except t = seq_len-2, whose target a_h occurs nowhere earlier.
        weights[:, half - 1 : seq_len - 2] = 1.0
        return tokens, targets, weights

    tr = make(num_train, rng)
    te = make(num_test, rng)
    return LMDataset(*tr, *te)
