"""Procedural language-modeling data — a numpy copy of ``ddl_tpu/data/lm.py``
(``LMDataset``, ``synthesize_copy``, ``synthesize_prompts``,
``synthesize_shared_prefix_prompts``), byte-equal for the same arguments.

Each sequence is ``[BOS, prefix, prefix]`` with loss only on the repeated
half, so every scored target is a token that appeared exactly
``seq_len//2 - 2`` positions earlier: a model that cannot attend that far
back cannot beat chance ``1/vocab``. The serving prompt sets are
``[BOS, payload...]`` lists of variable length (the serving stack owns its
padding).
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


def synthesize_prompts(
    num: int = 16,
    min_len: int = 4,
    max_len: int = 48,
    vocab: int = 64,
    seed: int = 0,
) -> list[np.ndarray]:
    """Deterministic variable-length prompt set for serving: each prompt is
    ``[BOS, payload...]`` (token 0 reserved as BOS, payload uniform in
    ``[1, vocab)``), lengths uniform in ``[min_len, max_len]``; a list of
    int32 arrays."""
    if not 1 <= min_len <= max_len:
        raise ValueError(f"need 1 <= min_len <= max_len, got "
                         f"{min_len}/{max_len}")
    if vocab < 2:
        raise ValueError(f"vocab {vocab} too small for payload + BOS")
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=num)
    return [
        np.concatenate([
            np.zeros(1, np.int32),
            rng.integers(1, vocab, size=int(n) - 1, dtype=np.int32),
        ])
        for n in lens
    ]


def synthesize_shared_prefix_prompts(
    n_families: int = 4,
    per_family: int = 4,
    prefix_len: int = 16,
    tail_min: int = 1,
    tail_max: int = 8,
    vocab: int = 64,
    seed: int = 0,
) -> list[np.ndarray]:
    """Deterministic shared-prefix prompt workload for the prefix cache:
    ``n_families`` families of ``per_family`` prompts, every prompt of a
    family opening with the same ``prefix_len``-token ``[BOS, payload...]``
    prefix and ending in its own tail of length uniform in ``[tail_min,
    tail_max]``; returned round-robin across families."""
    if n_families < 1 or per_family < 1:
        raise ValueError(
            f"need n_families >= 1 and per_family >= 1, got "
            f"{n_families}/{per_family}"
        )
    if prefix_len < 2:
        raise ValueError(
            f"prefix_len {prefix_len} must be >= 2 (BOS + >=1 shared "
            f"payload token — a 1-token 'shared prefix' is just BOS)"
        )
    if not 1 <= tail_min <= tail_max:
        raise ValueError(f"need 1 <= tail_min <= tail_max, got "
                         f"{tail_min}/{tail_max}")
    if vocab < 2:
        raise ValueError(f"vocab {vocab} too small for payload + BOS")
    rng = np.random.default_rng(seed)
    prefixes = [
        np.concatenate([
            np.zeros(1, np.int32),
            rng.integers(1, vocab, size=prefix_len - 1, dtype=np.int32),
        ])
        for _ in range(n_families)
    ]
    prompts = []
    for _ in range(per_family):
        for f in range(n_families):
            tail_len = int(rng.integers(tail_min, tail_max + 1))
            prompts.append(np.concatenate([
                prefixes[f],
                rng.integers(1, vocab, size=tail_len, dtype=np.int32),
            ]))
    return prompts
