"""Procedural language-modeling data — a numpy copy of ``ddl_tpu/data/lm.py``
(``LMDataset``, ``synthesize_copy``, ``synthesize_prompts``,
``synthesize_shared_prefix_prompts``, ``MixedRequest``,
``synthesize_mixed_traffic`` and ``synthesize_longtail_prompts``),
byte-equal for the same arguments.

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


@dataclasses.dataclass(frozen=True)
class MixedRequest:
    """One arrival of the mixed-traffic stream
    (:func:`synthesize_mixed_traffic`): a serve request plus its SLO
    class. ``arrival`` is a scheduler tick (the open-loop clock);
    ``family`` identifies the shared-prefix family a prompt was drawn
    from (-1 = no family — the prompt is independent), so tests can
    assert affinity without re-deriving prefixes."""

    id: int
    arrival: int
    traffic_class: str
    prompt: np.ndarray  # int32 [p], BOS-led
    max_new_tokens: int
    family: int = -1


# The canonical three-class mix: short interactive chat with shared-prefix families (system prompts), long
# document prompts with short answers, and bulk offline generation.
# Rates are per-tick Poisson means; callers override freely.
DEFAULT_TRAFFIC_CLASSES: dict[str, dict] = {
    "chat": dict(rate=0.5, prompt_min=8, prompt_max=24, max_new_tokens=8,
                 families=4, family_prefix_len=6),
    "longdoc": dict(rate=0.1, prompt_min=48, prompt_max=96,
                    max_new_tokens=16),
    "bulk": dict(rate=0.25, prompt_min=8, prompt_max=32,
                 max_new_tokens=32),
}

_TRAFFIC_CLASS_KEYS = ("rate", "prompt_min", "prompt_max",
                       "max_new_tokens", "families", "family_prefix_len")


def synthesize_mixed_traffic(
    classes: dict[str, dict] | None = None,
    horizon: int = 64,
    vocab: int = 64,
    seed: int = 0,
    diurnal_amplitude: float = 0.0,
    diurnal_period: int = 0,
    burst: tuple | None = None,
    max_requests: int = 0,
) -> list[MixedRequest]:
    """Seeded OPEN-LOOP multi-class traffic for the multi-tenant router
    (``serve.router``): per tick ``t`` in ``[0, horizon)`` and per class, draw
    ``k ~ Poisson(rate * diurnal(t) * burst(t))`` arrivals. Classes are
    dicts (see :data:`DEFAULT_TRAFFIC_CLASSES`): ``rate`` (per-tick
    Poisson mean, >= 0), prompt length bounds, ``max_new_tokens``, and
    optionally ``families``/``family_prefix_len`` — a family class
    draws each prompt's first ``family_prefix_len`` tokens from one of
    ``families`` fixed BOS-led prefixes (the system-prompt shape), so
    prefix affinity is measurable on the stream.

    ``diurnal_amplitude``/``diurnal_period`` ramp every class's rate by
    ``1 + A * sin(2*pi*t / period)`` (the day-night load curve);
    ``burst`` is ``(start, length, multiplier)`` or ``(start, length,
    multiplier, class_name)`` — inside the window the (one or every)
    class's rate multiplies, the overload scenario shedding is pinned
    against. ``max_requests > 0`` truncates the stream to its first N
    arrivals in (arrival, id) order — the knob that gives router tests a
    statically visible request bound.

    Determinism: one seeded generator, classes iterated in sorted name
    order, ticks in order — one seed, one stream, everywhere. Returned
    ids are 0..n-1 in (arrival, class, draw) order. Same prompt
    contracts as :func:`synthesize_prompts` (int32, BOS-led, payload in
    ``[1, vocab)``)."""
    if classes is None:
        classes = DEFAULT_TRAFFIC_CLASSES
    if not classes:
        raise ValueError("classes must name at least one traffic class")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    if vocab < 2:
        raise ValueError(f"vocab {vocab} too small for payload + BOS")
    if max_requests < 0:
        raise ValueError(f"max_requests must be >= 0, got {max_requests}")
    if not 0.0 <= diurnal_amplitude < 1.0:
        # amplitude >= 1 would drive the rate negative at the trough.
        raise ValueError(
            f"diurnal_amplitude must be in [0, 1), got {diurnal_amplitude}"
        )
    if diurnal_amplitude and diurnal_period < 2:
        raise ValueError(
            f"diurnal_amplitude needs diurnal_period >= 2, got "
            f"{diurnal_period}"
        )
    if burst is not None:
        if not isinstance(burst, (tuple, list)) or not 3 <= len(burst) <= 4:
            raise ValueError(
                f"burst must be (start, length, multiplier[, class]), "
                f"got {burst!r}"
            )
        b_start, b_len, b_mult = int(burst[0]), int(burst[1]), float(burst[2])
        b_class = burst[3] if len(burst) == 4 else None
        if b_start < 0 or b_len < 1 or b_mult <= 0:
            raise ValueError(
                f"burst needs start >= 0, length >= 1, multiplier > 0, "
                f"got {burst!r}"
            )
        if b_class is not None and b_class not in classes:
            raise ValueError(
                f"burst class {b_class!r} is not a traffic class "
                f"({sorted(classes)})"
            )
    for name, spec in classes.items():
        unknown = set(spec) - set(_TRAFFIC_CLASS_KEYS)
        if unknown:
            raise ValueError(
                f"class {name!r}: unknown spec keys {sorted(unknown)} "
                f"(valid: {list(_TRAFFIC_CLASS_KEYS)})"
            )
        rate = spec.get("rate", 0.0)
        if rate < 0:
            raise ValueError(f"class {name!r}: rate must be >= 0, got {rate}")
        pmin = spec.get("prompt_min", 4)
        pmax = spec.get("prompt_max", 16)
        if not 2 <= pmin <= pmax:
            raise ValueError(
                f"class {name!r}: need 2 <= prompt_min <= prompt_max, "
                f"got {pmin}/{pmax}"
            )
        if spec.get("max_new_tokens", 8) < 1:
            raise ValueError(
                f"class {name!r}: max_new_tokens must be >= 1"
            )
        fams = spec.get("families", 0)
        if fams:
            fpl = spec.get("family_prefix_len", 0)
            if fams < 1:
                raise ValueError(f"class {name!r}: families must be >= 1")
            if not 2 <= fpl < pmin:
                raise ValueError(
                    f"class {name!r}: family_prefix_len ({fpl}) must be in "
                    f"[2, prompt_min) — a family prefix needs BOS + >= 1 "
                    "payload token and must leave >= 1 tail token"
                )
    rng = np.random.default_rng(seed)
    arrivals: list[tuple[int, str, np.ndarray, int, int]] = []
    for name in sorted(classes):
        spec = classes[name]
        rate = float(spec.get("rate", 0.0))
        pmin = int(spec.get("prompt_min", 4))
        pmax = int(spec.get("prompt_max", 16))
        max_new = int(spec.get("max_new_tokens", 8))
        fams = int(spec.get("families", 0))
        fpl = int(spec.get("family_prefix_len", 0)) if fams else 0
        prefixes = [
            np.concatenate([
                np.zeros(1, np.int32),
                rng.integers(1, vocab, size=fpl - 1, dtype=np.int32),
            ])
            for _ in range(fams)
        ]
        for t in range(horizon):
            lam = rate
            if diurnal_amplitude:
                lam *= 1.0 + diurnal_amplitude * np.sin(
                    2.0 * np.pi * t / diurnal_period
                )
            if burst is not None and b_start <= t < b_start + b_len \
                    and (b_class is None or b_class == name):
                lam *= b_mult
            for _ in range(int(rng.poisson(lam))):
                if fams:
                    fam = int(rng.integers(fams))
                    tail = int(rng.integers(pmin - fpl, pmax - fpl + 1))
                    prompt = np.concatenate([
                        prefixes[fam],
                        rng.integers(1, vocab, size=tail, dtype=np.int32),
                    ])
                else:
                    fam = -1
                    n = int(rng.integers(pmin, pmax + 1))
                    prompt = np.concatenate([
                        np.zeros(1, np.int32),
                        rng.integers(1, vocab, size=n - 1, dtype=np.int32),
                    ])
                arrivals.append((t, name, prompt, max_new, fam))
    # (arrival, class, draw) order — class order is the sorted-name
    # generation order, draw order the Poisson sequence — then ids
    # assigned sequentially so (arrival, id) sorting is stable.
    arrivals.sort(key=lambda a: a[0])  # stable: preserves class/draw order
    if max_requests:
        arrivals = arrivals[:max_requests]
    return [
        MixedRequest(id=i, arrival=t, traffic_class=name, prompt=prompt,
                     max_new_tokens=max_new, family=fam)
        for i, (t, name, prompt, max_new, fam) in enumerate(arrivals)
    ]


def synthesize_longtail_prompts(
    num_short: int = 12,
    num_long: int = 2,
    short_min: int = 4,
    short_max: int = 12,
    long_len: int = 96,
    long_prefix_len: int = 0,
    vocab: int = 64,
    seed: int = 0,
) -> list[np.ndarray]:
    """Deterministic LONG-TAIL prompt mix for the paged pool: ``num_short``
    short prompts (lengths uniform in ``[short_min, short_max]``) with
    ``num_long`` prompts of exactly ``long_len`` tokens spread evenly among
    them, the workload where a worst-case reservation per slot hurts most
    and pooled page admission wins. The long prompts share a
    ``long_prefix_len``-token prefix (0: ``long_len // 2``; 1: only the
    BOS). Same contracts as :func:`synthesize_prompts`: int32 arrays of
    variable length, token 0 the BOS, payload in ``[1, vocab)``."""
    if num_short < 0 or num_long < 0 or num_short + num_long < 1:
        raise ValueError(f"need num_short >= 0, num_long >= 0 and at least one "
                         f"prompt, got {num_short}/{num_long}")
    if not 1 <= short_min <= short_max:
        raise ValueError(f"need 1 <= short_min <= short_max, got "
                         f"{short_min}/{short_max}")
    if num_long and long_len <= short_max:
        raise ValueError(f"long_len ({long_len}) must exceed short_max ({short_max}) "
                         "— otherwise the mix has no tail")
    long_prefix_len = long_prefix_len or long_len // 2
    if num_long and not 1 <= long_prefix_len <= long_len:
        raise ValueError(f"long_prefix_len ({long_prefix_len}) outside "
                         f"[1, long_len={long_len}]")
    if vocab < 2:
        raise ValueError(f"vocab {vocab} too small for payload + BOS")
    rng = np.random.default_rng(seed)
    shorts = [
        np.concatenate([np.zeros(1, np.int32),
                        rng.integers(1, vocab, size=int(n) - 1, dtype=np.int32)])
        for n in rng.integers(short_min, short_max + 1, size=num_short)
    ]
    longs = []
    if num_long:
        # A shorts-only mix draws no long material at all.
        shared = np.concatenate([np.zeros(1, np.int32),
                                 rng.integers(1, vocab, size=long_prefix_len - 1,
                                              dtype=np.int32)])
        longs = [
            np.concatenate([shared, rng.integers(1, vocab, size=long_len - long_prefix_len,
                                                 dtype=np.int32)])
            for _ in range(num_long)
        ]
    # Longs spread evenly through the shorts (a long head-of-line burst
    # would test queueing, not pooling).
    prompts = list(shorts)
    stride = max(1, (len(prompts) + 1) // (num_long + 1))
    for i, lp in enumerate(longs):
        prompts.insert(min(len(prompts), (i + 1) * stride + i), lp)
    return prompts
