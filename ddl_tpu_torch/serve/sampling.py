"""Token sampling on the device — the port of the JAX engine's ``_sample``
(``ddl_tpu/serve/engine.py``), vectorised over slots.

- **Greedy** (``temperature == 0``): ``argmax``, first maximum on ties.
- **Temperature**: ``jax.random.categorical(key, logits / temperature)``
  with ``key = fold_in(fold_in(PRNGKey(seed), request_id), token_index)``,
  ported bit for bit: the threefry2x32 hash, ``fold_in`` as a hash of the
  count pair ``(0, data)``, 32 random bits a logit from the counts
  ``(0, iota)`` of the partitionable layout (``bits1 ^ bits2``, JAX's
  default), the uniform draw of ``gumbel``'s "low" mode (23 mantissa bits
  into ``[1, 2)``, minus 1, plus ``tiny``) and ``argmax(logits + gumbel)``.
  The key depends only on ``(seed, request_id, token_index)``, so a
  request's tokens do not depend on its slot or on who shares its batch,
  and they equal JAX's. The random bits are bit-equal to JAX's; the
  Gumbel noise goes through the device's ``log``, which may differ from
  XLA's in the last place, so a sampled token could differ only where two
  noisy logits tie to that precision.
- **Top-k**: JAX's tie rule, ``scaled >= sort(scaled)[-k]`` (every logit
  equal to the k-th largest survives), not ``torch.topk``.

Unsigned 32-bit words live in int64 tensors, masked after every add and
shift.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = 1.1754943508222875e-38  # float32's smallest normal (finfo.tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x1, x2)``
    under the key ``(k1, k2)``: ints or int64 tensors of uint32 values,
    broadcast together."""
    ks = [k1, k2, k1 ^ k2 ^ _PARITY]
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: ``(seed >> 32,
    seed & 0xFFFFFFFF)`` with the 32-bit shift giving 0."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return 0, seed & _MASK


def fold_in(key, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data)``
    (``data`` wrapped to uint32) under ``key``, a pair of ints or tensors."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data & _MASK)


def random_bits(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32, partitionable) for a batch of
    keys ``[S]``: ``[S, n]`` int64 words."""
    k1, k2 = (k[:, None] for k in key)
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in "low" mode for a batch
    of keys: ``[S, n]``."""
    bits = random_bits(key, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # uniform(minval=tiny, maxval=1): the scale 1 - tiny rounds to 1 in fp32.
    u = torch.clamp_min(mant + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, request_ids: torch.Tensor, token_index: torch.Tensor, *,
           temperature: float, top_k: int, seed: int) -> torch.Tensor:
    """One token per row of ``logits [S, vocab]``: greedy at ``temperature
    <= 0``, else the categorical draw keyed by ``(seed, request_ids[s],
    token_index[s])``. Returns int32 ``[S]`` on ``logits``' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.tensor(temperature, dtype=logits.dtype, device=logits.device)
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k, None]
        scaled = torch.where(scaled >= kth, scaled, torch.full_like(scaled, float("-inf")))
    key = fold_in(prng_key(seed), request_ids.to(torch.int64))
    key = fold_in(key, token_index.to(torch.int64))
    return torch.argmax(gumbel(key, logits.shape[-1]) + scaled, dim=-1).to(torch.int32)
