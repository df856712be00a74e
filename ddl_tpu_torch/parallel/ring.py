"""Sequence parallelism: ring attention and Ulysses — the port of
``ddl_tpu/parallel/ring.py``.

- :func:`full_attention`: plain softmax attention, the one-device oracle
  and Ulysses's default local kernel.
- :func:`ring_attention_shard`: exact attention over a sequence sharded
  around a ring of ``P`` ranks. Q stays; the K/V blocks move ``i -> i+1``
  once a ring step (``collectives.ring_shift``, the counterpart of
  ``lax.ppermute``), and the online-softmax state ``(m, l, acc)`` is
  rescaled block by block, in fp32 whatever the input type.
- :func:`ulysses_attention_shard`: two tiled all-to-alls re-partition the
  sequence-sharded ``[B, T/P, H, D]`` activations into head-sharded
  ``[B, T, H/P, D]`` ones and back (``collectives.seq_to_heads`` /
  ``heads_to_seq``); the local attention in between is any full-sequence
  kernel, e.g. the CUDA flash kernels.

Causal ring sweeps support JAX's two position layouts: ``contiguous``
(block ``i`` on rank ``i``) and ``zigzag`` (rank ``i`` holds chunks ``i`` and
``2P-1-i`` of ``2P``: :func:`zigzag_positions`, :func:`zigzag_permutation`).
Every block's positions are a static function of (rank, ring step, layout),
so the causal sub-tile skip that JAX decides on the device with
``lax.cond(kmin > qmax)`` is decided here on the host
(:func:`causal_skip_plan`): the ring never waits on a device-to-host read,
and the positions never travel. :func:`causal_work_profile` is the same
plan summed per (rank, step), as JAX's.

The ring is JAX's plain arithmetic (plain jnp there, torch ops here: cuBLAS
batched matmuls and elementwise kernels), so it does not route through the
flash kernels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import collectives as coll

_MASKED = -1e30  # large-negative (not -inf): keeps exp(s - m) NaN-free
LAYOUTS = ("contiguous", "zigzag")


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
    scale: float | None = None, q_offset: int = 0, k_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention over ``[B, T, H, D]``: scores in the inputs'
    type, upcast to fp32, scaled, masked where a key's absolute position
    follows the query's (``q_offset``/``k_offset`` are the positions of
    element 0), softmaxed, then ``P`` cast to ``v``'s type times ``V``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _zigzag_positions(i: int, axis_size: int, t_local: int, xp, **arange_kw):
    """Rank ``i``'s absolute positions under the zigzag layout: its halves
    are chunks ``i`` and ``2P-1-i`` of ``2P``. ``xp`` is ``numpy`` (host
    plans and staging) or ``torch`` (``arange_kw`` then places the result
    on a device): one definition for both."""
    if t_local % 2:
        raise ValueError(f"zigzag layout needs an even per-shard length, got {t_local}")
    h = t_local // 2
    lo = i * h + xp.arange(h, **arange_kw)
    hi = (2 * axis_size - 1 - i) * h + xp.arange(h, **arange_kw)
    return xp.concatenate([lo, hi])


def zigzag_positions(i: int, axis_size: int, t_local: int) -> np.ndarray:
    """Absolute positions of shard ``i``'s rows under the two-ended
    ("zigzag") causal layout: the sequence is cut into ``2P`` equal chunks
    and rank ``i`` holds chunks ``i`` and ``2P-1-i``."""
    return _zigzag_positions(i, axis_size, t_local, np)


def shard_positions(layout: str, i: int, axis_size: int, t_local: int, xp=np, **arange_kw):
    """Shard ``i``'s absolute positions ``[t_local]`` under ``layout``
    (``xp`` and ``arange_kw`` as :func:`_zigzag_positions`)."""
    if layout == "zigzag":
        return _zigzag_positions(i, axis_size, t_local, xp, **arange_kw)
    if layout == "contiguous":
        return i * t_local + xp.arange(t_local, **arange_kw)
    raise ValueError(f"unknown layout {layout!r}")


def zigzag_permutation(axis_size: int, seq_len: int) -> np.ndarray:
    """Gather index ``perm [seq_len]`` such that contiguous sharding of
    ``x[..., perm]`` over ``axis_size`` ranks lands the zigzag chunk pair
    ``(i, 2P-1-i)`` on rank ``i``."""
    if seq_len % (2 * axis_size):
        raise ValueError(
            f"zigzag layout needs seq_len % (2 * {axis_size}) == 0, got {seq_len}"
        )
    t_local = seq_len // axis_size
    return np.concatenate([
        _zigzag_positions(i, axis_size, t_local, np) for i in range(axis_size)
    ]).astype(np.int64)


def default_nsub(layout: str, causal: bool) -> int:
    """The skip granularity JAX defaults to: 2 sub-chunks for a causal
    zigzag sweep (chunk-pair granularity), else 1."""
    return 2 if (layout == "zigzag" and causal) else 1


def causal_skip_plan(
    index: int, axis_size: int, t_local: int, layout: str = "contiguous",
    nsub: int | None = None,
) -> np.ndarray:
    """``skip [P, nsub, nsub]`` for rank ``index``'s causal sweep:
    ``skip[r, b, a]`` is True when, at ring step ``r``, the travelling
    k-sub-chunk ``b`` (of the block that started on rank ``(index - r) %
    P``) lies entirely after q-sub-chunk ``a`` — JAX's ``lax.cond(kmin >
    qmaxs[a])`` predicate, evaluated on the host."""
    if nsub is None:
        nsub = default_nsub(layout, True)
    if t_local % nsub:
        raise ValueError(f"per-shard length {t_local} not divisible by nsub={nsub}")
    ns = t_local // nsub
    pos = [shard_positions(layout, j, axis_size, t_local) for j in range(axis_size)]
    qmax = [pos[index][a * ns:(a + 1) * ns].max() for a in range(nsub)]
    skip = np.zeros((axis_size, nsub, nsub), bool)
    for r in range(axis_size):
        kp = pos[(index - r) % axis_size]
        for b in range(nsub):
            kmin = kp[b * ns:(b + 1) * ns].min()
            for a in range(nsub):
                skip[r, b, a] = kmin > qmax[a]
    return skip


def causal_work_profile(axis_size: int, layout: str = "contiguous") -> np.ndarray:
    """Per-(rank, ring step) compute of a causal ring sweep in units of one
    full local tile, ``work [P, P]``: the sub-tiles
    :func:`causal_skip_plan` keeps. The lockstep ring's critical path is
    ``sum_r max_i work[i, r]``: P tiles contiguous, (2P+1)/4 zigzag."""
    nsub = default_nsub(layout, True)
    t_local = 2 * nsub  # smallest even per-shard length; work is scale-free
    work = np.zeros((axis_size, axis_size))
    for i in range(axis_size):
        kept = ~causal_skip_plan(i, axis_size, t_local, layout, nsub)
        work[i] = kept.sum(axis=(1, 2)) / (nsub * nsub)
    return work


def _block_update(m, l, acc, q, qpos, k, v, kpos, scale, masked):
    """One online-softmax step of a q-sub-chunk against a k/v-sub-chunk;
    ``masked`` says whether the causal mask can drop anything here."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if masked:
        s = torch.where(kpos[None, :] <= qpos[:, None], s, _MASKED)
    m_new = torch.maximum(m, s.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * correction + p.sum(dim=-1)
    acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float()
    )
    return m_new, l, acc


def ring_attention_shard(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, axis_size: int, index: int,
    ring: coll.Ring | None = None, causal: bool = False, scale: float | None = None,
    layout: str = "contiguous", nsub: int | None = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded around a ring: this rank is
    shard ``index`` of ``axis_size``, with ``[B, T/P, H, D]`` inputs.

    At ring step ``r`` this rank holds the K/V block that started on rank
    ``(index - r) % P``; ``ring`` moves the blocks between steps (None: a
    ring of one, which never moves anything). The state is fp32; the
    output is cast back to ``q``'s type. Causal sub-tiles that lie entirely
    in the future are skipped by the host plan (:func:`causal_skip_plan`);
    ``nsub`` is the skip granularity (default :func:`default_nsub`). A
    sub-tile wholly in the past needs no mask and gets none: the same
    values as JAX's ``jnp.where`` with an all-true condition."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if nsub is None:
        nsub = default_nsub(layout, causal)
    if Tq % nsub or Tk % nsub:
        raise ValueError(f"per-shard lengths ({Tq}, {Tk}) not divisible by nsub={nsub}")
    if Tq != Tk:
        raise ValueError(f"ring shards must be equal, got Tq={Tq}, Tk={Tk}")
    if axis_size > 1 and ring is None:
        raise ValueError(f"a ring of {axis_size} needs its Ring")
    nq = Tq // nsub
    host = [shard_positions(layout, j, axis_size, Tq) for j in range(axis_size)]
    if causal:
        skip = causal_skip_plan(index, axis_size, Tq, layout, nsub)
        dev = [shard_positions(layout, j, axis_size, Tq, torch, device=q.device)
               for j in range(axis_size)]
    qs = [q[:, a * nq:(a + 1) * nq] for a in range(nsub)]
    ms = [torch.full((B, H, nq), _MASKED, dtype=torch.float32, device=q.device)
          for _ in range(nsub)]
    ls = [torch.zeros((B, H, nq), dtype=torch.float32, device=q.device) for _ in range(nsub)]
    accs = [torch.zeros((B, nq, H, D), dtype=torch.float32, device=q.device)
            for _ in range(nsub)]
    for r in range(axis_size):
        j = (index - r) % axis_size
        for b in range(nsub):
            k_sub, v_sub = k[:, b * nq:(b + 1) * nq], v[:, b * nq:(b + 1) * nq]
            for a in range(nsub):
                masked = False
                if causal:
                    if skip[r, b, a]:
                        continue
                    qp = host[index][a * nq:(a + 1) * nq]
                    masked = bool(host[j][b * nq:(b + 1) * nq].max() > qp.min())
                ms[a], ls[a], accs[a] = _block_update(
                    ms[a], ls[a], accs[a], qs[a],
                    dev[index][a * nq:(a + 1) * nq] if masked else None, k_sub, v_sub,
                    dev[j][b * nq:(b + 1) * nq] if masked else None, scale, masked,
                )
        if r != axis_size - 1:
            k, v = coll.ring_shift(ring, k, v)
    acc = torch.cat(accs, dim=1)
    l = torch.cat(ls, dim=2)
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    # Every rank runs every shift's backward, skipped blocks or not.
    return coll.keep_in_backward(out, k, v) if axis_size > 1 else out


def ulysses_attention_shard(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, axis_size: int,
    group=None, causal: bool = False, scale: float | None = None,
    local_attn=None,
) -> torch.Tensor:
    """Ulysses sequence parallelism over ``[B, T/P, H, D]`` shards with ``H
    % P == 0``: one all-to-all turns the sequence sharding into a head
    sharding ``[B, T, H/P, D]`` (rank ``j`` gets head block ``j``), the
    local kernel runs over the whole sequence on the head subset, and a
    second all-to-all restores the sequence sharding. ``local_attn`` is a
    ``(q, k, v) -> out`` closure with causality and scale bound (default
    :func:`full_attention`). ``group`` is the sequence axis's process group
    (``coll.LOCAL``: no process group, a ring of one)."""
    H = q.shape[2]
    if H % axis_size:
        raise ValueError(f"ulysses needs num_heads % axis_size == 0, got {H} % {axis_size}")
    if local_attn is None:
        local_attn = functools.partial(full_attention, causal=causal, scale=scale)
    qh, kh, vh = coll.seq_to_heads(group, axis_size, q, k, v)
    (out,) = coll.heads_to_seq(group, axis_size, local_attn(qh, kh, vh))
    return out
