"""KV-cache primitives — the port of ``ddl_tpu/ops/kv_cache.py`` (``PAD_POS``,
``_MASKED``, ``copy_prefix``, ``table_rows``, ``gather_pages``,
``table_positions``, ``attend``; JAX's ``append_rows`` and
``write_rows_flat`` are :func:`put_rows` and :func:`put_flat` on indices
from :func:`drop_index` and :func:`flat_drop_index`, which the cached
forwards compute once for all their layers' writes).

Every layer's post-RoPE k and v rows are written once and re-read on every
later step, with each row's ABSOLUTE position beside it (``PAD_POS`` where
unwritten or stale). Attention masks on positions, never on row indices, so
stale rows of a reused slot are invisible, a wrapped ring is an exact
sliding window, and the paged pool's gathered view attends exactly as the
contiguous ring does.

**Writes are in place, and out-of-bounds writes drop.** JAX donates its
cache and relies on XLA's scatter dropping out-of-bounds updates: padded
prefill tails, rows of unmapped pages and inactive decode slots all write
"nowhere". Torch's ``index_put_`` raises for such indices on the CPU and
trips a device-side assert on CUDA, so every cache tensor here carries ONE
EXTRA ROW along its row axis, the drop row, which nothing reads:

- a contiguous cache ``[B, C + 1, ...]`` (per slot, row ``C``);
- a paged pool ``[P + 1, page, ...]`` (page ``P``; flat row ``P * page``).

An index outside the valid rows is redirected there, on the device, with no
host synchronisation. Negative indices wrap once, as JAX's ``.at[]`` does.
Callers read the valid rows only (``[:, :C]``, ``[:P]``), so the drop row's
contents never matter. ``quantize_rows`` / ``dequantize_rows`` (the int8
pool) wait for their slice (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import math

import torch

# Sentinel position of unwritten/stale rows (int32 max): attend() masks k rows
# with pos > q_pos, and no real query position reaches it.
PAD_POS = 2**31 - 1

_MASKED = -1e30  # ring.py's mask constant: keeps exp(s - max) NaN-free


def drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Row indices into a row axis of ``n`` valid rows plus the drop row
    ``n``: negatives wrap once (JAX's index normalisation), anything still
    outside ``[0, n)`` becomes ``n``."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def put_rows(cache: torch.Tensor, new: torch.Tensor, rows: torch.Tensor) -> None:
    """``cache[b, rows[b, t]] = new[b, t]``, in place, for ``cache [B, C + 1,
    ...]`` and per-slot rows from :func:`drop_index` (JAX's ``append_rows``:
    a row JAX drops lands on the drop row ``C``). Rows within one slot must
    be distinct."""
    b = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[b, rows] = new


def copy_prefix(dst: torch.Tensor, src: torch.Tensor, n: int, *, axis: int = 1) -> torch.Tensor:
    """Rows ``[0, n)`` along ``axis`` take ``src``'s values, the rest keep
    ``dst``'s: in place on ``dst``, which is returned. ``n`` is a host
    integer (the engine's hit or prompt length)."""
    if n > 0:
        dst.narrow(axis, 0, n).copy_(src.narrow(axis, 0, n))
    return dst


# -- paged (block-table) layout ----------------------------------------------
#
# One shared pool ``[pages + 1, page_size, ...]`` (the last page is the drop
# page) and a per-slot int32 block table of page ids (-1 = unmapped): logical
# row r of a slot lives in pool page table[r // page_size] at offset
# r % page_size. Reads gather whole pages through the table, and positions
# gather beside them with PAD_POS where the table is unmapped, so attend()
# runs unchanged on the gathered view.


def table_rows(table: torch.Tensor, logical: torch.Tensor, page_size: int,
               num_pages: int) -> torch.Tensor:
    """Flat pool row indices for per-slot LOGICAL rows ``logical [B, T]``
    through ``table [B, TP]`` (page ids, -1 = unmapped). Rows whose page is
    unmapped or beyond the table's reach map to ``num_pages * page_size``:
    the drop page's first row."""
    tp = table.shape[1]
    page = torch.div(logical, page_size, rounding_mode="floor")
    pid = torch.gather(table, 1, page.clamp(0, tp - 1).long())
    ok = (logical >= 0) & (page < tp) & (pid >= 0)
    flat = pid * page_size + torch.remainder(logical, page_size)
    return torch.where(ok, flat, torch.full_like(flat, num_pages * page_size))


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-slot contiguous view ``[B, TP * page_size, ...]`` gathered from
    ``pool [pages(+1), page_size, ...]`` through ``table [B, TP]``. Unmapped
    (-1) entries clamp to page 0: their values are another slot's, which is
    why masking happens on :func:`table_positions`' ``PAD_POS``."""
    g = pool[table.clamp(min=0).long()]  # [B, TP, page, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:]))


def table_positions(pos: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Positions travelling with the gathered rows: ``pos [pages(+1),
    page_size]`` through ``table [B, TP]`` -> ``[B, TP * page_size]``, with
    ``PAD_POS`` wherever the table is unmapped."""
    g = pos[table.clamp(min=0).long()]
    g = torch.where((table >= 0)[..., None], g, torch.full_like(g, PAD_POS))
    return g.reshape(g.shape[0], -1)


def flat_drop_index(pool: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """:func:`drop_index` of flat rows ``flat [B, T]`` into ``pool [P + 1,
    page_size, ...]``, flattened: rows outside ``[0, P * page_size)`` become
    the drop page's first row."""
    return drop_index(flat.reshape(-1), (pool.shape[0] - 1) * pool.shape[1])


def put_flat(pool: torch.Tensor, new: torch.Tensor, rows: torch.Tensor) -> None:
    """``pool``'s flat row ``rows[i]`` = ``new``'s i-th row, in place, for
    ``new [B, T, ...]`` and rows from :func:`flat_drop_index` (JAX's
    ``write_rows_flat``: all slots scatter into the one pool, valid rows
    distinct by the allocator's invariant, dropped rows on the drop page)."""
    flat = pool.view((pool.shape[0] * pool.shape[1],) + tuple(pool.shape[2:]))
    flat[rows] = new.reshape((-1,) + tuple(new.shape[2:])).to(pool.dtype)


def attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, q_pos: torch.Tensor,
           k_pos: torch.Tensor, *, scale: float | None = None) -> torch.Tensor:
    """Causal attention of fresh queries ``q [B, T, H, D]`` at absolute
    positions ``q_pos [B, T]`` against ``k_cache``/``v_cache [B, C, H, D]``
    whose row c holds position ``k_pos[b, c]`` (``PAD_POS`` = unwritten).
    Masks ``k_pos <= q_pos``; fp32 scores and softmax, output in
    ``v_cache``'s dtype (``ring.full_attention``'s numerics)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    mask = k_pos[:, None, None, :] <= q_pos[:, None, :, None]  # [B, 1, T, C]
    s = s.masked_fill(~mask, _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v_cache.dtype), v_cache)
