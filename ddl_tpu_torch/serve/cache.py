"""The serving KV caches — the port of ``ddl_tpu/serve/cache.py``: the
slot-major ring (:class:`KVCache`, the
bit-exactness oracle and default) and the PAGED block-table pool
(:class:`PagedKVCache` + the host allocator :class:`PagePool`), which pools
capacity across slots and makes prefix reuse zero-copy (refcounted page
sharing).

The port updates caches in place where JAX donates them, so every function
here mutates its first argument and returns it. Each cache tensor carries
one drop row (contiguous: row ``C`` of each slot; paged: page ``P``) that
out-of-bounds writes land on (``ops.kv_cache``); the properties below and
``convert.kv_cache_to_numpy`` see only the valid rows. Under tensor
parallelism a rank's cache holds its own ``H/tp`` heads (JAX shards the
head dimension over tp, ``cache_specs``), made by ``tensor_parallel=``. The int8 pool's scale
planes wait for their slice (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ..models.transformer import LMSpec
from ..ops.kv_cache import PAD_POS, copy_prefix


@dataclasses.dataclass
class KVCache:
    """``k``/``v [L, S, C + 1, H, D]`` per-layer rings, stacked layer-major;
    ``pos [S, C + 1]`` int32, the absolute position each row holds, shared
    by all layers (``PAD_POS`` = unwritten/stale). Row ``C`` of each slot is
    the drop row."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2] - 1

    @property
    def slots(self) -> int:
        return self.k.shape[1]


def host_cache(spec: LMSpec, slots: int, capacity: int, dtype=torch.float32,
               device: str | torch.device = "cpu", *, tensor_parallel: int = 1) -> KVCache:
    """Fresh cache: zero k/v, every row's position ``PAD_POS`` (nothing
    attendable); one tp rank's ``H/tensor_parallel`` heads."""
    shape = (spec.num_layers, slots, capacity + 1, spec.num_heads // tensor_parallel,
             spec.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((slots, capacity + 1), PAD_POS, dtype=torch.int32, device=device),
    )


def copy_slot_prefix(dst: KVCache, src: KVCache, *, src_slot: int, dst_slot: int,
                     n: int) -> KVCache:
    """Copy the first ``n`` ring rows (K/V of every layer and positions) of
    ``src_slot`` in ``src`` into ``dst_slot`` of ``dst``, in place; rows
    ``>= n`` of the destination reset to ``PAD_POS``. ``src`` and ``dst`` may
    be the same cache or two caches of one capacity (the prefix pool). The
    copy is a real copy: the prefix pool keeps a snapshot."""
    copy_prefix(dst.k[:, dst_slot], src.k[:, src_slot], n, axis=1)
    copy_prefix(dst.v[:, dst_slot], src.v[:, src_slot], n, axis=1)
    pos = dst.pos[dst_slot, : dst.capacity]
    copy_prefix(pos, src.pos[src_slot], n, axis=0)
    pos[n:] = PAD_POS
    return dst


# -- paged (block-table) layout ----------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """ONE shared K/V pool of fixed-size pages, mapped into slots by
    host-side block tables (``serve.engine``).

    - ``k``/``v [L, P + 1, page, H, D]`` — the pool, layer-major; page ``P``
      is the drop page.
    - ``pos [P + 1, page]`` int32 — the absolute position each pool row
      holds, shared by all layers. The free-list invariant (``PagePool``):
      every UNMAPPED page is fully ``PAD_POS`` (pages reset when their last
      reference drops), so a freshly mapped page leaks nothing into the
      gathered attend view.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def host_paged_cache(spec: LMSpec, num_pages: int, page_size: int, dtype=torch.float32,
                     device: str | torch.device = "cpu", *,
                     tensor_parallel: int = 1) -> PagedKVCache:
    """Fresh paged pool: zero k/v, every row ``PAD_POS`` (the free-list
    invariant holds from birth); one tp rank's ``H/tensor_parallel``
    heads."""
    shape = (spec.num_layers, num_pages + 1, page_size, spec.num_heads // tensor_parallel,
             spec.head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((num_pages + 1, page_size), PAD_POS, dtype=torch.int32, device=device),
    )


def kv_row_bytes(spec: LMSpec, kv_dtype: str | None, dtype=torch.float32) -> int:
    """Bytes ONE pool row (K + V of every layer) costs on the device:
    ``2 * L * H * D * itemsize``. The int8 pool (``kv_dtype="int8"``) waits
    for its slice."""
    if kv_dtype is not None:
        if kv_dtype != "int8":
            raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        raise NotImplementedError(
            "the int8 KV pool is not ported yet (ROADMAP queue 1, item 8: the int8 pool)"
        )
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * spec.num_layers * spec.num_heads * spec.head_dim * itemsize


def copy_page(pool: PagedKVCache, *, src_page: int, dst_page: int, n: int) -> PagedKVCache:
    """Copy the first ``n`` rows (K/V of every layer and positions) of
    ``src_page`` into ``dst_page``, in place; destination rows ``>= n``
    reset to ``PAD_POS``. The copy-on-write of a prefix hit's partial
    boundary page: the new occupant owns a real copy it may write into."""
    copy_prefix(pool.k[:, dst_page], pool.k[:, src_page], n, axis=1)
    copy_prefix(pool.v[:, dst_page], pool.v[:, src_page], n, axis=1)
    copy_prefix(pool.pos[dst_page], pool.pos[src_page], n, axis=0)
    pool.pos[dst_page, n:] = PAD_POS
    return pool


class PagePool:
    """Host-side page allocator: free list, per-page refcounts and admission
    RESERVATIONS, in plain Python (the device sees tables only).

    - **Refcounts**: a page is held by every slot whose table maps it and
      every prefix entry that registered it; the last ``decref`` frees it
      (the engine then resets its ``pos`` rows to ``PAD_POS``).
    - **Reservations**: the scheduler admits a request only when
      ``available`` (free minus promised) covers its worst case, so
      admission never deadlocks mid-decode.
    - **Deterministic**: the free list pops the lowest page id first.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages))  # a min-heap
        self.refs = np.zeros(num_pages, np.int32)
        self.reserved = 0

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        """Free pages not promised to an admitted request."""
        return len(self._free) - self.reserved

    @property
    def shared(self) -> int:
        """Pages held by more than one reader (slots + prefix entries)."""
        return int((self.refs >= 2).sum())

    def reserve(self, n: int) -> None:
        if n > self.available:
            raise RuntimeError(
                f"reserving {n} pages with only {self.available} available "
                f"({self.free} free, {self.reserved} already reserved) — "
                "admission must check availability first"
            )
        self.reserved += n

    def unreserve(self, n: int) -> None:
        if n > self.reserved:
            raise RuntimeError(f"unreserving {n} of {self.reserved} reserved pages")
        self.reserved -= n

    def alloc(self) -> int:
        """Pop the lowest free page id at refcount 1."""
        if not self._free:
            raise RuntimeError("page pool exhausted (no free pages)")
        page = heapq.heappop(self._free)
        self.refs[page] = 1
        return page

    def incref(self, page: int) -> None:
        if self.refs[page] < 1:
            # Increfing a free page would resurrect it while it sits in the
            # free list: a double allocation.
            raise RuntimeError(f"incref on free page {page}")
        self.refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; True when the page just freed (the caller
        must reset its device ``pos`` rows before reuse)."""
        if self.refs[page] < 1:
            raise RuntimeError(f"decref on free page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            heapq.heappush(self._free, page)
            return True
        return False
