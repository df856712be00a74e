"""The inference engine — the port of ``ddl_tpu/serve/engine.py``
(``ServeConfig``, ``InferenceEngine``).

Two programs cover a request's whole life, as in JAX:

- **prefill**: one block of a prompt, padded to a power-of-two bucket, runs
  through ``transformer.apply_lm_cached`` (``apply_lm_paged``) in one
  forward, writing rows ``base..base+t-1`` of its slot and sampling
  sequence element ``base + t`` from the last real position's logits.
  ``base > 0`` resumes after a prefix-cache copy or an earlier chunk. The
  slot's ``pos`` rows reset to ``PAD_POS`` from ``base`` on, so a reused
  slot never leaks its previous occupant's history; padded tail writes land
  on the drop row.
- **decode**: ONE token per slot, batched over all slots at fixed shapes;
  free slots ride along writing ``PAD_POS`` rows (contiguous) or nothing
  (paged: their writes land on the drop page).

JAX compiles one program per bucket and donates the cache; the port runs
eagerly on the device and updates the cache IN PLACE, keeping the same
buckets (the fixed shapes a later graph capture needs) and copying wherever
JAX keeps an old value (the prefix pool's snapshot, the copy-on-write
boundary page). The host prepares every index (positions, write rows, block
tables, through the same ``ops.kv_cache`` functions run on CPU tensors)
and uploads it before the forward, so a prefill or decode launches its
device work without a synchronisation and ends in one fetch of the sampled
tokens.

Sampling (``serve.sampling``) is greedy at ``temperature == 0``, else the
JAX key derivation ported bit for bit: a request's tokens equal JAX's and do
not depend on its slot or its neighbours.

**Prefix cache** (``prefix_slots > 0``): contiguous mode keeps a dedicated
pool (a second :class:`~ddl_tpu_torch.serve.cache.KVCache`, never part of
the decode batch) and copies rows pool -> slot on a hit, slot -> pool on
registration; paged mode shares whole pages by refcount and copies only a
partial boundary page (``page_copies``).

**Paged KV pool** (``page_size > 0``): one shared ``[L, pages + 1, page, H,
D]`` pool plus a host block table per slot; admission reserves pages, and
decode buckets on PAGE COUNT so attention tracks residency.

**Tensor parallelism** (``tensor_parallel > 1``): one engine a rank of a tp
group (``grid=``, ``parallel/mesh.py::make_grid``). A rank holds its
column/row shard of the weights (``models/partition.py``, the training
side's definition) and a contiguous or paged pool of its own heads only,
so a pool row costs ``2·L·(H/tp)·D·itemsize`` bytes there. The cached
forward completes the row-sharded partial sums with one all-reduce over
the tp group, the training side's ``g`` (``collectives.tp_allreduce``,
never differentiated here). Every rank runs the same
deterministic scheduler and samples the same token from bit-identical
reduced logits, so the host state never diverges.

**Compute dtype** (``compute_dtype="bfloat16"``): the cached forwards
cast the weights and activations to bf16 (logits stay fp32) and the KV
pools (contiguous, paged and the prefix pool) are allocated in bf16, so a
pool row costs half its fp32 bytes.

Not ported here, each raising ``NotImplementedError`` naming its ROADMAP
item: ``kv_dtype="int8"``, ``speculate_k > 0``,
``speculate_method="prompt"``, checkpoint loading, and the page hand-off
(``dump_slot_pages``, ``load_slot_pages``, ``alias_slot_pages``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import precision as _precision
from ..convert import lm_params_from_numpy
from ..models import transformer
from ..models.transformer import LMSpec
from ..ops import kv_cache
from ..ops.kv_cache import PAD_POS
from ..models.partition import lm_param_specs, shard_lm_params
from ..parallel import collectives as coll
from ..parallel.mesh import Grid, default_device
from ..utils import tree
from . import sampling
from .cache import (
    KVCache,
    PagePool,
    copy_page,
    copy_slot_prefix,
    host_cache,
    host_paged_cache,
    kv_row_bytes,
)
from .prefix import PrefixIndex

SPECULATE_METHODS = ("ngram", "prompt")
_HANDOFF = "ROADMAP queue 1, item 8: preempt/adopt and page dump/load"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving topology and sampling policy, every field of JAX's.
    ``slots`` is the continuous-batching width; ``capacity`` bounds each
    slot's prompt + generated length. ``prefix_slots`` sizes the prefix
    cache (0 = off; paged: the resident entry count). ``prefill_chunk`` (0
    = off; else a power of two >= 8) splits prompts into chunks interleaved
    with decode ticks, ``prefill_budget`` caps prefill tokens a tick (0 =
    one chunk). ``page_size > 0`` selects the paged pool of ``num_pages``
    pages (0 = ``slots * capacity / page_size``). ``tensor_parallel`` is the
    Megatron degree, which the engine's grid must have. ``compute_dtype``
    is None (fp32), ``"float32"`` or ``"bfloat16"``. ``kv_dtype``,
    ``speculate_k > 0`` and a ``speculate_method`` other than ``"ngram"``
    are accepted here and refused by the engine (not ported)."""

    spec: LMSpec = LMSpec()
    slots: int = 4
    capacity: int = 256
    tensor_parallel: int = 1
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = full vocab (temperature > 0 only)
    seed: int = 0
    compute_dtype: str | None = None  # None = fp32; "bfloat16" = bf16 compute and pools
    prefix_slots: int = 0
    prefill_chunk: int = 0
    prefill_budget: int = 0
    page_size: int = 0  # paged KV layout: rows per page; 0 = contiguous
    num_pages: int = 0  # paged pool size; 0 = slots * capacity / page_size
    kv_dtype: str | None = None
    speculate_k: int = 0
    speculate_method: str = "ngram"

    def dtype(self) -> torch.dtype | None:
        """The compute dtype as a torch dtype (None = fp32, no cast), as
        the precision policy resolves it: another dtype raises."""
        return _precision.resolve(None, self.compute_dtype).compute_dtype

    def pool_dtype(self) -> torch.dtype:
        """The dtype the KV pools are allocated in: the compute dtype."""
        return self.dtype() or torch.float32


def check_config(config: ServeConfig) -> None:
    """JAX's constructor checks (``ValueError``), then the refusals of what
    this slice does not port (``NotImplementedError``)."""
    spec, tp = config.spec, config.tensor_parallel
    if tp < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {tp}")
    if tp > 1:
        if spec.num_heads % tp:
            raise ValueError(
                f"tensor_parallel needs num_heads ({spec.num_heads}) divisible by tp ({tp})"
            )
        if spec.d_ff % tp:
            raise ValueError(f"tensor_parallel needs d_ff ({spec.d_ff}) divisible by tp ({tp})")
    if config.slots < 1 or config.capacity < 2:
        raise ValueError(f"need slots >= 1 and capacity >= 2, got "
                         f"{config.slots} / {config.capacity}")
    if not 0 <= config.top_k <= spec.vocab:
        raise ValueError(f"top_k must be in [0, vocab={spec.vocab}], got {config.top_k}")
    if config.prefix_slots < 0:
        raise ValueError(f"prefix_slots must be >= 0, got {config.prefix_slots}")
    ck = config.prefill_chunk
    if ck and (ck < 8 or ck & (ck - 1)):
        raise ValueError(f"prefill_chunk must be 0 or a power of two >= 8, got {ck}")
    if config.prefill_budget:
        if not ck:
            raise ValueError(
                "prefill_budget requires prefill_chunk (the budget meters chunk "
                "interleaving; whole-prompt prefill ignores it silently otherwise)"
            )
        if config.prefill_budget < ck:
            raise ValueError(f"prefill_budget ({config.prefill_budget}) below "
                             f"prefill_chunk ({ck}) could never start a chunk")
    ps = config.page_size
    if ps < 0 or (ps and ps & (ps - 1)):
        raise ValueError(
            f"page_size must be 0 (contiguous) or a power of two, got {ps} (pages "
            "tile the capacity and the row->page split is a shift/mask)"
        )
    if config.num_pages and not ps:
        raise ValueError(f"num_pages ({config.num_pages}) requires page_size > 0 "
                         "(the contiguous layout has no page pool)")
    if config.num_pages < 0:
        raise ValueError(f"num_pages must be >= 0, got {config.num_pages}")
    config.dtype()  # fp32 or bf16 compute only
    if config.kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {config.kv_dtype!r}")
    if config.kv_dtype == "int8" and not ps:
        raise ValueError(
            "kv_dtype='int8' needs the paged KV layout (page_size > 0): quantized "
            "storage lives in the shared page pool; the contiguous ring is the "
            "full-precision oracle"
        )
    sk = config.speculate_k
    if sk < 0:
        raise ValueError(f"speculate_k must be >= 0, got {sk}")
    if config.speculate_method not in SPECULATE_METHODS:
        raise ValueError(f"speculate_method must be one of {', '.join(SPECULATE_METHODS)}, "
                         f"got {config.speculate_method!r}")
    if ps:
        if config.capacity % ps:
            raise ValueError(f"capacity ({config.capacity}) must be a multiple of "
                             f"page_size ({ps}) — the block table holds whole pages")
        num_pages = config.num_pages or config.slots * (config.capacity // ps)
        if num_pages < config.slots:
            raise ValueError(
                f"num_pages ({num_pages}) below slots ({config.slots}) — every admitted "
                "slot needs at least one page; the pool could never fill the batch"
            )
    refused = (
        (config.kv_dtype is not None, "kv_dtype='int8' (ROADMAP queue 1, item 8: the int8 pool)"),
        (sk > 0, "speculate_k > 0 (ROADMAP queue 1, item 8: speculate)"),
        (config.speculate_method != "ngram",
         f"speculate_method={config.speculate_method!r} (ROADMAP queue 1, item 8: speculate)"),
    )
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


class InferenceEngine:
    """Owns the params on the device, the cache state and the bucketed
    prefill/decode pair. ``params`` is the full host tree of numpy arrays
    (e.g. JAX's ``jax.tree.map(np.asarray, params)``, checked by
    ``convert.lm_params_from_numpy``); ``None`` seeds the
    port's own init from ``config.seed`` (not JAX's draw). ``placed_params``
    shares a tree already on the device (at tp > 1, this rank's shard).
    Runs on ``cuda`` unless ``device`` says ``cpu``; at ``tensor_parallel
    > 1`` on the device of ``grid``, a grid of that tp degree whose tp
    group is this engine's."""

    kind = "real"

    def __init__(self, config: ServeConfig, params=None, *, placed_params=None,
                 device: str | torch.device | None = None, grid: Grid | None = None):
        if params is not None and placed_params is not None:
            raise ValueError("pass params (host tree, placed here) OR placed_params "
                             "(an already-placed tree to share), not both")
        check_config(config)
        tp = config.tensor_parallel
        if tp > 1:
            if grid is None or grid.tensor_parallel != tp:
                raise ValueError(f"tensor_parallel={tp} serves over a grid of tp {tp} "
                                 "(parallel.mesh.make_grid(world, 1, 1, tp)): pass grid=")
            if device is not None:
                raise ValueError("pass device or grid, not both (a grid has its device)")
            self.device = grid.world.device
            self._row_reduce = coll.tp_allreduce(grid.tp_group)
            tp_index = grid.tp_index
        else:
            self.device = default_device(device)
            self._row_reduce = None
            tp_index = 0
        spec = config.spec
        self.config = config
        self.paged = config.page_size > 0
        if self.paged:
            self.page_size = config.page_size
            self.max_pages = config.capacity // config.page_size  # block-table width
            self.num_pages = config.num_pages or config.slots * self.max_pages
        else:
            self.page_size = self.max_pages = self.num_pages = 0
        if placed_params is not None:
            self.params = placed_params
        elif params is None:
            # The full tree from the seed, then this rank's slice of it.
            full = transformer.init_lm_params(torch.Generator().manual_seed(config.seed), spec)
            shard = shard_lm_params(full, lm_param_specs(spec, tp), tp, tp_index)
            self.params = tree.map(lambda t: t.contiguous().to(self.device), shard)
        else:
            self.params = lm_params_from_numpy(params, spec, self.device, tensor_parallel=tp,
                                               tp_index=tp_index)
        # The width the LAST decode attended per slot (paged: the page-count
        # bucket's rows; contiguous: the capacity).
        self.last_attend_width = config.capacity
        self.pool: KVCache | None = None
        self.prefix: PrefixIndex | None = None
        self.reset()

    @classmethod
    def from_checkpoint(cls, config: ServeConfig, path) -> "InferenceEngine":
        raise NotImplementedError(
            "serving from a checkpoint is not ported yet (ROADMAP queue 1, item 5: checkpoints)"
        )

    def load_params(self, path) -> None:
        raise NotImplementedError(
            "serving from a checkpoint is not ported yet (ROADMAP queue 1, item 5: checkpoints)"
        )

    def handoff_bytes(self, n_pages: int) -> int:
        """Device bytes ``n_pages`` pages represent (``kv_row_bytes``)."""
        return int(n_pages) * self.page_size * kv_row_bytes(
            self.config.spec, self.config.kv_dtype, self.config.pool_dtype())

    def _put(self, a) -> torch.Tensor:
        """A host array (or CPU tensor) on the device."""
        return torch.as_tensor(a).to(self.device)

    # -- state -------------------------------------------------------------

    def reset(self) -> None:
        """Fresh (empty) cache: every slot free, nothing attendable. The
        prefix pool and its index reset together, and so do the page pool,
        the block tables and the allocator."""
        cfg = self.config
        if self.paged:
            self.cache = host_paged_cache(cfg.spec, self.num_pages, self.page_size,
                                          cfg.pool_dtype(), device=self.device,
                                          tensor_parallel=cfg.tensor_parallel)
            self.pages = PagePool(self.num_pages)
            self.tables = np.full((cfg.slots, self.max_pages), -1, np.int32)
            self.table_len = np.zeros(cfg.slots, np.int64)
            self.reserved_for = np.zeros(cfg.slots, np.int64)
            self.page_copies = 0  # copy-on-write tail copies
            if cfg.prefix_slots > 0:
                self.prefix = PrefixIndex(cfg.prefix_slots,
                                          on_evict=lambda e: self._release_pages(e.pages))
            return
        tp = cfg.tensor_parallel
        self.cache = host_cache(cfg.spec, cfg.slots, cfg.capacity, cfg.pool_dtype(),
                                device=self.device, tensor_parallel=tp)
        if cfg.prefix_slots > 0:
            self.pool = host_cache(cfg.spec, cfg.prefix_slots, cfg.capacity, cfg.pool_dtype(),
                                   device=self.device, tensor_parallel=tp)
            self.prefix = PrefixIndex(cfg.prefix_slots)

    # -- paged page management (host half) ---------------------------------

    def pages_needed(self, rows: int) -> int:
        """Worst-case page count for ``rows`` resident rows."""
        return -(-rows // self.page_size)

    def reserve_pages(self, slot: int, n: int) -> None:
        """Admission promise: hold ``n`` pages of headroom for ``slot``,
        consumed page by page as the slot maps them."""
        self.pages.reserve(n)
        self.reserved_for[slot] += n

    def reclaim_pages(self, need: int) -> bool:
        """Evict zero-ref prefix entries (LRU first) until ``need`` pages
        are available; only entries whose eviction frees a page qualify.
        False when no candidate can reach the target."""

        def frees(e) -> bool:
            return any(int(self.pages.refs[int(p)]) == 1 for p in set(e.pages))

        while self.pages.available < need:
            if self.prefix is None or self.prefix.evict_lru(frees) is None:
                return False
        return True

    def _map_page(self, slot: int) -> int:
        """Append one freshly allocated page to ``slot``'s block table,
        consuming the slot's reservation when it has one."""
        if self.reserved_for[slot] > 0:
            self.reserved_for[slot] -= 1
            self.pages.unreserve(1)
        elif self.pages.available < 1:
            raise RuntimeError(
                f"slot {slot}: page pool exhausted (free {self.pages.free}, reserved "
                f"{self.pages.reserved}) — admission must reserve before the slot grows"
            )
        page = self.pages.alloc()
        t = int(self.table_len[slot])
        self.tables[slot, t] = page
        self.table_len[slot] = t + 1
        return page

    def _ensure_rows(self, slot: int, rows: int) -> None:
        """Map pages so logical rows ``[0, rows)`` of ``slot`` are writable."""
        need = self.pages_needed(rows)
        if need > self.max_pages:
            raise ValueError(
                f"slot {slot}: {rows} rows need {need} pages, table reach is "
                f"{self.max_pages} pages ({self.config.capacity} rows)"
            )
        while int(self.table_len[slot]) < need:
            self._map_page(slot)

    def _release_pages(self, pages) -> None:
        """Drop one reference a page; pages reaching zero return to the free
        list and get their device ``pos`` rows reset to ``PAD_POS`` (the
        free-list invariant)."""
        freed = [int(p) for p in pages if self.pages.decref(int(p))]
        if freed:
            self.cache.pos[self._put(np.asarray(freed, np.int64))] = PAD_POS

    def release_slot(self, slot: int) -> None:
        """Free ``slot``'s residency: drop its page references (shared
        prefix pages survive on the entry's reference), clear its block
        table and return any unused reservation."""
        n = int(self.table_len[slot])
        pages = [int(p) for p in self.tables[slot, :n]]
        self.tables[slot, :] = -1
        self.table_len[slot] = 0
        left = int(self.reserved_for[slot])
        if left:
            self.pages.unreserve(left)
            self.reserved_for[slot] = 0
        self._release_pages(pages)

    def dump_slot_pages(self, slot: int):
        raise NotImplementedError(f"dump_slot_pages is not ported yet ({_HANDOFF})")

    def load_slot_pages(self, slot: int, k, v, pos) -> list[int]:
        raise NotImplementedError(f"load_slot_pages is not ported yet ({_HANDOFF})")

    def alias_slot_pages(self, dst_slot: int, src_slot: int, rows: int) -> int:
        raise NotImplementedError("alias_slot_pages is not ported yet "
                                  "(ROADMAP queue 1, item 8: speculate)")

    def decode_page_bucket(self, pages: int) -> int:
        """Smallest power of two >= ``pages``, capped at the table width."""
        b = 1
        while b < pages:
            b *= 2
        return min(b, self.max_pages)

    # -- sampling ----------------------------------------------------------

    def _sample(self, logits: torch.Tensor, request_ids, token_index) -> torch.Tensor:
        """Tokens ``[S]`` from ``logits [S, vocab]``; the ids and indices are
        host arrays, uploaded only when the draw is random."""
        cfg = self.config
        if cfg.temperature <= 0.0:
            return sampling.sample(logits, None, None, temperature=0.0, top_k=0, seed=cfg.seed)
        return sampling.sample(
            logits, self._put(np.asarray(request_ids, np.int64)),
            self._put(np.asarray(token_index, np.int64)),
            temperature=cfg.temperature, top_k=cfg.top_k, seed=cfg.seed,
        )

    # -- prefix-cache device half ------------------------------------------

    def prefix_fetch(self, entry_id: int, n: int, slot: int) -> int:
        """HIT: make the first ``n`` rows of entry ``entry_id`` resident in
        ``slot`` and pin the entry until the caller releases it. Returns the
        K/V rows copied: ``n`` (contiguous, pool -> slot), or the partial
        boundary page's ``n % page_size`` (paged; full pages map by
        refcount, zero-copy)."""
        e = self.prefix.entry(entry_id)
        if self.paged:
            ps = self.page_size
            shared, tail = n // ps, n % ps
            if int(self.table_len[slot]):
                raise RuntimeError(f"prefix_fetch into non-empty slot {slot} (admission "
                                   "maps shared pages into a fresh table only)")
            for i in range(shared):
                page = int(e.pages[i])
                self.pages.incref(page)
                self.tables[slot, i] = page
            self.table_len[slot] = shared
            copied = 0
            if tail:
                # The entry covers the boundary page: its token coverage is
                # a page multiple >= any match depth n.
                dst = self._map_page(slot)
                copy_page(self.cache, src_page=int(e.pages[shared]), dst_page=dst, n=tail)
                self.page_copies += 1
                copied = tail
            self.prefix.touch(entry_id)
            self.prefix.acquire(entry_id)
            return copied
        copy_slot_prefix(self.cache, self.pool, src_slot=e.slot, dst_slot=slot, n=n)
        self.prefix.touch(entry_id)
        self.prefix.acquire(entry_id)
        return n

    def prefix_release(self, entry_id: int) -> None:
        self.prefix.release(entry_id)

    def prefix_store(self, prompt, slot: int) -> bool:
        """REGISTRATION: index ``prompt`` and keep its freshly prefilled rows
        ``0..p-1`` for future hits; run before the slot's first decode write.
        Contiguous mode copies the rows into a claimed pool slot; paged mode
        donates the slot's FULL prompt pages to the entry (a reference each,
        no copy). False = skipped (index full of pinned entries, or a paged
        prompt spanning no full page)."""
        prompt = np.asarray(prompt, np.int32)
        if self.paged:
            full = int(prompt.shape[0]) // self.page_size
            if full < 1:
                return False
            pages = [int(p) for p in self.tables[slot, :full]]
            got = self.prefix.insert(prompt[: full * self.page_size], pages=pages)
            if got is None:
                return False
            for page in pages:
                self.pages.incref(page)
            return True
        got = self.prefix.insert(prompt)
        if got is None:
            return False
        _, pool_slot = got
        copy_slot_prefix(self.pool, self.cache, src_slot=slot, dst_slot=pool_slot,
                         n=int(prompt.shape[0]))
        return True

    # -- host API ----------------------------------------------------------

    def prefill_bucket(self, prompt_len: int) -> int:
        """Smallest power-of-two bucket >= max(prompt_len, 8), capped at the
        capacity."""
        if not 1 <= prompt_len <= self.config.capacity:
            raise ValueError(f"prompt length {prompt_len} outside [1, capacity="
                             f"{self.config.capacity}]")
        b = 8
        while b < prompt_len:
            b *= 2
        return min(b, self.config.capacity)

    def prefill(self, prompt, *, slot: int, request_id: int, base: int = 0,
                _bucket: int | None = None):
        """Prefill one prompt BLOCK into ``slot``: rows ``base..base+t-1``
        (positions likewise), sampling sequence element ``base + t``.
        Returns ``(next_token int, logits np [t, vocab])``. ``_bucket``
        forces a larger bucket (the warm-up ladder)."""
        cfg = self.config
        prompt = np.asarray(prompt, np.int32)
        t = int(prompt.shape[0])
        if base < 0 or base + t > cfg.capacity:
            raise ValueError(f"prefill block [base={base}, base+{t}) outside cache "
                             f"capacity {cfg.capacity}")
        bucket = self.prefill_bucket(t) if _bucket is None else _bucket
        if bucket < t:
            raise ValueError(f"bucket {bucket} below the block's {t} tokens")
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :t] = prompt
        ar = np.arange(bucket, dtype=np.int32)
        real = ar < t
        positions = np.where(real, base + ar, PAD_POS).astype(np.int32)[None, :]
        tok = self._put(tokens)
        if self.paged:
            self._ensure_rows(slot, base + t)
            # Padded tails get logical row = reach: beyond the table, so the
            # write lands on the drop page.
            reach = self.max_pages * self.page_size
            table = torch.from_numpy(self.tables[slot:slot + 1].copy())
            logical = torch.from_numpy(np.where(real, base + ar, reach).astype(np.int32)[None, :])
            flat = kv_cache.table_rows(table, logical, self.page_size, self.num_pages)
            logits, *_ = transformer.apply_lm_paged(
                self.params, tok, self.cache.k, self.cache.v, self.cache.pos, self._put(table),
                cfg.spec, positions=self._put(positions), flat_rows=self._put(flat),
                compute_dtype=cfg.dtype(), row_reduce=self._row_reduce,
            )
        else:
            c = cfg.capacity
            # Rows below base are the copied prefix or earlier chunks; the
            # rest are the previous occupant's and must never be attended.
            self.cache.pos[slot, base:c] = PAD_POS
            rows = np.where(real, (base + ar) % c, c).astype(np.int32)[None, :]
            sl = slice(slot, slot + 1)
            logits, *_ = transformer.apply_lm_cached(
                self.params, tok, self.cache.k[:, sl], self.cache.v[:, sl], self.cache.pos[sl],
                cfg.spec, start=None, positions=self._put(positions), rows=self._put(rows),
                compute_dtype=cfg.dtype(), row_reduce=self._row_reduce,
            )
        logits = logits[0, :t]
        # The sampled token is sequence element `base + t` of the request.
        nxt = self._sample(logits[t - 1:], [request_id], [base + t])
        return int(nxt.item()), logits.cpu().numpy()

    def decode(self, last_tokens, lengths, request_ids, active, *, _pages: int | None = None):
        """One batched decode step over all slots: host arrays in,
        ``(next_tokens np [S], logits np [S, vocab])`` out. Paged mode first
        maps any page a growing slot crosses into (consuming its
        reservation), then attends the page-count bucket covering the widest
        ACTIVE table; ``_pages`` forces a bucket (the warm-up ladder, with
        every slot inactive)."""
        cfg = self.config
        lengths = np.asarray(lengths, np.int32)
        active = np.asarray(active, bool)
        request_ids = np.asarray(request_ids, np.int32)
        tok = self._put(np.asarray(last_tokens, np.int32)[:, None])
        positions = self._put(np.where(active, lengths, PAD_POS).astype(np.int32)[:, None])
        if self.paged:
            if _pages is None:
                widest = 1
                for s in np.nonzero(active)[0]:
                    self._ensure_rows(int(s), int(lengths[s]) + 1)
                    widest = max(widest, int(self.table_len[s]))
                pb = self.decode_page_bucket(widest)
            else:
                pb = _pages
            self.last_attend_width = pb * self.page_size
            table = torch.from_numpy(self.tables[:, :pb].copy())
            logical = torch.from_numpy(
                np.where(active, lengths, pb * self.page_size).astype(np.int32)[:, None])
            flat = kv_cache.table_rows(table, logical, self.page_size, self.num_pages)
            logits, *_ = transformer.apply_lm_paged(
                self.params, tok, self.cache.k, self.cache.v, self.cache.pos, self._put(table),
                cfg.spec, positions=positions, flat_rows=self._put(flat),
                compute_dtype=cfg.dtype(), row_reduce=self._row_reduce,
            )
        else:
            # Free slots still compute (fixed shapes) and write a PAD_POS row
            # at `lengths % C`: invisible to any future occupant.
            rows = self._put((lengths % cfg.capacity)[:, None])
            logits, *_ = transformer.apply_lm_cached(
                self.params, tok, self.cache.k, self.cache.v, self.cache.pos, cfg.spec,
                start=None, positions=positions, rows=rows, compute_dtype=cfg.dtype(),
                row_reduce=self._row_reduce,
            )
        logits = logits[:, 0]
        # This step extends each sequence to length + 1 tokens: the sampled
        # token's index is lengths + 1.
        nxt = self._sample(logits, request_ids, lengths.astype(np.int64) + 1)
        return nxt.cpu().numpy(), logits.cpu().numpy()
