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

**Compute dtype** (``compute_dtype="bfloat16"`` or ``"float16"``, as JAX's
engine passes either through): the cached forwards cast the weights and
activations to it (logits stay fp32) and the KV pools (contiguous, paged
and the prefix pool) are allocated in it, so a pool row costs half its
fp32 bytes.

**Serving a checkpoint** (:meth:`InferenceEngine.from_checkpoint`,
:meth:`InferenceEngine.load_params`): the params only, from a trainer
checkpoint of any topology (``utils/checkpoint.py``, either package's),
sharded here for tp; optimizer and step state are ignored.

**Page hand-off** (:meth:`InferenceEngine.dump_slot_pages`,
:meth:`InferenceEngine.load_slot_pages`): a slot's mapped pages gathered on
the device in block-table order and copied to host numpy, and written back
whole into freshly mapped pages of another engine's pool
(``cache.write_page``): the cross-replica preemption and the disaggregated
prefill -> decode transfer move KV bits, never recompute them. At tp > 1
each rank dumps and loads its own head shard (JAX assembles every shard
into one host array); the round trip is bitwise either way.

**Int8 pool** (``kv_dtype="int8"``, paged only): the pool stores int8
payloads with per-head fp32 scales (``cache.PagedKVCache.k_scale``); fresh
rows quantize on write and the gathered attend view dequantizes
(``transformer.apply_lm_paged``'s ``pool_k_scale``), so a pool row costs
``2·L·H·(D + 4)`` bytes against fp32's ``2·L·H·D·4``. Scales travel with
their pages: the hand-off moves ``(payload, scale)`` pairs.

**Speculative decoding** (``speculate_k > 0``, ``serve.speculate``): the
scheduler verifies drafts through free slots of the one batched decode;
:meth:`InferenceEngine.alias_slot_pages` maps a draft lane onto the
speculating slot's pages by reference count, zero copy.

**Program hooks** (``compile_hook``, ``ledger_hook``; the scheduler sets
both when it has a registry): JAX builds one program per ``(kind, key)``
(``prefill`` by bucket, ``decode`` by page-count bucket or 0, ``prefix_copy``,
``page_write``, ``pages_reset``) and calls its hooks once per program. Eager
PyTorch builds nothing, so the port calls ``compile_hook(kind, key)`` at the
FIRST dispatch of each key, and ``ledger_hook(kind, key, records)`` after
it with the collectives that dispatch tallied (``parallel.collectives.
tally``): the ``xla_compiles_total{kind=}`` counts and the per-program
collective ledger come out per key, as JAX's do.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import precision as _precision
from ..convert import lm_params_from_numpy, lm_zeros_numpy
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
    write_page,
)
from .prefix import PrefixIndex
from .speculate import SPECULATE_METHODS

# The compute dtypes the engine serves in, by name (None: fp32, no cast).
SERVE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16, "float16": torch.float16}


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
    is None (fp32), ``"float32"``, ``"bfloat16"`` or ``"float16"``.
    ``kv_dtype="int8"`` (paged only) stores the pool as int8 payloads with
    per-head fp32 scales. ``speculate_k > 0`` drafts up to that many tokens
    a tick for each active slot (``speculate_method`` ``"ngram"`` over
    prompt and generated tokens, or ``"prompt"``) and verifies them through
    free slots of the one batched decode; it needs the paged layout,
    ``temperature == 0`` and ``slots >= 2``."""

    spec: LMSpec = LMSpec()
    slots: int = 4
    capacity: int = 256
    tensor_parallel: int = 1
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = full vocab (temperature > 0 only)
    seed: int = 0
    compute_dtype: str | None = None  # None = fp32; "bfloat16"/"float16": compute and pools
    prefix_slots: int = 0
    prefill_chunk: int = 0
    prefill_budget: int = 0
    page_size: int = 0  # paged KV layout: rows per page; 0 = contiguous
    num_pages: int = 0  # paged pool size; 0 = slots * capacity / page_size
    kv_dtype: str | None = None  # "int8": quantized paged pool
    speculate_k: int = 0  # draft tokens a tick for each active slot; 0 = off
    speculate_method: str = "ngram"

    def dtype(self) -> torch.dtype | None:
        """The compute dtype as a torch dtype (None = fp32, no cast). JAX's
        engine takes any dtype the name gives (``jnp.dtype``), with no
        precision policy in between; the port serves in the three its
        models run in (:data:`SERVE_DTYPES`) and raises ``ValueError`` for
        another."""
        if self.compute_dtype is None:
            return None
        name = _precision.dtype_name(self.compute_dtype)
        if name not in SERVE_DTYPES:
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r} for serving "
                             f"(choices: {', '.join(SERVE_DTYPES)})")
        return SERVE_DTYPES[name]

    def pool_dtype(self) -> torch.dtype:
        """The dtype the KV pools are allocated in: the compute dtype."""
        return self.dtype() or torch.float32


def check_config(config: ServeConfig) -> None:
    """JAX's constructor checks, with its ``ValueError`` texts."""
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
    config.dtype()  # fp32, bf16 or fp16 compute only
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
    if sk > 0:
        if not ps:
            raise ValueError(
                f"speculate_k={sk} needs the paged KV layout (page_size > 0): draft lanes "
                "verify through block-table ALIASES of the speculating slot's pages, and "
                "contiguous slot rings have no pages to alias")
        if config.temperature > 0.0:
            raise ValueError(
                f"speculate_k={sk} needs temperature=0 (greedy): greedy-accept is what keeps "
                "speculative output bit-identical to plain decode; sampled acceptance is a "
                "different algorithm")
        if config.slots < 2:
            raise ValueError(
                f"speculate_k={sk} needs slots >= 2: drafts verify through FREE slots of the "
                "batched decode, and a 1-slot batch has no lane to ride")
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


def _load_host_params(path, spec: LMSpec) -> dict:
    """The params-only host tree of any trainer checkpoint; the template is
    numpy zeros of the standard shapes (only shapes and dtypes are read)."""
    from ..utils.checkpoint import load_params

    host, _, _ = load_params(path, lm_zeros_numpy(spec))
    return host


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
        self._tp_index = tp_index
        self.grid = grid
        spec = config.spec
        self.config = config
        self.paged = config.page_size > 0
        self.quantized = config.kv_dtype == "int8"
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
        # Program hooks (module docstring); the dispatched keys outlive
        # reset(), as JAX's compiled programs do.
        self.compile_hook = None
        self.ledger_hook = None
        self._dispatched: set[tuple[str, int]] = set()
        self.pool: KVCache | None = None
        self.prefix: PrefixIndex | None = None
        self.reset()

    @classmethod
    def from_checkpoint(cls, config: ServeConfig, path, *,
                        device: str | torch.device | None = None,
                        grid: Grid | None = None) -> "InferenceEngine":
        """An engine serving a checkpoint's params directly: the loaded
        host tree goes to the constructor, so no throwaway random init is
        ever placed. Same params-only contract as :meth:`load_params`."""
        return cls(config, params=_load_host_params(path, config.spec), device=device,
                   grid=grid)

    def load_params(self, path) -> None:
        """Params-only checkpoint load (``utils.checkpoint.load_params``):
        a trainer checkpoint of ANY topology; optimizer and step state are
        ignored if present and not required. At tp > 1 this rank keeps its
        shard."""
        tp = self.config.tensor_parallel
        self.params = lm_params_from_numpy(_load_host_params(path, self.config.spec),
                                           self.config.spec, self.device, tensor_parallel=tp,
                                           tp_index=self._tp_index)

    def handoff_bytes(self, n_pages: int) -> int:
        """Device bytes ``n_pages`` pages represent (``kv_row_bytes``)."""
        return int(n_pages) * self.page_size * kv_row_bytes(
            self.config.spec, self.config.kv_dtype, self.config.pool_dtype())

    def _program(self, kind: str, key: int):
        """Bracket one dispatch of the program ``(kind, key)``: at its FIRST
        dispatch, call ``compile_hook`` and tally its collectives for
        ``ledger_hook``; a no-op bracket after that."""
        if (kind, key) in self._dispatched:
            return contextlib.nullcontext()
        self._dispatched.add((kind, key))
        if self.compile_hook is not None:
            self.compile_hook(kind, key)
        if self.ledger_hook is None:
            return contextlib.nullcontext()
        return self._ledgered(kind, key)

    @contextlib.contextmanager
    def _ledgered(self, kind: str, key: int):
        with coll.tally() as records:
            yield
        self.ledger_hook(kind, key, records)

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
                                          tensor_parallel=cfg.tensor_parallel,
                                          kv_dtype=cfg.kv_dtype)
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
            with self._program("pages_reset", 0):
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
        """Serialize ``slot``'s resident pages host-side, the send half of
        the page hand-off: ``(k, v, pos)`` numpy arrays ``[L, n, page, H,
        D]`` / ``[n, page]`` for the slot's ``n`` mapped pages in
        BLOCK-TABLE order, gathered on the device and then copied to
        pageable host memory (the copy waits for the gather). At tp > 1,
        ``H`` is this rank's heads. A pool dtype numpy lacks (bfloat16)
        comes back as its raw bits, ``int16``, which
        :meth:`load_slot_pages` reinterprets: bits move, not values. An int8
        pool returns ``k`` and ``v`` as ``(payload, scale)`` pairs (int8
        ``[L, n, page, H, D]``, fp32 ``[L, n, page, H]``), which the host
        layers (``PreemptedRequest``, the controller, the disagg
        coordinator) pass on opaquely."""
        if not self.paged:
            raise RuntimeError(
                "dump_slot_pages needs the paged KV layout (page_size > 0) — the contiguous "
                "ring has no slot-independent pages to hand off")
        n = int(self.table_len[slot])
        pages = self._put(self.tables[slot, :n].astype(np.int64))

        def host(t: torch.Tensor) -> np.ndarray:
            t = t.cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return t.numpy()

        c = self.cache
        k, v, pos = host(c.k[:, pages]), host(c.v[:, pages]), host(c.pos[pages])
        if self.quantized:
            return (k, host(c.k_scale[:, pages])), (v, host(c.v_scale[:, pages])), pos
        return k, v, pos

    def _rows(self, a, like: torch.Tensor) -> torch.Tensor:
        """Host rows on the device in ``like``'s dtype: a synchronous copy
        (the caller may reuse ``a`` at once); same-width integer bits of a
        float pool (the bfloat16 dump) are reinterpreted, never converted."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype != like.dtype:
            if t.is_floating_point() or t.element_size() != like.element_size():
                raise ValueError(f"load_slot_pages: rows of dtype {t.dtype} for a pool of "
                                 f"{like.dtype} (hand-offs need the same pool dtype on "
                                 "both replicas)")
            t = t.view(like.dtype)
        return t.to(self.device)

    def load_slot_pages(self, slot: int, k, v, pos) -> list[int]:
        """Make serialized page contents resident in ``slot``: map one FRESH
        page per source page (consuming the slot's admission reservation,
        as prefill growth does) and overwrite them whole with the rows in
        one ``write_page``. A freshly mapped page is all ``PAD_POS`` (the
        free-list invariant) and the written ``pos`` rows carry the source's
        own ``PAD_POS`` tail, so nothing stale is attendable. Returns the
        mapped page ids (table order). An int8 pool takes ``k`` and ``v`` as
        the ``(payload, scale)`` pairs its :meth:`dump_slot_pages` made; a
        mismatch either way raises ``ValueError``."""
        if not self.paged:
            raise RuntimeError("load_slot_pages needs the paged KV layout (page_size > 0)")
        c = self.cache
        rows = {}
        if self.quantized:
            if not (isinstance(k, tuple) and isinstance(v, tuple)):
                raise ValueError(
                    "int8 pool: load_slot_pages needs the (payload, scale) pairs "
                    "dump_slot_pages produced — a bare payload came from a full-precision "
                    "dump and would dequantize to garbage")
            (k, ks), (v, vs) = k, v
            rows = dict(k_scale_rows=self._rows(ks, c.k_scale),
                        v_scale_rows=self._rows(vs, c.v_scale))
        elif isinstance(k, tuple) or isinstance(v, tuple):
            raise ValueError(
                "full-precision pool: load_slot_pages got (payload, scale) pairs — the dump "
                "came from an int8 engine; hand-offs need matching kv_dtype on both replicas")
        rows.update(k_rows=self._rows(k, c.k), v_rows=self._rows(v, c.v),
                    pos_rows=self._rows(pos, c.pos))
        mapped = [self._map_page(slot) for _ in range(int(k.shape[1]))]
        with self._program("page_write", 0):
            if mapped:
                write_page(self.cache, dst_page=self._put(np.asarray(mapped, np.int64)),
                           **rows)
        return mapped

    def alias_slot_pages(self, dst_slot: int, src_slot: int, rows: int) -> int:
        """Make ``dst_slot`` a zero-copy alias of ``src_slot``'s table
        covering logical rows ``[0, rows)``: a speculative draft LANE, which
        writes its draft token's K/V row through the shared pages and
        attends the shared history. Maps any page ``src_slot`` still needs
        first (consuming ITS reservation: the lane reserves nothing), then
        increfs each page into the lane's table. ``release_slot`` tears the
        lane down (a pure decref: the source's references keep every page
        live). Returns the aliased page count."""
        if not self.paged:
            raise RuntimeError("alias_slot_pages needs the paged KV layout (page_size > 0) — "
                               "contiguous slots have no pages to alias")
        if int(self.table_len[dst_slot]) or int(self.reserved_for[dst_slot]):
            raise RuntimeError(f"alias_slot_pages into non-empty slot {dst_slot} (lanes must "
                               "be free slots)")
        self._ensure_rows(src_slot, rows)
        n = int(self.table_len[src_slot])
        for i in range(n):
            page = int(self.tables[src_slot, i])
            self.pages.incref(page)
            self.tables[dst_slot, i] = page
        self.table_len[dst_slot] = n
        return n

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
                with self._program("prefix_copy", 0):
                    copy_page(self.cache, src_page=int(e.pages[shared]), dst_page=dst, n=tail)
                self.page_copies += 1
                copied = tail
            self.prefix.touch(entry_id)
            self.prefix.acquire(entry_id)
            return copied
        with self._program("prefix_copy", 1):
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
        with self._program("prefix_copy", 0):
            copy_slot_prefix(self.pool, self.cache, src_slot=slot, dst_slot=pool_slot,
                             n=int(prompt.shape[0]))
        return True

    # -- host API ----------------------------------------------------------

    def _paged_forward(self, tokens, table, positions, flat_rows) -> torch.Tensor:
        """The one ``apply_lm_paged`` call of paged prefill and decode, in
        place on the pool; an int8 pool's scale planes ride along. Returns
        the logits."""
        cfg, c = self.config, self.cache
        scales = dict(pool_k_scale=c.k_scale, pool_v_scale=c.v_scale) if self.quantized else {}
        logits, *_ = transformer.apply_lm_paged(
            self.params, tokens, c.k, c.v, c.pos, table, cfg.spec, positions=positions,
            flat_rows=flat_rows, compute_dtype=cfg.dtype(), row_reduce=self._row_reduce,
            **scales)
        return logits

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
        with self._program("prefill", bucket):
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
                logical = torch.from_numpy(
                    np.where(real, base + ar, reach).astype(np.int32)[None, :])
                flat = kv_cache.table_rows(table, logical, self.page_size, self.num_pages)
                logits = self._paged_forward(tok, self._put(table), self._put(positions),
                                             self._put(flat))
            else:
                c = cfg.capacity
                # Rows below base are the copied prefix or earlier chunks;
                # the rest are the previous occupant's, never to be attended.
                self.cache.pos[slot, base:c] = PAD_POS
                rows = np.where(real, (base + ar) % c, c).astype(np.int32)[None, :]
                sl = slice(slot, slot + 1)
                logits, *_ = transformer.apply_lm_cached(
                    self.params, tok, self.cache.k[:, sl], self.cache.v[:, sl],
                    self.cache.pos[sl], cfg.spec, start=None, positions=self._put(positions),
                    rows=self._put(rows), compute_dtype=cfg.dtype(), row_reduce=self._row_reduce,
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
        key = 0
        if self.paged:
            if _pages is None:
                widest = 1
                for s in np.nonzero(active)[0]:
                    self._ensure_rows(int(s), int(lengths[s]) + 1)
                    widest = max(widest, int(self.table_len[s]))
                key = self.decode_page_bucket(widest)
            else:
                key = _pages
            self.last_attend_width = key * self.page_size
        with self._program("decode", key):
            tok = self._put(np.asarray(last_tokens, np.int32)[:, None])
            positions = self._put(np.where(active, lengths, PAD_POS).astype(np.int32)[:, None])
            if self.paged:
                table = torch.from_numpy(self.tables[:, :key].copy())
                logical = torch.from_numpy(
                    np.where(active, lengths, key * self.page_size).astype(np.int32)[:, None])
                flat = kv_cache.table_rows(table, logical, self.page_size, self.num_pages)
                logits = self._paged_forward(tok, self._put(table), positions, self._put(flat))
            else:
                # Free slots still compute (fixed shapes) and write a PAD_POS
                # row at `lengths % C`: invisible to any future occupant.
                rows = self._put((lengths % cfg.capacity)[:, None])
                logits, *_ = transformer.apply_lm_cached(
                    self.params, tok, self.cache.k, self.cache.v, self.cache.pos, cfg.spec,
                    start=None, positions=positions, rows=rows, compute_dtype=cfg.dtype(),
                    row_reduce=self._row_reduce,
                )
            logits = logits[:, 0]
            # This step extends each sequence to length + 1 tokens: the
            # sampled token's index is lengths + 1.
            nxt = self._sample(logits, request_ids, lengths.astype(np.int64) + 1)
            return nxt.cpu().numpy(), logits.cpu().numpy()
