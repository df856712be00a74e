"""The cost-model serve engine — the port of ``ddl_tpu/serve/sim.py``: the
digital twin's engine, which touches no device.

:class:`CostModelEngine` implements the :class:`~ddl_tpu_torch.serve.
engine_iface.ServeEngine` contract with no tensors. It runs the same host
bookkeeping as the real engine (the same :class:`~ddl_tpu_torch.serve.cache.
PagePool`, block tables, reservations and copy-on-write counter, the same
:class:`~ddl_tpu_torch.serve.prefix.PrefixIndex`) and replaces every device
program with a deterministic token hash and a per-phase virtual-time charge
(prefill a token, decode a tick, hand-off a page) fitted from the goodput
plane's measured ``time_in_seconds{phase=}``
(:func:`ddl_tpu_torch.obs.goodput.phase_cost_fit`).

Every control decision of the serve stack reads only the host half of the
engine (pressure, pages, block tables, prefix index, the tick clock), so a
fleet of cost-model engines replays the real fleet's controller events and
per-class shed, admit and requeue counts tick for tick
(tests/test_torch_twin.py). It does not reproduce token values (the hash,
like the real sampling key, depends only on ``(seed, request_id,
position)``, so requeues and preemptions replay the same stream) or wall
time (virtual seconds accumulate in :meth:`CostModelEngine.virtual_time`,
never in the scheduler's ``perf_counter`` clock).

Beyond JAX's engine: :meth:`CostModelEngine.handoff_bytes`, with the real
engine's formula. JAX's control plane calls it on a crash requeue, a
preemption and a disaggregated hand-off whenever a registry is on, and JAX's
cost-model engine lacks it, so JAX's twin raises ``AttributeError`` there.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from ..ops.kv_cache import PAD_POS
from .cache import PagePool, kv_row_bytes
from .prefix import PrefixIndex

__all__ = ["CostModel", "CostModelEngine", "sim_engine_factory"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-phase virtual-time costs the twin charges. The defaults are
    JAX's placeholder CPU-scale constants; fitted tables come from
    :func:`ddl_tpu_torch.obs.goodput.phase_cost_fit` over a measured run's
    metrics."""

    prefill_s_per_token: float = 1.2e-4
    decode_s_per_tick: float = 4.0e-3
    handoff_s_per_page: float = 3.0e-4

    @classmethod
    def from_phase_fit(cls, fit: Mapping[str, float]) -> "CostModel":
        """Build from a :func:`phase_cost_fit` table. ``handoff`` is
        optional (a run without hand-offs measures none); prefill and
        decode are required."""
        missing = [k for k in ("prefill_s_per_token", "decode_s_per_tick") if k not in fit]
        if missing:
            raise ValueError(
                f"cost fit missing {', '.join(missing)} — fit it from a "
                "run that actually prefilled and decoded "
                "(obs.goodput.phase_cost_fit names the absent phase)"
            )
        return cls(
            prefill_s_per_token=float(fit["prefill_s_per_token"]),
            decode_s_per_tick=float(fit["decode_s_per_tick"]),
            handoff_s_per_page=float(fit.get("handoff_s_per_page", cls.handoff_s_per_page)),
        )


_M64 = 0xFFFFFFFFFFFFFFFF


def _sim_token(seed: int, request_id: int, index: int, vocab: int) -> int:
    """The stand-in token: a 64-bit mix of ``(seed, request_id, position)``
    only, bit for bit JAX's, so batch composition, slots, requeues and
    preemptions cannot change a request's stream. Never 0 (the pad id)."""
    h = ((int(seed) & 0xFFFFFFFF) * 0x9E3779B1) & _M64
    h ^= ((int(request_id) & 0xFFFFFFFFFFFF) * 0x85EBCA77) & _M64
    h ^= ((int(index) & 0xFFFFFFFF) * 0xC2B2AE3D) & _M64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _M64
    h ^= h >> 33
    return 1 + h % max(vocab - 1, 1)


class CostModelEngine:
    """No-tensor ``ServeEngine``: the real engine's host bookkeeping,
    virtual time instead of device time, hashed tokens instead of a
    transformer. Takes (and ignores) ``params``/``placed_params`` so the
    router's one-checkpoint replica wiring works unchanged."""

    kind = "sim"
    # The memory sampler finds no stats here and latches off; the peak
    # lookup falls back to the CPU nominal, as JAX's sim device does.
    device = "cpu"
    grid = None

    def __init__(self, config, params=None, *, placed_params=None,
                 cost: CostModel | None = None):
        if params is not None and placed_params is not None:
            raise ValueError(
                "pass params (host tree, placed here) OR placed_params "
                "(an already-placed tree to share), not both"
            )
        # A config the real engine rejects fails here too (JAX's subset of
        # the checks, with its texts): a twin must not evaluate a geometry
        # no real fleet can run.
        spec = config.spec
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
                    "prefill_budget requires prefill_chunk (the budget "
                    "meters chunk interleaving; whole-prompt prefill "
                    "ignores it silently otherwise)"
                )
            if config.prefill_budget < ck:
                raise ValueError(f"prefill_budget ({config.prefill_budget}) below "
                                 f"prefill_chunk ({ck}) could never start a chunk")
        ps = config.page_size
        if ps < 0 or (ps and ps & (ps - 1)):
            raise ValueError(
                f"page_size must be 0 (contiguous) or a power of two, "
                f"got {ps} (pages tile the capacity and the row->page "
                "split is a shift/mask)"
            )
        if config.num_pages and not ps:
            raise ValueError(f"num_pages ({config.num_pages}) requires page_size > 0 "
                             "(the contiguous layout has no page pool)")
        if config.num_pages < 0:
            raise ValueError(f"num_pages must be >= 0, got {config.num_pages}")
        if config.speculate_k > 0:
            raise ValueError(
                f"speculate_k={config.speculate_k} has no cost-model "
                "implementation: draft acceptance depends on token "
                "CONTENT, which the twin does not model — run "
                "speculative configs on the real engine"
            )
        self.paged = ps > 0
        if self.paged:
            if config.capacity % ps:
                raise ValueError(f"capacity ({config.capacity}) must be a multiple of "
                                 f"page_size ({ps}) — the block table holds whole pages")
            self.page_size = ps
            self.max_pages = config.capacity // ps
            self.num_pages = config.num_pages or config.slots * self.max_pages
            if self.num_pages < config.slots:
                raise ValueError(
                    f"num_pages ({self.num_pages}) below slots "
                    f"({config.slots}) — every admitted slot needs at "
                    "least one page; the pool could never fill the batch"
                )
        else:
            self.page_size = self.max_pages = self.num_pages = 0
        self.config = config
        self.cost = cost if cost is not None else CostModel()
        self.params = placed_params  # opaque; replicas may share None
        self.compile_hook = self.ledger_hook = None  # set by a scheduler, never called
        self.last_attend_width = config.capacity
        self.pool = None
        self.prefix: PrefixIndex | None = None
        self.reset()

    # -- state -------------------------------------------------------------

    def reset(self) -> None:
        """Fresh empty state, as the real engine's reset: allocator, tables
        and prefix index rebuilt together. The virtual-time ledger resets
        too, so a warmed run's virtual seconds cover the run alone."""
        S = self.config.slots
        if self.paged:
            self.pages = PagePool(self.num_pages)
            self.tables = np.full((S, self.max_pages), -1, np.int32)
            self.table_len = np.zeros(S, np.int64)
            self.reserved_for = np.zeros(S, np.int64)
            self.page_copies = 0
            if self.config.prefix_slots > 0:
                self.prefix = PrefixIndex(self.config.prefix_slots,
                                          on_evict=lambda e: self._release_pages(e.pages))
        elif self.config.prefix_slots > 0:
            self.prefix = PrefixIndex(self.config.prefix_slots)
        self.rows = np.zeros(S, np.int64)  # resident rows, for a dump's pos
        self.virtual = {"prefill": 0.0, "decode": 0.0, "handoff": 0.0}

    def virtual_time(self) -> dict:
        """Virtual seconds a phase charged since the last reset, and their
        sum under ``"total"``."""
        out = dict(self.virtual)
        out["total"] = float(sum(self.virtual.values()))
        return out

    def handoff_bytes(self, n_pages: int) -> int:
        """Device bytes ``n_pages`` pages would move on the real engine
        (``kv_row_bytes``, the real engine's formula)."""
        cfg = self.config
        return int(n_pages) * self.page_size * kv_row_bytes(cfg.spec, cfg.kv_dtype,
                                                            cfg.pool_dtype())

    # -- paged page management (the real engine's host half) ---------------

    def pages_needed(self, rows: int) -> int:
        return -(-rows // self.page_size)

    def reserve_pages(self, slot: int, n: int) -> None:
        self.pages.reserve(n)
        self.reserved_for[slot] += n

    def reclaim_pages(self, need: int) -> bool:
        def frees(e) -> bool:
            return any(int(self.pages.refs[int(p)]) == 1 for p in set(e.pages))

        while self.pages.available < need:
            if self.prefix is None or self.prefix.evict_lru(frees) is None:
                return False
        return True

    def _map_page(self, slot: int) -> int:
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
        need = self.pages_needed(rows)
        if need > self.max_pages:
            raise ValueError(
                f"slot {slot}: {rows} rows need {need} pages, table reach is "
                f"{self.max_pages} pages ({self.config.capacity} rows)"
            )
        while int(self.table_len[slot]) < need:
            self._map_page(slot)

    def _release_pages(self, pages) -> None:
        # The refcount half of the real release: a sim page has no device
        # pos rows to reset.
        for p in pages:
            self.pages.decref(int(p))

    def release_slot(self, slot: int) -> None:
        if not self.paged:
            raise RuntimeError(
                "release_slot needs the paged KV layout (page_size > 0) "
                "— contiguous slots free by pos masking, not page return"
            )
        n = int(self.table_len[slot])
        pages = [int(p) for p in self.tables[slot, :n]]
        self.tables[slot, :] = -1
        self.table_len[slot] = 0
        left = int(self.reserved_for[slot])
        if left:
            self.pages.unreserve(left)
            self.reserved_for[slot] = 0
        self.rows[slot] = 0
        self._release_pages(pages)

    # -- cross-replica hand-off --------------------------------------------

    def dump_slot_pages(self, slot: int):
        """The real dump's ``(k, v, pos)`` contract: ``pos`` is real (row
        positions in block-table order, ``PAD_POS`` tail); ``k`` and ``v``
        are placeholders whose page axis matches. Charges hand-off virtual
        time a page (a dump and its load are one hand-off)."""
        if not self.paged:
            raise RuntimeError(
                "dump_slot_pages needs the paged KV layout (page_size > "
                "0) — the contiguous ring has no slot-independent pages "
                "to hand off"
            )
        n = int(self.table_len[slot])
        ps = self.page_size
        rows = int(self.rows[slot])
        pos = np.full((n, ps), PAD_POS, np.int32)
        for i in range(n):
            filled = min(max(rows - i * ps, 0), ps)
            if filled:
                pos[i, :filled] = np.arange(i * ps, i * ps + filled, dtype=np.int32)
        k = np.zeros((1, n, ps, 1, 1), np.float32)
        v = np.zeros((1, n, ps, 1, 1), np.float32)
        self.virtual["handoff"] += n * self.cost.handoff_s_per_page
        return k, v, pos

    def load_slot_pages(self, slot: int, k, v, pos) -> list[int]:
        if not self.paged:
            raise RuntimeError("load_slot_pages needs the paged KV layout (page_size > 0)")
        mapped = [self._map_page(slot) for _ in range(int(k.shape[1]))]
        self.rows[slot] = int(np.count_nonzero(np.asarray(pos) != PAD_POS))
        return mapped

    def alias_slot_pages(self, dst_slot: int, src_slot: int, rows: int) -> int:
        if not self.paged:
            raise RuntimeError(
                "alias_slot_pages needs the paged KV layout "
                "(page_size > 0) — contiguous slots have no pages to "
                "alias"
            )
        if int(self.table_len[dst_slot]) or int(self.reserved_for[dst_slot]):
            raise RuntimeError(f"alias_slot_pages into non-empty slot {dst_slot} "
                               "(lanes must be free slots)")
        self._ensure_rows(src_slot, rows)
        n = int(self.table_len[src_slot])
        for i in range(n):
            page = int(self.tables[src_slot, i])
            self.pages.incref(page)
            self.tables[dst_slot, i] = page
        self.table_len[dst_slot] = n
        self.rows[dst_slot] = rows
        return n

    # -- prefix cache -------------------------------------------------------

    def prefix_fetch(self, entry_id: int, n: int, slot: int) -> int:
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
                self._map_page(slot)
                self.page_copies += 1
                copied = tail
            self.rows[slot] = n
            self.prefix.touch(entry_id)
            self.prefix.acquire(entry_id)
            return copied
        self.rows[slot] = n
        self.prefix.touch(entry_id)
        self.prefix.acquire(entry_id)
        return n

    def prefix_release(self, entry_id: int) -> None:
        self.prefix.release(entry_id)

    def prefix_store(self, prompt, slot: int) -> bool:
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
        return self.prefix.insert(prompt) is not None

    # -- host API ----------------------------------------------------------

    def prefill_bucket(self, prompt_len: int) -> int:
        if not 1 <= prompt_len <= self.config.capacity:
            raise ValueError(f"prompt length {prompt_len} outside [1, capacity="
                             f"{self.config.capacity}]")
        b = 8
        while b < prompt_len:
            b *= 2
        return min(b, self.config.capacity)

    def decode_page_bucket(self, pages: int) -> int:
        b = 1
        while b < pages:
            b *= 2
        return min(b, self.max_pages)

    def prefill(self, prompt, *, slot: int, request_id: int, base: int = 0,
                _bucket: int | None = None):
        prompt = np.asarray(prompt, np.int32)
        t = int(prompt.shape[0])
        if base < 0 or base + t > self.config.capacity:
            raise ValueError(f"prefill block [base={base}, base+{t}) outside cache "
                             f"capacity {self.config.capacity}")
        bucket = self.prefill_bucket(t) if _bucket is None else _bucket
        if bucket < t:
            raise ValueError(f"bucket {bucket} below the block's {t} tokens")
        if self.paged:
            self._ensure_rows(slot, base + t)
        self.rows[slot] = max(int(self.rows[slot]), base + t)
        self.virtual["prefill"] += t * self.cost.prefill_s_per_token
        cfg = self.config
        nxt = _sim_token(cfg.seed, request_id, base + t, cfg.spec.vocab)
        return nxt, np.zeros((t, cfg.spec.vocab), np.float32)

    def decode(self, last_tokens, lengths, request_ids, active, *,
               _pages: int | None = None):
        cfg = self.config
        lengths_np = np.asarray(lengths, np.int64)
        active_np = np.asarray(active, bool)
        rids = np.asarray(request_ids, np.int64)
        if self.paged:
            if _pages is None:
                widest = 1
                for s in np.nonzero(active_np)[0]:
                    self._ensure_rows(int(s), int(lengths_np[s]) + 1)
                    widest = max(widest, int(self.table_len[s]))
                pb = self.decode_page_bucket(widest)
            else:
                pb = _pages
            self.last_attend_width = pb * self.page_size
        if _pages is None:
            # One batched step is one decode tick of virtual time; the
            # all-inactive warm-up probe (_pages forced) charges nothing.
            self.virtual["decode"] += self.cost.decode_s_per_tick
        nxt = np.zeros(cfg.slots, np.int32)
        for s in np.nonzero(active_np)[0]:
            s = int(s)
            if _pages is None:
                self.rows[s] = max(int(self.rows[s]), int(lengths_np[s]) + 1)
            nxt[s] = _sim_token(cfg.seed, int(rids[s]), int(lengths_np[s]) + 1,
                                cfg.spec.vocab)
        return nxt, np.zeros((cfg.slots, cfg.spec.vocab), np.float32)


def sim_engine_factory(cost: CostModel | None = None):
    """A ``RouterConfig.engine_factory`` building cost-model engines that
    share one :class:`CostModel`: the one switch that turns a fleet config
    into its twin."""

    def factory(config, params=None, *, placed_params=None):
        return CostModelEngine(config, params, placed_params=placed_params, cost=cost)

    return factory
