"""Host-side prefix-cache index — the port's own copy of
``ddl_tpu/serve/prefix.py`` (pure Python): a token trie over cached prompt
prefixes, with refcounted LRU eviction over a fixed pool of slots.

Identical prompt prefixes (system prompts, few-shot headers) are recomputed
per request unless their K/V rows are retained and reused. This is the HOST
half only — which prefixes are resident, where, and who may evict them; the
device half is ``serve.cache.copy_slot_prefix`` (contiguous mode) or nothing
at all (paged mode: entries own refcounted page lists, and a hit maps them
into the new slot's block table), wired together by ``serve.engine``.

- **A trie, not a scan**: ``match`` is one walk of the new prompt, returning
  the deepest node some live entry covers. Causal attention makes row ``r``
  of a cached prefix depend only on tokens ``0..r``, so matching a prefix of
  an entry is as good as matching the entry.
- **Refcounts before LRU**: eviction considers only entries with zero
  readers; a full pool of pinned entries SKIPS registration
  (``skipped_full``).
- **Deterministic**: ties in ``match`` resolve to the smallest entry id and
  the LRU clock is logical, so a replayed request sequence reproduces the
  same hits and evictions.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class _Node:
    children: dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    holders: set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Entry:
    """One resident prefix. Contiguous mode: ``tokens`` rows live in
    prefix-pool slot ``slot``. Paged mode (``slot == -1``): the entry
    OWNS a reference on each page in ``pages`` — the rows were donated
    by the registering slot's table, never copied, and a hit maps them
    straight into the new slot's table (``serve.engine``)."""

    id: int
    tokens: tuple[int, ...]
    slot: int
    refs: int = 0
    last_used: int = 0
    pages: tuple[int, ...] = ()


class PrefixIndex:
    """Trie + pool bookkeeping for up to ``slots`` resident prefixes
    (pool slots in contiguous mode; plain entry count in paged mode).
    ``on_evict`` (paged mode) is called with each evicted :class:`Entry`
    so the engine can drop the entry's page references — eviction is the
    ONLY place entries give pages back."""

    def __init__(self, slots: int, on_evict=None):
        if slots < 1:
            raise ValueError(f"prefix pool needs >= 1 slot, got {slots}")
        self.slots = slots
        self._root = _Node()
        self._entries: dict[int, Entry] = {}
        self._free = list(range(slots - 1, -1, -1))  # pop() yields slot 0 first
        self._next_id = 0
        self._clock = 0
        self._on_evict = on_evict
        self.insertions = 0
        self.evictions = 0
        self.skipped_full = 0

    def __len__(self) -> int:
        return len(self._entries)

    def entry(self, entry_id: int) -> Entry:
        return self._entries[entry_id]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ------------------------------------------------------------

    def match(self, tokens) -> tuple[int, int]:
        """Longest registered prefix of ``tokens``: ``(entry_id, depth)``,
        or ``(-1, 0)`` when nothing matches. PURE — no LRU stamp: every
        BOS-led prompt trivially matches depth 1, and stamping unusable
        matches would keep a dead entry perpetually recent while hot
        prefixes paid the evictions; the caller :meth:`touch`-es the
        entry it actually reuses. The depth is UNCAPPED — the caller
        decides how much of a full-prompt match is usable (the engine
        always re-prefills at least the last prompt token, since
        sampling needs its logits)."""
        node, depth, best = self._root, 0, (-1, 0)
        for tok in tokens:
            node = node.children.get(int(tok))
            if node is None:
                break
            depth += 1
            if node.holders:
                best = (min(node.holders), depth)
        return best

    def touch(self, entry_id: int) -> None:
        """Refresh the entry's LRU stamp — call on actual reuse only."""
        self._entries[entry_id].last_used = self._tick()

    # -- refcounts ---------------------------------------------------------

    def acquire(self, entry_id: int) -> None:
        self._entries[entry_id].refs += 1

    def release(self, entry_id: int) -> None:
        e = self._entries[entry_id]
        if e.refs < 1:
            raise ValueError(f"prefix entry {entry_id} released with no readers")
        e.refs -= 1

    # -- registration / eviction -------------------------------------------

    def insert(self, tokens, *, pages=None) -> tuple[int, int] | None:
        """Claim residency for ``tokens``: ``(entry_id, pool_slot)``,
        evicting the least-recently-used ZERO-REF entry if the pool is
        full, or ``None`` (registration skipped) when every resident
        entry is pinned by a live reader.

        Contiguous mode (``pages is None``): claims a pool slot; the
        caller performs the device copy into it. Paged mode: the entry
        records ``pages`` (the registering slot's table prefix — the
        caller increfs them; no device work) and the returned slot is
        ``-1``. Eviction in paged mode hands the victim to ``on_evict``
        so its page references drop."""
        paged = pages is not None
        if paged:
            if len(self._entries) >= self.slots and self._evict_lru() is None:
                self.skipped_full += 1
                return None
            slot = -1
        elif self._free:
            slot = self._free.pop()
        else:
            if self._evict_lru() is None:
                self.skipped_full += 1
                return None
            slot = self._free.pop()
        eid = self._next_id
        self._next_id += 1
        self._entries[eid] = Entry(
            id=eid, tokens=tuple(int(t) for t in tokens), slot=slot,
            last_used=self._tick(),
            pages=tuple(int(p) for p in pages) if paged else (),
        )
        node = self._root
        for tok in self._entries[eid].tokens:
            node = node.children.setdefault(tok, _Node())
            node.holders.add(eid)
        self.insertions += 1
        return eid, slot

    def _evict_lru(self, want=None) -> Entry | None:
        """Evict the least-recently-used ZERO-REF entry satisfying
        ``want`` (``None`` when no such entry exists), notifying
        ``on_evict``."""
        victim = min(
            (e for e in self._entries.values()
             if e.refs == 0 and (want is None or want(e))),
            key=lambda e: e.last_used,
            default=None,
        )
        if victim is None:
            return None
        self._remove(victim)
        self.evictions += 1
        if self._on_evict is not None:
            self._on_evict(victim)
        return victim

    def evict_lru(self, want=None) -> Entry | None:
        """Public reclaim hook (paged mode): the scheduler evicts
        zero-ref entries to free shared pages when admission runs short
        (``serve.engine.reclaim_pages``). ``want`` filters candidates —
        the engine passes "would actually free a page", so reclaim
        never wipes entries whose pages live slots still hold (evicting
        those frees nothing now and only costs future hits)."""
        return self._evict_lru(want)

    def _remove(self, e: Entry) -> None:
        path = [self._root]
        for tok in e.tokens:
            path.append(path[-1].children[tok])
        for node in path[1:]:
            node.holders.discard(e.id)
        # Prune childless, holderless tail nodes so the trie never grows
        # beyond the live entries' token mass.
        for parent, tok, node in reversed(
            list(zip(path[:-1], e.tokens, path[1:]))
        ):
            if not node.children and not node.holders:
                del parent.children[tok]
        del self._entries[e.id]
        if e.slot >= 0:  # paged entries (slot == -1) hold pages, not slots
            self._free.append(e.slot)
