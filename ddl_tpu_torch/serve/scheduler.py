"""Continuous batching — the port of ``ddl_tpu/serve/scheduler.py``'s
single-engine scheduler (``Request``, ``Completion``, ``ServeStats``,
``Pressure``, ``Scheduler``).

Every tick, finished sequences free their slots, waiting requests prefill
into them, and ONE fixed-shape decode advances every active slot together.
Admission is a prefill into a slot (after an optional prefix-cache copy or
page mapping), eviction is host bookkeeping: the position-masked cache
makes stale rows invisible.

- **Prefix-cache reuse** (``ServeConfig.prefix_slots``): a hit of >=
  ``MIN_PREFIX_HIT`` tokens becomes a row copy (contiguous) or page mapping
  (paged) plus a TAIL-only prefill; completed prompts register back.
- **Chunked prefill** (``ServeConfig.prefill_chunk``): prompts stream in
  fixed chunks interleaved with decode ticks under a per-tick token budget.
- **Paged admission**: a request is admitted only when the pool can
  reserve its worst case ``ceil((prompt + max_new) / page_size)`` pages
  (minus the full pages a prefix hit shares); the queue stays strictly
  FIFO.
- **Robustness**: per-request TTFT and total deadlines (expiry evicts and
  returns ``status="deadline_exceeded"`` with the partial tokens) and
  admission shedding (``shed_threshold``: ``status="shed"``).

The policy is pure Python and the same as JAX's tick for tick: the port's
``Completion`` steps, statuses, tokens and ``ServeStats`` counters equal
JAX's on the same requests (tests/test_torch_serve.py). Determinism:
sampling keys depend only on ``(seed, request_id, token_index)`` and slot
computation is row-independent, so a request's tokens do not depend on its
neighbours, on arrival time, on the prefix cache or on chunking.

Metrics: prefill and decode tok/s, per-decode-step latency, TTFT (from
eligibility to first token) and ITL (the gap between consecutive decode
completions while slots stay active). Not ported, each refused with its
ROADMAP item: the tracer, metric registry, writer, SLO monitor, anomaly
detector, fault injector and peak-FLOPs hooks (serve observability),
``role != "mixed"`` (disagg), and ``preempt`` / ``adopt`` / ``abandon``
(the page hand-off).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from ..utils.metrics import StepStats, StepTimer
from .engine import InferenceEngine

# A prefix hit shorter than this prefills normally: every BOS-led prompt
# trivially shares its first token with every cached entry.
MIN_PREFIX_HIT = 2

_OBS = "ROADMAP queue 1, item 8: serve observability"
_HANDOFF = "ROADMAP queue 1, item 8: preempt/adopt and page dump/load"


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``arrival`` is the earliest scheduler step
    at which it may be admitted. ``ttft_deadline_s`` bounds eligibility ->
    first token and ``deadline_s`` eligibility -> completion (wall seconds;
    None inherits the scheduler's defaults). JAX's ``traffic_class`` and
    ``shed_exempt`` wait for the router and the fleet controller (ROADMAP
    queue 1, item 8), the slices that set them."""

    id: int
    prompt: np.ndarray  # int32 [p], p >= 1
    max_new_tokens: int
    arrival: int = 0
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None


@dataclasses.dataclass
class Completion:
    """``status``: ``"ok"`` (ran to its stop condition),
    ``"deadline_exceeded"`` (evicted at a deadline; ``tokens`` holds the
    partial output) or ``"shed"`` (refused at admission)."""

    id: int
    prompt_len: int
    tokens: list[int]  # generated ids (includes the eos token if hit)
    admitted_step: int  # -1: never admitted (shed / expired in queue)
    finished_step: int
    status: str = "ok"


@dataclasses.dataclass
class ServeStats:
    """Aggregate throughput/latency for one :meth:`Scheduler.run`."""

    prefill_tokens: int
    prefill_s: float
    decode_tokens: int
    decode_steps: int
    decode_s: float
    slots: int
    latency: StepStats  # per-decode-step = per-token percentiles
    ttft: StepStats = dataclasses.field(default_factory=lambda: StepStats.from_times([]))
    itl: StepStats = dataclasses.field(default_factory=lambda: StepStats.from_times([]))
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefill_tokens_saved: int = 0

    @property
    def prefill_tokens_per_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def decode_tokens_per_s_per_slot(self) -> float:
        return self.decode_tokens_per_s / self.slots

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_lookups if self.prefix_lookups else 0.0


@dataclasses.dataclass(frozen=True)
class Pressure:
    """Non-destructive load probe: occupied and active slots, eligible and
    all pending requests, free and available (free minus reserved) pages
    (0 contiguous), resident prefix entries."""

    occupied_slots: int
    active_slots: int
    waiting_eligible: int  # submitted, arrival reached, not yet admitted
    pending_total: int  # submitted and not yet admitted, future arrivals too
    pages_free: int
    pages_available: int
    prefix_entries: int

    @property
    def outstanding(self) -> int:
        """Occupied slots + waiting eligibles: what the shed threshold
        compares against."""
        return self.occupied_slots + self.waiting_eligible


class _RunState:
    """Everything one run keeps, so a run can be driven tick by tick
    (``begin``/``submit``/``tick``/``collect``) and probed mid-flight."""

    def __init__(self, slots: int):
        self.pending: collections.deque = collections.deque()
        self.occupant: list[Request | None] = [None] * slots
        self.active = np.zeros(slots, bool)  # decoding (prefill complete)
        self.lengths = np.zeros(slots, np.int32)  # tokens resident
        self.last_tokens = np.zeros(slots, np.int32)  # sampled, unappended
        self.req_ids = np.zeros(slots, np.int32)
        self.generated: list[list[int]] = [[] for _ in range(slots)]
        self.admitted_at = np.zeros(slots, np.int64)
        self.prefilled = np.zeros(slots, np.int64)  # prompt tokens in cache
        self.store_after = [False] * slots  # register prompt when done
        self.held_entry = [-1] * slots  # pinned pool entry behind admission
        self.done: dict[int, Completion] = {}
        self.prefill_timer = StepTimer()
        self.decode_timer = StepTimer()
        self.eligible_wall: dict[int, float] = {}
        self.ttfts: list[float] = []
        self.itls: list[float] = []
        self.lookups = self.hits = self.saved = 0
        self.last_decode_done: float | None = None
        self.step = 0
        self.deadlines_on = False
        self.seen_ids: set[int] = set()


class Scheduler:
    """Continuous-batching scheduler, one per engine. ``run`` is synchronous
    and returns when every request has completed; it is literally
    ``begin`` / ``submit`` / ``tick`` / ``collect``. ``allow_window=True``
    admits requests whose ``prompt + max_new_tokens`` exceeds the capacity
    (the ring wraps into an exact sliding window; contiguous only)."""

    def __init__(self, engine: InferenceEngine, *, eos_id: int | None = None,
                 allow_window: bool = False, tracer=None, registry=None,
                 metrics_writer=None, ttft_deadline_s: float | None = None,
                 deadline_s: float | None = None,
                 shed_threshold: int | None = None, injector=None,
                 slo_monitor=None, peak_flops: float | None = None,
                 anomaly_detector=None, role: str = "mixed"):
        self.engine = engine
        self.eos_id = eos_id
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role must be 'mixed', 'prefill' or 'decode', got {role!r}")
        if role != "mixed":
            raise NotImplementedError(
                f"role={role!r} is not ported yet (ROADMAP queue 1, item 8: disagg)")
        for name, value in (("tracer", tracer), ("registry", registry),
                            ("metrics_writer", metrics_writer), ("injector", injector),
                            ("slo_monitor", slo_monitor), ("peak_flops", peak_flops),
                            ("anomaly_detector", anomaly_detector)):
            if value is not None:
                raise NotImplementedError(f"Scheduler({name}=...) is not ported yet ({_OBS})")
        if allow_window and engine.paged:
            raise ValueError(
                "allow_window is a ring-buffer (contiguous) semantics — the paged "
                "layout never wraps (a wrap would stomp shared prefix pages); size "
                "capacity/num_pages for the full request instead"
            )
        self.allow_window = allow_window
        for name, v in (("ttft_deadline_s", ttft_deadline_s), ("deadline_s", deadline_s)):
            if v is not None and v <= 0:
                raise ValueError(
                    f"{name} must be > 0 seconds, got {v} (a non-positive deadline "
                    "would expire every request at its first tick)"
                )
        if shed_threshold is not None and shed_threshold < engine.config.slots:
            raise ValueError(
                f"shed_threshold ({shed_threshold}) is below the engine's concurrent "
                f"capacity (slots={engine.config.slots}) — it would shed traffic the "
                "batch could serve; use a value >= slots"
            )
        self.ttft_deadline_s = ttft_deadline_s
        self.deadline_s = deadline_s
        self.shed_threshold = shed_threshold
        self._st: _RunState | None = None

    def warmup(self, requests) -> None:
        """Run every program shape ``requests`` will need OUTSIDE any timed
        run, then reset the engine (fresh cache, empty prefix pool):
        clones with negative ids and at most 2 new tokens, the whole
        power-of-two prefill ladder up to the largest prompt, the paged
        decode ladder up to the widest residency, and the prefix copies.
        Deadlines and shedding are off meanwhile."""
        if not requests:
            return
        eng = self.engine
        saved = (self.ttft_deadline_s, self.deadline_s, self.shed_threshold)
        self.ttft_deadline_s = self.deadline_s = self.shed_threshold = None
        try:
            self.run([
                dataclasses.replace(r, id=-1 - i, max_new_tokens=min(2, r.max_new_tokens),
                                    ttft_deadline_s=None, deadline_s=None)
                for i, r in enumerate(requests)
            ])
            if eng.paged:
                # The clone run may leave prefix entries holding pages; the
                # ladders below need a clean pool.
                eng.reset()
            max_bucket = eng.prefill_bucket(max(int(np.asarray(r.prompt).shape[0])
                                                for r in requests))
            b = 8
            while True:
                # A 1-token prompt at a forced bucket: one real row (paged:
                # one page) per bucket.
                bucket = min(b, max_bucket)
                eng.prefill(np.zeros(1, np.int32), slot=0, request_id=-1, base=0,
                            _bucket=bucket)
                if bucket == max_bucket:
                    break
                b *= 2
            if eng.paged:
                eng.release_slot(0)
                # Decode is keyed by page-count bucket: the ladder up to the
                # widest residency the real run can reach, all slots inactive
                # (every write lands on the drop page).
                top = eng.decode_page_bucket(eng.pages_needed(max(
                    min(int(np.asarray(r.prompt).shape[0]) + r.max_new_tokens,
                        eng.config.capacity)
                    for r in requests
                )))
                S = eng.config.slots
                zeros = np.zeros(S, np.int32)
                pb = 1
                while True:
                    pbi = min(pb, eng.max_pages)
                    eng.decode(zeros, zeros, zeros, np.zeros(S, bool), _pages=pbi)
                    if pbi >= top:
                        break
                    pb *= 2
            if eng.prefix is not None:
                if eng.paged:
                    # One page-UNALIGNED hit runs the copy-on-write copy.
                    ps = eng.page_size
                    if eng.max_pages >= 2 and eng.num_pages >= 3:
                        eng.prefill(np.zeros(2 * ps, np.int32), slot=0, request_id=-1, base=0)
                        if eng.prefix_store(np.zeros(2 * ps, np.int32), 0):
                            entry, _ = eng.prefix.match(np.zeros(2 * ps, np.int32))
                            eng.release_slot(0)
                            eng.prefix_fetch(entry, ps + 1, 0)
                            eng.prefix_release(entry)
                elif eng.prefix_store(np.zeros(2, np.int32), 0):
                    entry, _ = eng.prefix.match(np.zeros(2, np.int32))
                    eng.prefix_fetch(entry, 2, 0)
                    eng.prefix_release(entry)
            eng.reset()
        finally:
            self.ttft_deadline_s, self.deadline_s, self.shed_threshold = saved

    def _validate(self, r: Request) -> None:
        """Reject a malformed request at SUBMIT time, before any state
        moves."""
        eng = self.engine
        cap = eng.config.capacity
        p = int(np.asarray(r.prompt).shape[0])
        if p < 1:
            raise ValueError(f"request {r.id}: empty prompt")
        if r.max_new_tokens < 1:
            raise ValueError(f"request {r.id}: max_new_tokens must be >= 1")
        if p > cap:
            raise ValueError(f"request {r.id}: prompt length {p} exceeds cache capacity {cap}")
        if p + r.max_new_tokens > cap and not self.allow_window:
            if eng.paged:
                raise ValueError(
                    f"request {r.id}: prompt ({p}) + max_new_tokens ({r.max_new_tokens}) "
                    f"exceeds the block-table reach ({eng.max_pages} pages x "
                    f"{eng.page_size} rows = {cap}); raise --capacity (table width) or "
                    "shorten the request"
                )
            raise ValueError(
                f"request {r.id}: prompt ({p}) + max_new_tokens ({r.max_new_tokens}) "
                f"exceeds cache capacity {cap} (pass allow_window=True to accept "
                f"sliding-window attention once the ring wraps)"
            )
        if eng.paged:
            need = eng.pages_needed(p + r.max_new_tokens)
            if need > eng.num_pages:
                raise ValueError(
                    f"request {r.id}: prompt ({p}) + max_new_tokens ({r.max_new_tokens}) "
                    f"needs {need} KV pages but the pool holds num_pages={eng.num_pages}; "
                    "raise --num-pages or shorten the request"
                )
        for name, v in (("ttft_deadline_s", r.ttft_deadline_s), ("deadline_s", r.deadline_s)):
            if v is not None and v <= 0:
                raise ValueError(f"request {r.id}: {name} must be > 0 seconds, got {v}")

    def _deadline_for(self, r: Request) -> tuple[float | None, float | None]:
        """Effective ``(ttft, total)`` deadlines: the request's, else the
        scheduler's."""
        ttft = r.ttft_deadline_s if r.ttft_deadline_s is not None else self.ttft_deadline_s
        total = r.deadline_s if r.deadline_s is not None else self.deadline_s
        return ttft, total

    # -- externally-driven run form ----------------------------------------

    def begin(self) -> None:
        """Arm a run; ``collect`` (or ``release``) disarms it."""
        if self._st is not None:
            raise RuntimeError("a run is already armed on this scheduler; collect() or "
                               "release() it before begin()")
        st = _RunState(self.engine.config.slots)
        st.deadlines_on = self.ttft_deadline_s is not None or self.deadline_s is not None
        self._st = st

    def submit(self, r: Request) -> None:
        """Validate and enqueue one request; the queue stays (arrival,
        id)-sorted."""
        st = self._require_run()
        self._validate(r)
        if r.id in st.seen_ids:
            raise ValueError(f"duplicate request id {r.id}")
        st.seen_ids.add(r.id)
        st.deadlines_on = st.deadlines_on or (r.ttft_deadline_s is not None
                                              or r.deadline_s is not None)
        last = st.pending[-1] if st.pending else None
        if last is not None and (r.arrival, r.id) < (last.arrival, last.id):
            st.pending = collections.deque(sorted([*st.pending, r],
                                                  key=lambda q: (q.arrival, q.id)))
        else:
            st.pending.append(r)

    def _require_run(self) -> _RunState:
        if self._st is None:
            raise RuntimeError("no armed run: call begin() first")
        return self._st

    @property
    def idle(self) -> bool:
        """True when a tick would have nothing to do: no occupant and
        nothing pending (a future arrival counts as work)."""
        st = self._st
        if st is None:
            return True
        return not st.pending and all(o is None for o in st.occupant)

    def pressure(self) -> Pressure:
        """Non-destructive load probe, armed run or not."""
        eng = self.engine
        occupied = active = waiting = total = 0
        st = self._st
        if st is not None:
            occupied = sum(o is not None for o in st.occupant)
            active = int(st.active.sum())
            for q in st.pending:  # (arrival, id)-sorted: early break
                if q.arrival > st.step:
                    break
                waiting += 1
            total = len(st.pending)
        return Pressure(
            occupied_slots=occupied,
            active_slots=active,
            waiting_eligible=waiting,
            pending_total=total,
            pages_free=int(eng.pages.free) if eng.paged else 0,
            pages_available=int(eng.pages.available) if eng.paged else 0,
            prefix_entries=len(eng.prefix) if eng.prefix is not None else 0,
        )

    def preempt(self, request_id: int, *, path: str = "preempt"):
        raise NotImplementedError(f"preempt is not ported yet ({_HANDOFF})")

    def adopt(self, pre) -> int:
        raise NotImplementedError(f"adopt is not ported yet ({_HANDOFF})")

    def abandon(self):
        raise NotImplementedError(
            "abandon is not ported yet (ROADMAP queue 1, item 8: the controller)")

    def collect(self) -> tuple[dict[int, Completion], ServeStats]:
        """Finalize the armed run: ``(completions, stats)`` as :meth:`run`
        returns them. Disarms the run."""
        st = self._require_run()
        latency = st.decode_timer.stats()
        stats = ServeStats(
            prefill_tokens=st.prefill_timer.total_images,
            prefill_s=st.prefill_timer.total_s,
            decode_tokens=st.decode_timer.total_images,
            decode_steps=latency.steps,
            decode_s=st.decode_timer.total_s,
            slots=self.engine.config.slots,
            latency=latency,
            ttft=StepStats.from_times(st.ttfts),
            itl=StepStats.from_times(st.itls),
            prefix_lookups=st.lookups,
            prefix_hits=st.hits,
            prefill_tokens_saved=st.saved,
        )
        self._st = None
        return st.done, stats

    def release(self) -> None:
        """Disarm an aborted run, dropping every prefix pin, page reference
        and reservation it still holds (no-op after ``collect``)."""
        st = self._st
        if st is None:
            return
        eng = self.engine
        for s in range(eng.config.slots):
            if st.held_entry[s] >= 0:
                eng.prefix_release(st.held_entry[s])
                st.held_entry[s] = -1
            if eng.paged and (st.occupant[s] is not None or int(eng.table_len[s])
                              or int(eng.reserved_for[s])):
                eng.release_slot(s)
        self._st = None

    def run(self, requests) -> tuple[dict[int, Completion], ServeStats]:
        """Serve ``requests`` to completion in (arrival, id) order. Every
        request is validated before any is enqueued."""
        for r in requests:
            self._validate(r)
        ids = [r.id for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate request ids in {ids}")
        self.begin()
        try:
            for r in sorted(requests, key=lambda r: (r.arrival, r.id)):
                self.submit(r)
            while not self.idle:
                self.tick()
            return self.collect()
        finally:
            self.release()

    # -- the tick body ------------------------------------------------------

    def _finish(self, st: _RunState, s: int, status: str = "ok") -> None:
        eng = self.engine
        r = st.occupant[s]
        st.done[r.id] = Completion(
            id=r.id,
            prompt_len=int(np.asarray(r.prompt).shape[0]),
            tokens=list(st.generated[s]),
            admitted_step=int(st.admitted_at[s]),
            finished_step=st.step,
            status=status,
        )
        st.active[s] = False
        st.occupant[s] = None
        if eng.paged:
            # Completion and eviction are the same bookkeeping: page
            # references drop and any unused reservation returns.
            eng.release_slot(s)
        if st.held_entry[s] >= 0:
            eng.prefix_release(st.held_entry[s])
            st.held_entry[s] = -1

    def _expire_queued(self, st: _RunState, r: Request, status: str) -> None:
        """Remove a never-admitted request from the queue with a structured
        outcome (shed, or expired while waiting)."""
        st.pending.remove(r)
        st.done[r.id] = Completion(
            id=r.id, prompt_len=int(np.asarray(r.prompt).shape[0]), tokens=[],
            admitted_step=-1, finished_step=st.step, status=status,
        )

    def _finished(self, st: _RunState, s: int, token: int) -> bool:
        return (len(st.generated[s]) >= st.occupant[s].max_new_tokens
                or (self.eos_id is not None and token == self.eos_id))

    def tick(self) -> None:
        """One scheduler step of the armed run: stamp eligibility, shed and
        expire, admit into free slots, prefill under the chunk budget, one
        batched decode. An idle tick makes no device calls."""
        st = self._require_run()
        eng = self.engine
        cfg = eng.config
        S = cfg.slots
        chunk = cfg.prefill_chunk
        # An unset budget is ONE chunk a tick (maximum decode interleaving).
        budget0 = cfg.prefill_budget or chunk
        step = st.step
        # The TTFT clock starts the first tick a request is eligible, slot
        # or no slot: queueing is part of time-to-first-token.
        now = time.perf_counter()
        # Shedding decides ONCE, at first eligibility.
        outstanding = -1
        if self.shed_threshold is not None:
            outstanding = sum(o is not None for o in st.occupant) + sum(
                1 for q in st.pending if q.arrival <= step and q.id in st.eligible_wall
            )
        shed_now = []
        for r in st.pending:
            if r.arrival > step:
                break  # pending is (arrival, id)-sorted
            if r.id not in st.eligible_wall:
                if self.shed_threshold is not None and outstanding >= self.shed_threshold:
                    shed_now.append(r)
                    continue
                st.eligible_wall[r.id] = now
                outstanding += 1
        for r in shed_now:
            self._expire_queued(st, r, "shed")
        if st.deadlines_on:
            # Waiting requests past a deadline never admit; occupied slots
            # past theirs evict (partial tokens kept).
            expired = []
            for r in st.pending:
                if r.arrival > step:
                    break
                t0 = st.eligible_wall.get(r.id)
                if t0 is None:
                    continue
                lims = [v for v in self._deadline_for(r) if v is not None]
                if lims and now - t0 > min(lims):
                    expired.append(r)
            for r in expired:
                self._expire_queued(st, r, "deadline_exceeded")
            for s in range(S):
                r = st.occupant[s]
                if r is None:
                    continue
                ttft, total = self._deadline_for(r)
                # Before the first token both deadlines bound the wait; once
                # decoding, only the total deadline applies.
                lims = [v for v in ((ttft, total) if not st.active[s] else (total,))
                        if v is not None]
                if lims and now - st.eligible_wall[r.id] > min(lims):
                    self._finish(st, s, status="deadline_exceeded")
        # Admit: claim every free slot whose turn has come. Paged admission
        # reserves the worst case first; when the head cannot fit, nothing
        # behind it admits either (strict FIFO).
        for s in range(S):
            if st.occupant[s] is not None or not st.pending or st.pending[0].arrival > step:
                continue
            r = st.pending[0]
            p = int(np.asarray(r.prompt).shape[0])

            def probe():
                # match() is PURE (no LRU stamp): probing cannot perturb it.
                if eng.prefix is None:
                    return -1, 0, 0
                entry, full = eng.prefix.match(r.prompt)
                hit = min(full, p - 1)
                return entry, full, hit if hit >= MIN_PREFIX_HIT else 0

            entry, full, hit = probe()
            if eng.paged:
                while True:
                    need = eng.pages_needed(p + r.max_new_tokens) - hit // eng.page_size
                    if eng.pages.available >= need:
                        break
                    if not eng.reclaim_pages(need):
                        need = -1
                        break
                    # Reclaim may have evicted the matched entry: re-probe.
                    entry, full, hit = probe()
                if need < 0:
                    break  # the head waits for pages; FIFO holds
                eng.reserve_pages(s, need)
            st.pending.popleft()
            st.occupant[s] = r
            st.generated[s] = []
            st.admitted_at[s] = step
            base = 0
            st.store_after[s] = False
            if eng.prefix is not None:
                st.lookups += 1
                if hit >= MIN_PREFIX_HIT:
                    eng.prefix_fetch(entry, hit, s)
                    st.held_entry[s] = entry
                    base = hit
                    st.hits += 1
                    st.saved += hit
                # Register once the prompt is resident if the cache covers
                # less than half of it (a miss, or a long continuation).
                st.store_after[s] = full < max(p // 2, MIN_PREFIX_HIT)
            st.prefilled[s] = base
            # A mid-prefill slot still rides the decode batch and writes one
            # PAD_POS row at lengths[s]: keep that at the next chunk's first
            # row, never at a row already resident.
            st.lengths[s] = base
        # Prefill every occupied-but-not-active slot: the whole prompt, or
        # chunk by chunk under the shared per-tick budget.
        budget = budget0
        prefilled_any = False
        for s in range(S):
            r = st.occupant[s]
            if r is None or st.active[s]:
                continue
            prompt = np.asarray(r.prompt, np.int32)
            p = int(prompt.shape[0])
            while st.prefilled[s] < p:
                todo = p - int(st.prefilled[s])
                n = todo if not chunk else min(chunk, todo)
                if budget0 and budget < n:
                    break  # out of tick budget; resume next tick
                base = int(st.prefilled[s])
                with st.prefill_timer.step(images=n):
                    tok, _ = eng.prefill(prompt[base:base + n], slot=s, request_id=r.id,
                                         base=base)
                st.prefilled[s] += n
                prefilled_any = True
                st.lengths[s] = st.prefilled[s]  # see the admission comment
                if budget0:
                    budget -= n
                if base + n == p:  # prompt complete: first token
                    if eng.prefix is not None and st.store_after[s]:
                        eng.prefix_store(prompt, s)
                    st.active[s] = True
                    st.lengths[s] = p
                    st.last_tokens[s] = tok
                    st.req_ids[s] = r.id
                    st.generated[s] = [tok]
                    st.ttfts.append(time.perf_counter() - st.eligible_wall[r.id])
                    if self._finished(st, s, tok):
                        self._finish(st, s)
                    break
        if st.active.any():
            n_active = int(st.active.sum())
            with st.decode_timer.step(images=n_active):
                nxt, _ = eng.decode(st.last_tokens, st.lengths, st.req_ids, st.active)
            now = time.perf_counter()
            if st.last_decode_done is not None:
                # The gap since the previous decode completion, interleaved
                # prefill work included.
                st.itls.append(now - st.last_decode_done)
            st.last_decode_done = now
            for s in range(S):
                if not st.active[s]:
                    continue
                st.lengths[s] += 1  # last_tokens[s] entered the cache
                tok = int(nxt[s])
                st.generated[s].append(tok)
                st.last_tokens[s] = tok
                if self._finished(st, s, tok):
                    self._finish(st, s)
        else:
            # No decoder advanced: the next decode's gap is lead-in, not an
            # inter-token stall.
            st.last_decode_done = None
            if (st.deadlines_on and not prefilled_any
                    and any(o is not None for o in st.occupant)):
                # Only expiring work remains: yield the host briefly instead
                # of spinning until a wall-clock deadline passes.
                time.sleep(0.0005)
        st.step = step + 1
        if all(o is None for o in st.occupant) and st.pending:
            # Jump an idle gap straight to the next arrival.
            st.step = max(st.step, st.pending[0].arrival)
