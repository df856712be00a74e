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
completions while slots stay active).

Telemetry: with an ``obs.Tracer`` the scheduler emits the request lifecycle
(``submit``, ``eligible``, ``admit``, ``prefix_copy``/``prefix_map``,
``prefill_chunk``, ``first_token``, ``decode_tick`` with the ``reqs`` that
decoded, ``complete``, ``shed``, ``deadline_exceeded``, ``preempt``,
``resume``), each stamped with the SAME ``perf_counter`` value its
``ServeStats`` math uses, so :func:`derive_request_slo` recovers TTFT and
ITL from the records float for float. On the card the decode's stamp is
read after the fetch of the sampled tokens, which waits for the device.
With an ``obs.MetricRegistry`` it keeps JAX's ``serve_*`` counters, gauges
and histograms and the goodput tracker's per-phase time. Both default off,
and every clock read they add is gated on them: a bare ``Scheduler(engine)``
runs the plain tick, and an idle tick makes no device call either way.

Fleet hooks: :meth:`Scheduler.preempt` / :meth:`Scheduler.adopt` lift an
active request out with its KV pages (``engine.dump_slot_pages``) and
resume it on another scheduler bit for bit; :meth:`Scheduler.abandon` hands
back a crashed replica's ledger; ``role="prefill"`` holds first-token slots
for the disaggregated hand-off (``serve.disagg``); an ``injector``'s
``stall`` never advances a request's prefill (its deadline must evict it).

Speculative decoding (``ServeConfig.speculate_k > 0``,
``Scheduler._speculate_decode``): still ONE batched decode a tick, with free
slots as draft lanes over the speculating slots' pages; the tokens equal
plain greedy decode's, in fewer decode steps when drafts are accepted.

The live control plane, each on the scheduler's own registry (checked at
construction, with JAX's texts) and each a per-tick consumer, in JAX's
order after the tick's gauges: the ``MetricsWriter``'s rate-limited
``maybe_flush``, the ``obs.anomaly.AnomalyDetector`` fed the tick's signals
(``queue_depth``, ``active_slots``, ``occupied_slots``, ``pages_free``: host
state; ``step_time``, ``itl``, ``mfu``: wall clock), and one burn-window
step of the ``obs.slo.SloMonitor``. ``peak_flops`` overrides the device
table behind ``serve_mfu``. With a registry the engine's program hooks
count ``xla_compiles_total{kind=}`` (warm-up included: the builds are the
run's) and publish each program's collective ledger. Warm-up suspends every
per-tick consumer.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from .. import precision as _precision
from ..obs import comms as _comms
from ..obs import cost as _cost
from ..obs.goodput import GoodputTracker
from ..obs.memory import MemorySampler, record_compile
from ..obs.trace import NULL_TRACER
from ..utils.metrics import StepStats, StepTimer
from .engine import InferenceEngine
from .speculate import greedy_accept, propose_draft

# A prefix hit shorter than this prefills normally: every BOS-led prompt
# trivially shares its first token with every cached entry.
MIN_PREFIX_HIT = 2


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``arrival`` is the earliest scheduler step
    at which it may be admitted. ``ttft_deadline_s`` bounds eligibility ->
    first token and ``deadline_s`` eligibility -> completion (wall seconds;
    None inherits the scheduler's defaults). ``traffic_class`` names the
    request's SLO class for the router (the scheduler ignores it);
    ``shed_exempt`` skips the admission-shed check (the fleet controller
    sets it on a request it re-queues after its replica crashed: its
    admission was decided once)."""

    id: int
    prompt: np.ndarray  # int32 [p], p >= 1
    max_new_tokens: int
    arrival: int = 0
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None
    traffic_class: str = "default"
    shed_exempt: bool = False


@dataclasses.dataclass
class Completion:
    """``status``: ``"ok"`` (ran to its stop condition),
    ``"deadline_exceeded"`` (evicted at a deadline; ``tokens`` holds the
    partial output), ``"shed"`` (refused at admission) or ``"requeued"``
    (the fleet controller's placeholder for a crash-orphaned request,
    overwritten once by its final completion)."""

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


@dataclasses.dataclass
class PreemptedRequest:
    """A mid-decode request lifted out of one scheduler for resumption on
    another: the request, its generated stream, the decode cursor, its
    original eligibility stamp (deadlines keep their meaning) and admission
    step, and its KV pages as host numpy (``engine.dump_slot_pages``,
    block-table order)."""

    request: Request
    generated: list[int]
    last_token: int
    lengths: int
    admitted_at: int
    eligible_wall: float
    k: np.ndarray  # [L, n_pages, page, H, D] (this rank's heads at tp > 1)
    v: np.ndarray  # [L, n_pages, page, H, D]
    pos: np.ndarray  # [n_pages, page]


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
    ``begin`` / ``submit`` / ``tick`` / ``collect``, the form the router
    drives tick by tick with ``pressure()`` as its load probe.
    ``allow_window=True`` admits requests whose ``prompt + max_new_tokens``
    exceeds the capacity (the ring wraps into an exact sliding window;
    contiguous only)."""

    def __init__(self, engine: InferenceEngine, *, eos_id: int | None = None,
                 allow_window: bool = False, tracer=None, registry=None,
                 metrics_writer=None, ttft_deadline_s: float | None = None,
                 deadline_s: float | None = None,
                 shed_threshold: int | None = None, injector=None,
                 slo_monitor=None, peak_flops: float | None = None,
                 anomaly_detector=None, role: str = "mixed"):
        self.engine = engine
        self.eos_id = eos_id
        # role="prefill" runs prompts to their first token and HOLDS the
        # slot for the fleet's page hand-off (serve.disagg); "decode"
        # behaves as "mixed" (the router's placement enforces the split).
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role must be 'mixed', 'prefill' or 'decode', got {role!r}")
        if role == "prefill" and not engine.paged:
            raise ValueError(
                "role='prefill' needs the paged KV layout (page_size > 0): the "
                "prefill->decode hand-off moves KV pages, and contiguous slot rings have none"
            )
        self.role = role
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
        # resilience.faults: stalls(id) defers that request's prefill forever.
        self.injector = injector
        # NULL_TRACER is falsy: `if tr:` keeps even the clock reads off the
        # disabled path.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry
        self.metrics_writer = metrics_writer
        self.slo_monitor = slo_monitor
        if slo_monitor is not None and slo_monitor.registry is not registry:
            raise ValueError(
                "slo_monitor was built on a different registry than this scheduler's — it "
                "would read metrics the scheduler never writes (burn 0.0 forever). Build it "
                "on the registry passed as registry="
            )
        self.anomaly = anomaly_detector
        if anomaly_detector is not None and anomaly_detector.registry is not registry:
            raise ValueError(
                "anomaly_detector was built on a different registry than this scheduler's — "
                "its anomaly_* metrics would land where nothing reads them. Build it on the "
                "registry passed as registry="
            )
        self._peak_flops = peak_flops
        self._peak: float | None = None
        self._mem = self._goodput = None
        if registry is not None:
            self._mem = MemorySampler(registry, [engine.device])
            self._goodput = GoodputTracker(registry, "serve")

            def _on_build(kind, key, _sched=self):
                # The registry is captured (warm-up's builds are the run's);
                # the tracer is read when called, so warm-up's stays off.
                record_compile(registry, _sched.tracer, kind, key=key)

            def _on_ledger(kind, key, records):
                _comms.publish_program_ledger(registry, records, program=f"{kind}[{key}]",
                                              grid=engine.grid)

            engine.compile_hook = _on_build
            engine.ledger_hook = _on_ledger
        self._st: _RunState | None = None

    @property
    def goodput(self):
        """The live ``obs.goodput.GoodputTracker`` (None without a
        registry)."""
        return self._goodput

    def attach_registry(self, registry) -> None:
        """Swap the metric registry mid-lifetime, rebuilding the consumers
        that capture it (the goodput tracker and the memory sampler). The
        engine's program hooks keep their registry. A bound SLO monitor or
        anomaly detector pins the registry: the swap is refused."""
        for name, consumer in (("slo_monitor", self.slo_monitor),
                               ("anomaly_detector", self.anomaly)):
            if consumer is not None and consumer.registry is not registry:
                raise ValueError(
                    f"attach_registry would strand the bound {name} on its old registry "
                    "(the ctor-enforced same-registry invariant); rebuild it on the new "
                    "registry first or detach it"
                )
        self.registry = registry
        self._mem = self._goodput = None
        if registry is not None:
            self._mem = MemorySampler(registry, [self.engine.device])
            self._goodput = GoodputTracker(registry, "serve")

    def warmup(self, requests) -> None:
        """Run every program shape ``requests`` will need OUTSIDE any timed
        run, then reset the engine (fresh cache, empty prefix pool):
        clones with negative ids and at most 2 new tokens, the whole
        power-of-two prefill ladder up to the largest prompt, the paged
        decode ladder up to the widest residency, and the prefix copies.
        Telemetry, deadlines, shedding and fault injection are off
        meanwhile (the engine's program hooks stay on: the builds are the
        run's), and the clones run as ``"mixed"`` (no coordinator takes a
        prefill role's held slots here)."""
        if not requests:
            return
        eng = self.engine
        saved = (self.tracer, self.registry, self.metrics_writer, self.ttft_deadline_s,
                 self.deadline_s, self.shed_threshold, self.injector, self.slo_monitor,
                 self._mem, self.anomaly, self._goodput, self.role)
        self.tracer, self.registry, self.metrics_writer = NULL_TRACER, None, None
        self.ttft_deadline_s = self.deadline_s = self.shed_threshold = self.injector = None
        self.slo_monitor = self._mem = self.anomaly = self._goodput = None
        self.role = "mixed"
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
            (self.tracer, self.registry, self.metrics_writer, self.ttft_deadline_s,
             self.deadline_s, self.shed_threshold, self.injector, self.slo_monitor,
             self._mem, self.anomaly, self._goodput, self.role) = saved

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
        if self.injector is not None and self.injector.stalls(r.id) \
                and self._deadline_for(r) == (None, None):
            raise ValueError(
                f"request {r.id}: stall fault injected but no TTFT/total deadline "
                "applies — the run would never terminate; set a per-request or "
                "scheduler-default deadline"
            )

    def _deadline_for(self, r: Request) -> tuple[float | None, float | None]:
        """Effective ``(ttft, total)`` deadlines: the request's, else the
        scheduler's."""
        ttft = r.ttft_deadline_s if r.ttft_deadline_s is not None else self.ttft_deadline_s
        total = r.deadline_s if r.deadline_s is not None else self.deadline_s
        return ttft, total

    def _resolve_peak(self) -> float:
        """Per-device peak FLOP/s for the ``serve_mfu`` gauge: the
        ``peak_flops`` override, else the device table's row at the
        engine's matmul precision (resolved once)."""
        if self._peak is None:
            self._peak = _cost.peak_flops_per_device(
                self.engine.device, self._peak_flops,
                precision=_precision.mfu_kind(self.engine.config.compute_dtype))
        return self._peak

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
        if self.tracer:
            self.tracer.event("submit", t=time.perf_counter(), req=int(r.id),
                              prompt_len=int(np.asarray(r.prompt).shape[0]),
                              arrival=int(r.arrival), max_new_tokens=int(r.max_new_tokens))

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

    def waiting_eligible_requests(self) -> list[Request]:
        """Queued requests whose arrival has come, in admission (FIFO)
        order: the fleet controller's preemption-trigger probe."""
        st = self._st
        if st is None:
            return []
        out = []
        for q in st.pending:  # (arrival, id)-sorted: early break
            if q.arrival > st.step:
                break
            out.append(q)
        return out

    def occupant_requests(self) -> list[tuple[int, Request, bool]]:
        """``(slot, request, active)`` for every occupied slot: the
        controller's victim probe (only active occupants carry a decode
        cursor to move)."""
        st = self._st
        if st is None:
            return []
        return [(s, r, bool(st.active[s])) for s, r in enumerate(st.occupant) if r is not None]

    # -- cross-replica preemption -------------------------------------------

    def preempt(self, request_id: int, *, path: str = "preempt") -> PreemptedRequest:
        """Lift an ACTIVE occupant out of the armed run for resumption on
        another scheduler (:meth:`adopt`): its pages go to the host, its
        slot frees (pages decref, the unused reservation returns, prefix
        pins release), and no completion is recorded (it completes once, on
        the adopter). Paged engines only. The dumped bytes count once into
        ``handoff_bytes_total{path=}``."""
        st = self._require_run()
        eng = self.engine
        if not eng.paged:
            raise RuntimeError(
                "preempt needs the paged KV layout (page_size > 0) — contiguous slots "
                "have no slot-independent pages to hand off")
        for s in range(eng.config.slots):
            r = st.occupant[s]
            if r is not None and r.id == request_id:
                break
        else:
            raise KeyError(f"request {request_id} occupies no slot on this scheduler")
        if not st.active[s]:
            raise RuntimeError(
                f"request {request_id} is mid-prefill, not mid-decode — only active "
                "occupants carry a resumable decode cursor")
        k, v, pos = eng.dump_slot_pages(s)
        if self.registry is not None:
            self.registry.counter(
                "handoff_bytes_total", help="KV bytes moved through the host, by hand-off path",
            ).inc(eng.handoff_bytes(int(pos.shape[0])), path=path)
        pre = PreemptedRequest(
            request=r, generated=list(st.generated[s]), last_token=int(st.last_tokens[s]),
            lengths=int(st.lengths[s]), admitted_at=int(st.admitted_at[s]),
            eligible_wall=st.eligible_wall[r.id], k=k, v=v, pos=pos,
        )
        st.active[s] = False
        st.occupant[s] = None
        # The id may come back here (a later crash of the adopter requeues it).
        st.seen_ids.discard(r.id)
        eng.release_slot(s)
        if st.held_entry[s] >= 0:
            eng.prefix_release(st.held_entry[s])
            st.held_entry[s] = -1
        if self.tracer:
            self.tracer.event("preempt", req=int(r.id), slot=s, step=st.step,
                              tokens=len(pre.generated))
        return pre

    def adopt(self, pre: PreemptedRequest) -> int:
        """Install a preempted request into a free slot of the armed run:
        its pages become fresh resident pages (``engine.load_slot_pages``)
        and its decode cursor carries over, so (the sampling key being
        ``(seed, request_id, token_index)``) its tokens equal an
        unpreempted run's. Reserves the request's worst case like an
        admission. Returns the slot."""
        st = self._require_run()
        eng = self.engine
        if not eng.paged:
            raise RuntimeError("adopt needs the paged KV layout (page_size > 0)")
        r = pre.request
        if r.id in st.seen_ids:
            raise ValueError(f"adopt: request id {r.id} already seen on this scheduler")
        slot = next((s for s in range(eng.config.slots) if st.occupant[s] is None), None)
        if slot is None:
            raise RuntimeError("adopt: no free slot on this scheduler")
        p = int(np.asarray(r.prompt).shape[0])
        need = eng.pages_needed(p + r.max_new_tokens)
        if eng.pages.available < need and not eng.reclaim_pages(need):
            raise RuntimeError(
                f"adopt: request {r.id} needs {need} pages but only {eng.pages.available} "
                "are available — the controller must check pages_available before "
                "choosing this replica")
        eng.reserve_pages(slot, need)
        eng.load_slot_pages(slot, pre.k, pre.v, pre.pos)
        st.seen_ids.add(r.id)
        st.occupant[slot] = r
        st.active[slot] = True
        st.generated[slot] = list(pre.generated)
        st.lengths[slot] = pre.lengths
        st.last_tokens[slot] = pre.last_token
        st.req_ids[slot] = r.id
        st.admitted_at[slot] = pre.admitted_at
        st.prefilled[slot] = p
        st.store_after[slot] = False
        st.held_entry[slot] = -1
        st.eligible_wall[r.id] = pre.eligible_wall
        st.deadlines_on = st.deadlines_on or (r.ttft_deadline_s is not None
                                              or r.deadline_s is not None)
        if self.tracer:
            self.tracer.event("resume", req=int(r.id), slot=slot, step=st.step,
                              tokens=len(pre.generated))
        return slot

    def abandon(self) -> tuple[dict[int, Completion], list[Request], list[Request]]:
        """Crash harvest: the armed run's completions, the requests resident
        in slots (their device state lost) and the queued ones; disarms
        WITHOUT touching the engine, which the caller discards whole."""
        st = self._require_run()
        inflight = [r for r in st.occupant if r is not None]
        queued = list(st.pending)
        done = dict(st.done)
        self._st = None
        return done, inflight, queued

    def collect(self) -> tuple[dict[int, Completion], ServeStats]:
        """Finalize the armed run: ``(completions, stats)`` as :meth:`run`
        returns them, the run-total prefix counters flushed into the
        registry. Disarms the run."""
        st = self._require_run()
        latency = st.decode_timer.stats()
        if self.registry is not None:
            reg = self.registry
            reg.counter("serve_prefix_lookups_total").inc(st.lookups)
            reg.counter("serve_prefix_hits_total").inc(st.hits)
            reg.counter("serve_prefill_tokens_saved_total").inc(st.saved)
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
        pages_held = int(eng.table_len[s]) if eng.paged else 0
        if eng.paged:
            # Completion and eviction are the same bookkeeping: page
            # references drop and any unused reservation returns.
            eng.release_slot(s)
        if st.held_entry[s] >= 0:
            eng.prefix_release(st.held_entry[s])
            st.held_entry[s] = -1
        if self.tracer:
            self.tracer.event("complete", req=int(r.id), slot=s, step=st.step,
                              tokens=len(st.generated[s]), status=status,
                              kv_pages_held=pages_held)
        if self.registry is not None:
            self.registry.counter("serve_deadline_exceeded_total" if status == "deadline_exceeded"
                                  else "serve_requests_completed_total").inc()

    def _expire_queued(self, st: _RunState, r: Request, status: str) -> None:
        """Remove a never-admitted request from the queue with a structured
        outcome (shed, or expired while waiting)."""
        st.pending.remove(r)
        st.done[r.id] = Completion(
            id=r.id, prompt_len=int(np.asarray(r.prompt).shape[0]), tokens=[],
            admitted_step=-1, finished_step=st.step, status=status,
        )
        if self.tracer:
            self.tracer.event(status, req=int(r.id), step=st.step)
        if self.registry is not None:
            self.registry.counter("serve_shed_total" if status == "shed"
                                  else "serve_deadline_exceeded_total").inc()

    def _finished(self, st: _RunState, s: int, token: int) -> bool:
        return (len(st.generated[s]) >= st.occupant[s].max_new_tokens
                or (self.eos_id is not None and token == self.eos_id))

    def _speculate_decode(self, st: _RunState, step: int):
        """The speculative decode phase, JAX's ``_speculate_decode``: still
        ONE batched decode call a tick, but FREE slots become draft LANES.
        Lane ``i`` aliases the speculating slot's pages
        (``engine.alias_slot_pages``, incref only), feeds draft token ``i``
        at position ``n + 1 + i``, and its returned greedy token is the
        model's own token for that position (a slot's decode row does not
        depend on the other slots). Greedy-accept keeps the longest matching
        draft prefix plus the first mismatch (the true next token), so the
        output equals plain decode's; rejected lanes leave rows only beyond
        the new frontier, position-masked and overwritten by the next step
        that reaches them. Returns ``(decode_s, itl_s, mfu)`` for the tick's
        anomaly signals."""
        eng = self.engine
        cfg = eng.config
        S = cfg.slots
        reg = self.registry
        k = cfg.speculate_k
        last = st.last_tokens.copy()
        lengths = st.lengths.copy()
        req_ids = st.req_ids.copy()
        active = st.active.copy()
        free = [s for s in range(S) if st.occupant[s] is None]
        lanes_of: dict[int, tuple[list[int], np.ndarray]] = {}
        proposed = 0
        for s in range(S):
            if not st.active[s] or not free:
                continue
            r = st.occupant[s]
            remaining = r.max_new_tokens - len(st.generated[s])
            if remaining < 2:
                # One token to go: a draft could only propose tokens the
                # budget forbids emitting.
                continue
            prompt = np.asarray(r.prompt, np.int32)
            ctx = np.concatenate([prompt, np.asarray(st.generated[s], np.int32)])
            draft = propose_draft(ctx, min(k, remaining - 1, len(free)),
                                  method=cfg.speculate_method, prompt_len=int(prompt.shape[0]))
            if not draft.size:
                continue  # no lookup hit: this slot rides plain
            n = int(st.lengths[s])
            lanes = free[: draft.size]
            del free[: draft.size]
            for i, lane in enumerate(lanes):
                # Covers row n + draft.size of the source: the decode's own
                # _ensure_rows of each lane (row n + 1 + i) maps nothing new.
                eng.alias_slot_pages(lane, s, n + int(draft.size) + 1)
                active[lane] = True
                last[lane] = int(draft[i])
                lengths[lane] = n + 1 + i
                req_ids[lane] = r.id
            lanes_of[s] = (lanes, draft)
            proposed += int(draft.size)
        n_active = int(st.active.sum())
        n_lanes = sum(len(lanes) for lanes, _ in lanes_of.values())
        # The REAL slots that decode (lanes are compute, not requests),
        # taken before finishes change the occupancy.
        reqs_now = [int(st.req_ids[i]) for i in range(S) if st.active[i]]
        t0 = time.perf_counter()
        nxt, _ = eng.decode(last, lengths, req_ids, active)
        # Read after decode's fetch of the sampled tokens, which waits for
        # the device.
        now = time.perf_counter()
        dt = now - t0
        # Lane teardown is a pure decref, done before any bookkeeping so no
        # later raise can leak an aliased table.
        for lanes, _ in lanes_of.values():
            for lane in lanes:
                eng.release_slot(lane)
        emitted_total = 0
        accepted_total = 0
        for s in range(S):
            if not st.active[s]:
                continue
            lanes, draft = lanes_of.get(s, (None, None))
            if lanes is None:
                # No draft: the slot's own decode row advanced it one token.
                st.lengths[s] += 1
                tok = int(nxt[s])
                st.generated[s].append(tok)
                st.last_tokens[s] = tok
                emitted_total += 1
                if self._finished(st, s, tok):
                    self._finish(st, s)
                continue
            # verified[0] is the slot's own next token, verified[1 + i] lane
            # i's: the model's greedy answer at each position.
            verified = [int(nxt[s])] + [int(nxt[lane]) for lane in lanes]
            a = greedy_accept(draft, verified)
            emitted = 0
            for tok in verified[: a + 1]:
                st.lengths[s] += 1
                st.generated[s].append(tok)
                st.last_tokens[s] = tok
                emitted += 1
                if self._finished(st, s, tok):
                    self._finish(st, s)
                    break  # eos or the budget truncates the rest of the block
            emitted_total += emitted
            # Only drafts actually EMITTED count as accepted.
            accepted_total += min(a, emitted)
        st.decode_timer.add(dt, images=emitted_total)
        # Lanes compute at the attended width whether or not their draft is
        # accepted: the MFU numerator prices real and lane rows.
        itl_s, mfu_val = self._account_decode(
            st, step, t0, now, dt, emitted_total, n_active + n_lanes, n_active=n_active,
            reqs=reqs_now, spec_lanes=n_lanes, spec_emitted=emitted_total)
        if reg is not None and proposed:
            # Accepted over proposed is the rate that says whether k paid.
            reg.counter("speculate_proposed_total").inc(proposed)
            reg.counter("speculate_accepted_total").inc(accepted_total)
        return dt, itl_s, mfu_val

    def _account_decode(self, st: _RunState, step: int, t0: float, now: float, dt: float,
                        tokens: int, fed_rows: int, **span):
        """The accounting every decode tick shares, plain or speculative:
        the ITL chain (the gap since the previous decode completion,
        interleaved prefill work included), goodput, the ``decode_tick``
        span (``span`` holds its attributes) and the decode metrics.
        ``tokens`` were emitted by ``fed_rows`` rows computed in ``dt``.
        Returns ``(itl_s, mfu)``, each None where not taken."""
        chained = st.last_decode_done is not None
        itl_s = mfu_val = None
        if chained:
            st.itls.append(now - st.last_decode_done)
            itl_s = st.itls[-1]
        st.last_decode_done = now
        if self._goodput is not None:
            self._goodput.add("decode", dt)
        if self.tracer:
            # The end stamp is the ITL clock's `now`; `reqs` lists the
            # requests that decoded (the per-request ITL derivation).
            self.tracer.complete("decode_tick", t0, now, step=step, chained=chained, **span)
        reg = self.registry
        if reg is not None:
            cfg = self.engine.config
            reg.counter("serve_decode_tokens_total").inc(tokens)
            reg.histogram("serve_decode_step_seconds").observe(dt)
            if chained:
                reg.histogram("serve_itl_seconds").observe(st.itls[-1])
            # Per-token FLOPs at the width this tick attended, and the MFU of
            # the decode just timed.
            fpt = _cost.serve_decode_flops_per_token(cfg.spec, self.engine.last_attend_width)
            reg.gauge("serve_flops_per_token").set(fpt)
            mfu_val = _cost.mfu(
                _cost.serve_speculate_verify_flops(cfg.spec, fed_rows,
                                                   self.engine.last_attend_width),
                dt, cfg.tensor_parallel, self._resolve_peak())
            reg.gauge("serve_mfu").set(mfu_val)
        return itl_s, mfu_val

    def tick(self) -> None:
        """One scheduler step of the armed run: stamp eligibility, shed and
        expire, admit into free slots, prefill under the chunk budget, one
        batched decode, the per-tick gauges. An idle tick makes no device
        calls."""
        st = self._require_run()
        eng = self.engine
        cfg = eng.config
        S = cfg.slots
        tr = self.tracer
        reg = self.registry
        inj = self.injector
        # Goodput: the tick is bracketed; the device sub-brackets (the SAME
        # StepTimer values the histograms observe) are attributed as they
        # close and the residual lands in host or idle at end_tick.
        gp = self._goodput
        if gp is not None:
            gp.begin_tick()
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
                if (self.shed_threshold is not None and outstanding >= self.shed_threshold
                        and not r.shed_exempt):
                    shed_now.append(r)
                    continue
                st.eligible_wall[r.id] = now
                outstanding += 1
                if tr:
                    # The same `now` the TTFT clock starts from.
                    tr.event("eligible", t=now, req=int(r.id), step=step)
        t_shed0 = (time.perf_counter() if gp is not None and (shed_now or st.deadlines_on)
                   else None)
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
        if t_shed0 is not None:
            gp.add("shed", time.perf_counter() - t_shed0, work=False)
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
            if tr:
                tr.event("admit", req=int(r.id), slot=s, step=step)
            if eng.prefix is not None:
                st.lookups += 1
                if hit >= MIN_PREFIX_HIT:
                    timed = tr or gp is not None
                    t0 = time.perf_counter() if timed else 0.0
                    copied = eng.prefix_fetch(entry, hit, s)
                    t1 = time.perf_counter() if timed else 0.0
                    if gp is not None:
                        gp.add("prefix_copy", t1 - t0)
                    if tr:
                        # Paged: copied_rows is the CoW partial tail page only.
                        tr.complete("prefix_map" if eng.paged else "prefix_copy", t0, t1,
                                    req=int(r.id), slot=s, rows=hit, copied_rows=int(copied))
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
            if inj is not None and inj.stalls(r.id):
                continue  # an injected stall: its deadline must evict it
            prompt = np.asarray(r.prompt, np.int32)
            p = int(prompt.shape[0])
            while st.prefilled[s] < p:
                todo = p - int(st.prefilled[s])
                n = todo if not chunk else min(chunk, todo)
                if budget0 and budget < n:
                    break  # out of tick budget; resume next tick
                base = int(st.prefilled[s])
                t0 = time.perf_counter() if tr else 0.0
                with st.prefill_timer.step(images=n):
                    tok, _ = eng.prefill(prompt[base:base + n], slot=s, request_id=r.id,
                                         base=base)
                if tr:
                    tr.complete("prefill_chunk", t0, time.perf_counter(), req=int(r.id),
                                slot=s, base=base, n=n)
                if gp is not None:
                    gp.add("prefill", st.prefill_timer._times[-1])
                if reg is not None:
                    reg.counter("serve_prefill_tokens_total").inc(n)
                    reg.histogram("serve_prefill_seconds").observe(st.prefill_timer._times[-1])
                    # The compiled bucket's rows over the cache-wide attend
                    # span, per real token (padding computes too).
                    reg.gauge("serve_prefill_flops_per_token").set(
                        _cost.serve_prefill_flops(cfg.spec, eng.prefill_bucket(n),
                                                  cfg.capacity) / n)
                st.prefilled[s] += n
                prefilled_any = True
                st.lengths[s] = st.prefilled[s]  # see the admission comment
                if budget0:
                    budget -= n
                if base + n == p:  # prompt complete: first token
                    if eng.prefix is not None and st.store_after[s]:
                        stored = eng.prefix_store(prompt, s)
                        if tr and stored:
                            tr.event("prefix_store", req=int(r.id), slot=s, rows=p)
                    st.active[s] = True
                    st.lengths[s] = p
                    st.last_tokens[s] = tok
                    st.req_ids[s] = r.id
                    st.generated[s] = [tok]
                    t_first = time.perf_counter()
                    st.ttfts.append(t_first - st.eligible_wall[r.id])
                    if tr:
                        # The same t_first as the TTFT sample above.
                        tr.event("first_token", t=t_first, req=int(r.id), slot=s, step=step)
                    if reg is not None:
                        reg.histogram("serve_ttft_seconds").observe(st.ttfts[-1])
                    if self._finished(st, s, tok):
                        self._finish(st, s)
                    break
        decode_s = itl_s = mfu_val = None
        if st.active.any() and self.role == "prefill":
            # First-token slots are HELD for the fleet's page hand-off: a
            # prefill replica never decodes, and a held tick makes no
            # device call.
            st.last_decode_done = None
        elif st.active.any() and cfg.speculate_k:
            decode_s, itl_s, mfu_val = self._speculate_decode(st, step)
        elif st.active.any():
            n_active = int(st.active.sum())
            t0 = time.perf_counter() if tr else 0.0
            with st.decode_timer.step(images=n_active):
                nxt, _ = eng.decode(st.last_tokens, st.lengths, st.req_ids, st.active)
            # Read after decode's fetch of the sampled tokens, which waits
            # for the device.
            now = time.perf_counter()
            decode_s = st.decode_timer._times[-1]
            itl_s, mfu_val = self._account_decode(
                st, step, t0, now, decode_s, n_active, n_active, n_active=n_active,
                reqs=[int(st.req_ids[i]) for i in range(S) if st.active[i]])
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
                # Only stalled or expiring work remains: yield the host
                # briefly instead of spinning until a deadline passes.
                time.sleep(0.0005)
        if reg is not None:
            depth = 0
            for q in st.pending:  # (arrival, id)-sorted: early break
                if q.arrival > step:
                    break
                depth += 1
            reg.gauge("serve_queue_depth").set(depth)
            reg.gauge("serve_active_slots").set(int(st.active.sum()))
            reg.gauge("serve_occupied_slots").set(sum(o is not None for o in st.occupant))
            if eng.prefix is not None:
                reg.gauge("serve_prefix_pool_entries").set(len(eng.prefix))
            if eng.paged:
                reg.gauge("serve_kv_pages_free").set(eng.pages.free)
                reg.gauge("serve_kv_pages_shared").set(eng.pages.shared)
            if self._mem is not None:
                self._mem.sample()
            if self.metrics_writer is not None:
                # Rate-limited inside: the gauges' history lands in the JSONL.
                self.metrics_writer.maybe_flush()
        if self.anomaly is not None:
            # Its registry is the scheduler's (checked at construction), so
            # `depth` is bound. The host-state signals are functions of the
            # tick clock; the wall-clock ones ride along.
            vals: dict = {"queue_depth": depth, "active_slots": int(st.active.sum()),
                          "occupied_slots": sum(o is not None for o in st.occupant)}
            if eng.paged:
                vals["pages_free"] = int(eng.pages.free)
            if decode_s is not None:
                vals["step_time"] = decode_s
                if mfu_val is not None:
                    vals["mfu"] = mfu_val
            if itl_s is not None:
                vals["itl"] = itl_s
            self.anomaly.tick(vals)
        if self.slo_monitor is not None:
            self.slo_monitor.tick()
        if gp is not None:
            gp.end_tick()
        st.step = step + 1
        if all(o is None for o in st.occupant) and st.pending:
            # Jump an idle gap straight to the next arrival.
            st.step = max(st.step, st.pending[0].arrival)


def request_slo_samples(records) -> dict[int, tuple[float, list[float]]]:
    """Per-request SLO samples from a run's tracer records:
    ``{request_id: (ttft_seconds, [itl_seconds, ...])}``. TTFT is
    ``first_token.t - eligible.t``; the ITL stream is the gaps between the
    request's token times (its ``first_token`` stamp, then the end stamp of
    every ``decode_tick`` whose ``reqs`` lists it). Requests that never
    reached a first token are absent. The shared substrate of the grouped
    :func:`derive_request_slo` and the router's per-class accounting."""
    eligible: dict[int, float] = {}
    first: dict[int, float] = {}
    token_times: dict[int, list[float]] = {}
    for rec in records:
        name = rec.get("name")
        attrs = rec.get("attrs", {})
        if name == "eligible":
            eligible.setdefault(attrs["req"], rec["t"])
        elif name == "first_token":
            rid = attrs["req"]
            first[rid] = rec["t"]
            token_times.setdefault(rid, []).append(rec["t"])
        elif name == "decode_tick":
            for rid in attrs.get("reqs", ()):
                token_times.setdefault(rid, []).append(rec["t"])
    out: dict[int, tuple[float, list[float]]] = {}
    for rid, t1 in first.items():
        ts = token_times[rid]
        out[rid] = (t1 - eligible[rid], [b - a for a, b in zip(ts, ts[1:])])
    return out


def derive_request_slo(records, group_by=None):
    """SLO stats derived purely from a run's tracer records.

    ``group_by=None``: the run-global ``(ttft, itl)`` ``StepStats`` pair,
    EXACTLY equal (the same floats) to the run's ``ServeStats.ttft`` /
    ``.itl``: TTFT is ``first_token.t - eligible.t`` per request, ITL the
    gap between consecutive ``decode_tick`` end stamps whose later tick is
    ``chained``. ``group_by`` (a dict or callable: request id -> label,
    None drops it): ``{label: (ttft, itl)}`` pooling the members'
    :func:`request_slo_samples`; a group with no first token is absent."""
    if group_by is None:
        eligible: dict[int, float] = {}
        ttfts: list[float] = []
        itls: list[float] = []
        prev: float | None = None
        for rec in records:
            name = rec.get("name")
            attrs = rec.get("attrs", {})
            if name == "eligible":
                eligible.setdefault(attrs["req"], rec["t"])
            elif name == "first_token":
                ttfts.append(rec["t"] - eligible[attrs["req"]])
            elif name == "decode_tick":
                if attrs.get("chained") and prev is not None:
                    itls.append(rec["t"] - prev)
                prev = rec["t"]
        return StepStats.from_times(ttfts), StepStats.from_times(itls)
    key_of = group_by if callable(group_by) else group_by.get
    grouped: dict[object, tuple[list[float], list[float]]] = {}
    for rid, (ttft, itls_r) in request_slo_samples(records).items():
        key = key_of(rid)
        if key is None:
            continue
        g = grouped.setdefault(key, ([], []))
        g[0].append(ttft)
        g[1].extend(itls_r)
    return {k: (StepStats.from_times(tt), StepStats.from_times(ii))
            for k, (tt, ii) in grouped.items()}
