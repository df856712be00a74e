"""Serving — the port of ``ddl_tpu/serve``: KV-cache prefill/decode with
continuous batching over the contiguous or the paged KV pool, the prefix
cache and chunked prefill, and the multi-replica fleet over it.

- ``serve.cache``        — the KV caches (slot-major rings and the paged
  pool), the host ``PagePool`` allocator and the whole-page write
- ``serve.engine``       — ``ServeConfig`` and the bucketed prefill/decode
  ``InferenceEngine`` (with the page dump/load of the hand-off)
- ``serve.sampling``     — greedy and JAX-keyed categorical sampling
- ``serve.prefix``       — the host prefix-cache index
- ``serve.scheduler``    — continuous batching over the engine, driven
  whole (``run``) or tick by tick; preempt/adopt/abandon; the lifecycle
  tracer, the ``serve_*`` registry and the SLO derivation from its records
- ``serve.engine_iface`` — the ``ServeEngine`` protocol the control plane
  calls
- ``serve.router``       — the SLO-aware front door over N replicas
- ``serve.controller``   — the self-healing fleet controller (scale out and
  in, drains, crash healing, cross-replica preemption)
- ``serve.disagg``       — prefill/decode roles and the page hand-off
- ``serve.speculate``    — n-gram / prompt-lookup drafts, verified through
  free slots of the one batched decode (``ServeConfig.speculate_k``)

The paged pool stores int8 payloads with per-head fp32 scales under
``ServeConfig.kv_dtype="int8"``. The cost-model twin and its scenarios
(ROADMAP queue 1, item 8, part 7) and the serve CLI's telemetry (part 8)
wait for their slices.

    from ddl_tpu_torch.serve import InferenceEngine, Request, Scheduler, ServeConfig

    eng = InferenceEngine(ServeConfig(slots=4, capacity=256))
    done, stats = Scheduler(eng).run([Request(id=0, prompt=ids, max_new_tokens=64)])
"""

from .cache import KVCache, PagedKVCache, PagePool  # noqa: F401
from .controller import (  # noqa: F401
    AutoscaleConfig,
    FleetController,
    RoleScale,
    parse_autoscale_spec,
)
from .disagg import (  # noqa: F401
    ROLES,
    DisaggCoordinator,
    parse_roles_spec,
    validate_roles,
)
from .engine import InferenceEngine, ServeConfig  # noqa: F401
from .engine_iface import ServeEngine, engine_kind  # noqa: F401
from .prefix import PrefixIndex  # noqa: F401
from .router import (  # noqa: F401
    ClassSpec,
    Router,
    RouterConfig,
    RouterStats,
    parse_slo_spec,
    parse_traffic_spec,
)
from .speculate import greedy_accept, propose_draft  # noqa: F401
from .scheduler import (  # noqa: F401
    Completion,
    PreemptedRequest,
    Pressure,
    Request,
    Scheduler,
    ServeStats,
    derive_request_slo,
    request_slo_samples,
)

__all__ = [
    "AutoscaleConfig",
    "ClassSpec",
    "Completion",
    "DisaggCoordinator",
    "FleetController",
    "InferenceEngine",
    "KVCache",
    "PagePool",
    "PagedKVCache",
    "PreemptedRequest",
    "PrefixIndex",
    "Pressure",
    "ROLES",
    "Request",
    "RoleScale",
    "Router",
    "RouterConfig",
    "RouterStats",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "ServeStats",
    "derive_request_slo",
    "engine_kind",
    "greedy_accept",
    "parse_autoscale_spec",
    "parse_roles_spec",
    "parse_slo_spec",
    "parse_traffic_spec",
    "propose_draft",
    "request_slo_samples",
    "validate_roles",
]
