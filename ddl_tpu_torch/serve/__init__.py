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

- ``serve.sim``         — the cost-model engine of the digital twin
  (``CostModel``, ``CostModelEngine``, ``sim_engine_factory``): the real
  control plane over host bookkeeping and virtual time, no device
- ``serve.scenarios``   — six seeded fleet scenarios and their
  ``NAME[:key=value,...]`` grammar

The paged pool stores int8 payloads with per-head fp32 scales under
``ServeConfig.kv_dtype="int8"``. The scheduler and router take JAX's live
telemetry (metrics writer, SLO monitor, anomaly detector, ``peak_flops``)
and the controller its ``burn=`` rules.

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
from .sim import CostModel, CostModelEngine, sim_engine_factory  # noqa: F401
from .speculate import greedy_accept, propose_draft  # noqa: F401
from .scenarios import SCENARIOS, Scenario, get_scenario, parse_scenario  # noqa: F401
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
    "CostModel",
    "CostModelEngine",
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
    "SCENARIOS",
    "Scenario",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "ServeStats",
    "derive_request_slo",
    "engine_kind",
    "get_scenario",
    "greedy_accept",
    "parse_autoscale_spec",
    "parse_roles_spec",
    "parse_scenario",
    "parse_slo_spec",
    "parse_traffic_spec",
    "propose_draft",
    "request_slo_samples",
    "sim_engine_factory",
    "validate_roles",
]
