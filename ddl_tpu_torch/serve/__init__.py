"""Serving — the port of ``ddl_tpu/serve``'s single-engine data plane:
KV-cache prefill/decode with continuous batching over the contiguous or the
paged KV pool, the prefix cache and chunked prefill, on one device.

- ``serve.cache``        — the KV caches (slot-major rings and the paged
  pool) and the host ``PagePool`` allocator
- ``serve.engine``       — ``ServeConfig`` and the bucketed prefill/decode
  ``InferenceEngine``
- ``serve.sampling``     — greedy and JAX-keyed categorical sampling
- ``serve.prefix``       — the host prefix-cache index
- ``serve.scheduler``    — continuous batching over the engine

The router, fleet controller, disaggregation, speculation, the int8 pool,
the cost-model twin (and with it the ``ServeEngine`` protocol), the
scenarios and serve observability wait for their slices (ROADMAP queue 1,
item 8).

    from ddl_tpu_torch.serve import InferenceEngine, Request, Scheduler, ServeConfig

    eng = InferenceEngine(ServeConfig(slots=4, capacity=256))
    done, stats = Scheduler(eng).run([Request(id=0, prompt=ids, max_new_tokens=64)])
"""

from .cache import KVCache, PagedKVCache, PagePool  # noqa: F401
from .engine import InferenceEngine, ServeConfig  # noqa: F401
from .prefix import PrefixIndex  # noqa: F401
from .scheduler import Completion, Pressure, Request, Scheduler, ServeStats  # noqa: F401

__all__ = [
    "Completion",
    "InferenceEngine",
    "KVCache",
    "PagePool",
    "PagedKVCache",
    "PrefixIndex",
    "Pressure",
    "Request",
    "Scheduler",
    "ServeConfig",
    "ServeStats",
]
