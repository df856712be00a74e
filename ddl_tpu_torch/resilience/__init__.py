"""Fault tolerance for training — the port of ``ddl_tpu/resilience``.

- **Step guard** (``resilience.guard``): when a step's fully reduced
  gradients hold ANY non-finite element, the step applies the identity
  instead of the optimizer update (a ``torch.where`` over the parameter and
  optimizer-state trees, on the device, no host sync). A host-side
  ``GuardMonitor`` escalates: K consecutive skips roll the trainer back to
  the last good checkpoint and re-seed the data stream to that step.
- **Checkpoint hardening** (``utils.checkpoint``): fsync'd atomic writes,
  per-array checksum manifests, last-N retention, and
  ``find_latest_valid`` discovery that skips corrupt or truncated saves
  (``--resume auto``).
- **Deterministic fault injection** (``resilience.faults``): the seeded
  inputs that prove each recovery path.

The serving half of JAX's package (deadlines and shedding in the
scheduler) was ported with serving; the serve kinds' consumers are the
scheduler's ``injector`` (``stall``) and the fleet controller
(``replica_crash``).
"""

from .faults import (  # noqa: F401
    FaultInjector,
    FaultSpec,
    corrupt_checkpoint,
    parse_fault,
    truncate_checkpoint,
)
from .guard import GuardMonitor, apply_guard  # noqa: F401
