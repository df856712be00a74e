"""The serve engine interface — the port of ``ddl_tpu/serve/engine_iface.py``:
the narrow surface the control plane calls.

Every control decision of the serve stack (router placement, door shedding,
autoscale, drain, crash healing, preemption, the disagg hand-off) is host
logic on a tick clock; only the engine underneath touches the device.
:class:`ServeEngine` writes that boundary down: the attributes and methods
``Scheduler``, ``Router``, ``FleetController`` and ``DisaggCoordinator``
read, and nothing else. The contract is structural (``typing.Protocol``):
the control plane stays duck-typed and the engine needs no base class.
Two implementations:

* :class:`~ddl_tpu_torch.serve.engine.InferenceEngine` (``kind == "real"``):
  placed params, device tensors;
* :class:`~ddl_tpu_torch.serve.sim.CostModelEngine` (``kind == "sim"``): no
  tensors; the same host bookkeeping (page pool, block tables, prefix index)
  with per-phase virtual time fitted from the goodput plane.

Because every control decision reads only this surface, an engine that
satisfies it replays the same controller event timeline
(tests/test_torch_twin.py). Beyond JAX's protocol: ``handoff_bytes``, which
JAX's control plane calls and its cost-model engine lacks.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

__all__ = ["ServeEngine", "engine_kind"]


@runtime_checkable
class ServeEngine(Protocol):
    """What the control plane may touch on an engine.

    Attributes (host state the scheduler and controller read directly):

    * ``kind`` — ``"real"`` or ``"sim"``;
    * ``config`` — the :class:`~ddl_tpu_torch.serve.engine.ServeConfig`;
    * ``paged`` / ``page_size`` / ``max_pages`` / ``num_pages`` — the KV
      layout (all zero when contiguous);
    * ``pages`` — the :class:`~ddl_tpu_torch.serve.cache.PagePool` (paged);
    * ``tables`` / ``table_len`` / ``reserved_for`` — the block tables;
    * ``prefix`` — the :class:`~ddl_tpu_torch.serve.prefix.PrefixIndex` or
      ``None``; ``page_copies`` — the copy-on-write tail copies;
    * ``device`` — where the engine runs (the memory sampler and the peak
      FLOPs lookup read it; ``"cpu"`` for the cost-model engine);
    * ``compile_hook`` / ``ledger_hook`` — set by a scheduler with a
      registry;
    * ``params`` — opaque; replicas share one tree via ``placed_params``;
    * ``last_attend_width`` — rows the last decode attended.
    """

    kind: str

    # -- compute ticks ------------------------------------------------------
    def prefill(self, prompt, *, slot: int, request_id: int, base: int = 0,
                _bucket: int | None = None): ...

    def decode(self, last_tokens, lengths, request_ids, active, *,
               _pages: int | None = None): ...

    # -- shape/bucket ladders ----------------------------------------------
    def prefill_bucket(self, prompt_len: int) -> int: ...

    def decode_page_bucket(self, pages: int) -> int: ...

    # -- paged page management ---------------------------------------------
    def pages_needed(self, rows: int) -> int: ...

    def reserve_pages(self, slot: int, n: int) -> None: ...

    def reclaim_pages(self, need: int) -> bool: ...

    def release_slot(self, slot: int) -> None: ...

    # -- cross-replica hand-off (preempt / crash requeue / disagg) ----------
    def dump_slot_pages(self, slot: int): ...

    def load_slot_pages(self, slot: int, k, v, pos) -> list[int]: ...

    def alias_slot_pages(self, dst_slot: int, src_slot: int, rows: int) -> int: ...

    def handoff_bytes(self, n_pages: int) -> int: ...

    # -- prefix cache -------------------------------------------------------
    def prefix_fetch(self, entry_id: int, n: int, slot: int) -> int: ...

    def prefix_release(self, entry_id: int) -> None: ...

    def prefix_store(self, prompt, slot: int) -> bool: ...

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None: ...


def engine_kind(engine) -> str:
    """``"real"`` or ``"sim"`` for any engine object; an engine without a
    ``kind`` attribute is real."""
    return str(getattr(engine, "kind", "real"))
