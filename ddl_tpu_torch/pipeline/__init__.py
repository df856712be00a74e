"""Pipeline parallelism for the LM — the port of ``ddl_tpu/pipeline``: the
layer stack split into contiguous stages over the grid's pp axis
(``parallel/mesh.py::make_grid``), microbatches streamed through them by
GPipe or 1F1B tick tables, activations (and cotangents on the backward)
handed stage to stage by point-to-point sends (``collectives.stage_hop``).

- ``schedule``: the tick tables, the in-flight buffer sizes they imply and
  the analytic bubble, identical to JAX's.
- ``step``: the train step (a manual backward recomputed from each saved
  stage input) and the forward-only eval, on one rank's row of the tables.
- ``trainer``: the builders ``SeqTrainer`` and the standalone
  :func:`make_pipeline_program` use.
"""

from .schedule import (  # noqa: F401
    IDLE,
    buffer_slots,
    bubble_fraction,
    max_in_flight,
    predicted_bubble,
    schedule_tables,
)
from .trainer import make_pipeline_program  # noqa: F401
