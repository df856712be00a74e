"""Observability — the port of ``ddl_tpu/obs``. Only the two counts the
non-finite step guard needs are ported (``health.py``); the registry,
tracer, goodput, cost, memory, comms, SLO and anomaly planes are ROADMAP
queue 1, item 7."""
