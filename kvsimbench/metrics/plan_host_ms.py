"""Host milliseconds a sweep in grid planning inside real sweeps: the self
times of ``grid.plan`` (the ``plan_grid`` call) and of its children
``grid.lower`` (the trace lowered to the device), ``grid.cohorts`` (the
cohort layout) and ``grid.init`` (each cohort's stream ids, draws and
``init_state``), which sum to the whole call (``plan_ms`` times separate
calls), median over the sweeps profiled with CUDA activity alone
(``kvsimbench.obs_frames``).  None without a card or without the spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("grid.plan", "grid.lower", "grid.cohorts", "grid.init")


def read(ctx):
    return median_self_ms(ctx, SPANS)
