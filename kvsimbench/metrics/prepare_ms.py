"""Host milliseconds a sweep in the program's front end: the self times of
its ``sweep.prepare`` spans (the source coerced, the arrival stream drawn, a
configuration a cell, the cache probe, the grid's latency rows), median over
the sweeps profiled with CUDA activity alone (``kvsimbench.obs_frames``).
None without a card or without the spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("sweep.prepare",)


def read(ctx):
    return median_self_ms(ctx, SPANS)
