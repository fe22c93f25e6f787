"""Host milliseconds a sweep in point assembly: the ``sweep.assemble`` spans
(a ``SimResult`` a cell, the best thread count a latency), summed over the
sweep, median over the sweeps profiled with CUDA activity alone
(``kvsimbench.obs_frames``).  None without a card or without the spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("sweep.assemble",)


def read(ctx):
    return median_self_ms(ctx, SPANS)
