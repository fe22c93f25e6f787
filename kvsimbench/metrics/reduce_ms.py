"""Host milliseconds a sweep in the percentile reduction: the self time of
``grid.reduce`` (``sweep_grid``'s scatter into the result planes and the
histograms' percentiles), median over the sweeps profiled with CUDA activity
alone (``kvsimbench.obs_frames``).  None without a card or without the
spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("grid.reduce",)


def read(ctx):
    return median_self_ms(ctx, SPANS)
