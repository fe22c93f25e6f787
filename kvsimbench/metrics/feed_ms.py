"""Host milliseconds a sweep in the uniform feed: the ``grid.feed`` spans
(``cohort_uniforms``, once a chunk), summed over the sweep, median over the
sweeps profiled with CUDA activity alone (``kvsimbench.obs_frames``).  None
without a card or without the spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("grid.feed",)


def read(ctx):
    return median_self_ms(ctx, SPANS)
