"""Host milliseconds a sweep in blocking device reads: the ``grid.exit_read``
spans (the early exit's flags) and ``grid.readback`` (the result planes),
summed over the sweep, median over the sweeps profiled with CUDA activity
alone (``kvsimbench.obs_frames``).  None without a card or without the
spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("grid.exit_read", "grid.readback")


def read(ctx):
    return median_self_ms(ctx, SPANS)
