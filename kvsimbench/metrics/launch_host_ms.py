"""Host milliseconds a sweep in kernel launches: the ``grid.launch`` spans
(each ``fused_steps_group`` call: its argument block and the ctypes call),
summed over the sweep, median over the sweeps profiled with CUDA activity
alone (``kvsimbench.obs_frames``).  None without a card or without the
spans."""
from kvsimbench.obs_frames import median_self_ms

SPANS = ("grid.launch",)


def read(ctx):
    return median_self_ms(ctx, SPANS)
