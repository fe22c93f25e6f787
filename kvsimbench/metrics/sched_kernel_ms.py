"""Device milliseconds of the fused scheduler kernel
(``csrc/sched_step.cu``, ``sched_step_kernel``) per sweep, summed from the
profiler's kernel events over the traced sweeps."""

KERNEL = "sched_step_kernel"


def read(ctx):
    dt = ctx["dtrace"]
    if dt is None:
        return None
    s = dt.device_seconds(KERNEL)
    return s / dt.n_sweeps * 1e3 if s > 0 else None
