"""Share of the scheduled scheduler steps the grid executed: 100 x the
program's counter ``grid.steps_run`` / ``grid.steps_bound`` (the
``GridResult`` fields ``cell_steps_run`` / ``cell_steps_bound``: steps
summed over cells, before the early exit and against each cohort's bound),
median over the sweeps profiled with CUDA activity alone
(``kvsimbench.obs_frames``).  None without a card or without the
counters."""
import statistics

from kvsimbench.obs_frames import profiled


def read(ctx):
    frames = profiled(ctx)
    if frames is None or not all(f.counters.get("grid.steps_bound")
                                 for f in frames):
        return None
    return statistics.median(100.0 * f.counters["grid.steps_run"]
                             / f.counters["grid.steps_bound"]
                             for f in frames)
