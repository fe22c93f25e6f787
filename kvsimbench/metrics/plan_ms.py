"""Milliseconds of ``replay_torch.plan_grid`` on the cell's grid (trace
lowered to the device, cohorts laid out, initial states and draws), by the
host clock from the call to the end of a ``torch.cuda.synchronize()``:
the median of the run's calls."""
import statistics


def read(ctx):
    spans = ctx["spans"].get("plan_grid")
    return statistics.median(spans) * 1e3 if spans else None
