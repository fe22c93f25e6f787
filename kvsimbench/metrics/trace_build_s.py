"""Seconds of the program's engine walk in set-up: the engine built and
the workload replayed through it (``core.engines.run_trace``), by the host
clock around the two calls."""


def read(ctx):
    spans = ctx["spans"].get("trace_build")
    return spans[0] if spans else None
