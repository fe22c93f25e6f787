"""Share of the traced window in which no kernel, copy or memset runs on
the card: 1 - the device's busy seconds / the window's seconds, both from
the profiler's trace of six sweeps with CUDA activity alone (the
``busy_s`` and ``window_s`` of the result's ``device``).  The profiler's
work on every launch slows the host's side of a traced sweep, so this
share reads somewhat above that of an untraced sweep; the result line's
``window`` gives both sweeps' mean walls, for that gap."""


def read(ctx):
    dt = ctx["dtrace"]
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
