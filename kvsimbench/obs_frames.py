"""The program's recorded sweeps (``repro_torch.obs``) as the readers of
its spans and counters take them: the frames of the sweeps profiled with
CUDA activity alone, the first ``n_sweeps`` a ``--trace 1`` run records
(the profile with host activity, which slows the host, comes after them).
"""
import statistics


def profiled(ctx):
    """Those frames; None without a card, without the program's spans (a
    program with no ``repro_torch.obs``) or with fewer frames."""
    dt = ctx["dtrace"]
    if dt is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    frames = obs.frames()[:dt.n_sweeps]
    return frames if len(frames) == dt.n_sweeps else None


def median_self_ms(ctx, spans):
    """Median over those frames of the self ms of ``spans``, summed."""
    frames = profiled(ctx)
    if frames is None:
        return None
    from repro_torch import obs
    return statistics.median(sum(obs.self_ms(f, s) for s in spans)
                             for f in frames)
