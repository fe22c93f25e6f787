"""The device trace of a few sweeps: ``torch.profiler`` over CPU and CUDA
activity, read back from its Chrome-format export.

Device activity is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
event; the traced window runs from the start of the first sweep's span to
the end of the last one's (each ends in ``torch.cuda.synchronize()``), or,
where only CUDA activity was recorded, the host clock's length of the
sweeps, ending at the last device event.  An
idle stretch of the device is named by what the host was doing at its
midpoint: the innermost host event (a PyTorch operator or a CUDA runtime
call) around it, ``python`` when only the sweep's own span is, and
``between sweeps`` when none is.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

SPAN = "kvsimbench.sweep"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class DeviceTrace:
    window: tuple            # (start, end) in microseconds
    device: list             # (name, start, end), sorted by start
    host: list               # (name, start, end), sorted by start
    spans: list              # (start, end) of each sweep's span
    n_sweeps: int
    wall_s: float            # host clock over the traced sweeps

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        lo, hi = self.window
        out = []
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds(self, part: str) -> float:
        """Device seconds of the events whose name contains ``part``."""
        return sum(b - a for n, a, b in self.device if part in n) * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for name, a, b in self.device:
            tot[name[:160]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device seconds in the window, summed by what the host did."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        starts = [h[1] for h in self.host]
        longest = max((e - s for _, s, e in self.host), default=0.0)
        tot = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and starts[i] >= mid - longest:
                name, s, e = self.host[i]
                if e >= mid and (best is None or e - s < best[2] - best[1]):
                    best = (name, s, e)
                i -= 1
            if best is not None:
                name = best[0][:160]
            elif any(s <= mid <= e for s, e in self.spans):
                name = "python"
            else:
                name = "between sweeps"
            tot[name] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def trace_sweeps(sweep, ks, host: bool) -> DeviceTrace:
    """Run ``sweep(k)`` for each ``k`` under the profiler, each inside the
    span ``kvsimbench.sweep`` that ends in a device synchronisation.

    ``host=False`` records CUDA activity alone, which leaves the host's
    pace as it is: its window is the host clock around the sweeps.
    ``host=True`` records the host's operators and runtime calls too (they
    slow the host), for naming the idle stretches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in ks:
            with record_function(SPAN):
                sweep(k)
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="kvsimbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, len(ks), wall)


def parse(events, n_sweeps: int, wall_s: float) -> DeviceTrace:
    device, host, spans = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, a, b))
        elif cat == "user_annotation" and name == SPAN:
            spans.append((a, b))
        elif cat in HOST_CATS:
            host.append((name, a, b))
    device.sort(key=lambda d: d[1])
    host.sort(key=lambda h: h[1])
    if spans:
        window = (min(a for a, _ in spans), max(b for _, b in spans))
    elif device:      # CUDA activity alone: the host clock's length
        end = max(b for _, _, b in device)
        window = (end - wall_s * 1e6, end)
    else:
        raise RuntimeError("the profiler recorded neither a sweep span nor "
                           "any device activity")
    return DeviceTrace(window=window, device=device, host=host, spans=spans,
                       n_sweeps=n_sweeps, wall_s=wall_s)
