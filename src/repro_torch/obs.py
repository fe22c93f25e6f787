"""Spans and counters of the sweep path, on the profiler's clock.

Off by default: :func:`span` returns one shared null context (no allocation,
no clock reading, no device synchronisation) and :func:`count` returns.
Recording is on inside :func:`recording` and while a ``torch.profiler``
session is active.  A span then records ``(name, start_ns, end_ns, parent,
sweep)`` by ``time.perf_counter_ns()`` into the open sweep's :class:`Frame`
(a ``root`` span opens one; the last :data:`FRAMES` are kept), its parent
from this thread's stack; under the profiler it also enters
``record_function(name)``, a ``user_annotation`` on the clock of the
kernels.  Outside an open sweep a span is the null context, profiler or
not, so callers of the grid alone (the fleet, the split benches) profile
as they would without this module.

    with obs.recording():
        sweep_latency(cfg, trace, latencies, threads)
    frame = obs.frames()[-1]
    obs.self_ms(frame, "grid.launch"), frame.counters["grid.steps_run"]
"""
from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

FRAMES = 64                #: sweeps the buffer keeps
_NULL = contextlib.nullcontext()
_frames: deque = deque(maxlen=FRAMES)
_lock = threading.Lock()
_tls = threading.local()
_on = 0                    # open recording() blocks
_open = None               # the frame of the open root span
_sweeps = 0                # sweep ids handed out
_enabled = None            # torch's profiler-state query, once torch is in


def _profiling() -> bool:
    global _enabled
    if _enabled is None:   # no profiler runs before torch is imported
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _enabled = torch._C._autograd._profiler_enabled
    return _enabled()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int            # index of the parent in the frame's spans, or -1
    sweep: int


@dataclass
class Frame:
    """One sweep: its spans in the order they opened, and its counters."""
    sweep: int
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class _Span:
    __slots__ = ("name", "root", "frame", "idx", "parent", "prev", "rf",
                 "start")

    def __init__(self, name: str, root: bool):
        self.name, self.root, self.rf, self.idx = name, root, None, -1

    def __enter__(self):
        global _open, _sweeps
        stack, self.parent = _stack(), -1
        if self.root:
            with _lock:
                _sweeps += 1
                self.frame = Frame(_sweeps)
            _frames.append(self.frame)
            self.prev, _open = _open, self.frame
        elif stack:
            self.frame, self.parent = stack[-1]
        else:
            self.frame = _open
        with _lock:
            self.idx = len(self.frame.spans)
            self.frame.spans.append(None)
        stack.append((self.frame, self.idx))
        # An annotation's cost falls inside its own span, not in the
        # parent's self time; a root's falls outside the sweep.
        self.start = time.perf_counter_ns()
        if _profiling():
            from torch.autograd.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
            if self.root:
                self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _open
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            if not self.root:
                end = time.perf_counter_ns()
        _stack().pop()
        self.frame.spans[self.idx] = Span(
            self.name, self.start, end, self.parent, self.frame.sweep)
        if self.root:
            _open = self.prev
        return False


def span(name: str, root: bool = False):
    """A context manager timing ``name`` inside the open sweep;
    ``root=True`` opens a sweep while recording is on."""
    if root:
        return _Span(name, True) if _on or _profiling() else _NULL
    return _NULL if _open is None else _Span(name, False)


def rooted(name: str):
    """Decorator: every call of the function runs inside ``span(name,
    root=True)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, root=True):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the open sweep's counter ``name``."""
    if _open is None:
        return
    stack = _stack()
    frame = stack[-1][0] if stack else _open
    with _lock:
        frame.counters[name] = frame.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside this block, profiler or not."""
    global _on
    _on += 1
    try:
        yield
    finally:
        _on -= 1


def frames() -> list:
    """The recorded sweeps, oldest first."""
    return list(_frames)


def self_ms(frame: Frame, name: str) -> float:
    """Milliseconds in ``frame``'s spans called ``name``, less what their
    child spans cover."""
    own = {i: s.end_ns - s.start_ns for i, s in enumerate(frame.spans)
           if s is not None and s.name == name}
    for s in frame.spans:
        if s is not None and s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return sum(own.values()) * 1e-6


def clear() -> None:
    """Forget every recorded sweep."""
    _frames.clear()
