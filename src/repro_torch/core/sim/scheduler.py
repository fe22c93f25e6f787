"""Thread/core scheduling state: FIFO ready rings and the parked-thread heap.

The paper's execution model is N user-level threads per core on a strict
FIFO ready ring, one context switch (T_sw) charged per suboperation yield,
and threads parked off-core while their asynchronous IO is in flight.  This
module holds those data structures; :mod:`.engine_loop` drives them.

Division of labour with :mod:`.devices`: the scheduler owns *where a thread
is* (on a ready ring, or in the parked heap keyed by its IO completion
time), the device layer owns *when things finish* (prefetch completions and
the per-device SSD token clocks).  The two meet at exactly two points --
a PREIO suboperation parks its thread until ``SSDClocks.submit`` says the
IO completes (on whichever SSD the round-robin stripe placed it), and a MEM
suboperation stalls its thread until ``PrefetchUnit.issue``'s completion
time.  Per-core state (ready ring, prefetch unit) is private to the core;
the parked heap and the SSD clocks are shared across all cores, which is
what makes multi-device IOPS an aggregate, machine-wide resource.
"""
from __future__ import annotations

import heapq
from collections import deque

from .devices import PrefetchUnit

__all__ = ["Thread", "Core", "ParkedHeap"]


class Thread:
    """One user-level thread: its current op (as subop cursor) + prefetch."""

    __slots__ = ("tid", "subops", "idx", "pf_ready", "op_start", "wake")

    def __init__(self, tid: int):
        self.tid = tid
        self.subops: tuple[tuple[int, float], ...] = ()
        self.idx = 0
        self.pf_ready = 0.0   # completion time of the prefetch for subops[idx]
        self.op_start = 0.0
        self.wake = 0.0


class Core:
    """One core: local clock, FIFO ready ring, and its prefetch unit."""

    __slots__ = ("now", "ready", "prefetch", "idle")

    def __init__(self):
        self.now = 0.0
        self.ready: deque[Thread] = deque()
        self.prefetch = PrefetchUnit()
        self.idle = 0.0


class ParkedHeap:
    """Threads waiting on IO completion, ordered by wake time.

    Entries are ``(wake_time, seq, core_id, thread)``; ``seq`` breaks ties
    FIFO so scheduling is deterministic.
    """

    __slots__ = ("heap", "_seq")

    def __init__(self):
        self.heap: list[tuple[float, int, int, Thread]] = []
        self._seq = 0

    def __bool__(self) -> bool:
        return bool(self.heap)

    def park(self, wake: float, cid: int, th: Thread) -> None:
        self._seq += 1
        heapq.heappush(self.heap, (wake, self._seq, cid, th))

    def next_wake(self) -> float:
        return self.heap[0][0]

    def wake_until(self, t: float, cores) -> None:
        """Move every thread whose IO completed by ``t`` back onto its
        core's ready ring (FIFO append, wake-time order)."""
        heap = self.heap
        while heap and heap[0][0] <= t:
            _, _, cid, th = heapq.heappop(heap)
            cores[cid].ready.append(th)

    def earliest_for(self, cid: int) -> float | None:
        """Earliest wake time among this core's parked threads, if any."""
        mine = [e[0] for e in self.heap if e[2] == cid]
        return min(mine) if mine else None
