"""Counter-based uniform draws of one grid cell (splitmix64), in Python
integers.

Every uniform the scheduler consumes is a hash of ``(seed, the cell's
stream id, purpose, counter)``: the stream id is the CRC-32 of the cell's
``(latency, threads)`` packed as ``<dq``; purpose 0 draws the trace cursor's
start, purpose 2 each thread's two start-up draws, purpose 1 the step
uniforms, ``n_u`` of them at counters ``4 * step + j``.  A uniform is the
top 53 bits of the hash over ``2**53``.
"""
from __future__ import annotations

import struct
import zlib

M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
MUL1 = 0xBF58476D1CE4E5B9
MUL2 = 0x94D049BB133111EB


def mix(z: int) -> int:
    z = (z + GOLDEN) & M64
    z = ((z ^ (z >> 30)) * MUL1) & M64
    z = ((z ^ (z >> 27)) * MUL2) & M64
    return z ^ (z >> 31)


def unit(bits: int) -> float:
    return (bits >> 11) * (2.0 ** -53)


def stream_id(latency: float, threads: int) -> int:
    return zlib.crc32(struct.pack("<dq", float(latency), int(threads)))


class CellDraws:
    def __init__(self, seed: int, latency: float, threads: int):
        self.key = mix(mix(int(seed) & M64) ^ stream_id(latency, threads))
        self.step_key = mix((self.key + 1) & M64)

    def cursor(self) -> float:
        return unit(mix(mix(self.key)))

    def thread(self, tid: int, j: int) -> float:
        kt = mix((mix((self.key + 2) & M64) + tid) & M64)
        return unit(mix((kt + j) & M64))

    def step(self, step: int, j: int) -> float:
        return unit(mix(self.step_key ^ mix(4 * step + j)))
