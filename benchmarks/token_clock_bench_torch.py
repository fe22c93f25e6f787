"""The standalone token-clock kernel against the launch floor, on an NVIDIA GPU.

``token_clock_update`` (``src/repro_torch/kernels/token_clock.py``, kernel
``csrc/token_clock.cu``) moves about 13 KB at the scenarios' (128, 2) clock
planes, some 1000x below what any launch costs, so it is measured against
the launch itself.  At a plane shape ``(G, S)`` (default: the main path's
widest cohort, 128 cells of ``hash_index_2ssd``'s 2 devices) one process
measures:

* ``device_us``: one call's device time, CUDA events around the call queued
  behind a ``torch.cuda._sleep`` (the host has queued the call before the
  start event is reached, so the events time the device alone), the mean
  over ``REPS`` calls;
* ``host_us``: the host's time a call, ``time.perf_counter`` over
  ``HOST_CALLS`` back-to-back calls with no synchronisation inside, the
  least of ``HOST_WINDOWS`` such windows (the host is shared: a window can
  lose the core; every window is kept in ``host_us_windows``);
* ``floor_device_us`` / ``floor_host_us``: the same two of an empty kernel
  launched with the token-clock kernel's grid (built here from
  ``EMPTY_SOURCE`` under ``build/token_clock_bench/``): the launch floor;
* ``plain_device_us`` / ``plain_host_us``: the same two of the plain
  PyTorch version;
* ``kernels_per_call``: device kernels a call, from ``torch.profiler``;
* with ``--plain-step``, ``plain_step_wall_s``: the wall time of the
  port's plain-step path (``Experiment.run`` with ``use_kernel=False``),
  which launches the kernel once a step: the main path's scenario at one
  cohort (128 latencies x 8 threads), as ``chip_smoke.py`` runs it.

``--turns DIR`` runs those in a process of their own on the port under
``DIR/src`` (another checkout, e.g. the parent commit unpacked) and on this
tree, in turns: DIR, this tree, this tree, DIR.  Run from the repository
root on a machine with a CUDA device::

    PYTHONPATH=src python -m benchmarks.token_clock_bench_torch \\
        [--turns DIR] [--plain-step]

``--one`` prints one process's measurements on this tree and nothing else;
``--count`` only ``kernels_per_call``, the launches a call and the instance
(``chip_smoke.py`` runs it so: a fresh process, where the profiler sees
every kernel).

It prints one JSON object a process and writes them, with the card's name
and power limit, to ``chiprun_out/token_clock_bench.json``.  Without a CUDA
device it raises.  The module imports torch and the port, never jax or the
reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
#: calls timed on the device, each behind its own sleep
REPS = 200
#: back-to-back calls timed on the host, and windows of them
HOST_CALLS = 1000
HOST_WINDOWS = 5
#: cycles of GPU sleep in front of each device-timed call (about 0.2 ms at
#: 1.5-2 GHz, more than the host needs to queue one call)
CUSHION_CYCLES = 300_000
#: the main path's widest cohort: 128 latencies x 2 striped devices
SHAPE = (128, 2)
#: threads a block of csrc/token_clock.cu (TC_THREADS)
THREADS = 128
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
_EMPTY = []


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "token_clock_bench_torch: no CUDA device is available; it "
            "measures the port's kernel on an NVIDIA GPU and has no CPU "
            "fallback")
    return torch.device("cuda", torch.cuda.current_device())


def empty_launcher():
    """``launch(G)``: an empty kernel on the current stream with the
    token-clock kernel's grid for ``G`` cells (built at first use)."""
    if not _EMPTY:
        from repro_torch.kernels import _build

        d = ROOT / "build" / "token_clock_bench"
        d.mkdir(parents=True, exist_ok=True)
        src, lib = d / "empty.cu", d / f"libempty_{os.getpid()}.so"
        src.write_text(EMPTY_SOURCE)
        run = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{run.stdout}"
                               f"{run.stderr}")
        fn = ctypes.CDLL(str(lib)).empty_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _EMPTY.append(fn)
    fn = _EMPTY[0]
    # the current stream as a pointer, the cheapest way there is (a
    # torch.cuda.Stream object costs the host about 5 us more a call)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)

    def launch(G):
        dev = torch.cuda.current_device()
        code = fn((G + THREADS - 1) // THREADS, THREADS,
                  raw(dev) if raw is not None
                  else torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"empty kernel: cudaError {code}")
    return launch


def planes(G, S, dev, seed=101, p_io=0.6, mask_dtype=torch.bool):
    """``(submit, devmask, tok, bw)`` on ``dev``: one-hot rows (about
    ``1 - p_io`` of them empty) and clocks in [0, 1 ms), drawn from
    ``seed``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    submit = t(rng.random(G) * 1e-3)
    mask = (np.arange(S)[None, :] == rng.integers(0, S, G)[:, None]) \
        & (rng.random(G) < p_io)[:, None]
    return (submit, t(mask).to(mask_dtype), t(rng.random((G, S)) * 1e-3),
            t(rng.random((G, S)) * 1e-3))


def device_us(fn, reps=REPS):
    """Mean device microseconds of one call of ``fn``, each call timed by
    its own events behind a ``CUSHION_CYCLES`` sleep."""
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(CUSHION_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps * 1e3


def host_us(fn, calls=HOST_CALLS, windows=HOST_WINDOWS) -> list[float]:
    """Host microseconds a call in each of ``windows`` windows of ``calls``
    back-to-back calls, with no synchronisation inside a window."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return out


def kernels_per_call(fn, calls=10):
    """Device kernels a call of ``fn`` (``torch.profiler``), or ``None``
    where the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(kernels) / calls if kernels else None


def _kernel_call(G, S, seed):
    """``(tc, args)``: the wrapper's module and one call's arguments on
    ``(G, S)`` planes drawn from ``seed``."""
    from repro_torch.kernels import token_clock as tc

    dev = _require_card()
    return tc, (*planes(G, S, dev, seed), 1 / 250e3, 1024 / 400e6)


def count(G=SHAPE[0], S=SHAPE[1], seed=101) -> dict:
    """The kernel's launches a call by its wrapper's counter, its device
    kernels a call by the profiler, and the instance it runs, at
    ``(G, S)``."""
    tc, args = _kernel_call(G, S, seed)
    kernel = lambda: tc.token_clock_update(*args)  # noqa: E731
    for _ in range(20):
        kernel()
    before = tc.token_clock_update.launches
    kernel()
    return {"shape": [G, S], "launches_a_call":
            tc.token_clock_update.launches - before,
            "instance": (tc.instance(*args[1:4]) if hasattr(tc, "instance")
                         else "one"),
            "kernels_per_call": kernels_per_call(kernel)}


def timings(G=SHAPE[0], S=SHAPE[1], seed=101) -> dict:
    """The kernel, the launch floor and the plain version at ``(G, S)``:
    device and host microseconds a call (module docstring)."""
    tc, args = _kernel_call(G, S, seed)
    kernel = lambda: tc.token_clock_update(*args)  # noqa: E731
    plain = lambda: tc.token_clock_update_ref(*args)  # noqa: E731
    empty = empty_launcher()
    floor = lambda: empty(G)  # noqa: E731
    for fn in (kernel, plain, floor):
        for _ in range(20):
            fn()
    out = {}
    for name, fn in (("", kernel), ("floor_", floor), ("plain_", plain)):
        out[f"{name}device_us"] = device_us(fn)
        out[f"{name}host_us_windows"] = host_us(fn)
        out[f"{name}host_us"] = min(out[f"{name}host_us_windows"])
    return out


def measure(G=SHAPE[0], S=SHAPE[1], seed=101) -> dict:
    """:func:`count` and :func:`timings` at ``(G, S)``."""
    return {**count(G, S, seed), **timings(G, S, seed)}


def plain_step_wall_s() -> float:
    """Wall seconds of the plain-step path: the main path's scenario at one
    cohort (128 latencies x 8 threads) through ``Experiment.run`` with
    ``use_kernel=False``, a warm run after a first one."""
    from repro_torch.core.experiment import Experiment, RunOptions, Scenario

    doc = json.loads((ROOT / "examples" / "scenarios"
                      / "hash_index_2ssd.json").read_text())
    lats = [float(x) for x in np.round(np.linspace(0.1, 10.0, 128), 4)]
    doc.update(latencies_us=lats, thread_candidates=[8])
    sc = Scenario.from_dict(doc)
    Experiment(sc, RunOptions(use_kernel=False)).run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Experiment(sc, RunOptions(use_kernel=False)).run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def one(plain_step: bool) -> dict:
    """This process's port: :func:`measure`, and with ``plain_step`` the
    plain-step path's wall time."""
    import repro_torch

    out = {"port": str(Path(repro_torch.__file__).resolve().parents[1]),
           **measure()}
    if plain_step:
        out["plain_step_wall_s"] = plain_step_wall_s()
    return out


def turns(other: Path, plain_step: bool) -> list[dict]:
    """:func:`one` on the port under ``other/src`` and on this tree in turns
    (other, this, this, other), each in a process of its own."""
    out = []
    for src in (other / "src", ROOT / "src", ROOT / "src", other / "src"):
        env = dict(os.environ, PYTHONPATH=str(src))
        run = subprocess.run(
            [sys.executable, "-m", "benchmarks.token_clock_bench_torch",
             "--one", *(["--plain-step"] if plain_step else [])],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"turn on {src} failed:\n"
                               f"{run.stderr[-3000:]}")
        out.append(json.loads(run.stdout.strip().splitlines()[-1]))
    return out


def card() -> tuple[str, str]:
    """``(name, power limit)`` as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[torch.cuda.current_device()]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return name, limit


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=Path, default=None,
                    help="a second checkout whose src/ is measured in turns "
                         "with this tree's")
    ap.add_argument("--plain-step", action="store_true",
                    help="also time the plain-step path (about a minute a "
                         "process)")
    ap.add_argument("--one", action="store_true",
                    help="print this process's measurements only")
    ap.add_argument("--count", action="store_true",
                    help="print this process's kernel count only (no timing)")
    args = ap.parse_args(argv)
    _require_card()
    if args.count:
        print(json.dumps(count()), flush=True)
        return []
    if args.one:
        print(json.dumps(one(args.plain_step)), flush=True)
        return []
    name, limit = card()
    rows = (turns(args.turns.resolve(), args.plain_step)
            if args.turns is not None else [one(args.plain_step)])
    for row in rows:
        print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "token_clock_bench.json").write_text(json.dumps(
        {"card": name, "power_limit": limit,
         "order": (["other", "this", "this", "other"]
                   if args.turns is not None else ["this"]),
         "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
