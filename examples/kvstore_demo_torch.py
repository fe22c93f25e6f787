"""The paper's story end to end, O1 -> O7, on the PyTorch / CUDA port.

The counterpart of ``examples/kvstore_demo.py`` over ``repro_torch``: every
latency sweep replays its grid on the device (``--device``, default
``cuda``) through the fused CUDA scheduler kernel.  The microbenchmark's
one repeated op is swept as a one-op trace (the grid replays traces, not
callables); the flash tail-latency mixture of O5 runs through the host's
compiled loop, as every mixture cell of a torch sweep does.

Run:  PYTHONPATH=src python examples/kvstore_demo_torch.py [--device cpu]
"""
import argparse
import random
import sys

import numpy as np

from repro_torch.core import workloads
from repro_torch.core.engines import TreeIndexStore, create_engine, run_trace
from repro_torch.core.experiment import (Experiment, RunArtifact, RunOptions,
                                         Scenario)
from repro_torch.core.latency_model import US, theta_mask_inv, theta_prob_inv
from repro_torch.core.sim import SimConfig, microbenchmark_source, sweep_latency
from repro_torch.core.tiering import FLASH_CXL


def one_op(src):
    """The microbenchmark source's one op, as a one-op trace."""
    return [src(random.Random(0))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the sweeps (default cuda; cpu runs the "
                         "plain PyTorch step on the host)")
    dev = ap.parse_args(argv).device
    import torch

    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        sys.exit("kvstore_demo_torch: no CUDA device is available; pass "
                 "--device cpu")

    def sweep(cfg, source, lats, **kw):
        return sweep_latency(cfg, source, lats, device=dev, **kw)

    print("O1: even with prefetching, memory-only traversal slows down:")
    src = microbenchmark_source(10, 0.1 * US, 0, 0, n_io=0)
    for pt in sweep(SimConfig(P=10), one_op(src), [1 * US, 5 * US],
                    n_ops=4000):
        print(f"  L={pt.L_mem / US:.0f}us: {pt.throughput / 1e3:7.1f} kops/s")

    print("O2/O3: IO makes the same traversal latency-tolerant:")
    src = microbenchmark_source(10, 0.1 * US, 4 * US, 3 * US)
    base = None
    for pt in sweep(SimConfig(P=10), one_op(src), [0.1 * US, 5 * US],
                    n_ops=4000):
        base = base or pt.throughput
        print(f"  L={pt.L_mem / US:.1f}us: {pt.throughput / 1e3:7.1f} kops/s "
              f"({pt.throughput / base:.0%} of DRAM)")

    print("O4: a real engine (tree index + SSD values), model vs "
          "'measurement':")
    store = TreeIndexStore(100_000, seed=1)
    wl = workloads.uniform(100_000, 30_000, (1, 0), seed=2)
    tr = run_trace(store, wl)           # one compiled columnar trace ...
    p = tr.op_params(store.times, P=12, T_sw=0.05 * US)
    print(f"  measured: M={p.M:.1f} hops/op, S={p.S:.2f} IOs/op")
    # ... shared by every cell of the latency x threads sweep grid:
    for pt in sweep(SimConfig(P=12), tr.trace, [0.1 * US, 5.0 * US],
                    n_ops=5000):
        L = np.array([pt.L_mem])
        prob = 1 / theta_prob_inv(L, p)[0]
        mask = 1 / theta_mask_inv(L, p)[0]
        print(f"  L={pt.L_mem / US:.1f}us: sim {pt.throughput / 1e3:7.1f}k  "
              f"Theta_prob {prob / 1e3:7.1f}k  Theta_mask {mask / 1e3:7.1f}k")

    print("O5 + Sec 5.1: flash-like tail latency (5/14/48us), still "
          "near-DRAM:")
    r_dram, r_tail = sweep(
        SimConfig(P=12), tr.trace, [0.1 * US, FLASH_CXL.latency_spec()],
        n_ops=5000)
    print(f"  DRAM {r_dram.throughput / 1e3:.1f}k vs flash-tail "
          f"{r_tail.throughput / 1e3:.1f}k "
          f"-> degradation {1 - r_tail.throughput / r_dram.throughput:.1%} "
          f"(paper: 2-19%)")

    print("O6: the engine x device matrix -- any registered engine against "
          "any")
    print("    SSD pool (per-device IOPS token clocks, switch fan-out hop):")
    hstore = create_engine("hash-index", 50_000, seed=6)
    htr = run_trace(hstore, workloads.uniform(50_000, 20_000, (1, 0), seed=2))
    for n_ssd in (1, 2):
        cfg = SimConfig(P=12, R_io=250e3, n_ssd=n_ssd,
                        L_switch=0.3 * US if n_ssd > 1 else 0.0)
        pts = sweep(cfg, htr.trace, [0.1 * US, 10 * US], n_ops=4000)
        thr = [pt.throughput / 1e3 for pt in pts]
        print(f"  hash-index x {n_ssd} SSD: {thr[0]:6.1f}k -> "
              f"{thr[1]:6.1f}k at 10us ({thr[1] / thr[0]:.0%} kept)")

    print("O7: the whole protocol as one declarative, serializable scenario")
    print("    (the public experiment API; same spec format as")
    print("    examples/scenarios/*.json and `benchmarks.run_torch "
          "--scenario`):")
    scenario = Scenario(
        engine="slab-cache",                  # any registry name or alias
        workload="zipf",                      # any workload-registry name
        workload_kwargs={"exponent": 0.9, "read_write": (3, 1), "seed": 8},
        n_keys=30_000, n_wl_ops=12_000,
        n_ssd=2, R_io=250e3, L_switch_us=0.3,
        latencies_us=(0.1, 5, 10), thread_candidates=(16, 32, 48),
        n_ops=3000,
    )
    # trace once, sweep on the device, model-compare
    art = Experiment(scenario, RunOptions(device=dev)).run()
    art = RunArtifact.from_json(art.to_json())   # artifacts round-trip
    print(f"  {art.engine} x {scenario.n_ssd} SSD: S={art.S:.2f} IOs/op, "
          f"M={art.M:.1f} hops/op")
    for row, norm in zip(art.rows, art.normalized()):
        print(f"  {row.label():>8}: sim {row.throughput / 1e3:7.1f}k "
              f"({norm:.0%} of DRAM)  model {row.model_throughput / 1e3:7.1f}k "
              f"[N={row.n_threads}]")


if __name__ == "__main__":
    main()
