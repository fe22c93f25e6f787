"""Benchmark of the PyTorch / CUDA port's latency x thread grid sweeps.

``python3 -m kvsimbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one NVIDIA GPU and
prints one JSON line; ``README.md`` says how the pieces fit.
"""
