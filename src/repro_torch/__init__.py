"""repro_torch: the PyTorch / CUDA port of the microsecond-latency-memory
KV-store reproduction.

The package mirrors ``repro`` (the JAX reference) module for module --
``repro/core/sim/replay_jax.py`` <-> ``repro_torch/core/sim/replay_torch.py``,
``repro/kernels/sched_step.py`` <-> ``repro_torch/kernels/sched_step.py`` --
and imports ``torch`` and numpy only: nothing of the reference package, so the
two can be held against each other by tests that import both.  See
``docs/PORT.md`` for the module map and the bit-identity contracts.
"""
__version__ = "0.1.0"
