"""Plain NumPy / Python reference of the simulated key-value store.

Everything the benchmark compares the program against is worked out again
here from the benchmark's own inputs (the workload's keys, the deployment's
settings, the seeds): the trace of suboperations (``trace``, ``engines``),
the key streams (``workloads``), the open-loop arrival streams
(``arrivals``), the counter-based uniform draws (``draws``) and one grid
cell's virtual-time scheduler as a plain event loop (``scheduler``).

This package imports only the standard library and NumPy: nothing of the
program under test, and nothing of JAX.  Engines, workload generators and
arrival kinds are found by name (``engines.get("hash-index")`` imports
``engines/hash_index.py``), so a deployment that needs another one adds a
file beside them.
"""
