"""Shared helpers of the ``test_torch_*`` files: the same seeded inputs for
the JAX reference (``repro``) and the PyTorch port (``repro_torch``), and
the reference's random streams as an injectable ``draws`` source."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import enable_x64

from repro.core.sim import replay_jax

from repro.core import workloads as ref_workloads
from repro.core.engines import available_engines as ref_engines
from repro.core.engines import run_trace as ref_run_trace
from repro.core.experiment import default_scenario as ref_default_scenario

from repro_torch.core import workloads as port_workloads
from repro_torch.core.engines import available_engines as port_engines
from repro_torch.core.engines import run_trace as port_run_trace
from repro_torch.core.experiment import (
    default_scenario as port_default_scenario,
)

US = 1e-6

#: ``compile(compiler_options=...)`` for the reference's jitted programs: at
#: the default level XLA-CPU contracts ``a*b+c`` into fused multiply-adds;
#: level 0 keeps every operation IEEE, bit-equal to op-by-op execution.
XLA_NO_FMA = {"xla_backend_optimization_level": 0}

ENGINES = sorted({cls.engine_name for cls in ref_engines().values()})


def engine_trace(engine, n_keys=2_000, n_wl_ops=600, port=True):
    """The engine's default-pairing trace (``TraceResult``) from the port
    (``port=True``) or from the reference package."""
    if port:
        default, engines, wls, run = (port_default_scenario, port_engines,
                                      port_workloads, port_run_trace)
    else:
        default, engines, wls, run = (ref_default_scenario, ref_engines,
                                      ref_workloads, ref_run_trace)
    sc = default(engine, n_keys=n_keys, n_wl_ops=n_wl_ops)
    store = engines()[engine](sc.n_keys, **sc.engine_kwargs)
    wname, wkw = sc.resolved_workload()
    wl = wls.create_workload(wname, sc.n_keys, sc.n_wl_ops, **wkw)
    return run(store, wl)


def bits_equal(a, b):
    """Bit-for-bit equality of two arrays (floats by pattern, so ``-0.0``
    differs from ``0.0`` and infinities compare)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.array_equal(a.astype(np.float64).view(np.int64),
                              b.astype(np.float64).view(np.int64))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))


def run_grid_no_fma(*args, **static):
    """``replay_jax._run_grid`` compiled at :data:`XLA_NO_FMA`: patch it in
    so the reference's grid keeps the op-by-op bits."""
    fn = jax.jit(partial(replay_jax._grid_body, **static))
    return fn.lower(*args).compile(compiler_options=XLA_NO_FMA)(*args)


class ReferenceDraws:
    """The reference's per-cell threefry streams (``_grid_body``'s fold_in
    structure), as an injectable ``draws`` source for the port."""

    def __init__(self, seed):
        self.seed = seed

    def _cell_keys(self, stream_ids):
        key = jax.random.PRNGKey(self.seed)
        return jax.vmap(jax.random.fold_in, (None, 0))(
            key, jnp.asarray(np.asarray(stream_ids, dtype=np.uint32)))

    def init(self, stream_ids, n_slots):
        f = jnp.float64
        with enable_x64():
            ck = self._cell_keys(stream_ids)
            tids = jnp.arange(n_slots, dtype=jnp.int32)
            u_cursor = jax.vmap(lambda k: jax.random.uniform(
                jax.random.fold_in(k, 0), (), dtype=f))(ck)
            u_thread = jax.vmap(lambda k: jax.vmap(
                lambda t: jax.random.uniform(jax.random.fold_in(k, 2 + t),
                                             (2,), dtype=f))(tids))(ck)
            return np.asarray(u_cursor), np.asarray(u_thread)

    def chunk(self, stream_ids, ck, n_u):
        with enable_x64():
            kc = jax.vmap(lambda k: jax.random.fold_in(k, 1))(
                self._cell_keys(stream_ids))
            us = jax.vmap(lambda k: jax.random.uniform(
                jax.random.fold_in(k, jnp.int32(ck)), (1024, n_u),
                dtype=jnp.float64))(kc)
            return np.asarray(jnp.moveaxis(us, 0, -1))
