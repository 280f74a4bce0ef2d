"""Device-mesh construction and sharding helpers.

The reference scales with goroutines inside one process (gp/gp.go:165-213
row-parallel covariance, :436-469 per-theta gradient traces) — there is no
distributed backend to mirror.  The multi-device scaling story is built
here instead (SURVEY.md §5 "distributed communication backend"):

- a named :class:`jax.sharding.Mesh` over the visible devices,
- ``chain``-axis data parallelism for MCMC chains / SMC particles / batched
  MLE restarts (each device owns a slab of independent problems),
- ``data``-axis sharding for large-N covariance work (rows of K, and the
  distributed blocked Cholesky in gogp.ops.distributed).

Collectives ride the mesh through GSPMD (sharding annotations + jit) or
explicitly through ``shard_map`` + ``psum``/``all_gather`` where the
schedule matters (NUTS adaptation, SMC resampling).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chain"  # independent problems: MCMC chains, SMC particles, refits
DATA_AXIS = "data"  # rows of large-N covariance matrices


def make_mesh(
    n_chain: int | None = None,
    n_data: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a (chain, data) mesh.

    ``n_chain`` defaults to ``len(devices) // n_data``.  With one device this
    degenerates to a 1x1 mesh, so all sharded code paths also run (trivially)
    on a single chip.
    """
    if devices is None:
        devices = jax.devices()
    if n_chain is None:
        n_chain = len(devices) // n_data
    n = n_chain * n_data
    if n > len(devices):
        raise ValueError(f"mesh {n_chain}x{n_data} needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(n_chain, n_data)
    return Mesh(dev, (CHAIN_AXIS, DATA_AXIS))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis split over chains, everything else replicated."""
    return NamedSharding(mesh, P(CHAIN_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis split over the data axis (rows of K / blocks of X)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leading(mesh: Mesh, tree, axis: str = CHAIN_AXIS):
    """Place every array in ``tree`` with its leading axis split over ``axis``."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sh), tree)


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Initialize multi-host JAX (one process per host).

    Thin wrapper over ``jax.distributed.initialize``.  Pass the
    coordinator address (``host:port``), the process count and this
    process's id; with no arguments JAX auto-detects only the cluster
    environments it knows.  After this, ``jax.devices()`` spans every host
    and ``make_mesh`` builds meshes over all of them; passing the
    host-local device count as ``n_data`` keeps the ``data`` axis (the
    collective-heavy one) inside a host.  Returns the global device count.

    Must run before any backend-initializing jax call (jax.devices,
    computations, ...).  Rehearsed without hardware by
    tests/test_multihost.py: two OS processes join a localhost
    coordinator, each contributing one CPU device, and run a shard_map
    psum across the resulting mesh.
    """
    try:
        if coordinator_address is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        else:
            jax.distributed.initialize()
    except (ValueError, RuntimeError):
        # single-process environment (nothing to join) or already initialized
        pass
    return len(jax.devices())
