"""Sharded serving: spread serving caches and request batches over the mesh.

Serving is embarrassingly parallel along two axes, and GSPMD does all the
work once the operands are *placed* — these helpers are the placement
conventions plus jitted entry points:

- **draw-sharded mixture**: a ServingMixture's S draws shard over the
  CHAIN axis (each device holds its draws' (n, n) factors); the mixture
  moments are means over S, which GSPMD turns into one psum at the end.
  This is how a big Bayesian serving cache (S x n x n floats) scales past
  one chip's HBM.
- **request-sharded batch**: test points shard over the CHAIN axis of the
  mesh (each device predicts its rows); no collectives at all.

Both are semantically invisible (device-count invariance is pinned by
tests on the virtual CPU mesh).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gogp.gp.core import GP
from gogp.ops import linalg
from gogp.gp.serve import (
    ServingMixture,
    ServingPosterior,
    serve_predict,
    serve_predict_mixture,
)
from gogp.parallel.mesh import CHAIN_AXIS

Array = jax.Array


def shard_mixture(sm: ServingMixture, mesh: Mesh) -> ServingMixture:
    """Place a ServingMixture with draws sharded over the chain axis.

    Shared leaves (training inputs, mask) replicate; per-draw leaves
    (thetas, alpha, the (n, n) factors) split their leading S axis.
    S must divide the chain-axis size evenly (pad with repeated draws if
    needed — the mixture mean is unchanged by duplicating a draw only if
    you also reweight, so prefer exact multiples).
    """
    draws = NamedSharding(mesh, P(CHAIN_AXIS))
    repl = NamedSharding(mesh, P())
    return ServingMixture(
        theta_simil=jax.device_put(sm.theta_simil, draws),
        theta_noise=jax.device_put(sm.theta_noise, draws),
        x=jax.device_put(sm.x, repl),
        alpha=jax.device_put(sm.alpha, draws),
        w=jax.device_put(sm.w, draws),
        mask=jax.device_put(sm.mask, repl),
    )


def serve_predict_mixture_sharded(
    gp: GP, sm: ServingMixture, z, mesh: Mesh, precision: str | None = linalg.ACCURATE_PRECISION
):
    """Mixture predict with draws sharded: per-draw matmuls run shard-
    local, the two moment means become one psum each (GSPMD-inserted)."""
    sm = shard_mixture(sm, mesh)
    z = jax.device_put(z, NamedSharding(mesh, P()))
    return jax.jit(
        lambda sm_, z_: serve_predict_mixture(gp, sm_, z_, precision)
    )(sm, z)


def serve_predict_sharded(
    gp: GP, sp: ServingPosterior, z, mesh: Mesh, precision: str | None = linalg.ACCURATE_PRECISION
):
    """Batch predict with the request rows sharded over the chain axis and
    the cache replicated — zero collectives, linear scaling in devices."""
    rows = NamedSharding(mesh, P(CHAIN_AXIS))
    repl = NamedSharding(mesh, P())
    sp = jax.tree.map(lambda a: jax.device_put(a, repl), sp)
    z = jax.device_put(z, rows)
    return jax.jit(
        lambda sp_, z_: serve_predict(gp, sp_, z_, precision),
        out_shardings=rows,
    )(sp, z)


__all__ = [
    "shard_mixture",
    "serve_predict_mixture_sharded",
    "serve_predict_sharded",
]
