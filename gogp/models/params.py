"""The flat parameter-vector protocol of the reference ``GP.Observe``.

Layout (reference gp/gp.go:374-400, SURVEY.md §2.1-1):

    v = [log theta_simil..., log theta_noise...,
         (optional) x_1...x_n each ndim, y_1...y_n]

Hyperparameters are exp-transformed at this boundary (gp/gp.go:377-381), so
gradients w.r.t. ``v`` are automatically on log scale — the chain-rule
multiplications the reference does by hand (kgrad[i] *= theta, gp/gp.go:
114-116, :138-140) fall out of ``jax.grad`` for free.  Inputs/outputs are not
transformed.  If anything follows the thetas, inputs and outputs are inferred
too ("withObs" mode, gp/gp.go:386-397); a trailing-length mismatch is an
error (:398-400).

Under jit all lengths are static, so the destructuring is trace-time Python.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, Posterior, absorb, lml

Array = jax.Array


class GPParams(NamedTuple):
    """Destructured parameter vector (natural-scale thetas)."""

    theta_simil: Array
    theta_noise: Array
    x: Array | None  # (n, ndim) or None in hyperparameters-only mode
    y: Array | None  # (n,) or None


def split_params(gp: GP, v: Array) -> GPParams:
    """Destructure ``v`` per the reference layout, exp-transforming thetas."""
    v = jnp.asarray(v)
    nts, ntn = gp.n_theta_simil, gp.n_theta_noise
    theta = jnp.exp(v[: nts + ntn])
    theta_simil, theta_noise = theta[:nts], theta[nts:]
    rest = v[nts + ntn :]
    if rest.shape[0] == 0:
        return GPParams(theta_simil, theta_noise, None, None)
    n, rem = divmod(rest.shape[0], gp.ndim + 1)
    if rem != 0:
        # reference panics on trailing-length mismatch (gp/gp.go:398-400)
        raise ValueError(
            f"parameter vector tail of length {rest.shape[0]} is not a "
            f"multiple of ndim+1={gp.ndim + 1}"
        )
    x = rest[: n * gp.ndim].reshape(n, gp.ndim)
    y = rest[n * gp.ndim :]
    return GPParams(theta_simil, theta_noise, x, y)


def join_params(gp: GP, log_theta: Array, x: Array | None = None, y: Array | None = None) -> Array:
    """Inverse of :func:`split_params` (thetas supplied in log scale).

    Mirrors the parameter-vector construction of the Evaluate driver
    (tutorial/tutorial.go:96-116)."""
    parts = [jnp.asarray(log_theta).reshape(-1)]
    if x is not None:
        parts.append(jnp.asarray(x).reshape(-1))
        parts.append(jnp.asarray(y).reshape(-1))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def gp_posterior(gp: GP, v: Array, x=None, y=None, mask=None) -> Posterior:
    """Absorb under the parameter-vector protocol.

    ``x``/``y`` are the stored observations used when ``v`` carries only
    hyperparameters (reference gp.X/gp.Y fields); ignored in withObs mode.
    """
    p = split_params(gp, v)
    if p.x is not None:
        x, y = p.x, p.y
    if x is None:
        raise ValueError("no observations: pass x/y or a withObs parameter vector")
    return absorb(gp, p.theta_simil, p.theta_noise, x, y, mask)


def gp_observe(gp: GP, v: Array, x=None, y=None, mask=None) -> Array:
    """Log marginal likelihood at a flat parameter vector — the reference
    ``GP.Observe`` (gp/gp.go:374-412).  Returns 0 with no observations.

    Differentiate with ``jax.grad`` to get the reference ``GP.Gradient``
    (gp/gp.go:418-499): gradients w.r.t. log-thetas, inputs, and outputs
    (the latter equal -alpha, :488-493) in one reverse pass.
    """
    p = split_params(gp, v)
    if p.x is not None:
        x, y = p.x, p.y
    if x is None or jnp.asarray(x).shape[0] == 0:
        return jnp.asarray(0.0, dtype=jnp.asarray(v).dtype)
    # routes through linalg.lml_core and its analytic pullback
    return lml(gp, p.theta_simil, p.theta_noise, x, y, mask)


def make_gp_logp(gp: GP, x=None, y=None, mask=None):
    """Close over static data: returns ``logp(v) -> scalar``."""

    def logp(v):
        return gp_observe(gp, v, x=x, y=y, mask=mask)

    return logp
