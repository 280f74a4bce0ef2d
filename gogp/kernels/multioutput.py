"""Multi-output (multi-task) GP kernels: ICM / LMC coregionalization.

The reference is strictly single-output (gp/gp.go:20-38: one y per x).
Multi-output GPs are table stakes for a production GP framework; this
module adds them the accelerator-first way — as *kernels*, so every existing
subsystem (exact/iterative/sparse inference, all samplers, the serving
caches, the distributed paths) gets multi-output support with zero new
machinery:

- Observations from T tasks are stacked into one dataset whose inputs
  carry the task id as an extra trailing coordinate (``stack_tasks``).
  Static shapes, one covariance, one factorization — no per-task graphs.
- The intrinsic coregionalization model (ICM):

      K((x, i), (x', j)) = B[i, j] * k(x, x'),
      B = W W^T + diag(kappa),  W: (T, R) free,  kappa: (T,) >= 0

  ``B`` stays small (T is small); the task lookup is a tiny
  gather fused into the elementwise covariance build.
- LMC (linear model of coregionalization) is a sum of ICM terms with
  independent base kernels (``lmc``), built with the existing ``add``
  combinator.

Parameter-protocol note (IMPORTANT): the flat-vector Observe protocol
exp-transforms every hyperparameter (reference gp/gp.go:377-381), so
kernels receive strictly positive ``theta``.  Coregionalization weights
W must span the real line; the W slots therefore apply ``log`` to the
incoming natural-scale theta — under the Observe protocol the optimizer's
*log-scale parameter itself* is the signed weight (log(exp(v)) = v).
``kappa`` slots use theta directly (positive, like every variance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gogp.kernels.base import Kernel

Array = jax.Array


def icm(base: Kernel, n_tasks: int, rank: int = 1, name: str | None = None) -> Kernel:
    """Intrinsic coregionalization model over ``base``.

    Input convention: points are (ndim_base + 1)-dimensional, the LAST
    coordinate is the task index (0..n_tasks-1, stored as float — cast
    internally).  Theta layout (natural scale, length
    ``base.n_theta + n_tasks*rank + n_tasks``):

        [ theta_base... | W slots (T*R, row-major; SIGNED via log) |
          kappa (T, positive) ]
    """
    nb = base.n_theta
    T, R = n_tasks, rank

    def pair(theta, xa, xb):
        tb = theta[:nb]
        # W spans the real line: recover the unconstrained value from the
        # exp-transformed protocol theta (module docstring).
        W = jnp.log(theta[nb : nb + T * R]).reshape(T, R)
        kappa = theta[nb + T * R :]
        ti = xa[-1].astype(jnp.int32)
        tj = xb[-1].astype(jnp.int32)
        b = jnp.dot(W[ti], W[tj]) + jnp.where(ti == tj, kappa[ti], 0.0)
        return b * base.pair(tb, xa[:-1], xb[:-1])

    return Kernel(
        nb + T * R + T, pair, name or f"icm({base.name},T={T},R={R})",
        ("icm", base, T, R),
    )


def lmc(bases: list[Kernel], n_tasks: int, rank: int = 1) -> Kernel:
    """Linear model of coregionalization: sum of independent ICM terms,
    each with its own base kernel and its own coregionalization matrix
    (the ``+`` combinator concatenates the per-term thetas, self first)."""
    terms = [icm(b, n_tasks, rank) for b in bases]
    k = terms[0]
    for t in terms[1:]:
        k = k + t
    return k


def stack_tasks(xs: list, ys: list) -> tuple[Array, Array]:
    """Stack per-task datasets into the single multi-output dataset.

    ``xs[t]``: (n_t, d) inputs of task t; ``ys[t]``: (n_t,) outputs.
    Returns (X, y) with X: (sum n_t, d+1) carrying the task id in the
    last column — the input convention of :func:`icm`.
    """
    xt = []
    for t, x in enumerate(xs):
        x = jnp.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        tid = jnp.full((x.shape[0], 1), float(t), dtype=x.dtype)
        xt.append(jnp.concatenate([x, tid], axis=1))
    X = jnp.concatenate(xt, axis=0)
    y = jnp.concatenate([jnp.asarray(yy).reshape(-1) for yy in ys])
    return X, y


def task_inputs(z, task: int) -> Array:
    """Test inputs for one task: append the task-id column to ``z``."""
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    tid = jnp.full((z.shape[0], 1), float(task), dtype=z.dtype)
    return jnp.concatenate([z, tid], axis=1)


def init_icm_theta(
    base_log_theta, n_tasks: int, rank: int = 1, w_scale: float = 1.0
) -> Array:
    """Log-scale (protocol) initial parameter vector for an ICM kernel:
    base thetas as given, W = w_scale on the first factor column (log-scale
    slots ARE the weights), kappa = 1 (log 0)."""
    base_log_theta = jnp.asarray(base_log_theta, dtype=jnp.float32).reshape(-1)
    W = jnp.zeros((n_tasks, rank), dtype=base_log_theta.dtype)
    W = W.at[:, 0].set(w_scale)
    kappa_log = jnp.zeros((n_tasks,), dtype=base_log_theta.dtype)
    return jnp.concatenate([base_log_theta, W.reshape(-1), kappa_log])


__all__ = ["icm", "lmc", "stack_tasks", "task_inputs", "init_icm_theta"]
