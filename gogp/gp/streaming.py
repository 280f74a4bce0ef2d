"""Streaming conditioning: O(n^2 b) posterior updates, no refits.

The reference's rolling-forecast protocol refits from scratch at every
prefix length (tutorial/tutorial.go:91: a fresh Cholesky per step, O(n^3)
each).  At fixed hyperparameters, conditioning on b new points only needs
the new block row of the factor:

    L' = [ L     0   ]      w  = L^{-1} k_new          (one blocked TRSM)
         [ w^T  Lbb  ],     Lbb = chol(Kbb - w^T w)    (b x b)

an O(n^2 b) update.  Twist: shapes must be static under jit, so the posterior is
allocated at *capacity* — the house masked-padding convention (padded rows
are identity rows of K, zeros in y; gp/core.py module docstring) makes the
update exact with fully static shapes: appended points simply claim the
next padded slots, and the insertion offset is a traced scalar
(dynamic_update_slice), so the whole stream of appends compiles ONCE and
runs as one jitted step per batch.

This is the production shape of the reference's only "online" surface
(Produce off stored fields, gp/gp.go:255-257): fit once, then absorb new
observations at serving time without ever paying the O(n^3) refit.
Hyperparameters stay fixed across appends (refit when they drift — the
usual streaming-GP contract).

No downdate is provided: removing a point changes every later row of L
(an O(n^2) sequential rotation chain per removal — the wrong shape for
matrix units); re-absorb without the point instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, Posterior
from gogp.ops import linalg

Array = jax.Array


def streaming_posterior(
    gp: GP, theta_simil, theta_noise, capacity: int, dtype=jnp.float32
) -> Posterior:
    """An empty posterior with ``capacity`` padded slots.

    K's padding is identity (so chol = I), y/alpha are zeros, mask is all
    zero: exactly what absorb would produce for an all-padding dataset.
    """
    theta_simil = jnp.asarray(theta_simil, dtype=dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=dtype).reshape(gp.n_theta_noise)
    n = capacity
    return Posterior(
        theta_simil=theta_simil,
        theta_noise=theta_noise,
        x=jnp.zeros((n, gp.ndim), dtype=dtype),
        y=jnp.zeros((n,), dtype=dtype),
        chol=jnp.eye(n, dtype=dtype),
        alpha=jnp.zeros((n,), dtype=dtype),
        mask=jnp.zeros((n,), dtype=dtype),
    )


def absorb_append(gp: GP, post: Posterior, x_new, y_new) -> Posterior:
    """Condition on ``b`` new observations in O(n^2 b) — jit-safe.

    ``x_new``: (b, ndim) (or (b,) for 1-D); ``y_new``: (b,).  The new
    points claim the next ``b`` padded slots (the caller must leave enough
    capacity; slots are NOT bounds-checked under jit — appending past
    capacity silently drops, as dynamic_update_slice clamps).  Returns a
    posterior identical (up to float error) to a fresh ``absorb`` on the
    concatenated data — pinned by tests.
    """
    x_new = jnp.asarray(x_new, dtype=post.x.dtype)
    if x_new.ndim == 1:
        x_new = x_new[:, None]
    b = x_new.shape[0]
    y_new = jnp.asarray(y_new, dtype=post.y.dtype).reshape(b)
    n = post.x.shape[0]
    c = jnp.sum(post.mask).astype(jnp.int32)  # live count (traced)

    # cross-covariance of the new block vs the LIVE rows (padding masked out)
    knew = gp.simil.matrix(post.theta_simil, post.x, x_new)  # (n, b)
    knew = knew * post.mask[:, None]

    # w = L^{-1} k_new: padded rows of knew are zero and L's padded region
    # is identity, so w is zero there too — the solve is exact at capacity
    w = linalg.trsm_lower(post.chol, knew)  # (n, b)

    # new diagonal block: prior + noise - explained
    kbb = gp.simil.matrix(post.theta_simil, x_new, x_new)
    noise = gp.noise.vector(post.theta_noise, x_new)
    eye_b = jax.lax.broadcasted_iota(jnp.int32, (b, b), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (b, b), 1
    )
    kbb = jnp.where(eye_b, kbb + noise[None, :], kbb)
    S = kbb - w.T @ w
    lbb = jnp.linalg.cholesky(S)  # b x b — tiny

    # write the new block row [w^T | Lbb] into rows c:c+b
    zero = jnp.zeros((), c.dtype)
    row_block = jnp.swapaxes(w, 0, 1)  # (b, n); zero at cols >= c
    row_block = jax.lax.dynamic_update_slice(row_block, lbb, (zero, c))
    chol = jax.lax.dynamic_update_slice(post.chol, row_block, (c, zero))

    x = jax.lax.dynamic_update_slice(post.x, x_new, (c, zero))
    y = jax.lax.dynamic_update_slice(post.y, y_new, (c,))
    mask = jax.lax.dynamic_update_slice(post.mask, jnp.ones((b,), post.mask.dtype), (c,))

    # alpha at the new factor: two O(n^2) triangular solves
    alpha = linalg.cho_solve_vec(chol, y * mask)
    return Posterior(post.theta_simil, post.theta_noise, x, y, chol, alpha, mask)


def absorb_stream(gp: GP, post: Posterior, xs: Array, ys: Array) -> Posterior:
    """Fold a whole stream of (b, ...) batches through absorb_append as one
    lax.scan — the compile-once form for replaying history.

    ``xs``: (steps, b, ndim); ``ys``: (steps, b).
    """

    def step(p, xy):
        xb, yb = xy
        return absorb_append(gp, p, xb, yb), None

    out, _ = jax.lax.scan(step, post, (xs, ys))
    return out


__all__ = ["streaming_posterior", "absorb_append", "absorb_stream"]
