"""GP layer over the SKI operator: LML + Produce for irregular inputs.

``lml_toeplitz`` (gp/core.py) is the O(n log n) path when the inputs sit on
a regular 1-D grid — the reference's actual regime.  Real data is rarely
regular and often multi-dimensional; :func:`lml_ski` keeps the asymptotics
on ARBITRARY designs by interpolating onto an inducing grid (ops/ski.py,
Wilson & Nickisch 2015's KISS-GP):

- 1-D: symmetric-Toeplitz grid covariance, FFT circulant matvecs;
- d-D: tensor-product cubic taps (4^d per point) onto a d-dim grid whose
  covariance is d-level block-Toeplitz — one fftn circulant product per
  matvec (ops.ski.bttb_matvec_fn).  Any STATIONARY kernel qualifies.

Unlike the Toeplitz path this supports heteroscedastic noise kernels (the
noise diagonal lives in data space) and runs fully under jit (the grid
placement is traced min/max arithmetic; no host-side spacing checks).

Same estimator contract as gp.core.lml_iterative: SLQ/Hutchinson value and
gradient noise ~1/sqrt(probes), gradients via frozen-solution quadratic
forms (no differentiation through CG), plus the SKI interpolation bias
O(h^4) in the grid spacing — pick grid_size a few x the per-axis data
density for effectively exact results at O(n 4^d + N log N) per matvec.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, _LOG_2PI, _as_xy
from gogp.ops import ski

Array = jax.Array


def _axis_grid(x_col: Array, g: int):
    """Traced per-axis grid placement: 3 cells of margin each side keep
    every data point's 4 cubic taps interior (cubic_interp clamps as a
    safety net only)."""
    xmin, xmax = jnp.min(x_col), jnp.max(x_col)
    h = (xmax - xmin) / (g - 7)
    return xmin - 3.0 * h, h


def _grid_geometry(x: Array, dims: tuple):
    g0 = []
    hs = []
    for a in range(x.shape[1]):
        ga, ha = _axis_grid(x[:, a], dims[a])
        g0.append(ga)
        hs.append(ha)
    return jnp.stack(g0), jnp.stack(hs)


def _grid_col(gp: GP, ts, x_flat, grid_size: int):
    """1-D grid placement + the grid kernel's Toeplitz first column."""
    grid0, h = _axis_grid(x_flat, grid_size)
    grid = grid0 + h * jnp.arange(grid_size, dtype=x_flat.dtype)
    col = gp.simil.matrix(ts, grid[:, None], grid[:1, None])[:, 0]  # (g,)
    return grid0, h, col


def _grid_lags(gp: GP, ts, hs: Array, dims: tuple, dtype):
    """d-dim lag array: lags[i1..id] = k((i1 h1, .., id hd), 0) — valid for
    stationary kernels (every built-in except linear/white)."""
    axes = [hs[a] * jnp.arange(dims[a], dtype=dtype) for a in range(len(dims))]
    mesh = jnp.stack(jnp.meshgrid(*axes, indexing="ij"), axis=-1)  # dims + (d,)
    pts = mesh.reshape(-1, len(dims))
    zero = jnp.zeros((1, len(dims)), dtype=dtype)
    vals = gp.simil.matrix(ts, pts, zero)[:, 0]
    return vals.reshape(dims)


def _resolve_dims(grid_size, d: int) -> tuple:
    if isinstance(grid_size, int):
        return (grid_size,) * d
    dims = tuple(int(g) for g in grid_size)
    if len(dims) != d:
        raise ValueError(f"grid_size has {len(dims)} axes for {d}-D inputs")
    return dims


def lml_ski(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    key,
    grid_size: int | tuple = 2048,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    method: str = "matmul",
) -> Array:
    """Log marginal likelihood through the SKI operator (irregular inputs,
    any dimension; ``grid_size`` is per-axis — an int replicates).

    No padding mask (at O(N log N) there is no reason to pad) — the same
    contract as :func:`gogp.gp.core.lml_toeplitz`.

    ``method``: the W^T apply ("matmul" default — one-hot matmul form whose
    reduced-precision error sits below the SLQ estimator noise; "scatter" is
    exact for any dimension, "sorted" exact for 1-D sorted-input streams —
    ops.ski.ski_matvec_fn docstring).
    """
    x, y = _as_xy(gp, x, y)
    n, d = x.shape
    dims = _resolve_dims(grid_size, d)
    if d > 1 and method == "sorted":
        raise ValueError('method="sorted" is 1-D only; use scatter/matmul')
    ts0 = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn0 = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if d == 1:
        # sort along the grid axis (LML is permutation-invariant): keeps
        # the scatter-free "sorted" W^T form available; y's sort is a
        # differentiable gather, so the -alpha cotangent lands back in
        # caller order automatically
        order = jnp.argsort(x[:, 0])
        x = x[order]
        y = y[order]
    xs = jax.lax.stop_gradient(x)
    g0, hs = _grid_geometry(xs, dims)
    idx, w = ski.cubic_interp_nd(xs, g0, hs, dims)

    def c_of(ts):
        if d == 1:
            grid = g0[0] + hs[0] * jnp.arange(dims[0], dtype=x.dtype)
            return gp.simil.matrix(ts, grid[:, None], grid[:1, None])[:, 0]
        return _grid_lags(gp, ts, hs, dims, x.dtype)

    def noise_of(tn):
        return gp.noise.vector(tn, x)

    @jax.custom_vjp
    def core(ts, tn, yv):
        value, _ = ski.lml_ski_core(
            lambda: c_of(ts), lambda: noise_of(tn), idx, w, yv, key,
            num_probes, cg_iters, lanczos_iters, method,
        )
        return value

    def fwd(ts, tn, yv):
        value, aux = ski.lml_ski_core(
            lambda: c_of(ts), lambda: noise_of(tn), idx, w, yv, key,
            num_probes, cg_iters, lanczos_iters, method,
        )
        return value, (ts, tn, aux)

    def bwd(res, g):
        ts, tn, (alpha, Z, S) = res

        def hfun(ts_, tn_):
            return ski.ski_quadratic_forms(
                lambda: c_of(ts_), lambda: noise_of(tn_), idx, w, alpha, Z, S,
                method,
            )

        gts, gtn = jax.grad(hfun, argnums=(0, 1))(ts, tn)
        return (0.5 * g) * gts, (0.5 * g) * gtn, -g * alpha

    core.defvjp(fwd, bwd)
    return -0.5 * n * _LOG_2PI + core(ts0, tn0, y)


def predict_ski(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    z,
    grid_size: int | tuple = 2048,
    cg_iters: int = 200,
    tol: float = 1e-6,
    method: str | None = None,
) -> tuple[Array, Array]:
    """``Produce`` with every K-solve through the SKI matvec — the exact
    predict semantics (noise-free latent bands, reference gp/gp.go:258-360)
    against the interpolated operator; cross-covariances to the test points
    are exact kernel evaluations (only the training solve is approximated).
    Deterministic (no probes).  ``method`` defaults to the exact form
    ("sorted" in 1-D, "scatter" otherwise)."""
    from gogp.ops.iterative import cg_solve

    x, y = _as_xy(gp, x, y)
    z = jnp.atleast_2d(jnp.asarray(z))
    n, d = x.shape
    dims = _resolve_dims(grid_size, d)
    ts = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if method is None:
        method = "sorted" if d == 1 else "scatter"
    if d == 1:
        order = jnp.argsort(x[:, 0])
        x = x[order]
        y = y[order]
    g0, hs = _grid_geometry(x, dims)
    idx, w = ski.cubic_interp_nd(x, g0, hs, dims)
    if d == 1:
        grid = g0[0] + hs[0] * jnp.arange(dims[0], dtype=x.dtype)
        c_grid = gp.simil.matrix(ts, grid[:, None], grid[:1, None])[:, 0]
    else:
        c_grid = _grid_lags(gp, ts, hs, dims, x.dtype)
    mv = ski.ski_matvec_fn(c_grid, idx, w, gp.noise.vector(tn, x), method)
    kstar = gp.simil.matrix(ts, x, z)  # (n, m) exact
    X, _ = cg_solve(mv, jnp.concatenate([y[:, None], kstar], axis=1), cg_iters, tol)
    alpha, W = X[:, 0], X[:, 1:]
    mu = kstar.T @ alpha
    prior_var = gp.simil.diag_matrix(ts, z)
    var = prior_var - jnp.sum(kstar * W, axis=0)
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


__all__ = ["lml_ski", "predict_ski"]
