"""SKI / KISS-GP: structured kernel interpolation for IRREGULAR 1-D inputs.

ops/toeplitz gives O(n log n) inference but demands a regular input grid
(gp.core.lml_toeplitz's constraint).  SKI (Wilson & Nickisch 2015) removes
that constraint: place an inducing grid of g regular points under the data
and approximate

    K  ~=  W K_g W^T  +  noise_diag

with ``K_g`` the (symmetric Toeplitz) grid covariance and ``W`` an (n, g)
sparse cubic-interpolation matrix (4 taps per row, Keys' cubic-convolution
kernel, exact partition of unity).  Every matvec is then

    gather -> FFT circulant product (O(g log g)) -> scatter      + O(n)

and the whole iterative engine (CG solves, SLQ logdet, frozen-solution
Hutchinson gradients — ops/iterative) applies unchanged.  Unlike the pure
Toeplitz path this also supports HETEROSCEDASTIC noise: the noise diagonal
lives in data space, not grid space.

Notes: the scatter/gather touch (n, taps) elements against N-length
buffers — small next to the FFT; everything is static-shape and the grid
placement is traced arithmetic (min/max/floor), so the wrapper jits with
no host-side grid checks at all.  Multi-dimensional inputs use
tensor-product taps (:func:`cubic_interp_nd`, 4^d per point) and a
d-level block-Toeplitz grid covariance applied as one fftn circulant
product (:func:`bttb_matvec_fn`) — the Kronecker-free form that works
for ANY stationary kernel, separable or not.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gogp.ops.toeplitz import toeplitz_matvec_fn

Array = jax.Array


def cubic_interp(x: Array, grid0, h, g: int) -> tuple[Array, Array]:
    """Keys cubic-convolution interpolation of points onto a regular grid.

    ``x``: (n,) 1-D positions; grid point j sits at grid0 + j*h.  Returns
    (idx (n, 4) int32, w (n, 4)) with sum_j w[i, j] = 1 exactly for any
    interior point (taps clamp at the boundary — place the grid with >= 2
    cells of margin so no data point is within 2 cells of an edge).
    """
    u = (x - grid0) / h
    base = jnp.floor(u)
    frac = u - base
    # tap j = 0..3 sits at grid index base - 1 + j, signed distance
    # s_j = frac + 1 - j in [-2, 2]
    offs = jnp.arange(4, dtype=u.dtype)
    s = jnp.abs(frac[:, None] + 1.0 - offs[None, :])  # (n, 4)
    near = 1.5 * s**3 - 2.5 * s**2 + 1.0
    far = -0.5 * s**3 + 2.5 * s**2 - 4.0 * s + 2.0
    w = jnp.where(s <= 1.0, near, jnp.where(s < 2.0, far, 0.0))
    idx = jnp.clip(base.astype(jnp.int32)[:, None] - 1 + jnp.arange(4)[None, :], 0, g - 1)
    return idx, w


def cubic_interp_nd(x: Array, grid0, h, dims: tuple) -> tuple[Array, Array]:
    """Tensor-product Keys cubic interpolation onto a d-dimensional grid.

    ``x``: (n, d); ``grid0``/``h``: length-d arrays; ``dims``: grid points
    per axis.  Returns (idx (n, 4^d) int32 FLAT indices into the
    row-major prod(dims) grid, w (n, 4^d) tap weights — per-axis weight
    products, so partition of unity holds exactly in d dims too)."""
    import itertools

    d = x.shape[1]
    grid0 = jnp.asarray(grid0)
    h = jnp.asarray(h)
    per = [cubic_interp(x[:, a], grid0[a], h[a], dims[a]) for a in range(d)]
    idxs, ws = [], []
    for combo in itertools.product(range(4), repeat=d):
        flat = jnp.zeros(x.shape[0], dtype=jnp.int32)
        wprod = jnp.ones(x.shape[0], dtype=x.dtype)
        for a, t in enumerate(combo):
            flat = flat * dims[a] + per[a][0][:, t]
            wprod = wprod * per[a][1][:, t]
        idxs.append(flat)
        ws.append(wprod)
    return jnp.stack(idxs, axis=1), jnp.stack(ws, axis=1)


def bttb_matvec_fn(lags: Array):
    """Batched matvec for the d-level block-Toeplitz grid covariance.

    ``lags``: d-dim array, lags[i1..id] = k(lag), lag = (i1 h1, .., id hd)
    — any STATIONARY kernel on a regular grid has this structure (the
    d-dim generalization of the symmetric-Toeplitz first column).  The
    matvec embeds into a (2g1, .., 2gd) circulant and runs one fftn /
    pointwise product / ifftn per apply: O(N log N), O(N) memory,
    N = prod(dims).  V: (N,) or (N, k) in row-major grid order.
    """
    dims = lags.shape
    d = len(dims)
    emb = lags
    for a in range(d):
        zshape = list(emb.shape)
        zshape[a] = 1
        tail = jnp.flip(
            jax.lax.slice_in_dim(emb, 1, dims[a], axis=a), axis=a
        )
        emb = jnp.concatenate([emb, jnp.zeros(zshape, emb.dtype), tail], axis=a)
    spec = jnp.fft.fftn(emb, axes=tuple(range(d)))  # (2g1, .., 2gd) complex

    def mv(V):
        squeeze = V.ndim == 1
        Vm = V[:, None] if squeeze else V
        k = Vm.shape[1]
        X = Vm.reshape(*dims, k)
        pad = [(0, g, 0) for g in dims] + [(0, 0, 0)]
        X = jax.lax.pad(X, jnp.zeros((), X.dtype), pad)
        F = jnp.fft.fftn(X, axes=tuple(range(d)))
        out = jnp.fft.ifftn(F * spec[..., None], axes=tuple(range(d))).real
        for a in range(d):
            out = jax.lax.slice_in_dim(out, 0, dims[a], axis=a)
        out = out.astype(Vm.dtype).reshape(-1, k)
        return out[:, 0] if squeeze else out

    return mv


def interp_t(idx: Array, w: Array, g: int, V: Array) -> Array:
    """W^T V: scatter-add the taps of each point into grid space.
    idx/w: (n, T) (T = 4 in 1-D, 4^d for the tensor-product grid);
    V: (n, k) -> (g, k).  Works for any input ordering; the
    duplicate-index scatter serializes on an accelerator — use
    :func:`interp_t_sorted` when the inputs are sorted."""
    n, taps = idx.shape
    flat_idx = idx.reshape(n * taps)
    contrib = (w[:, :, None] * V[:, None, :]).reshape(n * taps, V.shape[1])
    return jnp.zeros((g, V.shape[1]), V.dtype).at[flat_idx].add(contrib)


def interp_t_sorted(idx: Array, w: Array, g: int, V: Array) -> Array:
    """W^T V for SORTED 1-D inputs — scatter-free.

    When the data points are sorted along the grid axis, each tap column
    ``idx[:, j]`` is nondecreasing, so the points contributing to one grid
    cell form a CONTIGUOUS range: the scatter becomes segment sums, i.e.
    an inclusive cumsum + a searchsorted boundary lookup + two gathers —
    all dense vector ops that stream at memory bandwidth.  f32 caveat:
    the cumsum accumulates ~sqrt(n)*eps roundoff; at n=10^5 that is ~1e-5
    relative — inside the CG/SLQ estimator noise this path feeds.
    """
    k = V.shape[1]
    out = jnp.zeros((g, k), V.dtype)
    grid_edges = jnp.arange(g + 1, dtype=idx.dtype)
    zero = jnp.zeros((1, k), V.dtype)
    for j in range(4):
        wj = w[:, j : j + 1] * V  # (n, k)
        s = jnp.concatenate([zero, jnp.cumsum(wj, axis=0)], axis=0)  # (n+1, k)
        b = jnp.searchsorted(idx[:, j], grid_edges)  # (g+1,)
        out = out + (s[b[1:]] - s[b[:-1]])
    return out


def interp_t_matmul(idx: Array, w: Array, g: int, V: Array,
                    precision: str | None = None) -> Array:
    """W^T V as 4 per-tap one-hot matmuls — the matrix-unit form.

    The one-hot generator (an iota compare times the tap weight) can fuse
    into the dot's operand read, so nothing (n, g) need be materialized
    and the reduction runs as a matmul.  At a reduced matmul precision
    (TF32, JAX's default for float32 products on the GPU) the result
    carries ~1e-3 relative error — below the SLQ/Hutchinson estimator
    noise of the LML path this serves; pass precision="highest" (or use
    the scatter/sorted forms) where exactness matters."""
    c = jnp.arange(g, dtype=idx.dtype)
    out = jnp.zeros((g, V.shape[1]), V.dtype)
    for j in range(idx.shape[1]):
        Mj = (idx[:, j : j + 1] == c[None, :]).astype(V.dtype) * w[:, j : j + 1]
        out = out + jnp.matmul(Mj.T, V, precision=precision)
    return out


def interp(idx: Array, w: Array, U: Array) -> Array:
    """W U: gather the 4 taps of each point from grid space.
    U: (g, k) -> (n, k)."""
    return jnp.sum(w[:, :, None] * U[idx], axis=1)


def ski_matvec_fn(
    c_grid: Array, idx: Array, w: Array, noise_diag: Array,
    method: str = "scatter", precision: str | None = None,
):
    """Batched matvec V -> (W T_g W^T + diag(noise)) V; V: (n,) or (n, k).

    ``c_grid``: 1-D -> symmetric-Toeplitz first column (FFT circulant);
    d-dim -> block-Toeplitz lag array (fftn circulant, bttb_matvec_fn);
    the interpolation taps in idx/w must match (4 vs 4^d per point).
    ``method`` selects the W^T apply: "scatter" (exact, any input order),
    "sorted" (exact 1-D, needs inputs sorted along the grid — cumsum
    segment sums), "matmul" (one-hot matmul form; ~1e-3 error at reduced
    matmul precision unless ``precision`` raises it)."""
    g = c_grid.size
    tmv = toeplitz_matvec_fn(c_grid) if c_grid.ndim == 1 else bttb_matvec_fn(c_grid)
    if method == "scatter":
        wt = interp_t
    elif method == "sorted":
        wt = interp_t_sorted
    elif method == "matmul":
        wt = lambda i, w_, g_, v: interp_t_matmul(i, w_, g_, v, precision)
    else:
        raise ValueError(f"unknown SKI matvec method {method!r}")

    def mv(V):
        squeeze = V.ndim == 1
        Vm = V[:, None] if squeeze else V
        out = interp(idx, w, tmv(wt(idx, w, g, Vm)))
        out = out + noise_diag[:, None] * Vm
        return out[:, 0] if squeeze else out

    return mv


def lml_ski_core(
    c_fn,
    noise_fn,
    idx: Array,
    w: Array,
    y: Array,
    key: Array,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    method: str = "scatter",
):
    """-1/2 (log|K| + y^T K^-1 y) for the SKI operator, frozen-solution
    gradient aux — the exact analogue of ops.toeplitz.lml_toeplitz_core.

    ``c_fn() -> (g,)`` grid-kernel first column; ``noise_fn() -> (n,)``
    noise diagonal (both closing over hyperparameters).  Returns
    (value, (alpha, Z, S)) for a custom VJP over
    :func:`ski_quadratic_forms`.
    """
    from gogp.ops.iterative import cg_solve, rademacher, slq_logdet

    mv = ski_matvec_fn(c_fn(), idx, w, noise_fn(), method)
    n = y.shape[0]
    k1, k2 = jax.random.split(jnp.asarray(key))
    probes_slq = rademacher(k1, (num_probes, n), y.dtype)
    probes_tr = rademacher(k2, (n, num_probes), y.dtype)
    X, _ = cg_solve(mv, jnp.concatenate([y[:, None], probes_tr], axis=1), cg_iters)
    alpha, S = X[:, 0], X[:, 1:]
    logdet = slq_logdet(mv, probes_slq, lanczos_iters)
    value = -0.5 * (logdet + jnp.dot(y, alpha))
    return value, (alpha, probes_tr, S)


def ski_quadratic_forms(
    c_fn, noise_fn, idx: Array, w: Array, alpha: Array, Z: Array, S: Array,
    method: str = "scatter",
) -> Array:
    """h = alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K) through the SKI
    matvec; d lml = g/2 * dh/dtheta with (alpha, Z, S) frozen
    (ops.toeplitz.toeplitz_quadratic_forms contract)."""
    mv = ski_matvec_fn(c_fn(), idx, w, noise_fn(), method)
    p = Z.shape[1]
    quad = jnp.dot(alpha, mv(alpha))
    tr = 0.5 * (jnp.sum(Z * mv(S)) + jnp.sum(S * mv(Z)))
    return quad - tr / p


__all__ = [
    "bttb_matvec_fn",
    "cubic_interp",
    "cubic_interp_nd",
    "interp",
    "interp_t",
    "interp_t_matmul",
    "interp_t_sorted",
    "lml_ski_core",
    "ski_matvec_fn",
    "ski_quadratic_forms",
]
