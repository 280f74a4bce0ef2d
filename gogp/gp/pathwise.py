"""Pathwise posterior sampling: random-feature priors + Matheron update.

The reference can only report per-point predictive moments (``Produce``,
gp/gp.go:258-360); ``gp.serve.serve_sample`` adds exact joint draws at
O(m^3) in the number of query points.  This module implements *decoupled*
(pathwise) sampling — Wilson et al. 2020, "Efficiently sampling functions
from Gaussian process posteriors" — which produces an actual posterior
FUNCTION you can evaluate anywhere for O(F + n) dots per point:

    f_post(z) = f_prior(z) + k(z, X) K^{-1} (y - f_prior(X) - eps)

with ``f_prior`` a random-Fourier-feature draw from the kernel's spectral
measure (Bochner) and ``eps ~ N(0, noise)``.  Conditioning reuses the
cached Cholesky factor from :class:`gogp.gp.core.Posterior` — no new
factorization, and every evaluation is pure matmuls (an (m,F) cosine
feature matrix and an (m,n) kernel cross block), so thousands of coherent
posterior trajectories serve in one fused dispatch.  This is the engine
behind O(1)-per-candidate Thompson sampling in :mod:`gogp.bo` — the
exact grid Thompson there is O(m^3).

Spectral measures are derived from the kernel's structural ``spec`` tag
(kernels/base.py) — a tree over:

    ("rbf",)           omega ~ N(0, I/l^2)
    ("matern", m)      omega ~ multivariate-t, dof m = 2*nu, scale 1/l
                       (matern12/32/52; sampled as normal / chi_m)
    ("matern52_ref",)  the reference's Go 5/3->1 quirk kernel
                       (1 + sqrt5 d + d^2) e^{-sqrt5 d}
                       = 0.4 matern32(l sqrt(3/5)) + 0.6 matern52(l)
                       exactly (kernels/stationary.py identity), so omega
                       is the matching two-component Student-t mixture —
                       both components share omega = z sqrt(5/chi2_nu)/l
                       with nu in {3, 5} w.p. {0.4, 0.6}
    ("periodic",)      discrete harmonics 2*pi*k/p weighted by the Bessel
                       series exp(-z) I_k(z), z = 1/l^2 (1-D only)
    ("rq",)            Gamma(alpha, rate alpha*l^2) scale mixture of RBFs
    ("sm", q, ndim)    Gaussian spectral mixture (Wilson-Adams):
                       omega = 2*pi*(sign*mu_q + sqrt(v_q) z)
    ("scaled", k)      variance weight *= theta[0]
    ("ard", k, d)      omega_inner / lengthscale per dimension
    ("sum", a, b)      features concatenate (half the budget each side)
    ("prod", a, b)     frequencies add (spectral convolution)
    ("icm", k, T, R)   multi-output coregionalization B ⊗ k: each feature
                       drives one latent function r and carries per-task
                       loadings A[:, r] (B = A A^T) — multi-task Thompson
                       sampling rides the same Matheron machinery
                       (sums of icm terms = LMC also supported)

Kernels without a spec (hand-written pair functions, deep wrappers)
raise — use :func:`gogp.gp.serve.serve_sample` for those.
All four reference-parity Matern-5/2 tutorials (hyperpriors, warpedtime,
anynoise, events — kernel/kernel.go:89-92) ride the matern52_ref branch.

The feature frequencies are shared across the S paths of one state
(standard practice: conditional on omega the paths are exactly iid; the
O(1/sqrt(F)) kernel-approximation error is common to the batch).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, Posterior
from gogp.kernels.base import Kernel
from gogp.ops import linalg

Array = jax.Array

_TWO_PI = 6.283185307179586

# Periodic-kernel spectral series: harmonics kept and quadrature resolution
# for the exponentially-scaled Bessel weights exp(-z) I_k(z).
_PERIODIC_HARMONICS = 64
_BESSEL_QUAD_POINTS = 256


def _bessel_ive(orders: int, z: Array) -> Array:
    """exp(-z) I_k(z) for k = 0..orders-1 via the integral representation
    I_k(z) = (1/pi) int_0^pi exp(z cos t) cos(k t) dt  (traced-z safe;
    jax.scipy has only i0e/i1e).  Trapezoid on a fixed grid — the
    integrand is smooth and periodic-ish, 256 points give ~1e-12."""
    t = jnp.linspace(0.0, jnp.pi, _BESSEL_QUAD_POINTS, dtype=jnp.result_type(z, jnp.float32))
    w = jnp.ones_like(t).at[0].set(0.5).at[-1].set(0.5)
    w = w * (jnp.pi / (_BESSEL_QUAD_POINTS - 1)) / jnp.pi
    k = jnp.arange(orders, dtype=t.dtype)
    # exp(z (cos t - 1)): bounded in (0, 1], no overflow for any z >= 0
    e = jnp.exp(z * (jnp.cos(t) - 1.0))  # (T,)
    c = jnp.cos(k[:, None] * t[None, :])  # (K, T)
    return jnp.sum(e[None, :] * c * w[None, :], axis=1)


class PathFeatures(NamedTuple):
    """A sampled random-feature expansion of the kernel:
    khat(x, x') = sum_j a_j * 2 cos(omega_j.x + b_j) cos(omega_j.x' + b_j).

    ``task_load`` (multi-output ICM/LMC kernels only, else None): (T, F)
    per-task feature loadings.  Each feature j belongs to one latent
    function r_j; its loading column is A[:, r_j] * sqrt(L) with
    B = A A^T the coregionalization matrix and L the latent count, so
    khat((x,t),(x',t')) -> B[t,t'] * k_base(x,x').  The task id rides as
    the LAST input coordinate (kernels/multioutput.py convention); the
    matching omega column is zero.
    """

    omega: Array  # (F, ndim) frequencies
    phase: Array  # (F,) uniform phases b
    a: Array  # (F,) per-feature variance weights
    task_load: Array | None = None  # (T, F) or None


def _sample(kernel: Kernel, theta, key, f: int, ndim: int):
    """Walk the spec tree; return (omega (f, ndim), a (f,))."""
    spec = kernel.spec
    if spec is None:
        raise ValueError(
            f"kernel {kernel.name!r} has no spectral structure tag; "
            "pathwise sampling supports the stationary built-ins and their "
            "scaled/ard/sum/product compositions (gp/pathwise.py docstring)"
        )
    tag = spec[0]
    dtype = theta.dtype

    if tag == "rbf":
        z = jax.random.normal(key, (f, ndim), dtype=dtype)
        return z / theta[0], jnp.full((f,), 1.0 / f, dtype=dtype)

    if tag == "matern":
        dof = spec[1]  # 2*nu: 1, 3, 5
        kz, kg = jax.random.split(key)
        z = jax.random.normal(kz, (f, ndim), dtype=dtype)
        g = 2.0 * jax.random.gamma(kg, 0.5 * dof, (f,), dtype=dtype)  # chi^2_dof
        omega = z * jnp.sqrt(dof / g)[:, None] / theta[0]
        return omega, jnp.full((f,), 1.0 / f, dtype=dtype)

    if tag == "matern52_ref":
        # Exact decomposition (kernels/stationary.py): 0.4 matern32 at
        # lengthscale l*sqrt(3/5) + 0.6 matern52 at l.  The matern32 term's
        # t_3 scale sqrt(5/3)/l and the matern52 term's t_5 scale 1/l both
        # reduce to omega = z * sqrt(5 / chi2_nu) / l — only nu differs.
        kc, kz, kg = jax.random.split(key, 3)
        nu = jnp.where(
            jax.random.bernoulli(kc, 0.6, (f,)),
            jnp.asarray(5.0, dtype),
            jnp.asarray(3.0, dtype),
        )
        z = jax.random.normal(kz, (f, ndim), dtype=dtype)
        g = 2.0 * jax.random.gamma(kg, 0.5 * nu, (f,), dtype=dtype)  # chi2_nu
        omega = z * jnp.sqrt(5.0 / g)[:, None] / theta[0]
        return omega, jnp.full((f,), 1.0 / f, dtype=dtype)

    if tag == "periodic":
        if ndim != 1:
            raise ValueError("periodic kernel pathwise sampling is 1-D only")
        l, p = theta[0], theta[1]
        z = 1.0 / (l * l)
        w = _bessel_ive(_PERIODIC_HARMONICS, z)  # exp(-z) I_k(z)
        w = w * jnp.concatenate([jnp.ones((1,), dtype), 2.0 * jnp.ones((_PERIODIC_HARMONICS - 1,), dtype)])
        # truncated series sums to ~k(0)=1; renormalize the sampling dist
        idx = jax.random.categorical(key, jnp.log(jnp.maximum(w, 1e-30)), shape=(f,))
        omega = (_TWO_PI / p) * idx.astype(dtype)[:, None]
        return omega, jnp.full((f,), 1.0 / f, dtype=dtype) * jnp.sum(w)

    if tag == "rq":
        l, alpha = theta[0], theta[1]
        kz, kg = jax.random.split(key)
        z = jax.random.normal(kz, (f, ndim), dtype=dtype)
        s = jax.random.gamma(kg, alpha, (f,), dtype=dtype) / (alpha * l * l)
        return z * jnp.sqrt(s)[:, None], jnp.full((f,), 1.0 / f, dtype=dtype)

    if tag == "sm":
        q, kdim = spec[1], spec[2]
        if kdim != ndim:
            raise ValueError(f"spectral_mixture built for ndim={kdim}, got {ndim}")
        w = theta[:q]
        mu = theta[q : q + q * ndim].reshape(q, ndim)
        v = theta[q + q * ndim :].reshape(q, ndim)
        kq, ks, kz = jax.random.split(key, 3)
        comp = jax.random.categorical(kq, jnp.log(jnp.maximum(w, 1e-30)), shape=(f,))
        sign = jax.random.rademacher(ks, (f, ndim), dtype=dtype)
        z = jax.random.normal(kz, (f, ndim), dtype=dtype)
        xi = sign * mu[comp] + jnp.sqrt(v[comp]) * z
        return _TWO_PI * xi, jnp.full((f,), 1.0 / f, dtype=dtype) * jnp.sum(w)

    if tag == "scaled":
        inner = spec[1]
        omega, a = _sample(inner, theta[1:], key, f, ndim)
        return omega, a * theta[0]

    if tag == "ard":
        inner, d = spec[1], spec[2]
        omega, a = _sample(inner, theta[d:], key, f, ndim)
        return omega / theta[:d][None, :], a

    if tag == "sum":
        ka, kb = spec[1], spec[2]
        fa = f // 2
        fb = f - fa
        k1, k2 = jax.random.split(key)
        oa, aa = _sample(ka, theta[: ka.n_theta], k1, fa, ndim)
        ob, ab = _sample(kb, theta[ka.n_theta :], k2, fb, ndim)
        return jnp.concatenate([oa, ob]), jnp.concatenate([aa, ab])

    if tag == "prod":
        ka, kb = spec[1], spec[2]
        k1, k2 = jax.random.split(key)
        oa, aa = _sample(ka, theta[: ka.n_theta], k1, f, ndim)
        ob, ab = _sample(kb, theta[ka.n_theta :], k2, f, ndim)
        # spectral densities convolve: frequencies add, per-feature weights
        # pair up (sum_j f * a_aj * a_bj -> k_a(0) k_b(0) for block weights)
        return oa + ob, aa * ab * f

    raise ValueError(f"unknown kernel spec tag {tag!r}")


def _contains_icm(spec) -> bool:
    if spec is None:
        return False
    tag = spec[0]
    if tag == "icm":
        return True
    if tag in ("sum", "prod"):
        return _contains_icm(spec[1].spec) or _contains_icm(spec[2].spec)
    if tag == "scaled":
        return _contains_icm(spec[1].spec)
    if tag == "ard":
        return _contains_icm(spec[1].spec)
    return False


def _sample_mo(kernel: Kernel, theta, key, f: int, ndim: int):
    """Multi-output spec walk: returns (omega (f, ndim), a (f,),
    load (T, f)).  Supports icm leaves, sums of them (LMC) and scaled
    wrappers; icm under a product has no random-feature form here."""
    spec = kernel.spec
    tag = spec[0]
    dtype = theta.dtype

    if tag == "icm":
        base, T, R = spec[1], spec[2], spec[3]
        nb = base.n_theta
        tb = theta[:nb]
        W = jnp.log(theta[nb : nb + T * R]).reshape(T, R)
        kappa = theta[nb + T * R :]
        A = jnp.concatenate([W, jnp.diag(jnp.sqrt(kappa))], axis=1)  # (T, L)
        L = R + T
        omega_s, a = _sample(base, tb, key, f, ndim - 1)
        omega = jnp.concatenate(
            [omega_s, jnp.zeros((f, 1), omega_s.dtype)], axis=1
        )
        # feature j drives latent r_j = j mod L; sqrt(L) renormalizes the
        # per-latent feature budget so each latent approximates the FULL
        # base kernel: sum_{j: r_j=r} a_j ~= 1/L
        r = jnp.arange(f) % L
        load = A[:, r] * jnp.sqrt(jnp.asarray(L, dtype))  # (T, f)
        return omega, a, load

    if tag == "sum":
        ka, kb = spec[1], spec[2]
        fa = f // 2
        fb = f - fa
        k1, k2 = jax.random.split(key)
        oa, aa, la = _sample_mo(ka, theta[: ka.n_theta], k1, fa, ndim)
        ob, ab, lb = _sample_mo(kb, theta[ka.n_theta :], k2, fb, ndim)
        if la.shape[0] != lb.shape[0]:
            raise ValueError("LMC terms must share the task count")
        return (
            jnp.concatenate([oa, ob]),
            jnp.concatenate([aa, ab]),
            jnp.concatenate([la, lb], axis=1),
        )

    if tag == "scaled":
        omega, a, load = _sample_mo(spec[1], theta[1:], key, f, ndim)
        return omega, a * theta[0], load

    raise ValueError(
        f"multi-output pathwise sampling supports icm leaves, sums of them "
        f"(lmc) and scaled wrappers — got {tag!r} over an icm"
    )


def sample_features(
    kernel: Kernel, theta, key, num_features: int, ndim: int
) -> PathFeatures:
    """Draw one random-feature expansion of ``kernel`` at natural-scale
    hyperparameters ``theta``."""
    theta = jnp.asarray(theta)
    ko, kp = jax.random.split(jnp.asarray(key))
    if _contains_icm(kernel.spec):
        omega, a, load = _sample_mo(kernel, theta, ko, num_features, ndim)
    else:
        omega, a = _sample(kernel, theta, ko, num_features, ndim)
        load = None
    phase = jax.random.uniform(
        kp, (num_features,), dtype=omega.dtype, maxval=_TWO_PI
    )
    return PathFeatures(omega, phase, a, load)


def eval_features(feat: PathFeatures, z) -> Array:
    """Feature matrix Phi(z): (m, F); khat(z, z') = Phi(z) Phi(z')^T.

    Multi-output features (task_load set) read the task id from the LAST
    input coordinate and scale each feature by its task loading."""
    z = jnp.atleast_2d(jnp.asarray(z))
    proj = z @ feat.omega.T + feat.phase[None, :]
    phi = jnp.sqrt(2.0 * jnp.maximum(feat.a, 0.0))[None, :] * jnp.cos(proj)
    if feat.task_load is not None:
        tasks = z[:, -1].astype(jnp.int32)
        phi = phi * feat.task_load[tasks]  # (T, F) indexed by row task -> (m, F)
    return phi


class PathState(NamedTuple):
    """S compiled posterior sample-functions: evaluate with
    :func:`eval_paths` at any inputs, any number of times."""

    feat: PathFeatures
    weights: Array  # (S, F) standard-normal feature weights
    v: Array  # (n, S) Matheron correction coefficients K^{-1} residual
    theta_simil: Array
    x: Array  # (n, ndim) training inputs
    mask: Array  # (n,)


def prior_paths(
    kernel: Kernel, theta, key, num_paths: int, num_features: int, ndim: int
) -> tuple[PathFeatures, Array]:
    """S draws from the GP *prior* as explicit functions:
    f_s(z) = Phi(z) w_s, w_s ~ N(0, I_F).  Returns (features, weights)."""
    kf, kw = jax.random.split(jnp.asarray(key))
    feat = sample_features(kernel, theta, kf, num_features, ndim)
    w = jax.random.normal(kw, (num_paths, num_features), dtype=feat.omega.dtype)
    return feat, w


def eval_prior_paths(feat: PathFeatures, weights: Array, z) -> Array:
    """Evaluate prior paths at ``z``: (S, m)."""
    return weights @ eval_features(feat, z).T


def sample_paths(
    gp: GP,
    post: Posterior,
    key,
    num_paths: int,
    num_features: int = 1024,
) -> PathState:
    """Compile S posterior sample-functions from a fitted Posterior.

    One batched K-solve against the cached factor (no new factorization);
    the observation noise in the Matheron residual is the GP's own noise
    kernel evaluated at the training inputs (the same diagonal ``absorb``
    put into K), so the math is exact up to the random-feature prior.
    """
    kp, ke = jax.random.split(jnp.asarray(key))
    feat, w = prior_paths(
        gp.simil, post.theta_simil, kp, num_paths, num_features, gp.ndim
    )
    f_train = eval_prior_paths(feat, w, post.x)  # (S, n)
    noise_sd = jnp.sqrt(gp.noise.vector(post.theta_noise, post.x))  # (n,)
    eps = noise_sd[None, :] * jax.random.normal(
        ke, f_train.shape, dtype=f_train.dtype
    )
    resid = (post.y - f_train - eps) * post.mask[None, :]  # (S, n)
    v = linalg.cho_solve_mat(post.chol, resid.T)  # (n, S)
    return PathState(feat, w, v, post.theta_simil, post.x, post.mask)


def eval_paths(gp: GP, ps: PathState, z) -> Array:
    """Evaluate the S posterior sample-functions at ``z``: (S, m).

    f_s(z) = Phi(z) w_s + k(z, X) v_s — two matmuls, coherent across any
    sequence of calls (the same continuous function every time)."""
    z = jnp.atleast_2d(jnp.asarray(z))
    prior = eval_prior_paths(ps.feat, ps.weights, z)  # (S, m)
    kstar = gp.simil.matrix(ps.theta_simil, ps.x, z) * ps.mask[:, None]  # (n, m)
    return prior + (kstar.T @ ps.v).T


# ---------------------------------------------------------------------------
# SKI-conditioned pathwise sampling — the large-n regime.
# ---------------------------------------------------------------------------


def sample_paths_ski(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    key,
    num_paths: int,
    num_features: int = 1024,
    grid_size: int | tuple = 2048,
    cg_iters: int = 200,
    tol: float = 1e-6,
    method: str | None = None,
) -> PathState:
    """Posterior sample-functions WITHOUT a factorization: the Matheron
    solve runs as batched CG against the SKI operator (gp/ski.py), so
    compiling S coherent posterior trajectories costs O(cg_iters x
    (n 4^d + N log N)) — the n=10^5-on-one-chip regime where
    :func:`sample_paths`'s dense Cholesky cannot exist.  Same PathState /
    :func:`eval_paths` contract (mask all-ones; no padding at this scale).
    """
    from gogp.gp.core import _as_xy
    from gogp.gp.ski import _grid_geometry, _grid_lags, _resolve_dims
    from gogp.ops import ski as ski_ops
    from gogp.ops.iterative import cg_solve

    x, y = _as_xy(gp, x, y)
    n, d = x.shape
    dims = _resolve_dims(grid_size, d)
    ts = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if method is None:
        method = "scatter"
    kp, ke = jax.random.split(jnp.asarray(key))
    feat, w = prior_paths(gp.simil, ts, kp, num_paths, num_features, gp.ndim)
    f_train = eval_prior_paths(feat, w, x)  # (S, n)
    noise_var = gp.noise.vector(tn, x)
    eps = jnp.sqrt(noise_var)[None, :] * jax.random.normal(
        ke, f_train.shape, dtype=f_train.dtype
    )
    resid = y[None, :] - f_train - eps  # (S, n)

    g0, hs = _grid_geometry(x, dims)
    idx, tw = ski_ops.cubic_interp_nd(x, g0, hs, dims)
    if d == 1:
        grid = g0[0] + hs[0] * jnp.arange(dims[0], dtype=x.dtype)
        c_grid = gp.simil.matrix(ts, grid[:, None], grid[:1, None])[:, 0]
    else:
        c_grid = _grid_lags(gp, ts, hs, dims, x.dtype)
    mv = ski_ops.ski_matvec_fn(c_grid, idx, tw, noise_var, method)
    v, _ = cg_solve(mv, resid.T, cg_iters, tol)  # (n, S)
    mask = jnp.ones((n,), dtype=x.dtype)
    return PathState(feat, w, v, ts, x, mask)


# ---------------------------------------------------------------------------
# Laplace (non-Gaussian likelihood) pathwise sampling.
# ---------------------------------------------------------------------------


def sample_paths_laplace(
    gp: GP,
    post,
    key,
    num_paths: int,
    num_features: int = 1024,
) -> PathState:
    """Posterior sample-functions from a fitted Laplace posterior
    (classification / counts / robust regression — gp/laplace.py).

    The Laplace posterior N(f_hat, (K^{-1} + W)^{-1}) is exactly a GP
    regression posterior with pseudo-targets  ytilde = f_hat + W^{-1} g
    (g the likelihood gradient at the mode) and heteroscedastic noise
    W^{-1}, so Matheron conditioning applies verbatim:

        f_s(.) = fp_s(.) + k(., X) (K + W^{-1})^{-1} (ytilde - fp_s(X) - eps),
        eps ~ N(0, W^{-1})

    with the solve through the stored stable factor:
    (K + W^{-1})^{-1} r = W^0.5 B^{-1} W^0.5 r,  B = I + W^0.5 K W^0.5.
    Rows with W = 0 (padding, or flat-likelihood points) carry infinite
    pseudo-noise — zero information — and drop out exactly.

    Returns a :class:`PathState`; evaluate with :func:`eval_paths`.
    The draws are over the LATENT f — push through the likelihood's
    inverse link for class-probability trajectories.
    """
    kp, ke = jax.random.split(jnp.asarray(key))
    feat, w = prior_paths(
        gp.simil, post.theta_simil, kp, num_paths, num_features, gp.ndim
    )
    fp_x = eval_prior_paths(feat, w, post.x)  # (S, n)
    sw = post.sqrt_w  # (n,) W^0.5, 0 at padded/flat rows
    live = sw > 0.0
    # W^0.5 (ytilde - fp(X)) = W^0.5 (f_hat - fp) + g / W^0.5  (0 where W=0)
    g_over_sw = jnp.where(live, post.grad_ll / jnp.where(live, sw, 1.0), 0.0)
    u_det = sw[None, :] * (post.f_hat[None, :] - fp_x) + g_over_sw[None, :]
    # W^0.5 eps with eps ~ N(0, W^{-1}):  standard normal on live rows
    z = jax.random.normal(ke, fp_x.shape, dtype=fp_x.dtype)
    u = (u_det - z * live[None, :].astype(fp_x.dtype)) * post.mask[None, :]
    v = sw[:, None] * linalg.cho_solve_mat(post.chol_b, u.T)  # (n, S)
    return PathState(feat, w, v, post.theta_simil, post.x, post.mask)


# ---------------------------------------------------------------------------
# Sparse (inducing-point) pathwise sampling — SVGP / SGPR posteriors.
# ---------------------------------------------------------------------------


class SparsePathState(NamedTuple):
    """S sparse posterior sample-functions: RFF prior + inducing update.

    f_s(t) = Phi(t) w_s + k(t, Z) v_s   with
    v_s = Kzz^{-1} (u_s - f_prior_s(Z)),  u_s ~ q(u).
    """

    feat: PathFeatures
    weights: Array  # (S, F)
    v: Array  # (M, S)
    theta_simil: Array
    z: Array  # (M, ndim) inducing inputs


def sample_paths_svgp(
    gp: GP,
    theta_simil,
    state,
    key,
    num_paths: int,
    num_features: int = 1024,
    jitter: float | None = None,
) -> SparsePathState:
    """Pathwise sample-functions from a fitted (whitened) SVGP posterior.

    Wilson et al. 2020's sparse decoupled sampler: draw u_s = L(q_mu +
    S eps) from q(u), a random-feature prior path, and correct through the
    inducing points — every evaluation afterwards is O(F + M) per point,
    independent of the training-set size.  ``state`` is a
    :class:`gogp.gp.sparse.SVGPState`; for SGPR compile the optimal
    whitened state first (:func:`gogp.gp.sparse.svgp_optimal_state`) —
    its q reproduces the collapsed posterior exactly.
    """
    from jax.scipy.linalg import solve_triangular

    from gogp.gp.sparse import DEFAULT_JITTER, _chol_kuu

    if jitter is None:
        jitter = DEFAULT_JITTER
    theta_simil = jnp.asarray(theta_simil).reshape(gp.n_theta_simil)
    kp, ke = jax.random.split(jnp.asarray(key))
    feat, w = prior_paths(
        gp.simil, theta_simil, kp, num_paths, num_features, gp.ndim
    )
    z = state.z
    m = z.shape[0]
    L = _chol_kuu(gp, theta_simil, z, jitter)  # (M, M)
    S = jnp.tril(state.q_sqrt)
    eps = jax.random.normal(ke, (num_paths, m), dtype=z.dtype)
    vs = state.q_mu[None, :] + eps @ S.T  # whitened draws v_s ~ N(q_mu, SS^T)
    fp_z = eval_prior_paths(feat, w, z)  # (S, M)
    # L^{-1}(u_s - fp(Z)) = v_s - L^{-1} fp(Z); then one upper solve
    resid = vs.T - solve_triangular(L, fp_z.T, lower=True)  # (M, S)
    v = solve_triangular(L, resid, lower=True, trans=1)  # (M, S) = Kzz^{-1}(u - fp)
    return SparsePathState(feat, w, v, theta_simil, z)


def eval_paths_sparse(gp: GP, ps: SparsePathState, t) -> Array:
    """Evaluate sparse posterior sample-functions at ``t``: (S, m)."""
    t = jnp.atleast_2d(jnp.asarray(t))
    prior = eval_prior_paths(ps.feat, ps.weights, t)  # (S, m)
    kzt = gp.simil.matrix(ps.theta_simil, ps.z, t)  # (M, m)
    return prior + (kzt.T @ ps.v).T


__all__ = [
    "PathFeatures",
    "PathState",
    "SparsePathState",
    "eval_features",
    "eval_paths",
    "eval_paths_sparse",
    "eval_prior_paths",
    "prior_paths",
    "sample_features",
    "sample_paths",
    "sample_paths_laplace",
    "sample_paths_ski",
    "sample_paths_svgp",
]
