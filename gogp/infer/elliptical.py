"""Elliptical slice sampling: exact latent posteriors for non-Gaussian GPs.

Murray, Adams & MacKay 2010.  The latent-GP model family

    f ~ N(0, K_theta),   y_i ~ p(y_i | f_i, theta_lik)

is served deterministically by the Laplace (gp/laplace.py) and EP
(gp/ep.py) approximations; ESS samples the EXACT latent posterior, making
it both the gold standard those approximations are validated against and
the production path when the posterior is non-Gaussian enough to matter
(heavy tails, multimodality in f).  The reference's only non-Gaussian
construction — anynoise's latent outputs under a Laplace observation model
(/root/reference/tutorial/anynoise/model/model.go:20-46) — is the special
case lik=laplace_noise.

Why ESS fits an accelerator: each update is one prior draw (an (n,n)@(n,) matvec
against the cached Cholesky factor), one likelihood evaluation per bracket
shrink, and NO gradients, step sizes, or tuning parameters.  The bracket
shrink is a ``lax.while_loop`` (provably terminates: the bracket collapses
onto the current state, whose likelihood exceeds the slice threshold a.s.),
chains vmap into one batched program, and the whole chain is a single
``lax.scan`` — no host round-trips, one compile.

Prediction from draws is the exact GP conditional averaged over samples:

    mu*(z)  = E_s[ k(z,X) K^{-1} f_s ]
    var*(z) = [k(z,z) - k(z,X) K^{-1} k(X,z)]  +  Var_s[ k(z,X) K^{-1} f_s ]

(the conditional covariance is f-independent, so it splits out exactly).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, _as_xy, masked_cov
from gogp.gp.laplace import predict_expect
from gogp.gp.likelihoods import Likelihood, bernoulli_probit
from gogp.ops import linalg

Array = jax.Array

_TWO_PI = 6.283185307179586
_MAX_SHRINKS = 64  # bracket halves to ~1e-19 rad by then; safety bound only


def ess_update(
    loglik_fn: Callable[[Array], Array], chol: Array, f: Array, ll: Array, key
):
    """One elliptical slice update of a single latent vector.

    Returns (f_new, ll_new, n_shrinks).  ``ll`` must equal loglik_fn(f)
    (threaded to save one evaluation per step)."""
    kn, ku, kt, kb = jax.random.split(key, 4)
    nu = chol @ jax.random.normal(kn, f.shape, dtype=f.dtype)
    logy = ll + jnp.log(jax.random.uniform(ku, dtype=f.dtype))
    t0 = jax.random.uniform(kt, dtype=f.dtype, maxval=_TWO_PI)

    def propose(t):
        fp = f * jnp.cos(t) + nu * jnp.sin(t)
        return fp, loglik_fn(fp)

    fp, llp = propose(t0)

    def cond(state):
        _, llp, _, _, t, _, i = state
        return jnp.logical_and(llp < logy, i < _MAX_SHRINKS)

    def body(state):
        _, _, lo, hi, t, k, i = state
        lo = jnp.where(t < 0.0, t, lo)
        hi = jnp.where(t >= 0.0, t, hi)
        k, ks = jax.random.split(k)
        t = jax.random.uniform(ks, dtype=f.dtype, minval=lo, maxval=hi)
        fp, llp = propose(t)
        return fp, llp, lo, hi, t, k, i + 1

    fp, llp, _, _, _, _, i = jax.lax.while_loop(
        cond, body, (fp, llp, t0 - _TWO_PI, t0, t0, kb, jnp.int32(0))
    )
    # the safety bound fires only on pathological likelihoods; keep the
    # chain valid by staying put in that case
    bad = llp < logy
    f_new = jnp.where(bad, f, fp)
    ll_new = jnp.where(bad, ll, llp)
    return f_new, ll_new, i


class ESSResult(NamedTuple):
    """Latent draws + everything the GP-conditional prediction needs."""

    f: Array  # (C, S, n) latent posterior draws
    loglik: Array  # (C, S)
    shrinks: Array  # (C, S) bracket-shrink counts (cost/mixing diagnostic)
    theta_simil: Array
    theta_lik: Array
    x: Array  # (n, ndim)
    mask: Array  # (n,)
    chol: Array  # (n, n) prior factor chol(K)


def run_ess_chain(
    loglik_fn: Callable[[Array], Array],
    chol: Array,
    f0c: Array,
    keyc,
    num_warmup: int,
    num_samples: int,
    thin: int = 1,
):
    """One ESS chain: (n,) initial state -> ((S,n), (S,), (S,)) draws/
    logliks/shrink counts.  The unit both the vmapped and the mesh-sharded
    drivers (parallel.sample.run_ess_sharded) build on."""
    steps = num_warmup + num_samples * thin

    def bodyfn(carry, k):
        f, ll = carry
        f, ll, i = ess_update(loglik_fn, chol, f, ll, k)
        return (f, ll), (f, ll, i)

    keys = jax.random.split(jnp.asarray(keyc), steps)
    _, (fs, lls, shr) = jax.lax.scan(bodyfn, (f0c, loglik_fn(f0c)), keys)
    sel = slice(num_warmup + thin - 1, None, thin)
    return fs[sel], lls[sel], shr[sel]


def run_ess(
    loglik_fn: Callable[[Array], Array],
    chol: Array,
    f0: Array,
    key,
    num_warmup: int,
    num_samples: int,
    thin: int = 1,
):
    """ESS over (C, n) initial states; returns ((C,S,n) draws, (C,S) logliks,
    (C,S) shrink counts).  Pure function of (key, f0); chains are vmapped
    with per-chain keys fold_in(key, chain_index) — the same stream the
    sharded driver assigns by GLOBAL chain id, so draws are device-count
    invariant."""
    f0 = jnp.atleast_2d(jnp.asarray(f0))
    c = f0.shape[0]
    key = jnp.asarray(key)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(c))
    return jax.vmap(
        lambda f0c, k: run_ess_chain(
            loglik_fn, chol, f0c, k, num_warmup, num_samples, thin
        )
    )(f0, keys)


def run_ess_gp(
    gp: GP,
    lik: Likelihood,
    theta_simil,
    theta_lik,
    x,
    y,
    key,
    theta_noise=None,
    mask=None,
    num_chains: int = 4,
    num_warmup: int = 256,
    num_samples: int = 256,
    thin: int = 1,
) -> ESSResult:
    """Sample the exact latent posterior of a latent-GP model.

    Same conventions as :func:`gogp.gp.laplace.laplace_fit`: the GP's
    noise kernel contributes only diagonal jitter to the latent prior K
    (observation noise belongs to the likelihood; ``theta_noise`` defaults
    to zeros -> the 1e-10 default jitter), padded rows are identity rows in
    K and masked out of the likelihood.
    """
    if theta_noise is None:
        theta_noise = jnp.zeros((gp.n_theta_noise,))
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    ts = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    tl = jnp.asarray(theta_lik, dtype=x.dtype).reshape(lik.n_theta)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    K = masked_cov(gp, ts, tn, x, mask)
    chol = linalg.cholesky(K)

    def loglik_fn(f):
        return lik.sum_logp(tl, f, y, mask)

    f0 = jnp.zeros((num_chains, n), dtype=x.dtype)
    fs, lls, shr = run_ess(
        loglik_fn, chol, f0, key, num_warmup, num_samples, thin
    )
    return ESSResult(fs, lls, shr, ts, tl, x, mask, chol)


def ess_predict(gp: GP, res: ESSResult, z) -> tuple[Array, Array]:
    """Latent predictive mean/std at ``z`` from the exact draws.

    Noise-free latent bands, matching gp.predict / laplace_predict /
    reference Produce semantics (gp/gp.go:258-360, SURVEY §2.1-6)."""
    z = jnp.atleast_2d(jnp.asarray(z))
    if z.shape[-1] != gp.ndim:
        z = z.reshape(-1, gp.ndim)
    kstar = gp.simil.matrix(res.theta_simil, res.x, z) * res.mask[:, None]
    a = linalg.cho_solve_mat(res.chol, kstar)  # (n, m) = K^{-1} K*
    draws = res.f.reshape(-1, res.f.shape[-1])  # (C*S, n)
    mus = draws @ a  # (C*S, m) per-draw conditional means
    v = linalg.trsm_lower(res.chol, kstar)
    cond_var = gp.simil.diag_matrix(res.theta_simil, z) - jnp.sum(v * v, axis=0)
    mu = jnp.mean(mus, axis=0)
    var = jnp.maximum(cond_var, 0.0) + jnp.var(mus, axis=0)
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


def ess_predict_prob(
    gp: GP, lik: Likelihood, res: ESSResult, z, order: int = 32
) -> Array:
    """Predictive p(y=1 | z) for binary likelihoods from the exact draws
    (probit analytic, others Gauss-Hermite — mirrors laplace_predict_prob)."""
    mu, sd = ess_predict(gp, res, z)
    if lik is bernoulli_probit:
        from jax.scipy.stats import norm

        return norm.cdf(mu / jnp.sqrt(1.0 + sd * sd))
    one = jnp.ones((), dtype=mu.dtype)
    return predict_expect(
        lambda f: jnp.exp(lik.logp(res.theta_lik, f, one)), mu, sd * sd, order
    )


__all__ = [
    "ESSResult",
    "ess_predict",
    "ess_predict_prob",
    "ess_update",
    "run_ess",
    "run_ess_gp",
]
