"""Student-t process regression — heavy-tailed analogue of the exact GP.

y ~ MVT_nu(0, K): the multivariate Student-t with nu degrees of freedom and
scale matrix K (same kernel-assembled K as gp.core, noise on the diagonal).
Everything stays closed-form — same O(n^3) Cholesky path, same Posterior
pytree, same serving/streaming compatibility — but the marginal likelihood
couples observations through the quadratic form, so predictive variances
*adapt to the data* (they inflate when the observed residuals are large),
which a GP cannot do (Shah, Wilson & Ghahramani, AISTATS 2014).  As
nu -> inf every quantity converges to the exact GP's, pinned by tests.

Contrast with likelihoods.student_t + laplace: there the NOISE is t and the
latent process Gaussian (robust to point outliers); here the PROCESS itself
is t (captures global heavy-tailedness, stays analytic).  Both compose with
the same kernels.

No reference counterpart (the reference is Gaussian-only); this module
follows gp.core's conventions — masks/static shapes, natural-scale thetas,
flat-vector protocol with all-positive parameters under the exp transform
(SURVEY §2.1-1).  nu is carried as nu = 2 + exp(v_nu) in the protocol so
the predictive variance (finite for nu > 2) always exists.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from gogp.gp.core import GP, Posterior, _as_xy, absorb, masked_cov
from gogp.ops import linalg

Array = jax.Array

_LOG_PI = 1.1447298858494002


def tp_lml(gp: GP, nu, theta_simil, theta_noise, x, y, mask=None) -> Array:
    """Log marginal likelihood of the Student-t process.

    log p(y) = lgamma((nu+n)/2) - lgamma(nu/2) - (n/2) log(nu pi)
               - 1/2 log|K| - ((nu+n)/2) log(1 + y^T K^{-1} y / nu)

    Masked rows contribute identity rows to K and zeros to y (exactly the
    gp.core padding convention), so only the n's need the mask count.
    Differentiable in nu and all thetas through the blocked linalg core.
    """
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    ts = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    nu = jnp.asarray(nu, dtype=x.dtype)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    y = y * mask
    K = masked_cov(gp, ts, tn, x, mask)
    L = linalg.cholesky(K)
    alpha = linalg.cho_solve_vec(L, y)
    beta = jnp.dot(y, alpha)
    logdet = linalg.logdet_from_chol(L, mask)
    n_eff = jnp.sum(mask)
    return (
        gammaln(0.5 * (nu + n_eff))
        - gammaln(0.5 * nu)
        - 0.5 * n_eff * (jnp.log(nu) + _LOG_PI)
        - 0.5 * logdet
        - 0.5 * (nu + n_eff) * jnp.log1p(beta / nu)
    )


def tp_absorb(gp: GP, nu, theta_simil, theta_noise, x, y, mask=None) -> Posterior:
    """Condition the TP: same factorize/solve as the GP (the Posterior pytree
    is identical — nu only matters at lml/predict time)."""
    return absorb(gp, theta_simil, theta_noise, x, y, mask=mask)


def tp_predict(gp: GP, nu, post: Posterior, z) -> tuple[Array, Array]:
    """Predictive mean and std at test inputs z.

    The MVT conditional: mean is the usual K*^T K^{-1} y (identical to the
    GP — heavy tails do not move the point forecast), and the predictive
    VARIANCE is the GP's noise-free band scaled by (nu + beta)/(nu + n - 2),
    beta = y^T K^{-1} y — larger-than-expected residuals inflate the bands,
    smaller-than-expected shrink them.  Requires nu + n > 2 for the variance
    to exist.  Same noise-free-band semantics as gp.predict (reference
    Produce, gp/gp.go:258-360, SURVEY §2.1-6).
    """
    nu = jnp.asarray(nu, dtype=post.x.dtype)
    z = jnp.atleast_2d(jnp.asarray(z))
    if z.shape[-1] != gp.ndim:
        z = z.reshape(-1, gp.ndim)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z) * post.mask[:, None]
    mu = kstar.T @ post.alpha
    v = linalg.trsm_lower(post.chol, kstar)
    prior = gp.simil.diag_matrix(post.theta_simil, z)
    var_gp = jnp.maximum(prior - jnp.sum(v * v, axis=0), 0.0)
    beta = jnp.dot(post.y, post.alpha)
    n_eff = jnp.sum(post.mask)
    scale = (nu + beta) / (nu + n_eff - 2.0)
    return mu, jnp.sqrt(scale * var_gp)


def make_tp_logp(gp: GP, x, y, mask=None):
    """Flat-vector hyperparameter log-density, Observe-protocol layout:

        v = [v_nu, log theta_simil..., log theta_noise...],  nu = 2 + exp(v_nu)

    so nu is unconstrained for the optimizer yet always > 2 (finite
    predictive variance).  Returns (logp, n_params).
    """
    nts, ntn = gp.n_theta_simil, gp.n_theta_noise

    def logp(v):
        v = jnp.asarray(v)
        nu = 2.0 + jnp.exp(v[0])
        theta = jnp.exp(v[1:])
        return tp_lml(gp, nu, theta[:nts], theta[nts:], x, y, mask=mask)

    return logp, 1 + nts + ntn
