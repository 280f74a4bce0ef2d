"""Model selection: analytic leave-one-out cross-validation and scoring.

The reference selects models by eye — the forecast CSV's rolling one-step
errors (tutorial/tutorial.go:185-197) are its only model-quality signal,
and every refit in that loop costs a full O(n^3) fit.  For a GP the exact
LOO posterior is FREE once K is factorized (GPML §5.4.2, eqs. 5.10-5.12):

    mu_i     = y_i - alpha_i / [K^{-1}]_ii
    sigma_i^2 = 1 / [K^{-1}]_ii
    log p_LOO = sum_i log N(y_i | mu_i, sigma_i^2)

i.e. n leave-one-out refits for the cost of one diagonal of K^{-1} —
computed here as squared column norms of inv(L) (one triangular
inversion, the same O(n^3/3) primitive the serving cache uses,
ops/linalg.tril_inv).

``loo_score`` is differentiable in the hyperparameters, so the LOO pseudo-
likelihood is a drop-in alternative training objective to the LML (GPML
§5.4.3 recommends it when the model is misspecified: it targets predictive
performance rather than data fit).  ``bic``/``aic`` wrap the LML for
kernel-structure comparison (gogp.search uses BIC).

Note these are predictions of the NOISY y_i (the diagonal of K includes
the noise kernel) — unlike ``predict``'s noise-free latent bands
(SURVEY §2.1-6); held-out observations are noisy by definition.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, Posterior, absorb
from gogp.ops import linalg

Array = jax.Array

_LOG_2PI = 1.8378770664093453


class LOOResult(NamedTuple):
    """Per-point exact leave-one-out predictive state."""

    mu: Array  # (n,) LOO predictive means for y_i
    sigma: Array  # (n,) LOO predictive stds (noise included)
    logp: Array  # (n,) log N(y_i | mu_i, sigma_i^2), 0 at padded rows
    total: Array  # () masked sum — the LOO pseudo-(log-)likelihood


def loo_from_posterior(post: Posterior) -> LOOResult:
    """Exact LOO residuals from a fitted posterior (GPML eqs. 5.10-5.12).

    One blocked triangular inversion; padded rows (identity rows in K,
    zero y) yield kinv_diag = 1, alpha = 0 and are masked out of ``logp``.
    """
    w = linalg.tril_inv(post.chol)  # (n, n) = inv(L)
    kinv_diag = jnp.sum(w * w, axis=0)  # diag(K^{-1}) = colnorms^2(inv(L))
    var = 1.0 / kinv_diag
    resid = post.alpha * var  # y_i - mu_i
    mu = post.y - resid
    logp = -0.5 * (jnp.log(var) + resid * resid / var + _LOG_2PI)
    logp = logp * post.mask
    return LOOResult(mu, jnp.sqrt(var), logp, jnp.sum(logp))


def loo(gp: GP, theta_simil, theta_noise, x, y, mask=None) -> LOOResult:
    """Fit-and-LOO convenience: absorb then :func:`loo_from_posterior`."""
    return loo_from_posterior(absorb(gp, theta_simil, theta_noise, x, y, mask))


def loo_score(gp: GP, theta_simil, theta_noise, x, y, mask=None) -> Array:
    """The LOO pseudo-likelihood as a differentiable scalar — an
    alternative to ``gp.lml`` as the MLE objective (GPML §5.4.3); plug it
    into infer.mle.adam/lbfgs through the same Observe protocol."""
    return loo(gp, theta_simil, theta_noise, x, y, mask).total


def bic(lml_value: Array, n_params: int, n_obs) -> Array:
    """Bayesian information criterion (lower is better):
    -2 max-LML + p log n."""
    return -2.0 * lml_value + n_params * jnp.log(jnp.asarray(n_obs, jnp.result_type(lml_value)))


def aic(lml_value: Array, n_params: int) -> Array:
    """Akaike information criterion (lower is better): -2 max-LML + 2p."""
    return -2.0 * lml_value + 2.0 * n_params


__all__ = ["LOOResult", "aic", "bic", "loo", "loo_from_posterior", "loo_score"]
