"""Laplace approximation for latent-GP models with non-Gaussian likelihoods.

GP classification, Poisson counts, heavy-tailed regression: anything of the
form  f ~ GP(0, K_theta),  y_i ~ p(y_i | f_i, theta_lik)  with a
:class:`~gogp.gp.likelihoods.Likelihood`.  This generalizes the
reference's single non-Gaussian construction — the anynoise study, which
infers latent outputs as free parameters under a Laplace observation model
(/root/reference/tutorial/anynoise/model/model.go:20-46, SURVEY §2 C11) —
into a deterministic O(n^3) inference path that needs no sampling.

Math is GPML ch. 3 (Rasmussen & Williams): the latent posterior is
approximated at its mode f_hat by a Gaussian with precision K^{-1} + W,
W = -(d^2/df^2) log p(y|f) >= 0 (clipped for non-log-concave likelihoods).
All solves go through the stable B-parametrization B = I + W^0.5 K W^0.5
(GPML Alg. 3.1/3.2) so only well-conditioned Cholesky factorizations occur,
and they ride this codebase's dense linalg (ops/linalg).

Accelerator-first design notes:

- The Newton mode-search is a ``lax.while_loop`` (fixed trip bound +
  objective-change tolerance) — compiles once, no host round-trips.
- Hyperparameter gradients use the exact-Newton implicit trick: the Newton
  iteration map has ZERO Jacobian w.r.t. f at the converged mode, so
  differentiating ONE Newton step taken from ``stop_gradient(f_hat)``
  yields the exact implicit derivative df_hat/dtheta.  ``jax.grad`` of
  :func:`laplace_lml` therefore returns the full GPML eq. 5.22-5.23
  gradient (explicit + implicit terms) without differentiating through the
  while_loop and without any hand-derived third-derivative tables.  For
  non-log-concave likelihoods (student_t) the W-clipping makes this
  approximate — see likelihoods.Likelihood.log_concave.
- Everything is masked/static-shape like gp.core: padded rows have W = 0,
  f = 0 and identity rows in K and B, so jit caches one executable per
  capacity, not per dataset size.

Like the reference's ``Produce`` (gp/gp.go:258-360) and this repo's
``gp.predict``, predictive bands are for the noise-free latent function.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp.core import GP, _as_xy, masked_cov
from gogp.gp.likelihoods import Likelihood, bernoulli_probit
from gogp.ops import linalg

Array = jax.Array


def _safe_sqrt(w: Array) -> Array:
    """sqrt with a zero (not NaN) gradient at w == 0.

    Padded rows carry W = 0; plain sqrt has an infinite derivative there
    and reverse mode produces inf * 0 = NaN, silently killing the whole
    hyperparameter gradient under padding (caught by the classify study's
    batched-prefix fits)."""
    pos = w > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, w, 1.0)), 0.0)


class LaplacePosterior(NamedTuple):
    """Fitted Laplace state: everything prediction needs, checkpointable.

    The analogue of gp.core.Posterior (reference cached fields,
    gp/gp.go:24-37) for the non-conjugate case: alpha becomes grad_ll
    (= K^{-1} f_hat at the mode) and the Cholesky factor is of B rather
    than K.
    """

    theta_simil: Array  # (n_theta_simil,) natural scale
    theta_noise: Array  # (n_theta_noise,) natural scale
    theta_lik: Array  # (lik.n_theta,) natural scale
    x: Array  # (n, ndim)
    y: Array  # (n,) observations (labels / counts / values)
    f_hat: Array  # (n,) latent posterior mode
    grad_ll: Array  # (n,) d log p(y|f)/df at f_hat == K^{-1} f_hat
    sqrt_w: Array  # (n,) W^0.5 at f_hat
    chol_b: Array  # (n, n) lower Cholesky of B = I + W^0.5 K W^0.5
    mask: Array  # (n,) 1.0 real / 0.0 padding


def _prep(gp: GP, lik: Likelihood, theta_simil, theta_noise, theta_lik, x, y, mask):
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    ts = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    tl = jnp.asarray(theta_lik, dtype=x.dtype).reshape(lik.n_theta)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    return x, y, ts, tn, tl, mask


def _newton_step(lik: Likelihood, tl, K: Array, f: Array, y: Array, mask: Array,
                 precision: str | None = None):
    """One exact Newton step of the mode search (GPML Alg. 3.1 body).

    Returns (f_new, a, chol_b, sqrt_w_at_f, grad_ll_at_f) where f_new = K a,
    so a == K^{-1} f_new identically — the quadratic form in the objective
    never needs a solve against K itself.

    ``precision``: matmul precision for the K matvecs.  A reduced
    precision (TF32, JAX's default for float32 products on the GPU) leaves
    a sqrt(n)-accumulated product error in K @ b that floors the Newton
    iteration's accuracy, so the public entry points DEFAULT to
    linalg.ACCURATE_PRECISION ("highest").  Same choice as gp.serve.
    """
    gll, w = lik.grads(tl, f, y, mask)
    w = jnp.maximum(w, 0.0)  # no-op for log-concave likelihoods
    sw = _safe_sqrt(w)
    n = K.shape[0]
    eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (n, n), 1
    )
    B = jnp.where(eye, 1.0 + sw * sw * jnp.diag(K), sw[:, None] * K * sw[None, :])
    L = linalg.cholesky(B)
    b = w * f + gll
    Kb = jnp.matmul(K, b, precision=precision)
    a = b - sw * linalg.cho_solve_vec(L, sw * Kb)
    return jnp.matmul(K, a, precision=precision), a, L, sw, gll


def _objective(lik: Likelihood, tl, f, a, y, mask):
    # psi(f) = log p(y|f) - 1/2 f^T K^{-1} f with a = K^{-1} f.
    return lik.sum_logp(tl, f, y, mask) - 0.5 * jnp.dot(a, f)


def _newton_solve(
    lik: Likelihood, tl, K, y, mask, max_iters: int, tol: float,
    precision: str | None = None,
) -> Array:
    """Run guarded Newton to convergence (objective-change tolerance).

    Each iteration takes the Newton direction then backtracks along it with
    a fixed geometric step grid, keeping the step that maximizes the
    objective — unguarded Newton oscillates for non-log-concave likelihoods
    (student_t), and a fixed grid is the jit-friendly form of the GPML
    reference implementation's line search.  No extra solves: K^{-1} f
    moves linearly along the direction (a(s) = a + s*(a_new - a)), so the
    quadratic term of psi is free at every trial step.

    Not differentiable — callers wrap in stop_gradient and re-take one
    differentiable step (module docstring).
    """
    n = y.shape[0]
    f0 = jnp.zeros((n,), dtype=K.dtype)
    a0 = jnp.zeros((n,), dtype=K.dtype)
    steps = jnp.asarray(
        [1.0, 0.7, 0.5, 0.35, 0.25, 0.125, 0.0625, 0.03125, 0.01, 0.003, 0.001],
        dtype=K.dtype,
    )

    def psi_at(f, a):
        return _objective(lik, tl, f, a, y, mask)

    def cond(state):
        _, _, _, delta, it = state
        return jnp.logical_and(it < max_iters, delta > tol)

    def body(state):
        f, a, psi, _, it = state
        f_full, a_full, _, _, _ = _newton_step(lik, tl, K, f, y, mask, precision)
        df, da = f_full - f, a_full - a
        psis = jax.vmap(lambda s: psi_at(f + s * df, a + s * da))(steps)
        best = jnp.argmax(psis)
        s = steps[best]
        f_new, a_new = f + s * df, a + s * da
        psi_new = psis[best]
        return f_new, a_new, psi_new, jnp.abs(psi_new - psi), it + 1

    big = jnp.asarray(jnp.inf, dtype=K.dtype)
    f, _, _, _, _ = jax.lax.while_loop(cond, body, (f0, a0, psi_at(f0, a0), big, 0))
    return f


def laplace_fit(
    gp: GP,
    lik: Likelihood,
    theta_simil,
    theta_lik,
    x,
    y,
    theta_noise=None,
    mask=None,
    max_iters: int = 40,
    tol: float = 1e-9,
    precision: str | None = linalg.ACCURATE_PRECISION,
) -> LaplacePosterior:
    """Find the latent mode and package the Laplace posterior.

    ``gp.noise`` participates only as diagonal jitter on K (observation
    noise belongs to the likelihood here); the default 1e-10 variance
    (gp.core.DEFAULT_NOISE_STD, reference gp/gp.go:43-47) is exactly right.
    """
    if theta_noise is None:
        theta_noise = jnp.zeros((gp.n_theta_noise,))
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = masked_cov(gp, ts, tn, x, mask)
    f_hat = _newton_solve(lik, tl, K, y, mask, max_iters, tol, precision)
    # One more step from the converged mode: returns the mode again plus
    # the B-factorization evaluated there.
    f, a, L, sw, gll = _newton_step(lik, tl, K, f_hat, y, mask, precision)
    return LaplacePosterior(ts, tn, tl, x, y, f, gll, sw, L, mask)


def laplace_lml(
    gp: GP,
    lik: Likelihood,
    theta_simil,
    theta_lik,
    x,
    y,
    theta_noise=None,
    mask=None,
    max_iters: int = 40,
    tol: float = 1e-9,
    precision: str | None = linalg.ACCURATE_PRECISION,
) -> Array:
    """Laplace-approximate log marginal likelihood, GPML eq. 3.32:

        log q(y|X,theta) = log p(y|f_hat) - 1/2 f_hat^T K^{-1} f_hat
                           - 1/2 log|B|

    Differentiable in all thetas via the one-Newton-step implicit trick
    (module docstring); with the Gaussian likelihood this equals the exact
    :func:`gogp.gp.lml` with noise variance sigma^2 (the approximation
    is exact there — the validation anchor in tests/test_laplace.py).
    """
    if theta_noise is None:
        theta_noise = jnp.zeros((gp.n_theta_noise,))
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = masked_cov(gp, ts, tn, x, mask)
    sg = jax.lax.stop_gradient
    f_hat = _newton_solve(lik, sg(tl), sg(K), y, mask, max_iters, tol, precision)
    # Differentiable step from the (constant) converged mode: d f/d theta
    # is the exact implicit derivative because Newton's iteration map has
    # zero Jacobian w.r.t. f at its fixed point.
    f, a, _, _, _ = _newton_step(lik, tl, K, sg(f_hat), y, mask, precision)
    # Re-evaluate W (hence B) at the differentiable f so the implicit
    # dependence of log|B| on theta flows (GPML eq. 5.23's b/s3 terms).
    _, w = lik.grads(tl, f, y, mask)
    w = jnp.maximum(w, 0.0)
    sw = _safe_sqrt(w)
    n = K.shape[0]
    eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (n, n), 1
    )
    B = jnp.where(eye, 1.0 + sw * sw * jnp.diag(K), sw[:, None] * K * sw[None, :])
    L = linalg.cholesky(B)
    half_logdet_b = jnp.sum(jnp.log(jnp.diagonal(L)))  # padded rows: log 1
    return lik.sum_logp(tl, f, y, mask) - 0.5 * jnp.dot(a, f) - half_logdet_b


def laplace_predict(gp: GP, post: LaplacePosterior, z) -> tuple[Array, Array]:
    """Latent predictive mean and std at test inputs z (GPML Alg. 3.2).

        mu*    = K*^T grad_ll
        sigma*^2 = k(z,z) - || L^{-1} (W^0.5 K*) ||^2 per column

    Same noise-free-band semantics as gp.predict / reference Produce
    (gp/gp.go:258-360, SURVEY §2.1-6).
    """
    z = jnp.atleast_2d(jnp.asarray(z))
    if z.shape[-1] != gp.ndim:
        z = z.reshape(-1, gp.ndim)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z)  # (n, m)
    kstar = kstar * post.mask[:, None]
    mu = kstar.T @ post.grad_ll
    v = linalg.trsm_lower(post.chol_b, post.sqrt_w[:, None] * kstar)  # (n, m)
    prior = gp.simil.diag_matrix(post.theta_simil, z)
    var = prior - jnp.sum(v * v, axis=0)
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


def predict_expect(
    fn: Callable[[Array], Array], mu: Array, var: Array, order: int = 32
) -> Array:
    """E[fn(f*)] for f* ~ N(mu, var), elementwise, by Gauss-Hermite
    quadrature.  The generic link-integration helper — class probabilities,
    expected rates, expected likelihood-scale moments."""
    xs, ws = np.polynomial.hermite.hermgauss(order)
    xs = jnp.asarray(xs, dtype=mu.dtype)
    ws = jnp.asarray(ws / np.sqrt(np.pi), dtype=mu.dtype)
    f = mu[..., None] + jnp.sqrt(2.0 * jnp.maximum(var, 0.0))[..., None] * xs
    vals = jax.vmap(fn)(f.ravel()).reshape(f.shape)
    return jnp.sum(vals * ws, axis=-1)


def laplace_predict_prob(
    gp: GP, lik: Likelihood, post: LaplacePosterior, z, order: int = 32
) -> Array:
    """Predictive p(y=1 | z) for binary-classification likelihoods.

    Probit integrates analytically against the Gaussian latent:
    Phi(mu / sqrt(1 + sigma^2)) (GPML eq. 3.80); other links use
    Gauss-Hermite quadrature of exp(logp(f, y=1)).
    """
    mu, sd = laplace_predict(gp, post, z)
    if lik is bernoulli_probit:
        from jax.scipy.stats import norm

        return norm.cdf(mu / jnp.sqrt(1.0 + sd * sd))
    one = jnp.ones((), dtype=mu.dtype)
    return predict_expect(
        lambda f: jnp.exp(lik.logp(post.theta_lik, f, one)), mu, sd * sd, order
    )


def compile_laplace_serving(gp: GP, post: LaplacePosterior):
    """LaplacePosterior -> gp.serve.ServingPosterior — classification serving.

    The Laplace predictive has exactly the GP serving algebra with
    alpha -> grad_ll and W_serve = L_B^{-1} diag(sqrt_w):  mu = K*^T grad_ll,
    var = prior - ||W_serve K*||^2.  Packing those into ServingPosterior
    means the ENTIRE serving stack — serve_predict, serve_predict_cov,
    serve_sample, request-sharded batch serving (parallel/serving.py) —
    serves classification/count posteriors unchanged.  One-time cost: a
    triangular inverse of chol_b (same O(n^3/3) as GP serving).
    """
    from gogp.gp.serve import ServingPosterior

    w = linalg.tril_inv(post.chol_b) * post.sqrt_w[None, :]
    return ServingPosterior(
        post.theta_simil, post.theta_noise, post.x, post.grad_ll, w, post.mask
    )


def serve_predict_prob(
    gp: GP, lik: Likelihood, sp, theta_lik, z, order: int = 32,
    precision: str | None = linalg.ACCURATE_PRECISION,
) -> Array:
    """Predictive p(y=1 | z) from a compiled Laplace serving cache."""
    from gogp.gp.serve import serve_predict

    mu, sd = serve_predict(gp, sp, z, precision)
    if lik is bernoulli_probit:
        from jax.scipy.stats import norm

        return norm.cdf(mu / jnp.sqrt(1.0 + sd * sd))
    one = jnp.ones((), dtype=mu.dtype)
    return predict_expect(
        lambda f: jnp.exp(lik.logp(jnp.asarray(theta_lik), f, one)), mu, sd * sd, order
    )


def laplace_fit_ovr(
    gp: GP,
    lik: Likelihood,
    theta_simil,
    theta_lik,
    x,
    labels,
    n_classes: int,
    mask=None,
    max_iters: int = 40,
    tol: float = 1e-9,
) -> LaplacePosterior:
    """One-vs-rest multiclass: C binary Laplace fits as ONE batched program.

    ``labels``: (n,) integer class ids in [0, n_classes).  Each class c gets
    the binary problem y = 1[labels == c]; the C Newton solves vmap into a
    single XLA program (C covariance tiles, C Choleskys — all batched; the
    while_loop runs until the slowest class converges).  Thetas may
    be shared — shape (n_theta,) — or per-class — shape (C, n_theta).
    Returns a LaplacePosterior whose leaves carry a leading class axis.
    """
    labels = jnp.asarray(labels)
    ys = jax.vmap(lambda c: (labels == c).astype(jnp.asarray(x).dtype))(
        jnp.arange(n_classes)
    )
    ts = jnp.asarray(theta_simil)
    tl = jnp.asarray(theta_lik)
    ts_axis = 0 if ts.ndim == 2 else None
    tl_axis = 0 if tl.ndim == 2 else None

    def fit_one(y_c, ts_c, tl_c):
        return laplace_fit(
            gp, lik, ts_c, tl_c, x, y_c, mask=mask, max_iters=max_iters, tol=tol
        )

    return jax.vmap(fit_one, in_axes=(0, ts_axis, tl_axis))(ys, ts, tl)


def laplace_predict_ovr(
    gp: GP, lik: Likelihood, posts: LaplacePosterior, z, order: int = 32
) -> Array:
    """(m, C) normalized class probabilities from a batched OvR posterior.

    Standard one-vs-rest normalization: per-class Bernoulli probabilities
    rescaled to sum to one across classes.
    """
    probs = jax.vmap(
        lambda p: laplace_predict_prob(gp, lik, p, z, order=order)
    )(posts)  # (C, m)
    probs = probs.T
    return probs / jnp.sum(probs, axis=1, keepdims=True)


def make_laplace_logp(
    gp: GP,
    lik: Likelihood,
    x,
    y,
    mask=None,
    max_iters: int = 40,
    tol: float = 1e-9,
    precision: str | None = linalg.ACCURATE_PRECISION,
):
    """Flat-vector hyperparameter log-density following the Observe protocol.

    Layout v = [log theta_simil..., log theta_noise..., log theta_lik...]
    (all exp-transformed at this boundary, SURVEY §2.1-1, so every engine in
    infer/ — MLE, NUTS, ChEES, SMC, PT — does full Bayes or MLE over
    classification/count-model hyperparameters unchanged).  Returns
    (logp, n_params).
    """
    nts, ntn, ntl = gp.n_theta_simil, gp.n_theta_noise, lik.n_theta

    def logp(v):
        v = jnp.asarray(v)
        theta = jnp.exp(v)
        ts = theta[:nts]
        tn = theta[nts : nts + ntn]
        tl = theta[nts + ntn :]
        return laplace_lml(
            gp, lik, ts, tl, x, y, theta_noise=tn, mask=mask,
            max_iters=max_iters, tol=tol, precision=precision,
        )

    return logp, nts + ntn + ntl
