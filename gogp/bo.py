"""Bayesian optimization on the GP stack — serve + stream, zero refits.

The reference stops at GP regression; BO is the canonical production
*consumer* of a GP framework, and on an accelerator it composes from pieces this
framework already has, with no per-iteration refits anywhere:

- acquisition over a candidate grid = one batched predict (matmuls
  through the posterior; gp.core.predict_from_posterior semantics);
- Thompson sampling = joint posterior draws (gp.serve.serve_sample math,
  evaluated directly from the factor here);
- absorbing the new observation = gp.streaming.absorb_append, O(n^2 b);
- the whole optimize loop is ONE lax.scan over a jitted step — static
  shapes throughout (capacity-padded posterior, fixed candidate grid).

Hyperparameters stay fixed during a BO run (the streaming contract);
re-fit them between runs with MLE/NUTS as usual.

Convention: MAXIMIZATION (flip the sign of a loss to minimize).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, Posterior, predict_from_posterior
from gogp.gp.streaming import absorb_append, streaming_posterior
from gogp.ops import linalg

Array = jax.Array

_SQRT2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327


def _norm_pdf(z):
    return _INV_SQRT_2PI * jnp.exp(-0.5 * z * z)


def _norm_cdf(z):
    return 0.5 * (1.0 + jax.lax.erf(z / _SQRT2))


def expected_improvement(mu: Array, sigma: Array, best: Array, xi: float = 0.0) -> Array:
    """EI for maximization: E[max(f - best - xi, 0)] under N(mu, sigma^2).

    Zero-variance points (e.g. already-observed candidates) get EI = 0 —
    the guard also keeps the gradient finite there.
    """
    safe = jnp.where(sigma > 0.0, sigma, 1.0)
    z = (mu - best - xi) / safe
    ei = (mu - best - xi) * _norm_cdf(z) + safe * _norm_pdf(z)
    return jnp.where(sigma > 0.0, jnp.maximum(ei, 0.0), 0.0)


def upper_confidence_bound(mu: Array, sigma: Array, beta: float = 2.0) -> Array:
    """UCB for maximization: mu + beta * sigma."""
    return mu + beta * sigma


class BOState(NamedTuple):
    """Everything a BO run carries: the streaming posterior + incumbents."""

    post: Posterior
    best_x: Array  # (ndim,)
    best_y: Array  # ()


def bo_init(gp: GP, theta_simil, theta_noise, capacity: int, dtype=jnp.float32) -> BOState:
    post = streaming_posterior(gp, theta_simil, theta_noise, capacity, dtype)
    return BOState(
        post,
        jnp.zeros((gp.ndim,), dtype=dtype),
        jnp.asarray(-jnp.inf, dtype=dtype),
    )


def acquire(
    gp: GP,
    state: BOState,
    candidates: Array,
    kind: str = "ei",
    key: Array | None = None,
    xi: float = 0.0,
    beta: float = 2.0,
) -> tuple[Array, Array]:
    """Score the candidate grid and return (argmax index, scores).

    ``kind``: "ei" | "ucb" | "thompson" | "thompson-path".  Thompson draws
    ONE joint sample over the candidates (needs ``key``; O(m^3) in the
    grid size) and scores each candidate by its sampled value — exact
    Thompson on the grid.  "thompson-path" draws the sample as a pathwise
    (random-feature + Matheron) function instead — O(m (F + n)), the
    large-grid/continuous-domain form (gp/pathwise.py; kernel must carry a
    spectral spec).  With no observations yet, EI/UCB reduce to prior
    mean + std scoring and Thompson to a prior draw.
    """
    candidates = jnp.asarray(candidates, dtype=state.post.x.dtype)
    if candidates.ndim == 1:
        candidates = candidates[:, None]
    mu, sigma = predict_from_posterior(gp, state.post, candidates)
    if kind == "ei":
        scores = expected_improvement(mu, sigma, state.best_y, xi)
    elif kind == "ucb":
        scores = upper_confidence_bound(mu, sigma, beta)
    elif kind == "thompson":
        if key is None:
            raise ValueError("thompson acquisition needs a PRNG key")
        kzz = gp.simil.matrix(state.post.theta_simil, candidates, candidates)
        kstar = gp.simil.matrix(state.post.theta_simil, state.post.x, candidates)
        kstar = kstar * state.post.mask[:, None]
        v = linalg.trsm_lower(state.post.chol, kstar)
        cov = kzz - v.T @ v
        m = candidates.shape[0]
        scale = jnp.mean(jnp.diagonal(cov)) + 1.0
        chol = jnp.linalg.cholesky(cov + (1e-8 * scale) * jnp.eye(m, dtype=cov.dtype))
        eps = jax.random.normal(key, (m,), dtype=mu.dtype)
        scores = mu + chol @ eps
    elif kind == "thompson-path":
        if key is None:
            raise ValueError("thompson-path acquisition needs a PRNG key")
        scores = thompson_path_scores(gp, state, candidates, key)
    else:
        raise ValueError(f"unknown acquisition {kind!r}")
    return jnp.argmax(scores), scores


def thompson_path_scores(
    gp: GP, state: BOState, candidates: Array, key: Array, num_features: int = 512
) -> Array:
    """One pathwise posterior draw evaluated on the candidates — Thompson
    scores in O(m (F + n)) instead of the exact grid draw's O(m^3).

    The draw is a coherent continuous function (gp.pathwise), so the same
    key scores ANY candidate set consistently — usable for continuous
    optimization of the sample (score-and-refine grids) where the exact
    grid Thompson cannot leave its grid.
    """
    from gogp.gp import pathwise

    ps = pathwise.sample_paths(gp, state.post, key, 1, num_features)
    return pathwise.eval_paths(gp, ps, candidates)[0]


def thompson_path_optimize(
    gp: GP,
    state: BOState,
    key: Array,
    bounds: tuple,
    num_restarts: int = 8,
    steps: int = 100,
    lr: float = 0.05,
    num_features: int = 512,
) -> tuple[Array, Array]:
    """CONTINUOUS-domain Thompson: draw one pathwise posterior sample and
    maximize it by multi-start gradient ascent — possible only because the
    pathwise draw is a differentiable function (grid Thompson cannot leave
    its grid).  ``bounds`` = (lo, hi) arrays of shape (ndim,); restarts
    are vmapped, iterates clip to the box.  Returns (x (ndim,), value)."""
    from gogp.gp import pathwise

    lo = jnp.broadcast_to(jnp.asarray(bounds[0], state.post.x.dtype), (gp.ndim,))
    hi = jnp.broadcast_to(jnp.asarray(bounds[1], state.post.x.dtype), (gp.ndim,))
    kp, k0 = jax.random.split(jnp.asarray(key))
    ps = pathwise.sample_paths(gp, state.post, kp, 1, num_features)

    def f(x):
        return pathwise.eval_paths(gp, ps, x[None, :])[0, 0]

    g = jax.grad(f)
    x0 = lo + (hi - lo) * jax.random.uniform(
        k0, (num_restarts, gp.ndim), dtype=lo.dtype
    )
    scale = lr * (hi - lo)

    def ascend(x):
        def step(x, _):
            x = jnp.clip(x + scale * g(x), lo, hi)
            return x, None

        x, _ = jax.lax.scan(step, x, None, length=steps)
        return x, f(x)

    xs, vals = jax.vmap(ascend)(x0)
    i = jnp.argmax(vals)
    return xs[i], vals[i]


def acquire_batch_thompson(
    gp: GP,
    state: BOState,
    candidates: Array,
    key: Array,
    q: int,
    num_features: int = 512,
) -> tuple[Array, Array]:
    """Pick ``q`` candidates to evaluate IN PARALLEL by batch Thompson
    sampling: q independent pathwise posterior draws, each proposing its
    own argmax (Kandasamy et al. 2018's parallel TS, exact here — no
    fantasies or hallucinated updates needed because the draws are
    coherent functions).  Duplicates are resolved toward distinct points:
    a candidate already taken by an earlier draw falls through to that
    draw's best unclaimed candidate.  Returns (indices (q,), scores
    (q, m)).  Cost: one batched state build + one (q, m) evaluation —
    O(q m (F + n)); the grid-exact equivalent would need q sequential
    m x m factorizations.
    """
    from gogp.gp import pathwise

    candidates = jnp.asarray(candidates, dtype=state.post.x.dtype)
    if candidates.ndim == 1:
        candidates = candidates[:, None]
    ps = pathwise.sample_paths(gp, state.post, key, q, num_features)
    scores = pathwise.eval_paths(gp, ps, candidates)  # (q, m)

    def pick(taken, s):
        # mask out already-claimed candidates, then argmax
        masked = jnp.where(taken, -jnp.inf, s)
        i = jnp.argmax(masked)
        return taken.at[i].set(True), i

    taken0 = jnp.zeros(candidates.shape[0], dtype=bool)
    _, idx = jax.lax.scan(pick, taken0, scores)
    return idx, scores


def bo_update(gp: GP, state: BOState, x_new, y_new) -> BOState:
    """Absorb one (or a batch of) new observation(s); track the incumbent."""
    x_new = jnp.asarray(x_new, dtype=state.post.x.dtype)
    if x_new.ndim == 1:
        x_new = x_new[:, None] if gp.ndim == 1 and x_new.shape[0] != gp.ndim else x_new[None, :]
    y_new = jnp.atleast_1d(jnp.asarray(y_new, dtype=state.post.y.dtype))
    post = absorb_append(gp, state.post, x_new, y_new)
    i = jnp.argmax(y_new)
    better = y_new[i] > state.best_y
    best_x = jnp.where(better, x_new[i], state.best_x)
    best_y = jnp.where(better, y_new[i], state.best_y)
    return BOState(post, best_x, best_y)


def bo_run(
    gp: GP,
    theta_simil,
    theta_noise,
    objective: Callable[[Array], Array],
    candidates: Array,
    num_iters: int,
    key: Array,
    kind: str = "ei",
    n_init: int = 2,
    xi: float = 0.0,
    beta: float = 2.0,
) -> tuple[BOState, Array]:
    """Run BO against a jittable objective — the whole loop is one program.

    ``objective(x) -> scalar`` (maximized), evaluated in-graph; the
    candidate grid is fixed (static shapes).  ``n_init`` random grid
    points seed the posterior.  Returns (final state, (num_iters,) chosen
    ys).  For external (non-jittable) objectives drive
    :func:`acquire` / :func:`bo_update` yourself — each step is jittable
    on its own and compiles once.
    """
    candidates = jnp.asarray(candidates)
    if candidates.ndim == 1:
        candidates = candidates[:, None]
    capacity = n_init + num_iters
    state = bo_init(gp, theta_simil, theta_noise, capacity, candidates.dtype)

    key, sub = jax.random.split(key)
    init_idx = jax.random.choice(
        sub, candidates.shape[0], (n_init,), replace=False
    )
    x0 = candidates[init_idx]
    y0 = jax.vmap(lambda xx: objective(xx))(x0)
    state = bo_update(gp, state, x0, y0)

    def step(carry, k):
        st = carry
        idx, _ = acquire(gp, st, candidates, kind, k, xi, beta)
        x = candidates[idx]
        y = objective(x)
        st = bo_update(gp, st, x[None, :], y[None])
        return st, y

    keys = jax.random.split(key, num_iters)
    state, ys = jax.lax.scan(step, state, keys)
    return state, ys


__all__ = [
    "BOState",
    "acquire",
    "acquire_batch_thompson",
    "bo_init",
    "bo_run",
    "bo_update",
    "expected_improvement",
    "thompson_path_optimize",
    "thompson_path_scores",
    "upper_confidence_bound",
]
