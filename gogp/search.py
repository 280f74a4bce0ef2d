"""Automatic kernel-structure discovery: greedy compositional search.

The reference hard-codes one kernel per study (trend+seasonality chosen by
hand for hyperpriors, tutorial/hyperpriors/kernel/kernel.go:22-24).  This
module searches the compositional kernel grammar instead — the core of the
"automatic statistician" approach (Duvenaud et al. 2013, compositional
kernel search): starting from base kernels, greedily grow

    K  ->  K + B   |   K * B        (B in the base vocabulary)

accepting the move that most improves a complexity-penalized score (BIC by
default) and stopping when no move improves it.

Shape of the problem: every CANDIDATE is a different XLA program (a
different fused covariance kernel), so candidates loop in Python — but all
RESTARTS of one candidate are a single vmapped multi-start Adam fit (one
batched covariance + batched Cholesky per optimizer step, the same shape
as tutorial/evaluate.py's batched-prefix refits).  The per-candidate cost
is therefore one compile + one batched fit, regardless of restart count.

Scores: "bic" (default) and "aic" penalize by parameter count;
"loo" uses the exact leave-one-out pseudo-likelihood
(gp/model_selection.py) — all computed at the multi-start MLE.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp import core, model_selection
from gogp.infer import mle
from gogp.kernels import (
    linear,
    matern12,
    matern32,
    matern52,
    normal,
    periodic,
    rational_quadratic,
    uniform_noise,
)
from gogp.kernels.base import Kernel
from gogp.models.params import gp_observe

Array = jax.Array

#: Base vocabulary; every base enters compositions with its own output
#: scale (``.scaled()``), the standard CKS convention.
BASE_KERNELS: dict[str, Kernel] = {
    "rbf": normal,
    "matern12": matern12,
    "matern32": matern32,
    "matern52": matern52,
    "periodic": periodic,
    "rq": rational_quadratic,
    "linear": linear,
}


class Candidate(NamedTuple):
    name: str
    kernel: Kernel  # similarity kernel (bases already scaled)
    v_opt: Array  # (n_theta_total,) log-scale optimum incl. noise theta
    lml: float
    score: float


class SearchResult(NamedTuple):
    """Winning structure + the full greedy trace (one Candidate per
    accepted round, best-first history for inspection)."""

    kernel: Kernel
    name: str
    v_opt: Array
    lml: float
    score: float
    history: list  # list[Candidate], accepted move per round
    y_mean: float
    y_std: float


def _fit_candidate(kernel: Kernel, x, y, key, restarts: int, iters: int, rate: float):
    """Multi-restart Adam MLE of (kernel + uniform noise); returns the best
    (log-theta vector, lml).  Restarts are vmapped — one compiled program."""
    gp = core.GP(ndim=x.shape[1], simil=kernel, noise=uniform_noise)
    f = jax.value_and_grad(lambda v: gp_observe(gp, v, x=x, y=y))

    def one(k):
        v0 = 0.7 * jax.random.normal(k, (gp.n_theta,), dtype=x.dtype)
        res = mle.adam(f, v0, iters=iters, rate=rate)
        return res.x, res.value

    vs, vals = jax.vmap(one)(jax.random.split(key, restarts))
    vals = jnp.where(jnp.isnan(vals), -jnp.inf, vals)
    i = jnp.argmax(vals)
    return vs[i], float(vals[i]), gp


def _score(kind: str, gp, v_opt, lml_value: float, x, y) -> float:
    n = x.shape[0]
    if kind == "bic":
        return float(model_selection.bic(lml_value, gp.n_theta, n))
    if kind == "aic":
        return float(model_selection.aic(lml_value, gp.n_theta))
    if kind == "loo":
        theta = jnp.exp(v_opt)
        nts = gp.n_theta_simil
        return -float(
            model_selection.loo_score(gp, theta[:nts], theta[nts:], x, y)
        )
    raise ValueError(f"unknown score {kind!r}")


def search(
    x,
    y,
    bases: Sequence[str] = ("rbf", "matern32", "periodic", "linear"),
    max_depth: int = 3,
    restarts: int = 8,
    iters: int = 400,
    rate: float = 0.05,
    score: str = "bic",
    min_improvement: float = 0.0,
    normalize_y: bool = True,
    key=None,
) -> SearchResult:
    """Greedy compositional kernel search on (x, y).

    Round 0 fits every base alone; later rounds try ``current + B`` and
    ``current * B`` for every base, accepting the best scoring move while
    it improves the incumbent score by more than ``min_improvement``
    (scores are "lower is better").  Returns the winning kernel (bases
    scaled, ready for ``GP(simil=...)`` with ``uniform_noise``), its
    log-scale optimum, and the accepted-move history.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, dtype=float)
    y_mean, y_std = (float(y.mean()), float(y.std())) if normalize_y else (0.0, 1.0)
    if normalize_y and y_std > 0:
        y = (y - y_mean) / y_std
    yj = jnp.asarray(y, dtype=x.dtype)

    vocab = {b: BASE_KERNELS[b].scaled() for b in bases}
    history: list[Candidate] = []
    incumbent: Candidate | None = None

    for depth in range(max_depth):
        if incumbent is None:
            moves = [(name, k) for name, k in vocab.items()]
        else:
            moves = []
            for name, k in vocab.items():
                moves.append((f"({incumbent.name}+{name})", incumbent.kernel + k))
                moves.append((f"({incumbent.name}*{name})", incumbent.kernel * k))
        best: Candidate | None = None
        for i, (name, kern) in enumerate(moves):
            key, sub = jax.random.split(key)
            v_opt, lml_value, gp = _fit_candidate(kern, x, yj, sub, restarts, iters, rate)
            if not np.isfinite(lml_value):
                continue
            s = _score(score, gp, v_opt, lml_value, x, yj)
            if best is None or s < best.score:
                best = Candidate(name, kern, v_opt, lml_value, s)
        if best is None:
            break
        if incumbent is not None and best.score >= incumbent.score - min_improvement:
            break
        incumbent = best
        history.append(best)

    if incumbent is None:
        raise RuntimeError("kernel search found no finite-LML candidate")
    return SearchResult(
        incumbent.kernel,
        incumbent.name,
        incumbent.v_opt,
        incumbent.lml,
        incumbent.score,
        history,
        y_mean,
        y_std,
    )


__all__ = ["BASE_KERNELS", "Candidate", "SearchResult", "search"]
