"""Case study: GP binary classification (beyond-reference, round 3).

The classification counterpart of the Evaluate rolling-forecast protocol
(reference tutorial/tutorial.go:56-230): for every prefix length ``end``,
re-initialize the hyperparameters with seeded jitter (tutorial.go:119-121
analogue), fit them by approximate-marginal-likelihood ascent (Laplace or
EP — ``-e``), and emit the one-step-ahead class probability p(y=1 | x_end).
Like the regression Evaluate, the whole rolling loop is ONE batched vmap
over prefix masks — the refits share a single compiled program.

Output CSV row (reference CSV-schema style, tutorial.go:185-197):

    x..., y_true, p_hat, lml0, lml, exp(theta)...

where lml0/lml are the approximate log marginal likelihood before/after
optimization (0 for prefixes at or below MINOPT, where optimization is
skipped per the reference protocol, tutorial.go:127).

Run:  python -m gogp.tutorial.classify [-e laplace|ep] --seed 0 selfcheck
"""

from __future__ import annotations

import sys
from importlib import resources
from typing import IO

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp import ep as ep_mod
from gogp.gp import laplace as lap_mod
from gogp.gp import likelihoods
from gogp.gp.core import GP
from gogp.infer import mle
from gogp.kernels import rbf
from gogp.tutorial import io as tio

MINOPT = 8  # reference MINOPT analogue (tutorial.go:26, :127)


def make_gp() -> GP:
    # amplitude + lengthscale RBF on the latent; jitter-only noise (the
    # observation model is the likelihood).
    return GP(ndim=1, simil=rbf.scaled())


def evaluate_classify(
    gp: GP,
    lik,
    x: np.ndarray,
    y: np.ndarray,
    engine: str = "laplace",
    seed: int = 0,
    iters: int = 200,
    rate: float = 0.05,
    minopt: int = MINOPT,
    theta0: np.ndarray | None = None,
    ess_chains: int = 4,
    ess_warmup: int = 200,
    ess_samples: int = 200,
):
    """Rolling one-step-ahead class-probability evaluation, batched.

    Returns CSV rows [x..., y_true, p_hat, lml0, lml, exp(theta)...].
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    if x.shape[0] == 1 and x.shape[1] > 1 and gp.ndim == 1:
        x = x.T
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n = x.shape[0]
    n_params = gp.n_theta + lik.n_theta
    rng = np.random.default_rng(seed)
    v00 = np.zeros(n_params) if theta0 is None else np.log(np.asarray(theta0))
    v0s = jnp.asarray(v00[None, :] + 0.1 * rng.normal(size=(n, n_params)))
    masks = jnp.asarray(
        (np.arange(n)[None, :] < np.arange(n)[:, None]).astype(np.float64)
    )
    iters_row = jnp.asarray(np.where(np.arange(n) <= minopt, 0, iters))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    nts, ntn = gp.n_theta_simil, gp.n_theta_noise

    if engine == "laplace":
        lml_fn = lap_mod.laplace_lml
        fit_fn, prob_fn = lap_mod.laplace_fit, lap_mod.laplace_predict_prob
    elif engine == "ep":
        lml_fn = ep_mod.ep_lml
        fit_fn, prob_fn = ep_mod.ep_fit, ep_mod.ep_predict_prob
    elif engine == "ess":
        # exact latent inference: hyperparameters fit by the Laplace
        # marginal (the standard Laplace-then-sample workflow), class
        # probabilities from elliptical-slice draws of the EXACT latent
        # posterior (infer/elliptical.py) instead of the Gaussian
        # approximation
        lml_fn = lap_mod.laplace_lml
        fit_fn = prob_fn = None
    else:
        raise ValueError(f"unknown engine {engine!r} (laplace|ep|ess)")

    def logp(v, mask):
        theta = jnp.exp(v)
        return lml_fn(
            gp, lik, theta[:nts], theta[nts + ntn :], xj, yj,
            theta_noise=theta[nts : nts + ntn], mask=mask,
        )

    def fit_row(v0, mask, it):
        l0 = logp(v0, mask)
        res = mle.adam(
            jax.value_and_grad(lambda v: logp(v, mask)), v0, iters=it, rate=rate
        )
        return res.x, l0, logp(res.x, mask)

    vs, lml0s, lmls = jax.jit(jax.vmap(fit_row))(v0s, masks, iters_row)

    if engine == "ess":
        from gogp.infer import elliptical as ess_mod

        key0 = jax.random.PRNGKey(seed)

        def pred_row(v, mask, z, row):
            theta = jnp.exp(v)
            res = ess_mod.run_ess_gp(
                gp, lik, theta[:nts], theta[nts + ntn :], xj, yj,
                jax.random.fold_in(key0, row),
                theta_noise=theta[nts : nts + ntn], mask=mask,
                num_chains=ess_chains, num_warmup=ess_warmup,
                num_samples=ess_samples,
            )
            return ess_mod.ess_predict_prob(gp, lik, res, z[None, :])[0]

        probs = jax.jit(jax.vmap(pred_row))(
            vs, masks, xj, jnp.arange(xj.shape[0])
        )
    else:
        def pred_row(v, mask, z):
            theta = jnp.exp(v)
            post = fit_fn(
                gp, lik, theta[:nts], theta[nts + ntn :], xj, yj,
                theta_noise=theta[nts : nts + ntn], mask=mask,
            )
            return prob_fn(gp, lik, post, z[None, :])[0]

        probs = jax.jit(jax.vmap(pred_row))(vs, masks, xj)

    rows = []
    vs_np, p_np = np.asarray(vs), np.asarray(probs)
    l0_np, l_np = np.asarray(lml0s), np.asarray(lmls)
    for end in range(n):
        rows.append(
            [*x[end], y[end], p_np[end], l0_np[end], l_np[end], *np.exp(vs_np[end])]
        )
    return rows


def selfcheck_data() -> str:
    return (
        resources.files("gogp.tutorial").joinpath("data/classify.csv").read_text()
    )


def main(argv=None, wtr: IO[str] | None = None):
    import argparse

    ap = argparse.ArgumentParser(
        description="GP binary classification (Laplace/EP) rolling evaluation."
    )
    ap.add_argument("-e", "--engine", default="laplace", choices=["laplace", "ep", "ess"])
    ap.add_argument("-a", default="adam", choices=["adam"],
                    help="(reference CLI shape; classification uses adam)")
    ap.add_argument("--probit", action="store_true",
                    help="probit link instead of logit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--platform", default="cpu", choices=tio.PLATFORMS,
                    help="cpu (default) or gpu; float64 on both")
    ap.add_argument("mode", nargs="?", default=None)
    args = ap.parse_args(argv)

    tio.select_platform(args.platform)

    tio.progress("loading...", end="")
    if args.mode == "selfcheck":
        x, y = tio.load_csv(selfcheck_data())
    elif args.mode is None:
        x, y = tio.load_csv(sys.stdin)
    else:
        raise SystemExit(f"usage: unknown mode {args.mode!r}")
    tio.progress("done")

    lik = likelihoods.bernoulli_probit if args.probit else likelihoods.bernoulli_logit
    tio.progress("Classifying...")
    rows = evaluate_classify(
        make_gp(), lik, x, y,
        engine=args.engine, seed=args.seed, iters=args.iters, rate=args.rate,
    )
    tio.write_forecast_rows(wtr or sys.stdout, rows)
    tio.progress("done")
    return rows


if __name__ == "__main__":
    main()
