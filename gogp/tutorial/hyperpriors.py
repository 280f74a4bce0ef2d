"""Case study: hyperparameter priors on a composite kernel.

Counterpart of reference tutorial/hyperpriors: a 5-theta similarity kernel —
Matérn-5/2 trend plus periodic seasonality with the period pre-scaled by 10
(hyperpriors/kernel/kernel.go:22-24) — 1-theta noise scaled by 0.01, and
Normal hyperpriors including the hierarchical "seasonality weight is below
trend weight" prior (hyperpriors/model/model.go:23-37).  Priors act on the
*log-scale* thetas (the reference restores theta to log scale before the
priors run, gp/gp.go:408-410).

Uses matern52_ref — the reference-compatible Matérn-5/2 with the d² coefficient
1 (see gogp.kernels.stationary) — for posterior parity.

Run:  python -m gogp.tutorial.hyperpriors [flags] selfcheck
"""

from __future__ import annotations

import math
from importlib import resources

import jax.numpy as jnp

from gogp import dists
from gogp.gp.core import GP
from gogp.kernels import Kernel, matern52_ref, periodic, uniform_noise
from gogp.tutorial.evaluate import Study, run_cli

_LOG2 = math.log(2.0)


def _simil_pair(theta, xa, xb):
    # theta = [c1 trend scale, c2 season scale, l1, l2, p] (natural scale)
    c1, c2, l1, l2, p = theta[0], theta[1], theta[2], theta[3], theta[4]
    trend = c1 * matern52_ref.pair(jnp.stack([l1]), xa, xb)
    season = c2 * periodic.pair(jnp.stack([l2, 10.0 * p]), xa, xb)
    return trend + season


simil = Kernel(5, _simil_pair, "trend+season")


def make_priors(x0, y0):
    def priors(v, mask):
        # v[:6] are log-scale thetas: c1, c2, l1, l2, p, s
        ll = dists.normal_logp(-1.0, 1.0, v[0])  # trend weight in (0, 1)
        ll += dists.normal_logp(v[0] - _LOG2, 1.0, v[1])  # season below trend
        ll += dists.normal_logp(0.0, 2.0, v[2])
        ll += dists.normal_logp(0.0, 2.0, v[3])
        ll += dists.normal_logp(0.0, 1.0, v[4])  # period approx known (x10 scale)
        ll += dists.normal_logp(0.0, 1.0, v[5])  # noise (x0.01 scale)
        return ll

    return priors


def make_study() -> Study:
    return Study(
        name="hyperpriors",
        gp=GP(ndim=1, simil=simil, noise=uniform_noise.scaled_by(0.01)),
        make_priors=make_priors,
    )


def selfcheck_data() -> str:
    return (
        resources.files("gogp.tutorial")
        .joinpath("data/trend_season.csv")
        .read_text()
    )


def main(argv=None):
    return run_cli(
        make_study,
        selfcheck_data(),
        "GP with hyperparameter priors: Matern52 trend + periodic seasonality.",
        argv=argv,
    )


if __name__ == "__main__":
    main()
