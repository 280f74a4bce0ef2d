"""Case study: non-Gaussian (Laplace) observation noise via latent outputs.

Counterpart of reference tutorial/anynoise: the noise kernel contributes only
a 1e-5 jitter but allocates one theta slot (anynoise/kernel/kernel.go:31-35)
that the priors consume as the Laplace scale; OPTINP mode infers latent
outputs, the noise model ties them to the observed outputs via
Expon.Logp(1/exp(s), |y_obs - y_latent|) (anynoise/model/model.go:40-43);
inputs are pinned, outputs free (main.go:33-44).

The observed outputs are closed over from the (normalized) data — the
functional version of the priors' memoize-on-first-call (model.go:20-25).

Run:  python -m gogp.tutorial.anynoise [flags] selfcheck
"""

from __future__ import annotations

from importlib import resources

import jax.numpy as jnp
import numpy as np

from gogp import dists
from gogp.gp.core import GP
from gogp.kernels import jitter_only_noise, matern52_ref
from gogp.tutorial.evaluate import Study, run_cli


def make_priors(x0, y0):
    n = y0.shape[0]
    y_obs = jnp.asarray(y0)  # memoized observed outputs (normalized)

    def priors(v, mask):
        # v = [log c, log l, log s, x_0..x_{n-1}, y_0..y_{n-1}]
        ll = dists.normal_logp(-1.0, 1.0, v[0])  # output scale mostly < 1
        ll += dists.normal_logp(0.0, 2.0, v[1])  # length scale around 1
        ll += dists.normal_logp(-1.0, 2.0, v[2])  # noise std below 1
        y_lat = v[3 + n :]
        lam = 1.0 / jnp.exp(v[2])
        terms = dists.expon_logp(lam, jnp.abs(y_obs - y_lat)) * mask
        return ll + jnp.sum(terms)

    return priors


def free_fn(n_theta: int, n: int, end: int) -> np.ndarray:
    """Pin all inputs, keep outputs free (anynoise/main.go:33-44)."""
    free = np.ones(n_theta + 2 * n)
    free[n_theta : n_theta + n] = 0.0
    return free


def make_study() -> Study:
    return Study(
        name="anynoise",
        gp=GP(ndim=1, simil=matern52_ref.scaled(), noise=jitter_only_noise(1e-5)),
        optinp=True,
        make_priors=make_priors,
        free_fn=free_fn,
    )


def selfcheck_data() -> str:
    return resources.files("gogp.tutorial").joinpath("data/sine.csv").read_text()


def main(argv=None):
    return run_cli(
        make_study,
        selfcheck_data(),
        "GP with non-Gaussian (Laplace) observation noise via latent outputs.",
        argv=argv,
    )


if __name__ == "__main__":
    main()
