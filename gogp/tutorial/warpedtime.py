"""Case study: warped (latent) time — inputs inferred jointly with thetas.

Counterpart of reference tutorial/warpedtime: OPTINP mode puts inputs and
outputs into the parameter vector (warpedtime/main.go:59); priors put
N(1, sigma) on *relative* input steps against the initial steps, which are
closed over from the data (model/model.go:22-40 memoization → trace-time
closure here); the first and last input and all outputs are pinned
(main.go:44-56 gradient surgery → free mask here).

Run:  python -m gogp.tutorial.warpedtime [flags] selfcheck
Flags: --logsigma (log std of relative step, default log 0.5),
       --show-warp (re-emit rows at the warped inputs).
"""

from __future__ import annotations

import math
import sys
from importlib import resources

import jax.numpy as jnp
import numpy as np

from gogp import dists
from gogp.gp.core import GP
from gogp.kernels import matern52_ref, uniform_noise
from gogp.models.params import gp_posterior
from gogp.gp.core import predict_from_posterior
from gogp.tutorial.evaluate import Study, run_cli
from gogp.tutorial import io as tio


def make_priors(x0, y0, logsigma=math.log(0.5)):
    n = x0.shape[0]
    step0 = jnp.asarray(x0[1:, 0] - x0[:-1, 0])  # initial steps, trace-time constant
    sigma = math.exp(logsigma)

    def priors(v, mask):
        # v = [log c, log l, log s, x_0..x_{n-1}, y_0..y_{n-1}]
        ll = dists.normal_logp(-1.0, 1.0, v[0])  # output scale mostly < 1
        ll += dists.normal_logp(0.0, 2.0, v[1])  # length scale around 1
        ll += dists.normal_logp(0.5, 1.0, v[2])  # noise (x0.01 scale)
        xs = v[3 : 3 + n]
        ratio = (xs[1:] - xs[:-1]) / step0
        # step term i involves x_i and x_{i+1}: active iff x_{i+1} is real
        terms = dists.normal_logp(1.0, sigma, ratio) * mask[1:]
        return ll + jnp.sum(terms)

    return priors


def free_fn(n_theta: int, n: int, end: int) -> np.ndarray:
    """Pin the first and last (real) input and all outputs
    (warpedtime/main.go:44-56)."""
    free = np.ones(n_theta + 2 * n)
    free[n_theta + n :] = 0.0  # all outputs
    if end > 0:
        free[n_theta] = 0.0  # first input
        free[n_theta + end - 1] = 0.0  # last real input
    return free


def make_study(logsigma=math.log(0.5)) -> Study:
    return Study(
        name="warpedtime",
        gp=GP(
            ndim=1,
            simil=matern52_ref.scaled(),
            noise=uniform_noise.scaled_by(0.01),
        ),
        optinp=True,
        make_priors=lambda x0, y0: make_priors(x0, y0, logsigma),
        free_fn=free_fn,
    )


def selfcheck_data() -> str:
    return (
        resources.files("gogp.tutorial").joinpath("data/regimes.csv").read_text()
    )


def _extra_flags(ap):
    # Single-dash aliases mirror the reference's Go-style flags
    # (warpedtime/main.go:34-37) for drop-in command compatibility.
    ap.add_argument(
        "--logsigma",
        "-logsigma",
        type=float,
        default=math.log(0.5),
        help="log standard deviation of relative step",
    )
    ap.add_argument(
        "--show-warp", "-show-warp", action="store_true", help="show warped inputs"
    )


def main(argv=None):
    import io as _io

    # --show-warp buffers rows and re-emits them at the warped inputs
    # (reference warpedtime/main.go:90-116): the patched columns are the
    # warped x, the (normalized) stored y, and mu/sigma at the warped inputs
    # from the final fit; the trailing columns are kept; the last line is
    # left unmodified (its input is pinned).
    raw_args = sys.argv[1:] if argv is None else argv
    show_warp = "--show-warp" in raw_args
    buffered = _io.StringIO() if show_warp else None

    args, cfg, study, result = run_cli(
        lambda a: make_study(logsigma=a.logsigma),
        selfcheck_data(),
        "GP with warped (latent) time inputs.",
        extra_flags=_extra_flags,
        argv=argv,
        wtr=buffered,
    )
    if not getattr(args, "show_warp", False):
        return args, cfg, study, result

    gp = study.gp
    n_theta = gp.n_theta
    n = result.x.shape[0]
    v_last = jnp.asarray(result.v_all[-1])
    mask_last = jnp.asarray(result.masks[-1])
    post = gp_posterior(gp, v_last, mask=mask_last)
    x_warp = np.asarray(v_last[n_theta : n_theta + n])
    y_lat = np.asarray(v_last[n_theta + n :])
    mu, sigma = predict_from_posterior(gp, post, jnp.asarray(x_warp)[:, None])
    mu, sigma = np.asarray(mu), np.asarray(sigma)

    patched = []
    for i, row in enumerate(result.rows):
        if i < n - 1:
            patched.append([x_warp[i], y_lat[i], mu[i], sigma[i]] + row[4:])
        else:
            patched.append(row)
    tio.write_forecast_rows(sys.stdout, patched)
    return args, cfg, study, result


if __name__ == "__main__":
    main()
