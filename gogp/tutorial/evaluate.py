"""Rolling one-step-out-of-sample forecast driver.

Counterpart of the reference ``Evaluate`` (tutorial/tutorial.go:56-230) with
its exact protocol (SURVEY.md §2.1-9):

- Y normalized to zero mean / unit sample-std unless disabled (:78-86);
- for each prefix length ``end`` in 0..N-1: re-initialize theta to
  ``theta0 + 0.1*N(0,1)`` jitter (:119-121), record the initial
  log-density, fit on ``X[:end]`` (skipped while ``end <= minopt``, :127),
  record the final log-density, forecast ``X[end]``;
- output CSV row: ``x..., y_true*std+mean, mu*std+mean, sigma*std,
  lml0, lml, exp(theta)...`` (:185-197);
- optionally a whole-horizon out-of-sample forecast at ``X shifted by
  X[-1]`` from the last fit (:200-225).

Accelerator-first redesign: the reference runs the N refits serially, each a fresh
optimization (tutorial.go:91).  The refits are independent given their
jittered inits, so here every prefix length becomes one row of a *batched*
problem — fixed padded shapes with a 0/1 mask per prefix — and a single
``jit(vmap(fit))`` call optimizes and forecasts all N fits in one XLA
program.  The jitter is drawn from an explicit PRNG seed (the reference
seeds by wallclock, tutorial.go:36, so its runs are irreproducible; ours
take ``--seed``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import IO, Callable

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp.core import GP, predict_from_posterior
from gogp.infer import mle
from gogp.models.model import masked_value_and_grad
from gogp.models.params import gp_observe, gp_posterior
from gogp.tutorial import io as tio

Array = jax.Array

# Log-density of priors given the full padded parameter vector and the
# 0/1 observation mask for the current prefix.
PriorsFn = Callable[[Array, Array], Array]


@dataclasses.dataclass
class EvalConfig:
    """Shared knobs — names/semantics follow the reference flag set
    (tutorial/tutorial.go:21-45)."""

    alg: str = "lbfgs"  # -a: "lbfgs" | "adam"
    iters: int = 1000  # ITERS (major iterations)
    # MINITERS: an LBFGS failure (stall) is tolerated silently unless it
    # happens before this many iterations, in which case it is logged and
    # the run continues (reference tutorial.go:144-155).
    min_iters: int = 10
    threshold: float = 1e-6  # THRESHOLD (gradient)
    rate: float = 0.01  # RATE (adam)
    minopt: int = 0  # MINOPT: optimize only when n > minopt
    normalize: bool = True  # !NONORMALIZE (-n)
    out_of_sample: bool = False  # OUTOFSAMPLE (-o)
    seed: int = 0
    batched: bool = True  # vmap all prefix fits vs python loop


@dataclasses.dataclass
class Study:
    """A case study: GP spec + optional priors + optional constraints.

    ``make_priors(X0, Y0)`` closes over the *initial* (normalized) data —
    the functional version of the reference priors' memoize-on-first-call
    (warpedtime/model/model.go:22-40, anynoise/model/model.go:20-25,
    SURVEY.md §2.1-11).
    ``free_fn(n_theta, n, end)`` returns the study's 0/1 free mask over the
    full padded parameter vector for prefix length ``end`` — the functional
    version of the tutorials' Gradient() surgery (SURVEY.md §2.1-10).
    """

    name: str
    gp: GP
    optinp: bool = False
    make_priors: Callable[[np.ndarray, np.ndarray], PriorsFn] | None = None
    free_fn: Callable[[int, int, int], np.ndarray] | None = None


@dataclasses.dataclass
class EvalResult:
    rows: list  # forecast CSV rows (floats)
    v_all: np.ndarray  # (N, P) optimized parameter vectors per prefix
    masks: np.ndarray  # (N, N) observation masks per prefix
    mean_y: float
    std_y: float
    x: np.ndarray  # original inputs (N, d)
    y_norm: np.ndarray  # normalized outputs (N,)


def _padding_free(study: Study, n_theta: int, n: int, ndim: int, end: int) -> np.ndarray:
    """Free mask for one prefix: padding beyond ``end`` is always pinned;
    the study's own constraint composes on top."""
    p = n_theta + n * (ndim + 1)
    free = np.ones(p)
    xs, ys = n_theta, n_theta + n * ndim
    free[xs + end * ndim : ys] = 0.0
    free[ys + end :] = 0.0
    if study.free_fn is not None:
        free = free * study.free_fn(n_theta, n, end)
    return free


def evaluate(
    study: Study,
    x: np.ndarray,
    y: np.ndarray,
    theta0: np.ndarray | None = None,
    config: EvalConfig | None = None,
    wtr: IO[str] | None = None,
) -> EvalResult:
    """Run the rolling-forecast protocol; optionally stream rows to ``wtr``."""
    cfg = config or EvalConfig()
    gp = study.gp
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    if x.shape[0] == 0:
        return EvalResult([], np.zeros((0, 0)), np.zeros((0, 0)), 0.0, 1.0, x, y)
    if x.shape[1] != gp.ndim:
        x = x.reshape(-1, gp.ndim)
    y = np.asarray(y, dtype=np.float64)
    n, ndim = x.shape
    n_theta = gp.n_theta
    if theta0 is None:
        theta0 = np.zeros(n_theta)

    if cfg.normalize:
        y_norm, mean_y, std_y = tio.normalize(y)
    else:
        y_norm, mean_y, std_y = y, 0.0, 1.0

    xj = jnp.asarray(x)
    yj = jnp.asarray(y_norm)

    # theta jitter per prefix (tutorial.go:119-121), explicit seed.
    key = jax.random.PRNGKey(cfg.seed)
    jitter = 0.1 * jax.random.normal(key, (n, n_theta), dtype=xj.dtype)
    theta_init = jnp.asarray(theta0)[None, :] + jitter  # (n, n_theta)

    # prefix masks: row e has ones at 0..e-1
    masks_np = (np.arange(n)[None, :] < np.arange(n)[:, None]).astype(np.float64)
    masks = jnp.asarray(masks_np)

    priors = study.make_priors(x, y_norm) if study.make_priors else None

    if study.optinp:
        data_flat = jnp.concatenate([xj.reshape(-1), yj])
        v_init = jnp.concatenate(
            [theta_init, jnp.broadcast_to(data_flat, (n, data_flat.shape[0]))], axis=1
        )
        frees = jnp.asarray(
            np.stack([_padding_free(study, n_theta, n, ndim, e) for e in range(n)])
        )

        def logp(v, mask):
            ll = gp_observe(gp, v, mask=mask)
            if priors is not None:
                ll = ll + priors(v, mask)
            return ll

        def posterior(v, mask):
            return gp_posterior(gp, v, mask=mask)

    else:
        v_init = theta_init
        frees = jnp.ones((n, n_theta), dtype=xj.dtype)
        if study.free_fn is not None:
            frees = jnp.asarray(
                np.stack([study.free_fn(n_theta, n, e)[:n_theta] for e in range(n)])
            )

        def logp(v, mask):
            ll = gp_observe(gp, v, x=xj, y=yj, mask=mask)
            if priors is not None:
                ll = ll + priors(v, mask)
            return ll

        def posterior(v, mask):
            return gp_posterior(gp, v, x=xj, y=yj, mask=mask)

    def fit_one(v0, mask, free, z):
        lp = lambda v: logp(v, mask)  # noqa: E731
        lml0 = lp(v0)
        if cfg.alg == "adam":
            res = mle.adam(
                masked_value_and_grad(lp, free),
                v0,
                iters=cfg.iters,
                rate=cfg.rate,
                threshold=cfg.threshold,
            )
        else:
            res = mle.lbfgs(
                lp, v0, iters=cfg.iters, threshold=cfg.threshold, free=free
            )
        v = res.x
        lml = lp(v)
        post = posterior(v, mask)
        mu, sigma = predict_from_posterior(gp, post, z[None, :])
        early_stall = res.stalled & (res.iters < cfg.min_iters)
        return v, lml0, lml, mu[0], sigma[0], res.iters, early_stall

    def skip_one(v0, mask, z):
        # MINOPT rows (reference tutorial.go:127): no optimization at all —
        # partitioned out of the batched fit rather than masked inside it,
        # so their optimizer FLOPs are never spent
        lp0 = logp(v0, mask)
        post = posterior(v0, mask)
        mu, sigma = predict_from_posterior(gp, post, z[None, :])
        zero = jnp.zeros((), jnp.int32)
        return v0, lp0, lp0, mu[0], sigma[0], zero, zero.astype(bool)

    do_opt_np = np.arange(n) > cfg.minopt  # static: partition, don't mask
    opt_idx = np.flatnonzero(do_opt_np)
    skip_idx = np.flatnonzero(~do_opt_np)

    tio.progress("Forecasting...")
    outs = [None] * n
    if cfg.batched:
        if opt_idx.size:
            o = jax.jit(jax.vmap(fit_one))(
                v_init[opt_idx], masks[opt_idx], frees[opt_idx], xj[opt_idx]
            )
            for j, e in enumerate(opt_idx):
                outs[e] = [np.asarray(t)[j] for t in o]
        if skip_idx.size:
            o = jax.jit(jax.vmap(skip_one))(
                v_init[skip_idx], masks[skip_idx], xj[skip_idx]
            )
            for j, e in enumerate(skip_idx):
                outs[e] = [np.asarray(t)[j] for t in o]
    else:
        fit_jit = jax.jit(fit_one)
        skip_jit = jax.jit(skip_one)
        for e in range(n):
            if do_opt_np[e]:
                o = fit_jit(v_init[e], masks[e], frees[e], xj[e])
            else:
                o = skip_jit(v_init[e], masks[e], xj[e])
            outs[e] = [np.asarray(t) for t in o]
    v_all, lml0_all, lml_all, mu_all, sigma_all, iters_all, stall_all = (
        np.stack([outs[e][i] for e in range(n)]) for i in range(7)
    )

    # MINITERS stall reporting (reference tutorial.go:144-155): a stalled
    # optimizer is tolerated, but a stall before min_iters is logged; the
    # run always continues with whatever point the optimizer reached.
    for e in np.flatnonzero(stall_all):
        tio.progress(
            f"{e}: optimization stuck after {int(iters_all[e])} "
            f"iterations (< {cfg.min_iters})"
        )

    v_all = np.asarray(v_all)
    lml0_all = np.asarray(lml0_all)
    lml_all = np.asarray(lml_all)
    mu_all = np.asarray(mu_all)
    sigma_all = np.asarray(sigma_all)

    rows = []
    for e in range(n):
        row = list(x[e])
        row += [
            y_norm[e] * std_y + mean_y,
            mu_all[e] * std_y + mean_y,
            sigma_all[e] * std_y,
            lml0_all[e],
            lml_all[e],
        ]
        row += list(np.exp(v_all[e, :n_theta]))
        rows.append(row)

    if wtr is not None:
        tio.write_forecast_rows(wtr, rows)

    result = EvalResult(rows, v_all, masks_np, mean_y, std_y, x, y_norm)

    if cfg.out_of_sample and n > 1:
        oos_rows = out_of_sample_rows(study, result)
        result.rows.extend(oos_rows)
        if wtr is not None:
            tio.write_forecast_rows(wtr, oos_rows)

    tio.progress("done")
    return result


def out_of_sample_rows(study: Study, result: EvalResult) -> list:
    """Whole-horizon forecast at X shifted by X[-1], from the last prefix fit
    (reference tutorial.go:200-225).  Row: ``z..., nan, mu, sigma``."""
    gp = study.gp
    x, n = result.x, result.x.shape[0]
    z = (x + x[-1])[1:]
    v_last = jnp.asarray(result.v_all[-1])
    mask_last = jnp.asarray(result.masks[-1])
    if study.optinp:
        post = gp_posterior(gp, v_last, mask=mask_last)
    else:
        post = gp_posterior(
            gp, v_last, x=jnp.asarray(x), y=jnp.asarray(result.y_norm), mask=mask_last
        )
    mu, sigma = predict_from_posterior(gp, post, jnp.asarray(z))
    mu = np.asarray(mu) * result.std_y + result.mean_y
    sigma = np.asarray(sigma) * result.std_y
    return [
        list(z[i]) + [float("nan"), mu[i], sigma[i]] for i in range(z.shape[0])
    ]


def run_cli(
    study_factory: Callable[..., Study],
    selfcheck_data: str,
    description: str,
    extra_flags: Callable | None = None,
    argv: list[str] | None = None,
    wtr: IO[str] | None = None,
):
    """Shared CLI for the case studies — flags mirror the reference's
    (tutorial.go:35-45) plus an explicit --seed and --platform."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-a", default="lbfgs", choices=["lbfgs", "adam"], help="optimization algorithm")
    ap.add_argument("-p", action="store_true", help="(accepted for reference CLI parity; batching is always on — see --sequential)")
    ap.add_argument("-n", action="store_true", help="do not normalize outputs")
    ap.add_argument("-o", action="store_true", help="forecast out of sample")
    ap.add_argument("--seed", type=int, default=0, help="PRNG seed for theta jitter")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--rate", type=float, default=0.01)
    ap.add_argument("--sequential", action="store_true", help="fit prefixes one by one instead of one batched vmap")
    ap.add_argument("--platform", default="cpu", choices=tio.PLATFORMS,
                    help="cpu (default for these tiny datasets) or gpu; float64 on both")
    if extra_flags is not None:
        extra_flags(ap)
    ap.add_argument("mode", nargs="?", default=None, help="'selfcheck' to use embedded data")
    args = ap.parse_args(argv)

    tio.select_platform(args.platform)

    tio.progress("loading...", end="")
    if args.mode == "selfcheck":
        x, y = tio.load_csv(selfcheck_data)
    elif args.mode is None:
        x, y = tio.load_csv(sys.stdin)
    else:
        raise SystemExit(f"usage: unknown mode {args.mode!r}")
    tio.progress("done")

    cfg = EvalConfig(
        alg=args.a,
        iters=args.iters,
        rate=args.rate,
        normalize=not args.n,
        out_of_sample=args.o,
        seed=args.seed,
        batched=not args.sequential,
    )
    study = study_factory(args) if extra_flags is not None else study_factory()
    result = evaluate(study, x, y, config=cfg, wtr=sys.stdout if wtr is None else wtr)
    return args, cfg, study, result
