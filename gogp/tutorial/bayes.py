"""Bayesian forecast driver: full-posterior inference on a case study.

The reference's Evaluate loop is MLE-only (tutorial/tutorial.go:128-169);
this driver runs a sampler over the study's log-joint — NUTS, HMC,
ChEES-HMC, ADVI or SMC (BASELINE.json configs: "hyperpriors: NUTS posterior over
hyperparameters", "anynoise: HMC + ADVI comparison") — then forecasts with
the moment-matched posterior-predictive mixture over draws
(gogp.gp.predict_mixture semantics, generalized to latent-input
studies by conditioning each draw's full parameter vector).

Output CSV rows: ``z..., nan, mu, sigma`` (the out-of-sample schema of
tutorial/tutorial.go:200-225) for a forecast grid extending one span past
the data, plus a trailing comment line with posterior hyperparameter
means.

Usage:
    python -m gogp.tutorial.bayes hyperpriors --engine nuts  selfcheck
    python -m gogp.tutorial.bayes anynoise    --engine advi  selfcheck
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gogp import infer
from gogp.gp.core import predict_from_posterior
from gogp.models.params import gp_observe, gp_posterior, join_params
from gogp.tutorial import io as tio

STUDIES = ("barebones", "hyperpriors", "warpedtime", "anynoise", "events")


def get_study(name: str):
    import importlib

    mod = importlib.import_module(f"gogp.tutorial.{name}")
    return mod, mod.make_study(), mod.selfcheck_data()


def build_logjoint(study, x: np.ndarray, y: np.ndarray):
    """Log-joint over the study's full parameter vector + the free mask."""
    gp = study.gp
    n, ndim = x.shape
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    mask = jnp.ones(n)
    priors = study.make_priors(x, y) if study.make_priors else None

    if study.optinp:
        v0 = join_params(gp, jnp.zeros(gp.n_theta), xj, yj)
        free = np.ones(v0.shape[0])
        if study.free_fn is not None:
            free = free * study.free_fn(gp.n_theta, n, n)

        def logp(v):
            ll = gp_observe(gp, v, mask=mask)
            if priors is not None:
                ll = ll + priors(v, mask)
            return ll

        def posterior_of(v):
            return gp_posterior(gp, v, mask=mask)

    else:
        v0 = jnp.zeros(gp.n_theta)
        free = np.ones(gp.n_theta)
        if study.free_fn is not None:
            free = free * study.free_fn(gp.n_theta, n, n)[: gp.n_theta]

        def logp(v):
            ll = gp_observe(gp, v, x=xj, y=yj, mask=mask)
            if priors is not None:
                ll = ll + priors(v, mask)
            return ll

        def posterior_of(v):
            return gp_posterior(gp, v, x=xj, y=yj, mask=mask)

    return logp, posterior_of, v0, jnp.asarray(free)


def sample_posterior(logp, v0, free, engine: str, seed: int, num_samples: int,
                     num_warmup: int, chains: int, pops: int = 1,
                     replicas: int = 8, race: int = 0):
    key = jax.random.PRNGKey(seed)
    if engine == "chees":
        # population sampler: the chain axis lives inside the state (shared
        # adaptive trajectory), so no vmap — one call owns all chains;
        # pops > 1 splits them into independent populations, each adapting
        # its own kernel (infer.run_chees_pops)
        x0 = v0[None, :] + 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), (chains, v0.shape[0])
        ) * free[None, :]
        if pops > 1:
            run = lambda q, k: infer.run_chees_pops(
                logp, q, k, n_pops=pops, num_warmup=num_warmup,
                num_samples=max(1, num_samples // chains), free=free,
            )
        else:
            # race > 0: post-warmup trajectory-length selection
            # (infer.chees.chees_race) — the adaptation-draw variance fix
            run = lambda q, k: infer.run_chees(
                logp, q, k, num_warmup=num_warmup,
                num_samples=max(1, num_samples // chains), free=free,
                race=race, race_probe=min(128, max(32, num_warmup // 4)),
            )
        res = jax.jit(run)(x0, key)
        draws = np.asarray(res.positions).reshape(-1, v0.shape[0])
    elif engine in ("nuts", "hmc"):
        runner = infer.run_nuts if engine == "nuts" else infer.run_hmc
        keys = jax.random.split(key, chains)
        x0 = v0[None, :] + 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), (chains, v0.shape[0])
        ) * free[None, :]
        res = jax.jit(
            jax.vmap(
                lambda q, k: runner(
                    logp, q, k, num_warmup=num_warmup,
                    num_samples=num_samples // chains, free=free,
                )
            )
        )(x0, keys)
        draws = np.asarray(res.positions).reshape(-1, v0.shape[0])
    elif engine == "pt-chees":
        # parallel tempering with ChEES rung populations: --chains ladders
        # x --replicas rungs; cold-chain draws of every ladder are pooled
        # (infer/pt_chees.py — the multimodal-posterior engine)
        from gogp.infer.pt_chees import run_pt_chees

        x0 = v0[None, :] + 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), (chains, v0.shape[0])
        ) * free[None, :]
        res = run_pt_chees(
            logp, x0, key, n_ladders=chains, n_replicas=replicas,
            num_warmup=num_warmup,
            num_samples=max(1, num_samples // chains), free=free,
        )
        draws = np.asarray(res.positions).reshape(-1, v0.shape[0])
    elif engine == "ghmc":
        # persistent-momentum GHMC (infer/ghmc.py): one gradient per
        # transition, cross-fold ensemble preconditioning, no trajectory
        # knob — so it takes many more (much cheaper) transitions than
        # chees for the same draw budget; thin to the requested count
        x0 = v0[None, :] + 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), (chains, v0.shape[0])
        ) * free[None, :]
        per = max(1, num_samples // chains)
        oversample = 16  # transitions per kept draw (autocorrelation)
        res = jax.jit(
            lambda q, k: infer.run_ghmc(
                logp, q, k, num_warmup=max(num_warmup * 4, 512),
                num_samples=per * oversample, free=free,
            )
        )(x0, key)
        draws = np.asarray(res.positions[::oversample]).reshape(-1, v0.shape[0])
    elif engine == "advi":
        res = infer.run_advi(logp, v0, key, num_steps=num_warmup * 4, free=free)
        draws = np.asarray(
            infer.sample_posterior(res, jax.random.PRNGKey(seed + 2), num_samples, free)
        )
    elif engine == "advi-full":
        # full-rank q: captures the amplitude/lengthscale/noise correlations
        # a diagonal q cannot (infer/advi.py full-rank section)
        res = infer.run_advi_fullrank(
            logp, v0, key, num_steps=num_warmup * 4, free=free
        )
        draws = np.asarray(
            infer.sample_posterior_fullrank(
                res, jax.random.PRNGKey(seed + 2), num_samples, free
            )
        )
    elif engine == "smc":
        res = infer.run_smc(
            logp, v0, key, num_particles=max(num_samples, 128), free=free
        )
        draws = np.asarray(res.particles)
    else:
        raise SystemExit(f"unknown engine {engine!r}")
    return draws


def mixture_forecast(gp, posterior_of, draws: np.ndarray, z: np.ndarray,
                     max_draws: int = 256):
    if draws.shape[0] > max_draws:
        idx = np.linspace(0, draws.shape[0] - 1, max_draws).astype(int)
        draws = draws[idx]
    zj = jnp.asarray(z)

    def one(v):
        post = posterior_of(v)
        return predict_from_posterior(gp, post, zj)

    mus, sigmas = jax.jit(jax.vmap(one))(jnp.asarray(draws))
    mus, sigmas = np.asarray(mus), np.asarray(sigmas)
    mu = mus.mean(axis=0)
    var = (sigmas**2 + mus**2).mean(axis=0) - mu**2
    return mu, np.sqrt(np.maximum(var, 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("study", choices=STUDIES)
    ap.add_argument(
        "--engine", default="nuts",
        choices=["nuts", "hmc", "chees", "pt-chees", "ghmc", "advi", "advi-full", "smc"],
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=8,
                    help="with --engine pt-chees: rungs per ladder")
    ap.add_argument("--pops", type=int, default=1,
                    help="with --engine chees: independent populations of "
                    "chains/pops chains, each adapting its own kernel")
    ap.add_argument("--race", type=int, default=0,
                    help="with --engine chees (pops=1): K-candidate "
                    "post-warmup trajectory race (0 = off)")
    ap.add_argument("-n", action="store_true", help="do not normalize outputs")
    ap.add_argument("--grid", type=int, default=50, help="forecast grid points")
    ap.add_argument("--platform", default="cpu", choices=tio.PLATFORMS,
                    help="cpu (default) or gpu; float64 on both (same "
                    "contract as the evaluate CLI)")
    ap.add_argument("mode", nargs="?", default=None, help="'selfcheck' for embedded data")
    args = ap.parse_args(argv)

    tio.select_platform(args.platform)
    mod, study, data = get_study(args.study)
    if args.mode == "selfcheck":
        x, y = tio.load_csv(data)
    else:
        x, y = tio.load_csv(sys.stdin)
    if args.n:
        y_norm, mean_y, std_y = y, 0.0, 1.0
    else:
        y_norm, mean_y, std_y = tio.normalize(y)

    logp, posterior_of, v0, free = build_logjoint(study, x, y_norm)
    tio.progress(f"sampling ({args.engine})...")
    draws = sample_posterior(
        logp, v0, free, args.engine, args.seed, args.samples, args.warmup,
        args.chains, args.pops, args.replicas, args.race
    )
    tio.progress("forecasting...")
    lo, hi = x[:, 0].min(), x[:, 0].max()
    z = np.linspace(lo, hi + (hi - lo), args.grid)[:, None]
    mu, sigma = mixture_forecast(study.gp, posterior_of, draws, z)

    rows = [
        [z[i, 0], float("nan"), mu[i] * std_y + mean_y, sigma[i] * std_y]
        for i in range(z.shape[0])
    ]
    tio.write_forecast_rows(sys.stdout, rows)
    nts = study.gp.n_theta
    theta_mean = np.exp(draws[:, :nts]).mean(axis=0)
    print("# posterior theta mean: " + ",".join(f"{t:.6f}" for t in theta_mean))
    tio.progress("done")


if __name__ == "__main__":
    main()
