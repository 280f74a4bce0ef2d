"""Cross-engine posterior validation: two independent samplers built on
different principles (PT-NUTS: tempered gradient MCMC; SMC: annealed
importance resampling) must agree on the same multimodal GP posterior —
the strongest internal correctness check available without running the Go
reference (no toolchain in this environment; unit goldens cover the
likelihood itself)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp import infer
from gogp.models.params import gp_observe
from gogp.tutorial import io as tio
from gogp.tutorial.hyperpriors import make_priors, make_study, selfcheck_data


@pytest.fixture(scope="module")
def hp_logp():
    study = make_study()
    gp = study.gp
    x, y = tio.load_csv(selfcheck_data())
    y_norm, _, _ = tio.normalize(y)
    priors = make_priors(x, y_norm)
    xj, yj = jnp.asarray(x), jnp.asarray(y_norm)
    mask = jnp.ones(x.shape[0])

    def logp(v):
        return gp_observe(gp, v, x=xj, y=yj, mask=mask) + priors(v, mask)

    return logp, gp.n_theta


def test_pt_nuts_vs_smc_moments(hp_logp):
    logp, dim = hp_logp

    pt = infer.run_pt_nuts(
        logp, jnp.zeros(dim), jax.random.PRNGKey(0),
        n_replicas=6, beta_min=0.05, num_warmup=300, num_samples=1200,
        max_tree_depth=6,
    )
    pt_draws = np.asarray(pt.positions)

    smc = infer.run_smc(
        logp, jnp.zeros(dim), jax.random.PRNGKey(1),
        num_particles=1024, sigma0=1.5, num_mcmc_steps=8,
    )
    smc_draws = np.asarray(smc.particles)
    assert bool(smc.betas_hit_one)

    pt_mean, smc_mean = pt_draws.mean(axis=0), smc_draws.mean(axis=0)
    pt_std, smc_std = pt_draws.std(axis=0), smc_draws.std(axis=0)
    # agreement within generous MC error on a hard multimodal posterior
    scale = np.maximum(np.maximum(pt_std, smc_std), 0.3)
    assert np.all(np.abs(pt_mean - smc_mean) < 1.2 * scale), (
        pt_mean, smc_mean, pt_std, smc_std,
    )
    # spreads within a factor ~2.5 of each other
    ratio = pt_std / np.maximum(smc_std, 1e-3)
    assert np.all(ratio < 2.5) and np.all(ratio > 0.4), ratio
