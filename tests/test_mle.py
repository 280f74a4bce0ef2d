"""Optimizer tests: Adam and LBFGS on analytic and GP objectives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp import GP, matern32, uniform_noise
from gogp.infer import mle
from gogp.models import make_gp_logp, masked_value_and_grad


def quadratic_logp(v):
    target = jnp.asarray([1.0, -2.0, 0.5])
    return -jnp.sum((v - target) ** 2)


def test_lbfgs_quadratic():
    res = mle.lbfgs(quadratic_logp, jnp.zeros(3), iters=100)
    np.testing.assert_allclose(np.asarray(res.x), [1.0, -2.0, 0.5], atol=1e-6)
    assert bool(res.converged)
    assert int(res.iters) < 100


def test_adam_quadratic():
    res = mle.adam(jax.value_and_grad(quadratic_logp), jnp.zeros(3), iters=3000, rate=0.05)
    np.testing.assert_allclose(np.asarray(res.x), [1.0, -2.0, 0.5], atol=1e-3)


def test_lbfgs_respects_free_mask():
    res = mle.lbfgs(quadratic_logp, jnp.zeros(3), iters=100, free=jnp.asarray([1.0, 0.0, 1.0]))
    assert float(res.x[1]) == 0.0  # pinned at init
    np.testing.assert_allclose(np.asarray(res.x)[[0, 2]], [1.0, 0.5], atol=1e-6)


def test_adam_respects_free_mask():
    vg = masked_value_and_grad(quadratic_logp, jnp.asarray([0.0, 1.0, 1.0]))
    res = mle.adam(vg, jnp.zeros(3), iters=3000, rate=0.05)
    assert float(res.x[0]) == 0.0


def test_lbfgs_improves_gp_lml():
    gp = GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01))
    x = jnp.linspace(0, 6, 15).reshape(-1, 1)
    y = jnp.sin(x[:, 0])
    logp = make_gp_logp(gp, x=x, y=y)
    v0 = jnp.zeros(3)
    res = jax.jit(lambda v: mle.lbfgs(logp, v, iters=150))(v0)
    assert float(res.value) > float(logp(v0)) + 1.0


def test_optimizers_vmap():
    """Batched independent fits — the batched pattern behind Evaluate."""
    inits = jnp.asarray([[0.0, 0.0, 0.0], [2.0, 2.0, 2.0], [-1.0, 3.0, 0.1]])
    res = jax.vmap(lambda v: mle.lbfgs(quadratic_logp, v, iters=100))(inits)
    for i in range(3):
        np.testing.assert_allclose(np.asarray(res.x[i]), [1.0, -2.0, 0.5], atol=1e-5)


def test_early_stop_threshold():
    # start at the optimum: gradient is 0, must stop after one check
    res = mle.lbfgs(quadratic_logp, jnp.asarray([1.0, -2.0, 0.5]), iters=100)
    assert int(res.iters) <= 1
    assert bool(res.converged)
