"""Greedy compositional kernel search (gogp/search.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp import search as ks
from gogp.gp import core
from gogp.kernels import matern32, uniform_noise


def _periodic_trend_data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 8.0, size=(n, 1)), axis=0)
    y = 0.6 * x[:, 0] + 1.5 * np.sin(2.0 * np.pi * x[:, 0] / 1.7) + 0.1 * rng.normal(size=n)
    return x, y


class TestSearch:
    def test_discovers_periodic_structure(self):
        x, y = _periodic_trend_data()
        res = ks.search(
            x, y, bases=("rbf", "periodic", "linear"), max_depth=2,
            restarts=6, iters=300, key=jax.random.PRNGKey(1),
        )
        # a periodicity this strong must appear in the winning structure
        assert "periodic" in res.name, res.name
        # the composite must beat the best single-kernel score
        assert len(res.history) >= 1
        if len(res.history) > 1:
            assert res.history[-1].score < res.history[0].score

    def test_result_is_usable_for_prediction(self):
        x, y = _periodic_trend_data(50)
        res = ks.search(
            x, y, bases=("rbf", "periodic"), max_depth=2, restarts=4,
            iters=250, key=jax.random.PRNGKey(2),
        )
        gp = core.GP(ndim=1, simil=res.kernel, noise=uniform_noise)
        theta = jnp.exp(res.v_opt)
        nts = gp.n_theta_simil
        yn = (y - res.y_mean) / res.y_std
        mu, sd = core.predict(gp, theta[:nts], theta[nts:], x, yn, x)
        rmse = float(np.sqrt(np.mean((np.asarray(mu) - yn) ** 2)))
        assert rmse < 0.3, rmse
        assert np.all(np.asarray(sd) >= 0)

    def test_no_spurious_growth_on_simple_data(self):
        # pure matern32 draws: BIC must stop the search at depth 1 rather
        # than keep absorbing parameters
        rng = np.random.default_rng(4)
        n = 50
        x = np.sort(rng.uniform(0, 10, size=(n, 1)), axis=0)
        K = np.asarray(matern32.scaled().matrix(jnp.asarray([1.0, 1.5]), x, x))
        y = np.linalg.cholesky(K + 0.05**2 * np.eye(n)) @ rng.normal(size=n)
        res = ks.search(
            x, y, bases=("matern32",), max_depth=3, restarts=4, iters=300,
            min_improvement=2.0, key=jax.random.PRNGKey(3),
        )
        assert len(res.history) <= 2

    def test_deterministic_given_key(self):
        x, y = _periodic_trend_data(40)
        a = ks.search(x, y, bases=("rbf",), max_depth=1, restarts=3,
                      iters=100, key=jax.random.PRNGKey(7))
        b = ks.search(x, y, bases=("rbf",), max_depth=1, restarts=3,
                      iters=100, key=jax.random.PRNGKey(7))
        assert a.name == b.name
        np.testing.assert_array_equal(np.asarray(a.v_opt), np.asarray(b.v_opt))
