"""Bayesian optimization (gogp/bo.py): acquisition math + end-to-end
optimization, all on the streaming/serving stack (no refits)."""

import numpy as np
import jax
import jax.numpy as jnp

from gogp import bo
from gogp.gp import core
from gogp.kernels import rbf, uniform_noise


def _gp():
    return core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)


class TestAcquisitionMath:
    def test_ei_closed_form(self):
        # EI(mu=1, sigma=1, best=0) = 1*Phi(1) + phi(1)
        from scipy.stats import norm

        got = float(bo.expected_improvement(jnp.array([1.0]), jnp.array([1.0]),
                                            jnp.array(0.0))[0])
        want = 1.0 * norm.cdf(1.0) + norm.pdf(1.0)
        assert abs(got - want) < 1e-7

    def test_ei_zero_at_observed_points(self):
        ei = bo.expected_improvement(jnp.array([0.5]), jnp.array([0.0]),
                                     jnp.array(1.0))
        assert float(ei[0]) == 0.0

    def test_ei_monotone_in_mean(self):
        sig = jnp.ones(3)
        ei = bo.expected_improvement(jnp.array([-1.0, 0.0, 1.0]), sig, jnp.array(0.0))
        e = np.asarray(ei)
        assert e[0] < e[1] < e[2]

    def test_ucb_beta_tradeoff(self):
        mu = jnp.array([1.0, 0.0])
        sigma = jnp.array([0.0, 1.0])
        low = np.asarray(bo.upper_confidence_bound(mu, sigma, beta=0.5))
        high = np.asarray(bo.upper_confidence_bound(mu, sigma, beta=5.0))
        assert low[0] > low[1]      # exploit when beta small
        assert high[1] > high[0]    # explore when beta large


class TestBORun:
    def _objective(self):
        return lambda x: -((x[0] - 3.1) ** 2)

    def test_ei_finds_optimum(self):
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 101)[:, None]
        state, ys = bo.bo_run(
            gp, jnp.array([5.0, 1.5]), jnp.array([0.05]),
            self._objective(), grid, num_iters=15,
            key=jax.random.PRNGKey(0), kind="ei",
        )
        assert abs(float(state.best_x[0]) - 3.1) < 0.15, float(state.best_x[0])
        assert float(state.best_y) > -0.02

    def test_ucb_finds_optimum(self):
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 101)[:, None]
        state, _ = bo.bo_run(
            gp, jnp.array([5.0, 1.5]), jnp.array([0.05]),
            self._objective(), grid, num_iters=15,
            key=jax.random.PRNGKey(1), kind="ucb", beta=2.0,
        )
        assert abs(float(state.best_x[0]) - 3.1) < 0.15

    def test_thompson_finds_optimum(self):
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 101)[:, None]
        state, _ = bo.bo_run(
            gp, jnp.array([5.0, 1.5]), jnp.array([0.05]),
            self._objective(), grid, num_iters=20,
            key=jax.random.PRNGKey(2), kind="thompson",
        )
        assert abs(float(state.best_x[0]) - 3.1) < 0.3

    def test_beats_random_search(self):
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 101)[:, None]
        f = self._objective()
        state, _ = bo.bo_run(
            gp, jnp.array([5.0, 1.5]), jnp.array([0.05]), f, grid,
            num_iters=10, key=jax.random.PRNGKey(3), kind="ei",
        )
        # random baseline with the same budget (12 evals), best over seeds
        rng = np.random.default_rng(3)
        rand_best = []
        for _ in range(5):
            xs = rng.choice(np.asarray(grid[:, 0]), size=12, replace=False)
            rand_best.append(max(-((x - 3.1) ** 2) for x in xs))
        assert float(state.best_y) >= np.median(rand_best) - 1e-9

    def test_external_loop_jits_once(self):
        # driving acquire/update by hand (non-jittable objectives): each
        # step is one compiled program reused across iterations
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 51)[:, None]
        state = bo.bo_init(gp, jnp.array([5.0, 1.5]), jnp.array([0.05]), 8,
                           dtype=grid.dtype)
        step_acq = jax.jit(lambda st: bo.acquire(gp, st, grid, "ucb")[0])
        step_upd = jax.jit(lambda st, x, y: bo.bo_update(gp, st, x, y))
        for _ in range(6):
            idx = step_acq(state)
            x = grid[idx]
            y = -((x[0] - 3.1) ** 2)
            state = step_upd(state, x[None, :], jnp.atleast_1d(y))
        assert step_acq._cache_size() == 1 and step_upd._cache_size() == 1
        assert abs(float(state.best_x[0]) - 3.1) < 1.0


class TestThompsonPath:
    def test_thompson_path_finds_optimum(self):
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 101)[:, None]
        state, _ = bo.bo_run(
            gp, jnp.array([5.0, 1.5]), jnp.array([0.05]),
            lambda x: -((x[0] - 3.1) ** 2), grid, num_iters=20,
            key=jax.random.PRNGKey(3), kind="thompson-path",
        )
        assert abs(float(state.best_x[0]) - 3.1) < 0.25, float(state.best_x[0])

    def test_path_scores_are_a_coherent_function(self):
        # same key -> the SAME sampled function: scoring a subset matches
        # the corresponding entries of scoring the full grid
        gp = _gp()
        state = bo.bo_init(gp, jnp.array([5.0, 1.5]), jnp.array([0.05]), capacity=8)
        state = bo.bo_update(gp, state, jnp.array([[2.0], [7.0]]), jnp.array([0.3, -0.2]))
        grid = jnp.linspace(0.0, 10.0, 21)[:, None]
        key = jax.random.PRNGKey(9)
        full = np.asarray(bo.thompson_path_scores(gp, state, grid, key))
        sub = np.asarray(bo.thompson_path_scores(gp, state, grid[5:9], key))
        np.testing.assert_allclose(full[5:9], sub, rtol=1e-10)

    def test_path_scores_track_posterior(self):
        # near an observed point with tiny noise, sampled paths hug the data
        gp = _gp()
        state = bo.bo_init(gp, jnp.array([2.0, 1.0]), jnp.array([0.01]), capacity=4)
        state = bo.bo_update(gp, state, jnp.array([[5.0]]), jnp.array([1.7]))
        at_obs = np.asarray(
            bo.thompson_path_scores(
                gp, state, jnp.array([[5.0]]), jax.random.PRNGKey(1), num_features=2048
            )
        )
        assert abs(at_obs[0] - 1.7) < 0.15


class TestBatchThompson:
    def test_batch_points_are_distinct_and_sane(self):
        gp = _gp()
        state = bo.bo_init(gp, jnp.array([4.0, 1.2]), jnp.array([0.05]), capacity=8)
        state = bo.bo_update(gp, state, jnp.array([[2.0], [8.0]]), jnp.array([0.5, 1.5]))
        grid = jnp.linspace(0.0, 10.0, 51)[:, None]
        idx, scores = bo.acquire_batch_thompson(gp, state, grid,
                                                jax.random.PRNGKey(0), q=4)
        ii = np.asarray(idx)
        assert len(set(ii.tolist())) == 4          # distinct points
        assert scores.shape == (4, 51)

    def test_batch_bo_converges(self):
        # parallel BO: evaluate q=3 points per round against a jittable
        # objective; converges with fewer ROUNDS than sequential budget
        gp = _gp()
        grid = jnp.linspace(0.0, 10.0, 101)[:, None]
        obj = lambda x: -((x - 3.1) ** 2)
        state = bo.bo_init(gp, jnp.array([5.0, 1.5]), jnp.array([0.05]),
                           capacity=2 + 5 * 3)
        key = jax.random.PRNGKey(1)
        key, sub = jax.random.split(key)
        x0 = grid[jax.random.choice(sub, 101, (2,), replace=False)]
        state = bo.bo_update(gp, state, x0, jax.vmap(lambda xx: obj(xx[0]))(x0))
        for _ in range(5):
            key, sub = jax.random.split(key)
            idx, _ = bo.acquire_batch_thompson(gp, state, grid, sub, q=3)
            xb = grid[idx]
            yb = jax.vmap(lambda xx: obj(xx[0]))(xb)
            state = bo.bo_update(gp, state, xb, yb)
        assert abs(float(state.best_x[0]) - 3.1) < 0.3, float(state.best_x[0])


class TestContinuousThompson:
    def test_beats_coarse_grid_on_same_path(self):
        gp = _gp()
        state = bo.bo_init(gp, jnp.array([3.0, 1.0]), jnp.array([0.05]), capacity=8)
        state = bo.bo_update(gp, state, jnp.array([[2.0], [5.0], [8.0]]),
                             jnp.array([0.5, 1.8, -0.2]))
        key = jax.random.PRNGKey(3)
        x_opt, v_opt = bo.thompson_path_optimize(
            gp, state, key, (jnp.array([0.0]), jnp.array([10.0])),
            num_restarts=8, steps=200,
        )
        # same key -> same sampled path; its max over a coarse grid cannot
        # beat the continuous optimum
        from gogp.gp import pathwise
        kp, _ = jax.random.split(key)
        ps = pathwise.sample_paths(gp, state.post, kp, 1, 512)
        grid = jnp.linspace(0.0, 10.0, 11)[:, None]
        grid_best = float(jnp.max(pathwise.eval_paths(gp, ps, grid)))
        assert float(v_opt) >= grid_best - 1e-9
        assert 0.0 <= float(x_opt[0]) <= 10.0
