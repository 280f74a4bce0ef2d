"""Toeplitz fast path (ops/toeplitz + gp.lml_toeplitz) vs the dense oracle.

On a regular 1-D grid the stationary covariance is symmetric Toeplitz;
the FFT circulant matvec and the CG/SLQ LML built on it must match the
dense computations to estimator tolerance, and the frozen-solution theta
gradient must match the exact gradient.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gogp.gp import core
from gogp.kernels import matern32, rbf, uniform_noise
from gogp.ops import toeplitz as tz


def _grid_problem(n=256, seed=0, noise=0.3):
    gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    x = jnp.linspace(0.0, 25.0, n)[:, None]
    rng = np.random.default_rng(seed)
    y = jnp.asarray(np.sin(np.asarray(x[:, 0]) / 2.0) + 0.1 * rng.normal(size=n))
    ts = jnp.array([1.0, 1.2])
    tn = jnp.array([noise])
    return gp, x, y, ts, tn


class TestMatvec:
    def test_matches_dense(self):
        rng = np.random.default_rng(1)
        n = 97  # odd, non-power-of-two
        c = np.exp(-0.1 * np.arange(n) ** 1.3)
        K = np.asarray([[c[abs(i - j)] for j in range(n)] for i in range(n)])
        V = rng.normal(size=(n, 5))
        mv = tz.toeplitz_matvec_fn(jnp.asarray(c))
        got = np.asarray(mv(jnp.asarray(V)))
        assert np.allclose(got, K @ V, atol=1e-10)
        # 1-D operand path
        got1 = np.asarray(mv(jnp.asarray(V[:, 0])))
        assert np.allclose(got1, K @ V[:, 0], atol=1e-10)

    def test_col_fn(self):
        c = jnp.asarray(np.random.default_rng(2).normal(size=16))
        col = tz.toeplitz_col_fn(c)
        K = np.asarray([[float(c[abs(i - j)]) for j in range(16)] for i in range(16)])
        for j in (0, 5, 15):
            assert np.allclose(np.asarray(col(j)), K[:, j], atol=1e-12)


class TestLML:
    def test_value_matches_exact(self):
        # the smooth-RBF spectrum needs the preconditioned quadrature for a
        # tight logdet (same story as the dense iterative path); with it
        # the estimate pins the exact value
        gp, x, y, ts, tn = _grid_problem()
        exact = float(core.lml(gp, ts, tn, x, y))
        got = float(core.lml_toeplitz(gp, ts, tn, x, y, jax.random.PRNGKey(0),
                                      num_probes=32, cg_iters=300,
                                      lanczos_iters=48, precond_rank=32))
        assert abs(got - exact) / abs(exact) < 2e-2, (got, exact)

    def test_matches_dense_iterative_estimator(self):
        # same machinery, same key, same probes — the FFT matvec must
        # reproduce the dense iterative estimate (not just the exact
        # value) essentially bit-for-bit
        gp, x, y, ts, tn = _grid_problem()
        a = float(core.lml_toeplitz(gp, ts, tn, x, y, jax.random.PRNGKey(0),
                                    num_probes=64, cg_iters=200,
                                    lanczos_iters=48))
        b = float(core.lml_iterative(gp, ts, tn, x, y, jax.random.PRNGKey(0),
                                     num_probes=64, cg_iters=200,
                                     lanczos_iters=48))
        assert abs(a - b) < 1e-5, (a, b)

    def test_gradient_matches_exact(self):
        gp, x, y, ts, tn = _grid_problem()
        from gogp.models.params import gp_observe

        v0 = jnp.concatenate([jnp.log(ts), jnp.log(tn)])
        g_exact = jax.grad(lambda v: gp_observe(gp, v, x=x, y=y))(v0)

        def logp_t(v):
            th = jnp.exp(v)
            return core.lml_toeplitz(
                gp, th[:2], th[2:], x, y, jax.random.PRNGKey(1),
                num_probes=64, cg_iters=200, lanczos_iters=48,
            )

        g_t = jax.grad(logp_t)(v0)
        rel = np.abs(np.asarray(g_t - g_exact)) / (np.abs(np.asarray(g_exact)) + 1.0)
        assert rel.max() < 5e-2, (np.asarray(g_t), np.asarray(g_exact))
        # y-gradient is exact (-alpha up to CG tolerance)
        gy_exact = jax.grad(lambda yy: core.lml(gp, ts, tn, x, yy))(y)
        gy_t = jax.grad(
            lambda yy: core.lml_toeplitz(gp, ts, tn, x, yy,
                                         jax.random.PRNGKey(1),
                                         cg_iters=200)
        )(y)
        assert np.allclose(np.asarray(gy_t), np.asarray(gy_exact), atol=1e-5)

    def test_preconditioned_small_noise(self):
        # the ill-conditioned regime: tight grid, small noise — plain SLQ
        # at few Lanczos steps is off; the preconditioner fixes it
        gp, x, y, ts, _ = _grid_problem(noise=0.05)
        tn = jnp.array([0.05])
        exact = float(core.lml(gp, ts, tn, x, y))
        got = float(core.lml_toeplitz(gp, ts, tn, x, y, jax.random.PRNGKey(2),
                                      num_probes=32, cg_iters=400,
                                      lanczos_iters=32, precond_rank=32))
        assert abs(got - exact) / abs(exact) < 2e-2, (got, exact)

    def test_matern_kernel(self):
        gp = core.GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise)
        x = jnp.linspace(0.0, 12.0, 200)[:, None]
        y = jnp.asarray(np.cos(np.asarray(x[:, 0])))
        ts, tn = jnp.array([0.8, 0.9]), jnp.array([0.2])
        exact = float(core.lml(gp, ts, tn, x, y))
        got = float(core.lml_toeplitz(gp, ts, tn, x, y, jax.random.PRNGKey(3),
                                      num_probes=64, cg_iters=300,
                                      lanczos_iters=48))
        assert abs(got - exact) / abs(exact) < 2e-2

    def test_rejects_irregular_grid(self):
        gp, x, y, ts, tn = _grid_problem(n=32)
        x_bad = x.at[5, 0].add(0.05)
        with pytest.raises(ValueError, match="equally spaced"):
            core.lml_toeplitz(gp, ts, tn, x_bad, y, jax.random.PRNGKey(0))

    def test_rejects_multidim(self):
        gp = core.GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise)
        x = jnp.zeros((8, 2))
        with pytest.raises(ValueError, match="1-D"):
            core.lml_toeplitz(gp, jnp.ones(2), jnp.ones(1), x, jnp.zeros(8),
                              jax.random.PRNGKey(0))


class TestPredict:
    def test_matches_exact_predict(self):
        gp, x, y, ts, tn = _grid_problem(n=200)
        z = jnp.linspace(-2.0, 27.0, 31)[:, None]
        mu1, s1 = core.predict_toeplitz(gp, ts, tn, x, y, z, cg_iters=400)
        mu2, s2 = core.predict(gp, ts, tn, x, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-5)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-4)

    def test_preconditioned_matches(self):
        gp, x, y, ts, _ = _grid_problem(n=200, noise=0.05)
        tn = jnp.array([0.05])
        z = x[::9]
        mu1, s1 = core.predict_toeplitz(gp, ts, tn, x, y, z, cg_iters=300,
                                        precond_rank=32)
        mu2, s2 = core.predict(gp, ts, tn, x, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-4)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-3)
