"""SKI / KISS-GP (ops/ski.py, gp/ski.py): interpolation operator accuracy,
LML + gradient vs the exact dense path on irregular 1-D inputs,
heteroscedastic noise support, and predict parity."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp import core, ski as gski
from gogp.kernels import matern32, rbf, uniform_noise
from gogp.ops import ski


def _data(n=256, seed=0, span=10.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, span, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.3 * np.cos(2.3 * x[:, 0]) + 0.1 * rng.normal(size=n)
    return jnp.asarray(x), jnp.asarray(y)


class TestOperator:
    def test_cubic_weights_partition_of_unity(self):
        x = jnp.asarray(np.random.default_rng(1).uniform(1.0, 9.0, 200))
        idx, w = ski.cubic_interp(x, jnp.asarray(0.0), jnp.asarray(0.05), 256)
        np.testing.assert_allclose(np.asarray(w.sum(axis=1)), 1.0, atol=1e-12)
        assert int(idx.min()) >= 0 and int(idx.max()) < 256

    def test_matvec_approximates_dense(self):
        gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _data(128)
        ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.3])
        K = np.asarray(core.masked_cov(gp, ts, tn, x, jnp.ones(128)))
        gmin, h, col = gski._grid_col(gp, ts, x[:, 0], 1024)
        idx, w = ski.cubic_interp(x[:, 0], gmin, h, 1024)
        mv = ski.ski_matvec_fn(col, idx, w, gp.noise.vector(tn, x))
        v = jnp.asarray(np.random.default_rng(2).normal(size=128))
        got = np.asarray(mv(v))
        want = K @ np.asarray(v)
        assert np.max(np.abs(got - want)) < 2e-4, np.max(np.abs(got - want))

    def test_interp_adjoint(self):
        # interp and interp_t are exact transposes
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.uniform(1.0, 9.0, 50))
        idx, w = ski.cubic_interp(x, jnp.asarray(0.0), jnp.asarray(0.1), 128)
        U = jnp.asarray(rng.normal(size=(128, 3)))
        V = jnp.asarray(rng.normal(size=(50, 3)))
        a = float(jnp.sum(V * ski.interp(idx, w, U)))
        b = float(jnp.sum(U * ski.interp_t(idx, w, 128, V)))
        assert abs(a - b) < 1e-10


class TestLML:
    def test_value_matches_exact(self):
        gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _data(256)
        ts, tn = jnp.asarray([0.8, 1.2]), jnp.asarray([0.25])
        exact = float(core.lml(gp, ts, tn, x, y))
        got = float(gski.lml_ski(gp, ts, tn, x, y, jax.random.PRNGKey(0),
                                 grid_size=1024, num_probes=32, lanczos_iters=48))
        # SLQ probe error scales with the LOGDET (hundreds of nats here),
        # not the lml; the estimator contract is per-datapoint nats
        assert abs(got - exact) / len(y) < 2e-2, (got, exact)

    def test_gradient_matches_exact(self):
        gp = core.GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise)
        x, y = _data(200, seed=4)
        v0 = jnp.asarray([0.9, 1.1, 0.3])

        def f_ski(v):
            return gski.lml_ski(gp, v[:2], v[2:], x, y, jax.random.PRNGKey(1),
                                grid_size=2048, num_probes=32, cg_iters=200,
                                lanczos_iters=48)

        def f_exact(v):
            return core.lml(gp, v[:2], v[2:], x, y)

        g_ski = np.asarray(jax.grad(f_ski)(v0))
        g_ex = np.asarray(jax.grad(f_exact)(v0))
        rel = np.abs(g_ski - g_ex) / np.maximum(np.abs(g_ex), 1e-3)
        assert rel.max() < 5e-2, (g_ski, g_ex)

    def test_heteroscedastic_noise(self):
        # input-dependent noise: impossible on the pure Toeplitz path
        from gogp.kernels.base import NoiseKernel

        het = NoiseKernel(1, lambda t, xi: t[0] * t[0] * (1.0 + xi[0] / 10.0), "het")
        gp = core.GP(ndim=1, simil=rbf.scaled(), noise=het)
        x, y = _data(128, seed=5)
        ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.3])
        exact = float(core.lml(gp, ts, tn, x, y))
        got = float(gski.lml_ski(gp, ts, tn, x, y, jax.random.PRNGKey(2),
                                 grid_size=1024, num_probes=96, lanczos_iters=64))
        assert abs(got - exact) / len(y) < 2e-2, (got, exact)

    def test_jit(self):
        gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _data(64, seed=6)
        f = jax.jit(lambda ts, tn: gski.lml_ski(gp, ts, tn, x, y,
                                                jax.random.PRNGKey(3), grid_size=256))
        a = float(f(jnp.asarray([1.0, 1.0]), jnp.asarray([0.3])))
        b = float(gski.lml_ski(gp, jnp.asarray([1.0, 1.0]), jnp.asarray([0.3]),
                               x, y, jax.random.PRNGKey(3), grid_size=256))
        assert abs(a - b) < 1e-6


class TestPredict:
    def test_matches_exact_predict(self):
        gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _data(256, seed=7)
        ts, tn = jnp.asarray([1.0, 1.1]), jnp.asarray([0.2])
        z = jnp.asarray(np.linspace(-0.5, 10.5, 33)[:, None])
        mu1, s1 = gski.predict_ski(gp, ts, tn, x, y, z, grid_size=2048)
        mu2, s2 = core.predict(gp, ts, tn, x, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-3)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-3)


class TestSortedFastPath:
    def test_interp_t_sorted_matches_scatter(self):
        rng = np.random.default_rng(8)
        x = jnp.asarray(np.sort(rng.uniform(1.0, 9.0, 300)))
        idx, w = ski.cubic_interp(x, jnp.asarray(0.0), jnp.asarray(0.05), 256)
        V = jnp.asarray(rng.normal(size=(300, 5)))
        a = np.asarray(ski.interp_t(idx, w, 256, V))
        b = np.asarray(ski.interp_t_sorted(idx, w, 256, V))
        np.testing.assert_allclose(a, b, atol=1e-10)

    def test_lml_ski_permutation_invariant(self):
        # callers need not pre-sort: the wrapper sorts internally, and the
        # y-gradient lands back in caller order through the gather VJP
        gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _data(96, seed=9)
        perm = np.random.default_rng(10).permutation(96)
        xp, yp = x[perm], y[perm]
        ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.3])
        f = lambda xx, yy: gski.lml_ski(gp, ts, tn, xx, yy, jax.random.PRNGKey(4),
                                        grid_size=512, num_probes=16)
        assert abs(float(f(x, y)) - float(f(xp, yp))) < 1e-8
        gy = jax.grad(lambda yy: gski.lml_ski(gp, ts, tn, xp, yy,
                                              jax.random.PRNGKey(4), grid_size=512,
                                              num_probes=16))(yp)
        gy0 = jax.grad(lambda yy: gski.lml_ski(gp, ts, tn, x, yy,
                                               jax.random.PRNGKey(4), grid_size=512,
                                               num_probes=16))(y)
        np.testing.assert_allclose(np.asarray(gy), np.asarray(gy0)[perm], atol=1e-9)


class TestMultiDim:
    def _data2d(self, n=300, seed=11):
        rng = np.random.default_rng(seed)
        x = rng.uniform(0.0, 5.0, size=(n, 2))
        y = (np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1])
             + 0.1 * rng.normal(size=n))
        return jnp.asarray(x), jnp.asarray(y)

    def test_bttb_matvec_matches_dense(self):
        gp = core.GP(ndim=2, simil=matern32.scaled(), noise=uniform_noise)
        x, y = self._data2d(128)
        ts, tn = jnp.asarray([1.0, 1.2]), jnp.asarray([0.3])
        K = np.asarray(core.masked_cov(gp, ts, tn, x, jnp.ones(128)))
        from gogp.gp import ski as gs
        dims = (64, 64)
        g0, hs = gs._grid_geometry(x, dims)
        idx, w = ski.cubic_interp_nd(x, g0, hs, dims)
        lags = gs._grid_lags(gp, ts, hs, dims, x.dtype)
        mv = ski.ski_matvec_fn(lags, idx, w, gp.noise.vector(tn, x))
        v = jnp.asarray(np.random.default_rng(1).normal(size=128))
        err = np.max(np.abs(np.asarray(mv(v)) - K @ np.asarray(v)))
        assert err < 5e-3, err

    def test_lml_2d_matches_exact(self):
        gp = core.GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise)
        x, y = self._data2d(256)
        ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.25])
        exact = float(core.lml(gp, ts, tn, x, y))
        got = float(gski.lml_ski(gp, ts, tn, x, y, jax.random.PRNGKey(0),
                                 grid_size=(64, 64), num_probes=48,
                                 lanczos_iters=48, method="scatter"))
        assert abs(got - exact) / len(y) < 2e-2, (got, exact)

    def test_gradient_2d(self):
        gp = core.GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise)
        x, y = self._data2d(200, seed=12)
        v0 = jnp.asarray([0.9, 1.1, 0.3])

        def f_ski(v):
            return gski.lml_ski(gp, v[:2], v[2:], x, y, jax.random.PRNGKey(1),
                                grid_size=(64, 64), num_probes=96,
                                cg_iters=200, lanczos_iters=48, method="scatter")

        g_ski = np.asarray(jax.grad(f_ski)(v0))
        g_ex = np.asarray(jax.grad(
            lambda v: core.lml(gp, v[:2], v[2:], x, y))(v0))
        # Hutchinson trace noise ~1/sqrt(probes) dominates here
        rel = np.abs(g_ski - g_ex) / np.maximum(np.abs(g_ex), 1e-2)
        assert rel.max() < 1e-1, (g_ski, g_ex)

    def test_predict_2d_matches_exact(self):
        gp = core.GP(ndim=2, simil=rbf.scaled(), noise=uniform_noise)
        x, y = self._data2d(256, seed=13)
        ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.2])
        rngz = np.random.default_rng(14)
        z = jnp.asarray(rngz.uniform(0.5, 4.5, size=(15, 2)))
        mu1, s1 = gski.predict_ski(gp, ts, tn, x, y, z, grid_size=(96, 96))
        mu2, s2 = core.predict(gp, ts, tn, x, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=3e-3)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=3e-3)
