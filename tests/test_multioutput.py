"""Multi-output (ICM/LMC) kernels: structure, PSD-ness, protocol round
trips, and information sharing across tasks.

The reference is single-output; these tests pin the new family against
closed-form block structure and against the single-output core as the
degenerate case.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core
from gogp.kernels import matern32, multioutput as mo, rbf, uniform_noise
from gogp.models.params import gp_observe


def _two_task_data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x1 = np.sort(rng.uniform(0.0, 10.0, size=(n, 1)), axis=0)
    x2 = np.sort(rng.uniform(0.0, 10.0, size=(n // 2, 1)), axis=0)
    f = lambda x: np.sin(x[:, 0])
    y1 = f(x1) + 0.05 * rng.normal(size=n)
    y2 = -2.0 * f(x2) + 0.05 * rng.normal(size=n // 2)
    return x1, y1, x2, y2


class TestICMStructure:
    def test_block_structure_matches_manual(self):
        # K[(x,i),(x',j)] == B[i,j] * k_base(x, x') with B = W W^T + diag(kappa)
        k = mo.icm(rbf, n_tasks=2, rank=2)
        # natural-scale theta: [l | exp(W row-major, 4) | kappa (2)]
        W = np.array([[0.7, -0.3], [1.1, 0.4]])
        kappa = np.array([0.2, 0.05])
        theta = jnp.asarray(
            np.concatenate([[2.0], np.exp(W.reshape(-1)), kappa])
        )
        rng = np.random.default_rng(1)
        xs = rng.uniform(0, 5, size=(6, 1))
        X, _ = mo.stack_tasks([xs[:4], xs[4:]], [np.zeros(4), np.zeros(2)])
        K = np.asarray(k.matrix(theta, X, X))
        B = W @ W.T + np.diag(kappa)
        Kbase = np.asarray(rbf.matrix(jnp.asarray([2.0]), xs, xs))
        tasks = np.array([0, 0, 0, 0, 1, 1])
        expect = B[np.ix_(tasks, tasks)] * Kbase
        assert np.allclose(K, expect, atol=1e-10)

    def test_single_task_rank1_degenerates_to_scaled_base(self):
        # T=1, R=1, kappa=0: ICM == w^2 * base
        k = mo.icm(matern32, n_tasks=1, rank=1)
        w = 1.7
        theta = jnp.asarray([0.9, np.exp(w), 0.0])
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 4, size=(8, 1))
        X = mo.task_inputs(x, 0)
        K = np.asarray(k.matrix(theta, X, X))
        Kb = np.asarray(matern32.matrix(jnp.asarray([0.9]), x, x))
        assert np.allclose(K, w * w * Kb, atol=1e-10)

    def test_psd(self):
        k = mo.icm(rbf, n_tasks=3, rank=2)
        theta = jnp.asarray(
            np.concatenate([[1.0], np.exp(np.linspace(-1, 1, 6)), [0.1, 0.2, 0.3]])
        )
        rng = np.random.default_rng(3)
        xs = [rng.uniform(0, 8, size=(7, 1)) for _ in range(3)]
        X, _ = mo.stack_tasks(xs, [np.zeros(7)] * 3)
        K = np.asarray(k.matrix(theta, X, X))
        evals = np.linalg.eigvalsh(K + 1e-10 * np.eye(K.shape[0]))
        assert evals.min() > -1e-9

    def test_lmc_is_sum_of_icms(self):
        k = mo.lmc([rbf, matern32], n_tasks=2, rank=1)
        k1 = mo.icm(rbf, 2, 1)
        k2 = mo.icm(matern32, 2, 1)
        n1 = k1.n_theta
        theta = jnp.asarray(np.abs(np.random.default_rng(4).normal(size=k.n_theta)) + 0.3)
        rng = np.random.default_rng(5)
        X, _ = mo.stack_tasks([rng.uniform(0, 3, (4, 1)), rng.uniform(0, 3, (3, 1))],
                              [np.zeros(4), np.zeros(3)])
        K = np.asarray(k.matrix(theta, X, X))
        Ka = np.asarray(k1.matrix(theta[:n1], X, X))
        Kb = np.asarray(k2.matrix(theta[n1:], X, X))
        assert np.allclose(K, Ka + Kb, atol=1e-12)


class TestICMInference:
    def _gp_and_data(self):
        x1, y1, x2, y2 = _two_task_data()
        X, y = mo.stack_tasks([x1, x2], [y1, y2])
        gp = core.GP(ndim=2, simil=mo.icm(rbf, n_tasks=2, rank=1),
                     noise=uniform_noise)
        return gp, X, y, (x1, y1, x2, y2)

    def test_observe_protocol_and_fd_gradient(self):
        gp, X, y, _ = self._gp_and_data()
        v0 = jnp.concatenate([
            mo.init_icm_theta(jnp.asarray([0.5]), 2, 1, w_scale=1.0),
            jnp.asarray([np.log(0.1)]),
        ]).astype(jnp.float64)
        val, grad = jax.value_and_grad(
            lambda v: gp_observe(gp, v, x=X, y=y)
        )(v0)
        assert np.isfinite(float(val))
        # forward finite differences, the reference's own check
        # (gp/gp_test.go:168-171)
        eps = 1e-7
        for i in range(v0.shape[0]):
            vp = v0.at[i].add(eps)
            fd = (float(gp_observe(gp, vp, x=X, y=y)) - float(val)) / eps
            assert abs(fd - float(grad[i])) < 1e-3, (i, fd, float(grad[i]))

    def test_cross_task_information_sharing(self):
        # task-2 prediction in a region where ONLY task 1 has data must
        # have lower predictive variance with correlated tasks than with
        # kappa-only (uncorrelated) coregionalization
        gp, X, y, (x1, y1, x2, y2) = self._gp_and_data()
        z = mo.task_inputs(jnp.asarray([[2.0], [5.0], [8.0]]), 1)

        # correlated: W = [1, -2] (task 2 = -2 x task 1), tiny kappa
        ts_corr = jnp.exp(jnp.asarray([np.log(1.0), 1.0, -2.0, np.log(1e-3), np.log(1e-3)]))
        # uncorrelated: W ~ 0, kappa = [1, 4]
        ts_unc = jnp.exp(jnp.asarray([np.log(1.0), 1e-4, 1e-4, np.log(1.0), np.log(4.0)]))
        tn = jnp.asarray([0.01])

        _, s_corr = core.predict(gp, ts_corr, tn, X, y, z)
        _, s_unc = core.predict(gp, ts_unc, tn, X, y, z)
        assert float(jnp.mean(s_corr)) < float(jnp.mean(s_unc))

    def test_mle_recovers_negative_correlation(self):
        # y2 = -2 y1: the fitted coregionalization must find w1*w2 < 0
        from gogp.infer import mle

        gp, X, y, _ = self._gp_and_data()
        v0 = jnp.concatenate([
            mo.init_icm_theta(jnp.asarray([0.0]), 2, 1, w_scale=0.5),
            jnp.asarray([np.log(0.3)]),
        ])
        res = mle.adam(
            jax.value_and_grad(lambda v: gp_observe(gp, v, x=X, y=y)),
            v0, iters=400, rate=0.05,
        )
        w1, w2 = float(res.x[1]), float(res.x[2])
        assert w1 * w2 < 0.0  # opposite signs = negative correlation

    def test_serving_composes(self):
        # the serving cache works unchanged on the multi-output kernel
        from gogp.gp import serve

        gp, X, y, _ = self._gp_and_data()
        ts = jnp.exp(jnp.asarray([0.0, 1.0, -1.0, np.log(0.1), np.log(0.1)]))
        tn = jnp.asarray([0.05])
        sp = serve.fit_serving(gp, ts, tn, X, y)
        z = mo.task_inputs(jnp.linspace(0, 10, 9)[:, None], 0)
        mu1, s1 = serve.serve_predict(gp, sp, z)
        mu2, s2 = core.predict(gp, ts, tn, X, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-7)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-7)
