"""Matrix-free iterative inference (ops/iterative): CG, SLQ logdet, and
the stochastic-gradient LML core vs the exact Cholesky oracle.

The estimator contract under test (module docstring of ops/iterative):
fixed key -> deterministic value within ~1% of the exact lml; the custom
VJP is an independent estimator of the EXACT gradient — y-gradient exact,
theta-gradient within a few percent after contraction against smooth dK.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp.core import GP, lml, lml_iterative, masked_cov
from gogp.kernels import rbf, uniform_noise
from gogp.ops.iterative import (
    cg_solve,
    lml_core_iterative,
    rademacher,
    slq_logdet,
)


def gp_of(test):
    return test.gp


def make_spd(n, seed=0, shift=0.5):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return jnp.asarray(a @ a.T / n + shift * np.eye(n))


class TestCG:
    def test_matches_direct_solve(self):
        K = make_spd(128)
        y = jnp.asarray(np.random.default_rng(1).normal(size=128))
        x, iters = cg_solve(K, y, max_iters=400, tol=1e-12)
        assert float(jnp.linalg.norm(K @ x - y) / jnp.linalg.norm(y)) < 1e-8
        assert int(iters) < 400  # converged by tolerance, not budget

    def test_batched_rhs(self):
        K = make_spd(96, seed=2)
        B = jnp.asarray(np.random.default_rng(3).normal(size=(96, 5)))
        X, _ = cg_solve(K, B, max_iters=300, tol=1e-12)
        direct = jnp.linalg.solve(K, B)
        np.testing.assert_allclose(np.asarray(X), np.asarray(direct), atol=1e-7)

    def test_jit(self):
        K = make_spd(64, seed=4)
        y = jnp.ones(64)
        a, _ = cg_solve(K, y, 200, 1e-10)
        b, _ = jax.jit(lambda K, y: cg_solve(K, y, 200, 1e-10))(K, y)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9)


class TestSLQ:
    def test_logdet_within_statistical_error(self):
        K = make_spd(192, seed=5)
        exact = 2.0 * jnp.sum(jnp.log(jnp.diagonal(jnp.linalg.cholesky(K))))
        probes = rademacher(jax.random.PRNGKey(0), (64, 192), K.dtype)
        est = slq_logdet(K, probes, num_steps=48)
        assert abs(float(est - exact)) / abs(float(exact)) < 0.02, (
            float(est), float(exact),
        )


def make_dense_gp_cov(n=256, noise_var=1e-2, seed=6):
    """The ill-conditioned production shape: densely sampled inputs, long
    lengthscale, small noise — cond(K) ~ 1/noise_var."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 4.0)
    return jnp.asarray(K + noise_var * np.eye(n)), noise_var


class TestPivotedPrecond:
    def test_pivoted_cholesky_captures_smooth_kernel(self):
        from gogp.ops.iterative import pivoted_cholesky

        K, nv = make_dense_gp_cov()
        L = pivoted_cholesky(K, rank=32, shift=nv)
        resid = np.asarray(K - nv * jnp.eye(K.shape[0]) - L @ L.T)
        rel = np.linalg.norm(resid) / float(jnp.linalg.norm(K))
        assert rel < 1e-3, rel  # smooth RBF spectrum decays fast

    def test_pcg_beats_plain_cg(self):
        from gogp.ops.iterative import cg_solve, pivoted_precond

        K, nv = make_dense_gp_cov()
        y = jnp.asarray(np.random.default_rng(7).normal(size=K.shape[0]))
        x_plain, it_plain = cg_solve(K, y, max_iters=1000, tol=1e-8)
        pc = pivoted_precond(K, 32, nv)
        x_pc, it_pc = cg_solve(K, y, max_iters=1000, tol=1e-8, precond=pc)
        direct = jnp.linalg.solve(K, y)
        np.testing.assert_allclose(np.asarray(x_pc), np.asarray(direct), atol=1e-5)
        # the point of the preconditioner: far fewer K streams
        assert int(it_pc) * 4 < int(it_plain), (int(it_pc), int(it_plain))

    def test_preconditioned_slq_beats_plain(self):
        """GPyTorch-style preconditioned logdet: log|P| analytic + PCG-
        coefficient quadrature with N(0, P) probes — machine precision on
        the smooth kernel where plain SLQ plateaus (rank-32 P captures
        the whole signal spectrum there)."""
        from gogp.ops.iterative import (
            pivoted_precond,
            rademacher,
            slq_logdet,
            slq_logdet_pcg,
        )

        K, nv = make_dense_gp_cov(n=384)
        n = K.shape[0]
        exact = 2.0 * float(jnp.sum(jnp.log(jnp.diagonal(jnp.linalg.cholesky(K)))))
        pc = pivoted_precond(K, 32, nv)
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        est_pc = float(slq_logdet_pcg(
            K, pc, jax.random.normal(k1, (16, n)),
            jax.random.normal(k2, (16, 32)), num_steps=15,
        ))
        probes = rademacher(jax.random.PRNGKey(1), (16, n), K.dtype)
        est_plain = float(slq_logdet(K, probes, num_steps=48))
        assert abs(est_pc - exact) / abs(exact) < 1e-6, (est_pc, exact)
        assert abs(est_pc - exact) < abs(est_plain - exact)

    def test_lml_precond_full_accuracy(self):
        """With precond_rank the whole lml estimator (PCG solves +
        preconditioned SLQ) reaches near-exactness on the smooth-kernel
        covariance."""
        from gogp.ops.iterative import lml_core_iterative

        K, nv = make_dense_gp_cov(n=384)
        y = jnp.asarray(np.random.default_rng(10).normal(size=K.shape[0]))
        L = jnp.linalg.cholesky(K)
        exact = -0.5 * (
            2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            + y @ jax.scipy.linalg.cho_solve((L, True), y)
        )
        est = lml_core_iterative(
            K, y, jax.random.PRNGKey(4), num_probes=16, cg_iters=200,
            lanczos_iters=20, precond_rank=32, noise_diag=nv,
        )
        assert abs(float(est - exact)) / abs(float(exact)) < 1e-5, (
            float(est), float(exact),
        )

    def test_pivoted_cholesky_cols_matches_dense(self):
        """The column-accessor build (matrix-free / row-sharded form) must
        reproduce the dense pivoted Cholesky exactly — same pivots, same
        columns — when its col_fn reads from the same dense K."""
        from gogp.ops.iterative import pivoted_cholesky, pivoted_cholesky_cols

        K, nv = make_dense_gp_cov()
        n = K.shape[0]
        Ld = pivoted_cholesky(K, rank=24, shift=nv)

        def col_fn(i):
            return jnp.take(K, i, axis=1) - nv * (jnp.arange(n) == i).astype(K.dtype)

        Lc = pivoted_cholesky_cols(col_fn, jnp.diagonal(K) - nv, 24)
        np.testing.assert_allclose(np.asarray(Lc), np.asarray(Ld), atol=1e-12)

    def test_lml_precond_rescues_small_cg_budget(self):
        """At a CG budget where the plain solves have not converged on the
        ill-conditioned covariance, the preconditioned path must land on
        the exact quadratic term."""
        from gogp.ops.iterative import lml_core_iterative

        K, nv = make_dense_gp_cov()
        y = jnp.asarray(np.random.default_rng(8).normal(size=K.shape[0]))
        L = jnp.linalg.cholesky(K)
        exact = -0.5 * (
            2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            + y @ jax.scipy.linalg.cho_solve((L, True), y)
        )
        kwargs = dict(num_probes=64, cg_iters=40, lanczos_iters=48)
        plain = lml_core_iterative(K, y, jax.random.PRNGKey(2), **kwargs)
        pc = lml_core_iterative(
            K, y, jax.random.PRNGKey(2), precond_rank=32, noise_diag=nv, **kwargs
        )
        err_plain = abs(float(plain - exact)) / abs(float(exact))
        err_pc = abs(float(pc - exact)) / abs(float(exact))
        assert err_pc < 0.02, err_pc
        assert err_pc < err_plain


class TestIterativeLML:
    def setup_method(self):
        self.gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        rng = np.random.default_rng(0)
        n = 256
        self.x = jnp.asarray(np.sort(rng.uniform(0, 10, (n, 1)), axis=0))
        self.y = jnp.asarray(
            np.sin(np.asarray(self.x[:, 0])) + 0.1 * rng.normal(size=n)
        )
        self.v = jnp.asarray([0.3, -0.2, -1.5])

    def _exact(self, v):
        th = jnp.exp(v)
        return lml(self.gp, th[:2], th[2:], self.x, self.y)

    def _iter(self, v, probes=32):
        th = jnp.exp(v)
        return lml_iterative(
            self.gp, th[:2], th[2:], self.x, self.y,
            jax.random.PRNGKey(7), num_probes=probes,
            cg_iters=300, lanczos_iters=48,
        )

    def test_value_converges_with_probes(self):
        # Hutchinson variance dominates (error ~ 1/sqrt(p)); measured on
        # this problem: 64 probes -> 4.5%, 128 -> 1.9%, 256 -> 0.6%.  Pin
        # the convergence and the 256-probe operating bound.
        ve = float(self._exact(self.v))
        e64 = abs(float(self._iter(self.v, probes=64)) - ve) / abs(ve)
        e256 = abs(float(self._iter(self.v, probes=256)) - ve) / abs(ve)
        assert e256 < 0.015, e256
        assert e256 < e64

    def test_theta_gradient_within_percents(self):
        ge = np.asarray(jax.grad(self._exact)(self.v))
        gi = np.asarray(jax.grad(lambda v: self._iter(v, 64))(self.v))
        rel = np.abs(gi - ge).max() / np.abs(ge).max()
        assert rel < 0.05, (gi, ge, rel)

    def test_y_gradient_exact(self):
        K = make_spd(96, seed=8)
        y = jnp.asarray(np.random.default_rng(9).normal(size=96))
        f = lambda yv: lml_core_iterative(
            K, yv, jax.random.PRNGKey(1), 16, 300, 32
        )
        gy = jax.grad(f)(y)
        alpha = jnp.linalg.solve(K, y)
        np.testing.assert_allclose(np.asarray(gy), -np.asarray(alpha), atol=1e-5)

    def test_deterministic_given_key(self):
        a = float(self._iter(self.v))
        b = float(jax.jit(self._iter)(self.v))
        assert abs(a - b) < 1e-8 * abs(a)

    def test_matfree_matches_dense_iterative(self):
        """lml_iterative_matfree (K rematerialized panel-by-panel, theta
        gradient via the frozen-solution quadratic forms) must equal the
        dense iterative path bit-for-bit up to reassociation — same key,
        same probes, same CG trajectory."""
        from gogp.gp.core import lml_iterative_matfree

        key = jax.random.PRNGKey(7)
        kw = dict(num_probes=32, cg_iters=300, lanczos_iters=48)

        def f_dense(v):
            th = jnp.exp(v)
            return lml_iterative(gp_of(self), th[:2], th[2:], self.x, self.y, key, **kw)

        def f_free(v):
            th = jnp.exp(v)
            return lml_iterative_matfree(
                gp_of(self), th[:2], th[2:], self.x, self.y, key, panel=64, **kw
            )

        vd, gd = jax.value_and_grad(f_dense)(self.v)
        vf, gf = jax.value_and_grad(f_free)(self.v)
        assert abs(float(vd - vf)) < 1e-5
        np.testing.assert_allclose(np.asarray(gd), np.asarray(gf), rtol=1e-4, atol=1e-4)

    def test_matfree_precond_matches_dense_precond(self):
        """precond_rank on the matfree path: the preconditioner built from
        kernel-column evaluations must reproduce the dense path's PCG +
        preconditioned-SLQ estimate (same key, same probe layout) — value
        and theta gradient."""
        from gogp.gp.core import lml_iterative_matfree

        key = jax.random.PRNGKey(13)
        kw = dict(num_probes=16, cg_iters=200, lanczos_iters=24, precond_rank=24)

        def f_dense(v):
            th = jnp.exp(v)
            return lml_iterative(gp_of(self), th[:2], th[2:], self.x, self.y, key, **kw)

        def f_free(v):
            th = jnp.exp(v)
            return lml_iterative_matfree(
                gp_of(self), th[:2], th[2:], self.x, self.y, key, panel=64, **kw
            )

        vd, gd = jax.value_and_grad(f_dense)(self.v)
        vf, gf = jax.value_and_grad(f_free)(self.v)
        assert abs(float(vd - vf)) < 1e-5 * abs(float(vd)), (float(vd), float(vf))
        np.testing.assert_allclose(np.asarray(gd), np.asarray(gf), rtol=1e-4, atol=1e-4)
        # and the preconditioned estimate is near-exact on this smooth
        # posterior covariance even at the small probe/iteration budget
        ve = float(self._exact(self.v))
        assert abs(float(vf) - ve) / abs(ve) < 2e-3, (float(vf), ve)

    def test_matfree_precond_mask(self):
        """Masked (padded) rows are identity rows in K; the matfree
        preconditioner's columns/diag must honor that exactly as the dense
        builder does."""
        from gogp.gp.core import lml_iterative_matfree

        th = jnp.exp(self.v)
        n = self.x.shape[0]
        mask = jnp.ones(n).at[-64:].set(0.0)
        key = jax.random.PRNGKey(15)
        kw = dict(num_probes=16, cg_iters=200, lanczos_iters=24, precond_rank=24)
        free = lml_iterative_matfree(
            gp_of(self), th[:2], th[2:], self.x, self.y, key, mask=mask,
            panel=64, **kw,
        )
        dense = lml_iterative(
            gp_of(self), th[:2], th[2:], self.x, self.y, key, mask=mask, **kw
        )
        assert abs(float(free - dense)) < 1e-5 * abs(float(dense))

    def test_matfree_mask(self):
        from gogp.gp.core import lml_iterative_matfree

        th = jnp.exp(self.v)
        n = self.x.shape[0]
        mask = jnp.ones(n).at[-64:].set(0.0)
        key = jax.random.PRNGKey(9)
        kw = dict(num_probes=48, cg_iters=300, lanczos_iters=48)
        free = lml_iterative_matfree(
            gp_of(self), th[:2], th[2:], self.x, self.y, key, mask=mask,
            panel=64, **kw,
        )
        dense = lml_iterative(
            gp_of(self), th[:2], th[2:], self.x, self.y, key, mask=mask, **kw
        )
        assert abs(float(free - dense)) < 1e-5 * abs(float(dense))

    def test_matfree_panel_divisibility(self):
        from gogp.ops.iterative import matfree_matvec

        try:
            matfree_matvec(lambda r: None, 100, 33)
        except ValueError as e:
            assert "divisible" in str(e)
        else:
            raise AssertionError("expected ValueError")

    def test_predict_iterative_matches_exact_produce(self):
        """Matrix-free Produce: one batched CG for [y | Kstar] reproduces
        absorb+predict (noise-free bands, reference gp/gp.go:258-360) to
        solver tolerance — deterministic, no probes involved."""
        from gogp.gp.core import predict, predict_iterative

        th = jnp.exp(self.v)
        z = jnp.linspace(0, 11, 23).reshape(-1, 1)
        mu_e, s_e = predict(self.gp, th[:2], th[2:], self.x, self.y, z)
        mu_i, s_i = predict_iterative(
            self.gp, th[:2], th[2:], self.x, self.y, z,
            panel=64, cg_iters=400, tol=1e-10,
        )
        np.testing.assert_allclose(np.asarray(mu_i), np.asarray(mu_e), atol=1e-8)
        np.testing.assert_allclose(np.asarray(s_i), np.asarray(s_e), atol=1e-7)
        # masked rows drop out exactly like the exact path
        n = self.x.shape[0]
        mask = jnp.ones(n).at[-50:].set(0.0)
        mu_e2, s_e2 = predict(self.gp, th[:2], th[2:], self.x, self.y, z, mask=mask)
        mu_i2, s_i2 = predict_iterative(
            self.gp, th[:2], th[2:], self.x, self.y, z, mask=mask,
            panel=64, cg_iters=400, tol=1e-10,
        )
        np.testing.assert_allclose(np.asarray(mu_i2), np.asarray(mu_e2), atol=1e-8)
        np.testing.assert_allclose(np.asarray(s_i2), np.asarray(s_e2), atol=1e-7)

    def test_masked_rows_ignored(self):
        """Padding contract: identity rows in K / zeros in y contribute
        nothing, matching the exact core's masking semantics."""
        th = jnp.exp(self.v)
        n = self.x.shape[0]
        mask = jnp.ones(n).at[-32:].set(0.0)
        full = lml_iterative(
            self.gp, th[:2], th[2:], self.x, self.y, jax.random.PRNGKey(3),
            num_probes=48, cg_iters=300, lanczos_iters=48, mask=mask,
        )
        exact_masked = lml(
            self.gp, th[:2], th[2:], self.x, self.y, mask=mask
        )
        assert abs(float(full - exact_masked)) / abs(float(exact_masked)) < 0.01
