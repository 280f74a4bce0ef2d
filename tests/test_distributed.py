"""Distributed blocked Cholesky / solves / LML vs the dense XLA oracle
(SURVEY.md §4 test plan: sharded-vs-single-device equivalence on the fake
8-device CPU mesh)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from gogp.ops import distributed, linalg
from gogp.parallel import DATA_AXIS, make_mesh


def spd_matrix(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return jnp.asarray(a @ a.T + n * np.eye(n))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(n_chain=1, n_data=8)


def shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(
        jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
        )
    )


class TestCholeskyRowSharded:
    @pytest.mark.parametrize("n,block", [(64, 8), (128, 16), (256, 32), (128, 4)])
    def test_matches_dense(self, mesh, n, block):
        K = spd_matrix(n)
        f = shmap(
            functools.partial(
                distributed.cholesky_rowsharded, axis=DATA_AXIS, block=block
            ),
            mesh,
            (P(DATA_AXIS, None),),
            P(DATA_AXIS, None),
        )
        L = np.asarray(f(K))
        L_ref = np.asarray(jnp.linalg.cholesky(K))
        assert np.allclose(L, L_ref, atol=1e-8), np.abs(L - L_ref).max()

    def test_block_larger_than_shard_is_clamped(self, mesh):
        # n=64 over 8 devices -> n_local=8; block=256 clamps to 8
        K = spd_matrix(64)
        f = shmap(
            functools.partial(
                distributed.cholesky_rowsharded, axis=DATA_AXIS, block=256
            ),
            mesh,
            (P(DATA_AXIS, None),),
            P(DATA_AXIS, None),
        )
        L = np.asarray(f(K))
        assert np.allclose(L, np.asarray(jnp.linalg.cholesky(K)), atol=1e-8)


class TestSolveLowerRowSharded:
    def test_matches_dense(self, mesh):
        n, block = 128, 16
        K = spd_matrix(n, seed=1)
        L = jnp.linalg.cholesky(K)
        b = jnp.asarray(np.random.default_rng(2).normal(size=n))
        f = shmap(
            functools.partial(
                distributed.solve_lower_rowsharded, axis=DATA_AXIS, block=block
            ),
            mesh,
            (P(DATA_AXIS, None), P(DATA_AXIS)),
            P(DATA_AXIS),
        )
        y = np.asarray(f(L, b))
        y_ref = np.asarray(
            jax.scipy.linalg.solve_triangular(L, b, lower=True)
        )
        assert np.allclose(y, y_ref, atol=1e-8)


class TestLMLRowSharded:
    @pytest.mark.parametrize("n,block", [(64, 8), (256, 32)])
    def test_matches_dense_lml(self, mesh, n, block):
        K = spd_matrix(n, seed=3)
        y = jnp.asarray(np.random.default_rng(4).normal(size=n))
        f = distributed.make_sharded_lml(mesh, DATA_AXIS, block=block)
        got = float(f(K, y))

        L = linalg.cholesky(K)
        alpha = linalg.cho_solve_vec(L, y)
        want = float(
            -0.5 * (n * np.log(2 * np.pi) + 2 * np.sum(np.log(np.diag(np.asarray(L)))) + float(y @ alpha))
        )
        assert np.isclose(got, want, atol=1e-6), (got, want)


class TestSolveUpperRowSharded:
    def test_matches_dense(self, mesh):
        n, block = 128, 16
        K = spd_matrix(n, seed=11)
        L = jnp.linalg.cholesky(K)
        b = jnp.asarray(np.random.default_rng(12).normal(size=n))
        f = shmap(
            functools.partial(
                distributed.solve_upper_rowsharded, axis=DATA_AXIS, block=block
            ),
            mesh,
            (P(DATA_AXIS, None), P(DATA_AXIS)),
            P(DATA_AXIS),
        )
        got = np.asarray(f(L, b))
        want = np.asarray(
            jax.scipy.linalg.solve_triangular(L, b, lower=True, trans=1)
        )
        assert np.allclose(got, want, atol=1e-8)

    def test_matrix_rhs(self, mesh):
        n, block = 64, 8
        K = spd_matrix(n, seed=13)
        L = jnp.linalg.cholesky(K)
        B = jnp.asarray(np.random.default_rng(14).normal(size=(n, 5)))
        f = shmap(
            functools.partial(
                distributed.solve_upper_rowsharded, axis=DATA_AXIS, block=block
            ),
            mesh,
            (P(DATA_AXIS, None), P(DATA_AXIS, None)),
            P(DATA_AXIS, None),
        )
        got = np.asarray(f(L, B))
        want = np.asarray(
            jax.scipy.linalg.solve_triangular(L, B, lower=True, trans=1)
        )
        assert np.allclose(got, want, atol=1e-8)


class TestLMLGradient:
    def test_grad_matches_dense(self, mesh):
        """custom VJP of the sharded LML vs jax.grad through the dense path.

        Differentiation happens INSIDE shard_map (the supported convention;
        each device owns its rows of the K-cotangent)."""
        n, block = 64, 8
        K = spd_matrix(n, seed=20)
        y = jnp.asarray(np.random.default_rng(21).normal(size=n))

        def device_fn(K_local, y_local):
            return jax.grad(
                lambda K_l, y_l: distributed.lml_rowsharded(K_l, y_l, DATA_AXIS, block),
                argnums=(0, 1),
            )(K_local, y_local)

        f = shmap(
            device_fn,
            mesh,
            (P(DATA_AXIS, None), P(DATA_AXIS)),
            (P(DATA_AXIS, None), P(DATA_AXIS)),
        )
        gK_sharded, gy_sharded = f(K, y)

        def dense_lml(K, y):
            L = linalg.cholesky(K)
            alpha = linalg.cho_solve_vec(L, y)
            return -0.5 * (
                n * jnp.log(2 * jnp.pi)
                + 2 * jnp.sum(jnp.log(jnp.diagonal(L)))
                + y @ alpha
            )

        gK_dense, gy_dense = jax.grad(dense_lml, argnums=(0, 1))(K, y)
        assert np.allclose(np.asarray(gy_sharded), np.asarray(gy_dense), atol=1e-8)
        # dense autodiff through cholesky yields an asymmetric cotangent
        # convention; compare the symmetrized forms (both contract the same
        # against symmetric dK)
        sym = lambda A: 0.5 * (np.asarray(A) + np.asarray(A).T)  # noqa: E731
        assert np.allclose(sym(gK_sharded), sym(gK_dense), atol=1e-7)

    def test_grad_through_theta(self, mesh):
        """End-to-end: d lml / d theta through a sharded covariance build."""
        from gogp.gp.core import GP
        from gogp.kernels import rbf, uniform_noise
        from gogp.models.params import gp_observe
        from gogp.parallel.large_n import make_rowsharded_logp

        gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        n = 64
        rng = np.random.default_rng(22)
        x = jnp.asarray(np.sort(rng.uniform(0, 10, (n, 1)), axis=0))
        y = jnp.asarray(np.sin(np.asarray(x[:, 0])))
        mask = jnp.ones(n)

        def device_fn(x_local, y_local, m_local, v):
            from gogp.parallel.large_n import make_rowsharded_value_and_grad

            x_full = jax.lax.all_gather(x_local, DATA_AXIS, tiled=True)
            logp = make_rowsharded_logp(
                gp, x_local, x_full, y_local, m_local, DATA_AXIS, block=8
            )
            return make_rowsharded_value_and_grad(logp, DATA_AXIS)(v)

        f = shmap(
            device_fn,
            mesh,
            (P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P()),
            (P(), P()),
        )
        v = jnp.array([0.2, -0.4, -1.0])
        val_s, grad_s = f(x, y, mask, v)
        val_d, grad_d = jax.value_and_grad(
            lambda v: gp_observe(gp, v, x=x, y=y, mask=mask)
        )(v)
        assert np.isclose(float(val_s), float(val_d), atol=1e-8)
        assert np.allclose(np.asarray(grad_s), np.asarray(grad_d), atol=1e-6), (
            np.asarray(grad_s), np.asarray(grad_d),
        )


class TestUnrolledCholesky:
    def test_unrolled_matches_fori(self, mesh):
        n, block = 128, 16
        K = spd_matrix(n, seed=30)
        for unroll in (False, True):
            f = shmap(
                functools.partial(
                    distributed.cholesky_rowsharded,
                    axis=DATA_AXIS, block=block, unroll=unroll,
                ),
                mesh,
                (P(DATA_AXIS, None),),
                P(DATA_AXIS, None),
            )
            L = np.asarray(f(K))
            assert np.allclose(
                L, np.asarray(jnp.linalg.cholesky(K)), atol=1e-8
            ), unroll
