"""ops/linalg: the analytic LML pullback against autodiff, and the solves
against scipy, all in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
from jax.scipy.linalg import solve_triangular

from gogp.ops import linalg

LML_SIZES = [1, 2, 3, 8, 33, 64, 128, 257, 512]
SOLVE_SIZES = [1, 7, 64, 300]


def _spd(n, seed=0, noise=0.3):
    """RBF covariance on sorted random inputs plus noise: the GP shape."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + noise * np.eye(n)
    y = np.sin(x) + 0.1 * rng.normal(size=n)
    return jnp.asarray(K), jnp.asarray(y)


def _padded(n, seed=0):
    """The masked-padding convention of gp.core.masked_cov: the last third
    of the points are padding, with identity rows in K and zeros in y."""
    K, y = _spd(n, seed)
    m = np.ones(n)
    m[n - n // 3:] = 0.0
    mm = jnp.asarray(m[:, None] * m[None, :])
    K = K * mm + jnp.diag(jnp.asarray(1.0 - m))
    return K, y * jnp.asarray(m)


def _autodiff_core(K, y):
    """The same value through plain autodiff of XLA's Cholesky."""
    L = jnp.linalg.cholesky(K)
    z = solve_triangular(L, y, lower=True)
    return -jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * jnp.dot(z, z)


def _sym(A):
    return 0.5 * (A + A.T)


@pytest.mark.parametrize("padding", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("n", LML_SIZES)
def test_lml_rule_matches_autodiff(n, padding):
    K, y = _padded(n) if padding else _spd(n)
    v, (gK, gy) = jax.value_and_grad(linalg.lml_core, argnums=(0, 1))(K, y)
    v_ref, (gK_ref, gy_ref) = jax.value_and_grad(_autodiff_core, argnums=(0, 1))(K, y)
    np.testing.assert_allclose(v, v_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_sym(gK), _sym(gK_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(gy, gy_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [5, 64, 257])
def test_lml_rule_random_cotangent(n):
    K, y = _spd(n, seed=3)
    g = jnp.asarray(np.random.default_rng(n).normal())
    _, vjp = jax.vjp(linalg.lml_core, K, y)
    _, vjp_ref = jax.vjp(_autodiff_core, K, y)
    (gK, gy), (gK_ref, gy_ref) = vjp(g), vjp_ref(g)
    np.testing.assert_allclose(_sym(gK), _sym(gK_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(gy, gy_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [4, 100])
def test_lml_rule_jit_matches_eager(n):
    K, y = _spd(n, seed=5)
    f = jax.value_and_grad(linalg.lml_core, argnums=(0, 1))
    (v, (gK, gy)), (vj, (gKj, gyj)) = f(K, y), jax.jit(f)(K, y)
    np.testing.assert_allclose(v, vj, rtol=1e-12)
    np.testing.assert_allclose(gK, gKj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gy, gyj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [6, 65])
def test_lml_rule_under_vmap(n):
    Ks, ys = zip(*[_spd(n, seed=s) for s in range(3)])
    Kb, yb = jnp.stack(Ks), jnp.stack(ys)
    f = jax.value_and_grad(linalg.lml_core, argnums=(0, 1))
    vb, (gKb, gyb) = jax.vmap(f)(Kb, yb)
    for i in range(3):
        v, (gK, gy) = f(Kb[i], yb[i])
        np.testing.assert_allclose(vb[i], v, rtol=1e-12)
        np.testing.assert_allclose(gKb[i], gK, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(gyb[i], gy, rtol=1e-10, atol=1e-12)


def test_lml_rule_second_order_reverse():
    # the pullback is plain jnp, so reverse-over-reverse works
    K, y = _spd(12, seed=7)
    h = jax.grad(lambda s: jax.grad(lambda t: linalg.lml_core(t * K, y))(s))(1.0)
    h_ref = jax.grad(lambda s: jax.grad(lambda t: _autodiff_core(t * K, y))(s))(1.0)
    np.testing.assert_allclose(h, h_ref, rtol=1e-8)


@pytest.mark.parametrize("n", [2, 16, 48, 96])
def test_syrk_lower_t_matches_dense(n):
    W = jnp.tril(jnp.asarray(np.random.default_rng(n).normal(size=(n, n))))
    # min_size=8 forces the recursive split on every size above 8
    np.testing.assert_allclose(
        linalg.syrk_lower_t(W, min_size=8), W.T @ W, rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("n", SOLVE_SIZES)
def test_cho_solve_mat_matches_scipy(n):
    K, _ = _spd(n, seed=11)
    B = np.random.default_rng(n).normal(size=(n, 5))
    L = linalg.cholesky(K)
    want = sla.cho_solve((np.asarray(L), True), B)
    np.testing.assert_allclose(linalg.cho_solve_mat(L, jnp.asarray(B)), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", SOLVE_SIZES)
def test_trsm_lower_matches_scipy(n):
    K, _ = _spd(n, seed=13)
    B = np.random.default_rng(n + 1).normal(size=(n, 3))
    L = np.asarray(linalg.cholesky(K))
    want = sla.solve_triangular(L, B, lower=True)
    np.testing.assert_allclose(linalg.trsm_lower(jnp.asarray(L), jnp.asarray(B)), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", SOLVE_SIZES)
def test_tril_inv_matches_scipy(n):
    K, _ = _spd(n, seed=17)
    L = np.asarray(linalg.cholesky(K))
    want = sla.solve_triangular(L, np.eye(n), lower=True)
    got = np.asarray(linalg.tril_inv(jnp.asarray(L)))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert np.all(np.triu(got, 1) == 0.0)


def test_cholesky_with_jitter_leaves_spd_alone():
    K, _ = _spd(20)
    L, jitter = linalg.cholesky_with_jitter(K)
    assert float(jitter) == 0.0
    np.testing.assert_allclose(L, np.linalg.cholesky(np.asarray(K)), rtol=1e-12)


def test_cholesky_with_jitter_escalates():
    # rank-deficient PSD matrix: the plain factorization fails, jitter
    # escalates until it succeeds
    v = np.random.default_rng(0).normal(size=(30, 3))
    K = jnp.asarray(v @ v.T)
    assert not np.all(np.isfinite(np.asarray(jnp.linalg.cholesky(K))))
    L, jitter = linalg.cholesky_with_jitter(K)
    assert float(jitter) > 0.0
    assert np.all(np.isfinite(np.asarray(L)))
    n = K.shape[0]
    np.testing.assert_allclose(L @ L.T, K + float(jitter) * np.eye(n), rtol=1e-8, atol=1e-8)


def test_cholesky_with_jitter_gives_up_with_nans():
    K = -jnp.eye(4)
    L, _ = linalg.cholesky_with_jitter(K, max_tries=2)
    assert not np.all(np.isfinite(np.asarray(L)))
