"""Prior log-densities vs scipy.stats (replaces Infergo ``dist`` — reference
call sites: hyperpriors/model/model.go:23-37, anynoise/model/model.go:40-43)."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats as st

from gogp import dists

XS = np.array([0.1, 0.7, 1.3, 2.9])


def test_normal_logp():
    got = np.asarray(dists.normal_logp(0.5, 2.0, jnp.asarray(XS)))
    want = st.norm.logpdf(XS, loc=0.5, scale=2.0)
    assert np.allclose(got, want, atol=1e-12)


def test_expon_logp():
    got = np.asarray(dists.expon_logp(1.7, jnp.asarray(XS)))
    want = st.expon.logpdf(XS, scale=1 / 1.7)
    assert np.allclose(got, want, atol=1e-12)


def test_laplace_logp():
    got = np.asarray(dists.laplace_logp(0.3, 1.2, jnp.asarray(XS)))
    want = st.laplace.logpdf(XS, loc=0.3, scale=1.2)
    assert np.allclose(got, want, atol=1e-12)


def test_laplace_is_expon_of_abs_minus_log2():
    # the anynoise identity: Expon.Logp(lam, |r|) = laplace_logp(0, 1/lam, r) + log 2
    lam, r = 2.5, 0.8
    a = float(dists.expon_logp(lam, abs(r)))
    b = float(dists.laplace_logp(0.0, 1 / lam, r)) + np.log(2.0)
    assert np.isclose(a, b, atol=1e-12)


def test_lognormal_logp():
    got = np.asarray(dists.lognormal_logp(0.2, 0.9, jnp.asarray(XS)))
    want = st.lognorm.logpdf(XS, s=0.9, scale=np.exp(0.2))
    assert np.allclose(got, want, atol=1e-12)


def test_halfnormal_logp():
    got = np.asarray(dists.halfnormal_logp(1.5, jnp.asarray(XS)))
    want = st.halfnorm.logpdf(XS, scale=1.5)
    assert np.allclose(got, want, atol=1e-12)


def test_gamma_logp():
    got = np.asarray(dists.gamma_logp(2.5, 1.8, jnp.asarray(XS)))
    want = st.gamma.logpdf(XS, a=2.5, scale=1 / 1.8)
    assert np.allclose(got, want, atol=1e-10)


def test_grad_and_vmap_safe():
    g = jax.grad(lambda x: dists.normal_logp(0.0, 1.0, x))(0.7)
    assert np.isclose(float(g), -0.7)
    v = jax.vmap(lambda x: dists.expon_logp(1.0, x))(jnp.asarray(XS))
    assert v.shape == XS.shape
