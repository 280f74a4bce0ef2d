"""Sharded serving (parallel/serving.py) vs single-device serving — the
serving analogue of the reference's serial-vs-parallel equivalence
invariant (gp/gp_test.go:123-132)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gogp import parallel
from gogp.gp import core, serve
from gogp.kernels import rbf, uniform_noise


@pytest.fixture(scope="module")
def mesh8():
    return parallel.make_mesh(n_chain=8, n_data=1)


def _problem(n=24, seed=0):
    gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(np.sort(rng.uniform(0.0, 10.0, size=(n, 1)), axis=0))
    y = jnp.asarray(np.sin(np.asarray(x[:, 0])) + 0.1 * rng.normal(size=n))
    return gp, x, y


def test_request_sharded_predict_matches(mesh8):
    gp, x, y = _problem()
    sp = serve.fit_serving(gp, jnp.array([1.0, 0.8]), jnp.array([0.2]), x, y)
    z = jnp.linspace(-1.0, 11.0, 64)[:, None]  # 64 rows over 8 devices
    mu1, s1 = parallel.serve_predict_sharded(gp, sp, z, mesh8)
    mu2, s2 = serve.serve_predict(gp, sp, z)
    assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-10)
    assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-10)


def test_draw_sharded_mixture_matches(mesh8):
    gp, x, y = _problem(seed=1)
    rng = np.random.default_rng(2)
    vs = jnp.asarray(0.3 * rng.normal(size=(16, gp.n_theta)))  # 16 draws / 8 dev
    sm = serve.compile_mixture(gp, vs, x, y)
    z = jnp.linspace(0.0, 10.0, 21)[:, None]
    mu1, s1 = parallel.serve_predict_mixture_sharded(gp, sm, z, mesh8)
    mu2, s2 = serve.serve_predict_mixture(gp, sm, z)
    assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-9)
    assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-9)


def test_mixture_sharding_placement(mesh8):
    # per-draw leaves shard over the chain axis, shared leaves replicate
    gp, x, y = _problem(seed=3)
    vs = jnp.asarray(0.2 * np.random.default_rng(4).normal(size=(8, gp.n_theta)))
    sm = parallel.shard_mixture(serve.compile_mixture(gp, vs, x, y), mesh8)
    assert not sm.w.sharding.is_fully_replicated
    assert sm.x.sharding.is_fully_replicated
    assert sm.mask.sharding.is_fully_replicated
