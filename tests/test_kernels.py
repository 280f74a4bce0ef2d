"""Kernel unit tests (the reference leaves kernels untested — SURVEY.md §4.4;
we test them directly against closed forms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp.kernels import (
    SQRT3,
    SQRT5,
    constant_noise,
    jitter_only_noise,
    matern32,
    matern52,
    matern52_ref,
    normal,
    periodic,
    uniform_noise,
)


def k1(kernel, theta, a, b):
    return float(kernel(jnp.asarray(theta), jnp.asarray([a]), jnp.asarray([b])))


def test_normal_closed_form():
    # exp(-d^2/2), d=(xa-xb)/l — kernel/kernel.go:23-26
    assert k1(normal, [1.0], 0.0, 0.0) == pytest.approx(1.0)
    assert k1(normal, [1.0], 0.0, 1.0) == pytest.approx(np.exp(-0.5))
    assert k1(normal, [2.0], 0.0, 1.0) == pytest.approx(np.exp(-0.125))


def test_periodic_closed_form():
    # exp(-2 (sin(pi|xa-xb|/p)/l)^2) — kernel/kernel.go:44-47
    l, p = 0.7, 3.0
    d = np.sin(np.pi * 1.3 / p) / l
    assert k1(periodic, [l, p], 0.2, 1.5) == pytest.approx(np.exp(-2 * d * d))
    # exact periodicity
    assert k1(periodic, [l, p], 0.0, p) == pytest.approx(1.0)


def test_matern32_closed_form():
    d = 1.3 / 0.9
    want = (1 + SQRT3 * d) * np.exp(-SQRT3 * d)
    assert k1(matern32, [0.9], 0.2, 1.5) == pytest.approx(want)


def test_matern52_variants():
    d = 1.3 / 0.9
    want_correct = (1 + SQRT5 * d + 5.0 / 3.0 * d * d) * np.exp(-SQRT5 * d)
    # the reference's integer-division bug makes the d^2 coefficient 1
    # (kernel/kernel.go:91, kernel/ad/kernel.go:130)
    want_ref = (1 + SQRT5 * d + d * d) * np.exp(-SQRT5 * d)
    assert k1(matern52, [0.9], 0.2, 1.5) == pytest.approx(want_correct)
    assert k1(matern52_ref, [0.9], 0.2, 1.5) == pytest.approx(want_ref)
    assert want_correct != pytest.approx(want_ref)


def test_kernels_differentiable_at_coincident_points():
    """d/dtheta of every kernel must be finite at xa == xb (the covariance
    diagonal hits this on every absorb)."""
    for k in [normal, periodic, matern32, matern52, matern52_ref]:
        theta = jnp.ones(k.n_theta)
        g = jax.grad(lambda t: k(t, jnp.asarray([0.5]), jnp.asarray([0.5])))(theta)
        assert np.all(np.isfinite(np.asarray(g))), k.name


def test_combinators():
    sk = matern32.scaled()
    assert sk.n_theta == 2
    assert k1(sk, [2.5, 0.9], 0.2, 1.5) == pytest.approx(2.5 * k1(matern32, [0.9], 0.2, 1.5))

    both = matern52.scaled() + periodic.scaled()
    assert both.n_theta == 2 + 3
    th = [0.5, 1.1, 0.25, 0.7, 3.0]
    want = 0.5 * k1(matern52, [1.1], 0.2, 1.5) + 0.25 * k1(periodic, [0.7, 3.0], 0.2, 1.5)
    assert k1(both, th, 0.2, 1.5) == pytest.approx(want)

    prod = matern32 * matern32
    assert prod.n_theta == 2
    assert k1(prod, [0.9, 1.3], 0.2, 1.5) == pytest.approx(
        k1(matern32, [0.9], 0.2, 1.5) * k1(matern32, [1.3], 0.2, 1.5)
    )


def test_matrix_form_matches_pairs():
    x = jnp.asarray([[0.0], [0.5], [2.0]])
    z = jnp.asarray([[0.1], [1.0]])
    K = normal.matrix(jnp.ones(1), x, z)
    assert K.shape == (3, 2)
    for i in range(3):
        for j in range(2):
            assert float(K[i, j]) == pytest.approx(k1(normal, [1.0], float(x[i, 0]), float(z[j, 0])))


def test_noise_kernels():
    x = jnp.zeros((4, 1))
    np.testing.assert_allclose(
        np.asarray(constant_noise(0.1).vector(jnp.zeros(0), x)), 0.01
    )
    assert constant_noise(0.1).n_theta == 0
    np.testing.assert_allclose(
        np.asarray(uniform_noise.vector(jnp.asarray([0.3]), x)), 0.09
    )
    assert uniform_noise.n_theta == 1
    jo = jitter_only_noise(1e-5)
    assert jo.n_theta == 1
    np.testing.assert_allclose(np.asarray(jo.vector(jnp.asarray([9.0]), x)), 1e-5)
    scaled = uniform_noise.scaled_by(0.01)
    np.testing.assert_allclose(
        np.asarray(scaled.vector(jnp.asarray([0.5]), x)), 0.01 * 0.25
    )


def test_multidim_inputs():
    """Built-ins accept d-dim inputs via Euclidean distance."""
    xa = jnp.asarray([0.0, 3.0])
    xb = jnp.asarray([4.0, 0.0])
    d = 5.0 / 2.0
    want = (1 + SQRT3 * d) * np.exp(-SQRT3 * d)
    assert float(matern32(jnp.asarray([2.0]), xa, xb)) == pytest.approx(want)


def test_rational_quadratic_limits():
    """RQ -> RBF as alpha -> infinity; closed form at finite alpha."""
    from gogp.kernels import rational_quadratic, rbf

    xa, xb = jnp.array([0.3]), jnp.array([1.7])
    l = 0.8
    d2 = float((xa[0] - xb[0]) ** 2)
    alpha = 2.5
    want = (1 + d2 / (2 * alpha * l * l)) ** (-alpha)
    got = float(rational_quadratic(jnp.array([l, alpha]), xa, xb))
    assert np.isclose(got, want, atol=1e-12)
    # large-alpha limit approaches the RBF value
    big = float(rational_quadratic(jnp.array([l, 1e6]), xa, xb))
    assert np.isclose(big, float(rbf(jnp.array([l]), xa, xb)), atol=1e-4)


def test_linear_kernel():
    from gogp.kernels import linear

    xa, xb = jnp.array([2.0]), jnp.array([3.0])
    assert np.isclose(float(linear(jnp.array([0.5]), xa, xb)), 1.5 * 2.5)


def test_white_kernel():
    from gogp.kernels import white

    x = jnp.array([1.2])
    assert np.isclose(float(white(jnp.array([0.7]), x, x)), 0.49)
    assert float(white(jnp.array([0.7]), x, jnp.array([1.3]))) == 0.0


def test_new_kernels_psd():
    """Gram matrices of the new kernels must be PSD on random inputs."""
    from gogp.kernels import linear, rational_quadratic, white

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(12, 1)))
    for k, theta in [
        (rational_quadratic, jnp.array([0.9, 1.7])),
        (linear, jnp.array([0.2])),
        (white, jnp.array([0.5])),
    ]:
        K = np.asarray(k.matrix(theta, x, x))
        eig = np.linalg.eigvalsh(K + 1e-10 * np.eye(12))
        assert eig.min() > -1e-8, (k.name, eig.min())


class TestARD:
    """Per-dimension lengthscales via Kernel.ard (no reference counterpart —
    the reference only ever sees 1-D inputs)."""

    def test_matches_manual_anisotropic_rbf(self):
        import numpy as np
        from gogp.kernels import rbf

        k = rbf.ard(2)
        assert k.n_theta == 3  # [l1, l2, base l]
        ls = np.array([0.5, 3.0])
        theta = jnp.asarray([ls[0], ls[1], 1.0])
        rng = np.random.default_rng(0)
        xa, xb = rng.normal(size=(2, 2))
        got = float(k(theta, jnp.asarray(xa), jnp.asarray(xb)))
        d2 = float(np.sum(((xa - xb) / ls) ** 2))
        assert abs(got - np.exp(-d2 / 2)) < 1e-12

    def test_unit_lengthscales_equal_isotropic(self):
        import numpy as np
        from gogp.kernels import matern32

        k = matern32.ard(3)
        rng = np.random.default_rng(1)
        xa, xb = rng.normal(size=(2, 3))
        got = float(k(jnp.asarray([1.0, 1.0, 1.0, 0.8]), jnp.asarray(xa), jnp.asarray(xb)))
        want = float(matern32(jnp.asarray([0.8]), jnp.asarray(xa), jnp.asarray(xb)))
        assert abs(got - want) < 1e-12

    def test_fd_gradient_through_gp(self):
        import numpy as np
        from gogp.gp.core import GP
        from gogp.kernels import rbf, uniform_noise
        from gogp.models.params import gp_observe

        gp = GP(ndim=2, simil=rbf.ard(2).scaled(), noise=uniform_noise)
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.uniform(0, 3, size=(12, 2)))
        y = jnp.asarray(np.sin(np.asarray(x[:, 0])))
        v0 = jnp.asarray(0.1 * rng.normal(size=gp.n_theta))
        val, grad = jax.value_and_grad(lambda v: gp_observe(gp, v, x=x, y=y))(v0)
        eps = 1e-7
        for i in range(gp.n_theta):
            fd = (float(gp_observe(gp, v0.at[i].add(eps), x=x, y=y)) - float(val)) / eps
            assert abs(fd - float(grad[i])) < 1e-3


class TestSpectralMixture:
    def test_single_component_zero_mean_is_scaled_rbf(self):
        import numpy as np
        from gogp.kernels import rbf, spectral_mixture

        l, w = 1.7, 2.3
        v = 1.0 / (2 * np.pi * l) ** 2
        k = spectral_mixture(1)
        assert k.n_theta == 3
        xa, xb = jnp.asarray([0.4]), jnp.asarray([2.1])
        got = float(k(jnp.asarray([w, 0.0, v]), xa, xb))
        want = w * float(rbf(jnp.asarray([l]), xa, xb))
        assert abs(got - want) < 1e-12

    def test_psd_and_symmetric(self):
        import numpy as np
        from gogp.kernels import spectral_mixture

        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.uniform(0, 5, size=(40, 1)))
        k = spectral_mixture(3)
        th = jnp.asarray(np.abs(rng.normal(size=k.n_theta)) + 0.05)
        K = np.asarray(k.matrix(th, x, x))
        assert np.max(np.abs(K - K.T)) == 0.0
        assert np.linalg.eigvalsh(K).min() > -1e-9

    def test_learns_periodicity_better_than_rbf(self):
        # Data with a dominant frequency: an SM kernel initialized at the
        # right spectral peak should yield a (much) higher LML than RBF at
        # matched variance — the pattern-discovery property.
        import numpy as np
        from gogp.gp.core import GP, lml
        from gogp.kernels import rbf, spectral_mixture
        from gogp.kernels.noise import constant_noise

        rng = np.random.default_rng(3)
        x = jnp.asarray(np.linspace(0, 10, 60).reshape(-1, 1))
        f0 = 0.8
        y = jnp.asarray(np.cos(2 * np.pi * f0 * np.asarray(x)[:, 0]) + 0.05 * rng.normal(size=60))
        gp_sm = GP(1, spectral_mixture(1), noise=constant_noise(0.05))
        gp_rbf = GP(1, rbf.scaled(), noise=constant_noise(0.05))
        ll_sm = float(lml(gp_sm, jnp.asarray([0.5, f0, 0.001]), jnp.zeros(0), x, y))
        ll_rbf = float(lml(gp_rbf, jnp.asarray([0.5, 1.0]), jnp.zeros(0), x, y))
        assert ll_sm > ll_rbf + 10.0

    def test_multidim_fd_gradient_through_gp(self):
        import numpy as np
        from gogp.gp.core import GP
        from gogp.kernels import spectral_mixture, uniform_noise
        from gogp.models.params import gp_observe

        gp = GP(ndim=2, simil=spectral_mixture(2, ndim=2), noise=uniform_noise)
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.uniform(0, 3, size=(10, 2)))
        y = jnp.asarray(np.sin(np.asarray(x[:, 0])))
        v0 = jnp.asarray(0.1 * rng.normal(size=gp.n_theta))
        val, grad = jax.value_and_grad(lambda v: gp_observe(gp, v, x=x, y=y))(v0)
        eps = 1e-7
        for i in range(gp.n_theta):
            fd = (float(gp_observe(gp, v0.at[i].add(eps), x=x, y=y)) - float(val)) / eps
            assert abs(fd - float(grad[i])) < 1e-3


class TestMatern12:
    def test_value_and_diagonal(self):
        import numpy as np
        from gogp.kernels import matern12

        xa, xb = jnp.asarray([1.0]), jnp.asarray([3.0])
        got = float(matern12(jnp.asarray([2.0]), xa, xb))
        assert abs(got - np.exp(-1.0)) < 1e-12
        assert float(matern12(jnp.asarray([2.0]), xa, xa)) == 1.0
