"""Property tests: every expressible kernel composition must be PSD.

The reference's kernel contract is implicit (gonum's Cholesky just fails on
an indefinite K, gp/gp.go:228-230); here the property is pinned directly:
for a seeded sweep of random kernel TREES x random natural-scale thetas x
random inputs, the Gram matrix's smallest eigenvalue is >= -tol.  This is
the class of bug unit goldens cannot catch (a composition rule or a new
kernel that silently breaks positive-definiteness).

Deterministic (seeded enumeration, no hypothesis): failures reproduce.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gogp.kernels import (
    linear,
    matern12,
    matern32,
    matern52,
    matern52_ref,
    normal,
    periodic,
    rational_quadratic,
    spectral_mixture,
    white,
)

LEAVES = [
    ("rbf", normal),
    ("matern12", matern12),
    ("matern32", matern32),
    ("matern52", matern52),
    ("matern52_ref", matern52_ref),
    ("periodic", periodic),
    ("rq", rational_quadratic),
    ("linear", linear),
    ("white", white),
    ("sm2", spectral_mixture(2)),
]


def _random_tree(rng, depth=0):
    """Seeded random kernel tree over leaves + {scaled, +, *, ard(1)}."""
    if depth >= 2 or rng.random() < 0.4:
        k = LEAVES[rng.integers(len(LEAVES))][1]
        if rng.random() < 0.3:
            k = k.scaled()
        return k
    op = rng.integers(3)
    a = _random_tree(rng, depth + 1)
    if op == 0:
        return a.scaled()
    b = _random_tree(rng, depth + 1)
    return a + b if op == 1 else a * b


@pytest.mark.parametrize("seed", range(24))
def test_random_composition_is_psd(seed):
    rng = np.random.default_rng(seed)
    k = _random_tree(rng)
    n = 14
    x = jnp.asarray(rng.uniform(-4.0, 4.0, size=(n, 1)))
    # natural-scale thetas: log-uniform over two decades (the Observe
    # protocol's exp image)
    theta = jnp.asarray(np.exp(rng.uniform(-1.5, 1.5, size=k.n_theta)))
    K = np.asarray(k.matrix(theta, x, x))
    assert np.allclose(K, K.T, atol=1e-12), k.name
    w = np.linalg.eigvalsh(0.5 * (K + K.T))
    scale = max(abs(w).max(), 1.0)
    assert w.min() > -1e-9 * scale, (k.name, float(w.min()), np.asarray(theta))


@pytest.mark.parametrize("name,kern", [c for c in LEAVES if c[0] not in ("sm2",)])
def test_leaves_psd_2d(name, kern):
    rng = np.random.default_rng(hash(name) % 2**32)
    x = jnp.asarray(rng.uniform(-3.0, 3.0, size=(12, 2)))
    theta = jnp.asarray(np.exp(rng.uniform(-1.0, 1.0, size=kern.n_theta)))
    K = np.asarray(kern.matrix(theta, x, x))
    w = np.linalg.eigvalsh(0.5 * (K + K.T))
    assert w.min() > -1e-9 * max(abs(w).max(), 1.0), (name, float(w.min()))


def test_diag_matrix_matches_matrix_diagonal():
    rng = np.random.default_rng(3)
    for _, kern in LEAVES[:6]:
        x = jnp.asarray(rng.uniform(-2.0, 2.0, size=(9, 1)))
        theta = jnp.asarray(np.exp(rng.uniform(-1.0, 1.0, size=kern.n_theta)))
        full = np.diagonal(np.asarray(kern.matrix(theta, x, x)))
        diag = np.asarray(kern.diag_matrix(theta, x))
        np.testing.assert_allclose(diag, full, atol=1e-12)
