"""Noise kernels — diagonal-only variance contributions.

Counterparts of reference kernel/noise.go.  A noise kernel sees a single
input point and returns a *variance* added on the covariance diagonal only
(reference gp/gp.go:133-154).
"""

from __future__ import annotations

import jax.numpy as jnp

from gogp.kernels.base import NoiseKernel


def constant_noise(std: float) -> NoiseKernel:
    """Fixed noise: variance = std² for every point, zero hyperparameters.

    Reference kernel/noise.go:21-34 (``ConstantNoise``); note the reference
    squares the value, so the GP default ``ConstantNoise(1e-5)``
    (gp/gp.go:43-47) contributes variance 1e-10.
    """
    var = float(std) * float(std)

    def diag(theta, x):
        return jnp.asarray(var, dtype=x.dtype)

    return NoiseKernel(0, diag, f"constant_noise({std})")


def _uniform_diag(theta, x):
    # variance = std², std = theta[0] — reference kernel/noise.go:39-53.
    return theta[0] * theta[0]


uniform_noise = NoiseKernel(1, _uniform_diag, "uniform_noise")


def jitter_only_noise(jitter: float = 1e-5) -> NoiseKernel:
    """A noise kernel that *allocates* one hyperparameter but contributes only
    a fixed jitter — the anynoise tutorial's trick for carving out a slot in
    the parameter vector that the priors consume as the Laplace scale
    (tutorial/anynoise/kernel/kernel.go:31-35).
    """

    def diag(theta, x):
        return jnp.asarray(jitter, dtype=x.dtype)

    return NoiseKernel(1, diag, f"jitter_only_noise({jitter})")
