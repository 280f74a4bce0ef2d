"""Kernel protocol: pure pair functions, differentiated by jax.grad.

The reference models a kernel as a stateful Infergo ``model.Model`` whose
``Observe([theta..., xa..., xb...])`` runs a hand-generated AD tape
(reference kernel/kernel.go:15-26, kernel/ad/kernel.go:12-36).  Here a kernel
is an immutable spec around a *pure* scalar pair function

    pair(theta, xa, xb) -> covariance          (similarity kernels)
    diag(theta, x)      -> noise variance      (noise kernels)

with ``theta`` a 1-D array of ``n_theta`` hyperparameters and ``xa``/``xb``
1-D arrays of ``ndim`` input coordinates.  Matrix/vector forms are derived
with ``vmap`` — XLA fuses the broadcasted elementwise math into a single
kernel, which both replaces the reference's O(n^2) per-pair tape runs
(gp/gp.go:109-156) and its goroutine row-parallelism (gp/gp.go:165-213).
Gradients come from ``jax.grad`` of whatever consumes the kernel; there is no
AD layer and no codegen step (reference Makefile:12-13 is deleted wholesale).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A similarity kernel: ``pair(theta, xa, xb) -> scalar``.

    Mirrors the reference ``Kernel`` interface — ``model.Model`` +
    ``NTheta()`` (gp/gp.go:14-17) — minus the tape lifecycle.
    """

    n_theta: int
    pair: Callable[[Array, Array, Array], Array]
    name: str = "kernel"
    # Structural tag for subsystems that need more than the pair function
    # (e.g. gp.pathwise walks it to sample the kernel's spectral measure).
    # A tuple like ("rbf",), ("scaled", inner), ("sum", a, b) — see
    # gp/pathwise.py for the grammar.  None = opaque (pathwise unsupported).
    spec: tuple | None = None

    def __call__(self, theta, xa, xb):
        return self.pair(jnp.asarray(theta), jnp.asarray(xa), jnp.asarray(xb))

    def matrix(self, theta, xa, xb):
        """Cross-covariance matrix K[i, j] = pair(theta, xa[i], xb[j]).

        ``xa``: (n, d); ``xb``: (m, d); returns (n, m).  The reference
        assembles this with a double loop of tape runs over the upper
        triangle (gp/gp.go:196-226); one fused vmap computes the full
        (symmetric work is cheaper than gather/scatter on an accelerator).
        """
        theta = jnp.asarray(theta)
        xa = jnp.atleast_2d(jnp.asarray(xa))
        xb = jnp.atleast_2d(jnp.asarray(xb))
        row = jax.vmap(self.pair, in_axes=(None, None, 0))
        return jax.vmap(row, in_axes=(None, 0, None))(theta, xa, xb)

    def diag_matrix(self, theta, x):
        """k(theta, x[i], x[i]) for each row — prior variances
        (reference gp/gp.go:270-278)."""
        theta = jnp.asarray(theta)
        x = jnp.atleast_2d(jnp.asarray(x))
        return jax.vmap(lambda xi: self.pair(theta, xi, xi))(x)

    # -- combinators ----------------------------------------------------

    def scaled(self) -> "Kernel":
        """Prepend an output-scale hyperparameter: ``theta[0] * k(theta[1:])``.

        The reference composes amplitude by hand in every tutorial kernel
        (e.g. tutorial/barebones/kernel/kernel.go:14-18)."""
        inner = self

        def pair(theta, xa, xb):
            return theta[0] * inner.pair(theta[1:], xa, xb)

        return Kernel(
            inner.n_theta + 1, pair, f"scaled({inner.name})", ("scaled", inner)
        )

    def __add__(self, other: "Kernel") -> "Kernel":
        """Sum kernel; thetas concatenate (self first).

        Covers compositions like the hyperpriors trend+seasonality kernel
        (tutorial/hyperpriors/kernel/kernel.go:22-24)."""
        a, b = self, other

        def pair(theta, xa, xb):
            return a.pair(theta[: a.n_theta], xa, xb) + b.pair(
                theta[a.n_theta :], xa, xb
            )

        return Kernel(a.n_theta + b.n_theta, pair, f"({a.name}+{b.name})", ("sum", a, b))

    def __mul__(self, other: "Kernel") -> "Kernel":
        a, b = self, other

        def pair(theta, xa, xb):
            return a.pair(theta[: a.n_theta], xa, xb) * b.pair(
                theta[a.n_theta :], xa, xb
            )

        return Kernel(a.n_theta + b.n_theta, pair, f"({a.name}*{b.name})", ("prod", a, b))

    def ard(self, ndim: int) -> "Kernel":
        """Automatic relevance determination: per-dimension lengthscales.

        Prepends ``ndim`` positive thetas l_1..l_d and evaluates the kernel
        on x / l — so any stationary kernel becomes anisotropic
        (k(|x - x'|_W) with W = diag(1/l^2)).  The reference only ever sees
        1-D inputs (SURVEY §2 C3) so it has no counterpart; for real
        multi-dimensional regression ARD is table stakes.  The base
        kernel's own scalar lengthscale remains as a global factor — the
        usual mild over-parameterization; pin it via priors or leave Adam
        to resolve it.
        """
        k = self.warp_inputs(lambda w, x: x / w, extra_theta=ndim)
        return dataclasses.replace(k, spec=("ard", self, ndim))

    def warp_inputs(self, warp: Callable[[Array], Array], extra_theta: int = 0) -> "Kernel":
        """Apply ``warp(x)`` (optionally consuming ``extra_theta`` leading
        thetas as ``warp(theta, x)``) to both inputs before the kernel."""
        inner = self

        if extra_theta:

            def pair(theta, xa, xb):
                w, rest = theta[:extra_theta], theta[extra_theta:]
                return inner.pair(rest, warp(w, xa), warp(w, xb))

        else:

            def pair(theta, xa, xb):
                return inner.pair(theta, warp(xa), warp(xb))

        return Kernel(inner.n_theta + extra_theta, pair, f"warped({inner.name})")


@dataclasses.dataclass(frozen=True)
class NoiseKernel:
    """A noise kernel: ``diag(theta, x) -> variance`` added on the diagonal
    only (reference kernel/noise.go, applied at gp/gp.go:133-154)."""

    n_theta: int
    diag: Callable[[Array, Array], Array]
    name: str = "noise"

    def __call__(self, theta, x):
        return self.diag(jnp.asarray(theta), jnp.asarray(x))

    def vector(self, theta, x):
        """Noise variance for each input row; x: (n, d) -> (n,)."""
        theta = jnp.asarray(theta)
        x = jnp.atleast_2d(jnp.asarray(x))
        return jax.vmap(lambda xi: self.diag(theta, xi))(x)

    def scaled_by(self, factor: float) -> "NoiseKernel":
        """Multiply the variance by a fixed factor — the tutorials' trick of
        scaling UniformNoise by a plausible magnitude (e.g.
        tutorial/barebones/kernel/kernel.go:26-31 Noise(0.01))."""
        inner = self

        def diag(theta, x):
            return factor * inner.diag(theta, x)

        return NoiseKernel(inner.n_theta, diag, f"{factor}*{inner.name}")
