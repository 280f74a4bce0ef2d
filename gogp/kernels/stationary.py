"""Primitive stationary kernels.

Functional counterparts of reference kernel/kernel.go.  Each built-in takes
inputs of any dimensionality, reducing pairs through the Euclidean distance
(for 1-D inputs this is |xa-xb|, matching the reference exactly, which only
ever sees scalars).

Hyperparameters arrive *already in natural scale* — the exp-transform from
log scale happens once at the GP parameter boundary (see
gogp.models.params, reference gp/gp.go:377-381).
"""

from __future__ import annotations

import jax.numpy as jnp

from gogp.kernels.base import Kernel

SQRT3 = 1.7320508075688772  # reference kernel/kernel.go:50
SQRT5 = 2.2360679774997900  # reference kernel/kernel.go:51


def _dist(xa, xb):
    """Euclidean distance, safe to differentiate at zero.

    sqrt(x) has an infinite derivative at x=0; every stationary kernel below
    evaluates at xa == xb on the covariance diagonal, so we guard the norm.
    For 1-D inputs, d = |xa - xb| with subgradient 0 at coincidence, which
    matches the reference AD's |.| handling of kernel/ad/kernel.go.
    """
    diff = xa - xb
    sq = jnp.sum(diff * diff)
    # Zero-distance pairs get a zero gradient instead of NaN.
    safe = jnp.where(sq == 0.0, 1.0, sq)
    return jnp.where(sq == 0.0, 0.0, jnp.sqrt(safe))


def _normal_pair(theta, xa, xb):
    # exp(-d^2/2), d = |xa-xb|/l — reference kernel/kernel.go:23-26.
    # No output scale by design; users compose one (kernel/kernel.go comment,
    # tutorial/barebones/kernel/kernel.go:14-18).
    diff = (xa - xb) / theta[0]
    return jnp.exp(-jnp.sum(diff * diff) / 2)


normal = Kernel(1, _normal_pair, "normal", ("rbf",))
rbf = normal  # conventional alias


def _periodic_pair(theta, xa, xb):
    # exp(-2 sum_d (sin(pi tau_d / p) / l)^2), tau = xa - xb.
    # For 1-D inputs this equals the reference's exp(-2 (sin(pi|xa-xb|/p)/l)^2)
    # exactly (kernel/kernel.go:44-47; sin^2 is even), and it is smooth in
    # tau with no |.| guard needed.  The per-dimension PRODUCT form is the
    # standard multi-dim periodic kernel and is PSD in every dimension —
    # the Euclidean-norm form exp(-2 sin^2(pi ||tau|| / p)/l^2) is NOT a
    # valid kernel for ndim > 1 (measured: min eigenvalue -0.86 on random
    # 2-D inputs; caught by tests/test_kernel_properties.py).
    l, p = theta[0], theta[1]
    s = jnp.sin(jnp.pi * (xa - xb) / p) / l
    return jnp.exp(-2 * jnp.sum(s * s))


periodic = Kernel(2, _periodic_pair, "periodic", ("periodic",))


def _matern32_pair(theta, xa, xb):
    # (1 + sqrt3 d) exp(-sqrt3 d) — reference kernel/kernel.go:70-73.
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT3 * d) * jnp.exp(-SQRT3 * d)


matern32 = Kernel(1, _matern32_pair, "matern32", ("matern", 3))


def _matern52_pair(theta, xa, xb):
    # Correct Matérn-5/2: (1 + sqrt5 d + (5/3) d^2) exp(-sqrt5 d).
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT5 * d + (5.0 / 3.0) * d * d) * jnp.exp(-SQRT5 * d)


matern52 = Kernel(1, _matern52_pair, "matern52", ("matern", 5))


def _rq_pair(theta, xa, xb):
    # Rational quadratic: (1 + d^2/(2 alpha l^2))^-alpha — a scale mixture of
    # RBFs.  Not in the reference (its kernel set is Normal/Periodic/Matern,
    # kernel/kernel.go); included for model-surface completeness.
    l, alpha = theta[0], theta[1]
    diff = xa - xb
    d2 = jnp.sum(diff * diff)
    return (1.0 + d2 / (2.0 * alpha * l * l)) ** (-alpha)


rational_quadratic = Kernel(2, _rq_pair, "rational_quadratic", ("rq",))


def _linear_pair(theta, xa, xb):
    # Linear (dot-product) kernel about an offset c: <xa - c, xb - c>.
    #
    # NOTE: under the flat-vector protocol every theta is exp-transformed
    # (SURVEY.md §2.1-1), so c = exp(v) is constrained strictly positive —
    # an offset c <= 0 is unreachable through GP.Observe.  A model that
    # needs an unconstrained offset should compose the offset outside the
    # theta block (e.g. a warp combinator shifting the inputs) instead.
    c = theta[0]
    return jnp.sum((xa - c) * (xb - c))


linear = Kernel(1, _linear_pair, "linear")


def _white_pair(theta, xa, xb):
    # White kernel as a *similarity* (exact-coincidence) kernel — variance
    # only where xa == xb.  The reference expresses white noise through its
    # noise kernels instead (kernel/noise.go); this form composes with sums.
    diff = xa - xb
    same = jnp.all(diff == 0.0)
    return jnp.where(same, theta[0] * theta[0], 0.0)


white = Kernel(1, _white_pair, "white")


def _matern52_ref_pair(theta, xa, xb):
    # Reference-compatible Matérn-5/2.  The reference writes ``5/3*d*d``
    # (kernel/kernel.go:91) but Go integer constant division evaluates the
    # coefficient to 1 (confirmed in the generated AD, kernel/ad/kernel.go:130),
    # so the kernel it actually computes is (1 + sqrt5 d + d^2) exp(-sqrt5 d).
    # Use this variant when bit-matching reference posteriors (all four
    # Matérn-5/2 tutorials: hyperpriors, warpedtime, anynoise, events).
    d = _dist(xa, xb) / theta[0]
    return (1 + SQRT5 * d + d * d) * jnp.exp(-SQRT5 * d)


# Structural identity (any input dimension): with a = sqrt5, d = r/l,
#   (1 + a d + d^2) e^{-a d} = 0.4 (1 + a d) e^{-a d} + 0.6 (1 + a d + (5/3) d^2) e^{-a d}
# i.e. matern52_ref(l) = 0.4 * matern32(l * sqrt(3/5)) + 0.6 * matern52(l) —
# a convex sum of PSD kernels, so the quirk kernel is PSD and its spectral
# measure is the matching two-component Student-t mixture (gp/pathwise.py).
matern52_ref = Kernel(1, _matern52_ref_pair, "matern52_ref", ("matern52_ref",))


def _matern12_pair(theta, xa, xb):
    # Ornstein-Uhlenbeck / exponential kernel: exp(-d), d = |xa-xb|/l.
    # Completes the Matern half-integer ladder (1/2, 3/2, 5/2); the
    # reference ships only 3/2 and 5/2 (kernel/kernel.go:70-92).
    d = _dist(xa, xb) / theta[0]
    return jnp.exp(-d)


matern12 = Kernel(1, _matern12_pair, "matern12", ("matern", 1))
exponential = matern12  # conventional alias (OU process covariance)

_TWO_PI_SQ = 2.0 * jnp.pi * jnp.pi
_TWO_PI = 2.0 * jnp.pi


def spectral_mixture(q: int, ndim: int = 1) -> Kernel:
    """Spectral mixture kernel (Wilson & Adams 2013), Q components.

    k(tau) = sum_q w_q * prod_d exp(-2 pi^2 tau_d^2 v_qd) cos(2 pi mu_qd tau_d)

    with tau = xa - xb.  Theta layout (natural scale, all positive — the
    Observe protocol's exp transform, SURVEY §2.1-1, makes the optimizer's
    parameters their logs):

        [w_1..w_Q | mu_11..mu_Qd (Q*ndim) | v_11..v_Qd (Q*ndim)]

    w_q: component weights (variances); mu_qd: spectral means (frequencies);
    v_qd: spectral variances (inverse squared length scales, l_qd =
    1/(2 pi sqrt(v_qd))).  A single component with mu=0 reduces exactly to
    the RBF kernel scaled by w — pinned by tests/test_kernels.py.

    By Bochner's theorem a Q-component Gaussian spectral density can
    approximate any stationary covariance, which makes this the
    pattern-discovery kernel — it LEARNS periodicities instead of being
    told them (contrast the reference's fixed periodic kernel,
    kernel/kernel.go:44-47, whose period the hyperpriors study must
    pre-scale by hand, SURVEY §2 C9).  Note: the pair function is a
    fixed-Q fused product of exp/cos — no data-dependent shapes, vmaps into
    one elementwise kernel over the covariance tile like every other
    stationary kernel here.
    """
    if q < 1:
        raise ValueError(f"spectral_mixture needs q >= 1, got {q}")

    def pair(theta, xa, xb):
        w = theta[:q]
        mu = theta[q : q + q * ndim].reshape(q, ndim)
        v = theta[q + q * ndim :].reshape(q, ndim)
        tau = (xa - xb).reshape(1, ndim)
        envelope = jnp.exp(-_TWO_PI_SQ * (tau * tau) * v)  # (q, ndim)
        phase = jnp.cos(_TWO_PI * mu * tau)  # (q, ndim)
        return jnp.sum(w * jnp.prod(envelope * phase, axis=1))

    return Kernel(q * (1 + 2 * ndim), pair, f"spectral_mixture(q={q})", ("sm", q, ndim))
