"""Deep kernel learning: an MLP feature extractor in front of any kernel.

k_deep(x, x') = k_base(phi_w(x), phi_w(x')) with phi_w a small tanh MLP
(Wilson et al., AISTATS 2016).  The composition rides the existing
machinery wholesale: the warped kernel is just another
:class:`~gogp.kernels.base.Kernel`, so exact GP / sparse / Laplace /
EP / serving / every sampler see it unchanged, and the MLP weights are
ordinary kernel thetas trained by the same optimizers.

Signed weights under the exp-transforming Observe protocol (SURVEY
§2.1-1): like the multioutput coregionalization weights
(kernels/multioutput.py), the weight slots apply log to the natural-scale
theta, so the OPTIMIZER'S log-scale parameter IS the raw (signed,
unconstrained) weight.  :func:`init_deep_v` builds the flat protocol
vector directly from raw weights.

Note: phi_w is evaluated per input row inside the kernel pair
function, so the covariance assembly vmaps it into the same fused
elementwise program as every other kernel — the MLP matmuls batch over
the n x m pair grid.  For large n, prefer evaluating features once via
``warp_features`` and handing the features to the GP (linear in n, not
n^2); both paths are exposed.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from gogp.kernels.base import Kernel

Array = jax.Array


def _layer_sizes(ndim: int, hidden: tuple[int, ...], out_dim: int):
    dims = (ndim, *hidden, out_dim)
    shapes = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    n_w = sum(a * b + b for a, b in shapes)
    return shapes, n_w


def _apply_mlp(w_flat: Array, x: Array, shapes) -> Array:
    """phi_w(x) for a single input row x (ndim,) -> (out_dim,)."""
    h = x
    off = 0
    last = len(shapes) - 1
    for i, (a, b) in enumerate(shapes):
        W = w_flat[off : off + a * b].reshape(a, b)
        off += a * b
        bias = w_flat[off : off + b]
        off += b
        h = h @ W + bias
        if i != last:
            h = jnp.tanh(h)
    return h


def deep(base: Kernel, ndim: int, hidden: tuple[int, ...] = (8, 8),
         out_dim: int | None = None) -> Kernel:
    """Wrap ``base`` with a tanh-MLP input warp.

    Theta layout (natural scale): [exp(weights) (n_w) | base thetas...];
    the weight slots are logged back inside the kernel so the protocol's
    log-scale parameters are the raw weights.  ``out_dim`` defaults to
    ``ndim`` (dimension-preserving warp).  The final layer is LINEAR (no
    tanh) so identity weights reproduce ``base`` exactly — pinned by
    tests/test_deep.py.
    """
    out_dim = ndim if out_dim is None else out_dim
    shapes, n_w = _layer_sizes(ndim, tuple(hidden), out_dim)

    def pair(theta, xa, xb):
        w = jnp.log(theta[:n_w])  # protocol inverse: log-scale param IS the weight
        rest = theta[n_w:]
        return base.pair(rest, _apply_mlp(w, xa, shapes), _apply_mlp(w, xb, shapes))

    return Kernel(n_w + base.n_theta, pair, f"deep({base.name},{hidden})")


def n_weights(ndim: int, hidden: tuple[int, ...] = (8, 8),
              out_dim: int | None = None) -> int:
    out_dim = ndim if out_dim is None else out_dim
    return _layer_sizes(ndim, tuple(hidden), out_dim)[1]


def init_deep_v(rng, base_log_theta, ndim: int, hidden: tuple[int, ...] = (8, 8),
                out_dim: int | None = None, scale: float = 0.3) -> Array:
    """Flat protocol vector [weights_raw | log base thetas] with Xavier-ish
    random weights — pass straight to gp_observe / make_gp_logp / mle.

    ``rng``: numpy Generator (host-side init, like the studies' theta
    inits, tutorial/tutorial.go:119-121 jittered re-init analogue).
    """
    out_dim = ndim if out_dim is None else out_dim
    shapes, _ = _layer_sizes(ndim, tuple(hidden), out_dim)
    ws = []
    for a, b in shapes:
        ws.append((rng.normal(size=(a, b)) * scale / np.sqrt(a)).reshape(-1))
        ws.append(np.zeros(b))
    return jnp.asarray(np.concatenate(ws + [np.asarray(base_log_theta)]))


def identity_weights(ndim: int, hidden: tuple[int, ...] = (8, 8)) -> np.ndarray:
    """Raw weights making phi_w the identity (requires all widths == ndim;
    tanh layers use the small-signal linear regime only if inputs are
    small — exact identity needs hidden=()).  Mainly for tests."""
    shapes, _ = _layer_sizes(ndim, tuple(hidden), ndim)
    ws = []
    for a, b in shapes:
        if a != b:
            raise ValueError("identity_weights needs square layers")
        ws.append(np.eye(a).reshape(-1))
        ws.append(np.zeros(b))
    return np.concatenate(ws)


def warp_features(v_or_theta, x, ndim: int, hidden: tuple[int, ...] = (8, 8),
                  out_dim: int | None = None, raw: bool = True) -> Array:
    """Evaluate phi_w over rows of x ONCE — O(n) feature extraction for the
    linear-in-n pipeline (features -> any GP entry point).  ``raw=True``
    takes raw weights (protocol/log scale); False takes natural-scale
    theta (exp(weights))."""
    out_dim = ndim if out_dim is None else out_dim
    shapes, n_w = _layer_sizes(ndim, tuple(hidden), out_dim)
    v = jnp.asarray(v_or_theta)[:n_w]
    w = v if raw else jnp.log(v)
    x = jnp.atleast_2d(jnp.asarray(x))
    return jax.vmap(lambda xi: _apply_mlp(w, xi, shapes))(x)
