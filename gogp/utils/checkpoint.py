"""Checkpoint / resume for posteriors and sampler states.

The reference has no checkpointing; its closest surface is the documented
contract that ``Produce`` runs off the stored fields
ThetaSimil/ThetaNoise/X/L/Alpha (gp/gp.go:255-257).  Here that state is the
explicit immutable :class:`gogp.gp.core.Posterior` pytree, and this
module makes it (and any sampler state pytree: HMCState chains mid-run, SMC
particles, ADVI params) durable via orbax — including sharded arrays on a
multi-chip mesh (orbax handles distributed save/restore natively, which is
the elasticity story for long pod-slice SMC/NUTS runs).
"""

from __future__ import annotations

import os
from typing import Any

import jax


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def _pad_empty(leaf):
    # orbax refuses zero-size arrays; zero-theta kernels/likelihoods carry
    # (0,)-shaped leaves (e.g. LaplacePosterior.theta_lik for probit).
    # Saved as a 1-element placeholder; restore() rebuilds the empty leaf
    # from the structure (shape recorded in `like` or in the saved shape
    # via the size-1 convention below).
    import jax.numpy as jnp

    if hasattr(leaf, "size") and leaf.size == 0:
        return jnp.zeros((1,), dtype=leaf.dtype)
    return leaf


def save(path: str | os.PathLike, tree: Any, *, force: bool = True) -> None:
    """Save any pytree of arrays (Posterior, HMCState, SMC particles...).

    ``path`` must be a directory path (created by orbax); absolute paths
    required by orbax are derived automatically.  Zero-size leaves (thetas
    of parameter-free kernels/likelihoods) are stored as placeholders and
    reconstructed on restore.
    """
    path = os.path.abspath(os.fspath(path))
    ckptr = _checkpointer()
    ckptr.save(path, jax.tree.map(_pad_empty, tree), force=force)
    ckptr.wait_until_finished()


def restore(path: str | os.PathLike, like: Any | None = None) -> Any:
    """Restore a pytree saved by :func:`save`.

    ``like``: an abstract/concrete pytree of the same structure (e.g. built
    with jax.eval_shape or an actual template object); restores with its
    structure, dtypes, and shardings.  Without it, orbax restores with the
    saved metadata (plain numpy-backed arrays).
    """
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.fspath(path))
    ckptr = _checkpointer()
    if like is None:
        return ckptr.restore(path)
    abstract = jax.tree.map(
        ocp.utils.to_shape_dtype_struct, jax.tree.map(_pad_empty, like)
    )
    restored = ckptr.restore(path, abstract)
    flat = jax.tree.unflatten(jax.tree.structure(like), jax.tree.leaves(restored))
    # undo the placeholder padding wherever `like` has a zero-size leaf
    return jax.tree.map(
        lambda r, l: jnp.zeros(l.shape, l.dtype)
        if hasattr(l, "size") and l.size == 0
        else r,
        flat,
        like,
    )
