"""Maximum-likelihood / MAP optimization of log-densities.

Replaces the reference's optimizer layer (tutorial/tutorial.go:128-169):
gonum ``optimize.Minimize`` LBFGS (:131-142) and Infergo ``infer.Adam``
(:156-168).  Both run as a single compiled ``lax.while_loop`` — the whole
optimization is one XLA program, no host round-trips per step.

Conventions: we *maximize* ``logp`` (the reference's Observe is a
log-likelihood; its FuncGrad adapter negates for gonum).  Early stopping
matches the reference's criterion: stop when every |grad_i| < threshold
(tutorial.go:160-166), capped at ``iters`` major iterations.

Batched fits: both optimizers are vmap-safe, so a whole family of
independent fits (e.g. every prefix length of the rolling-forecast loop,
reference tutorial.go:91) runs as one batched program — see
``gogp.tutorial.evaluate``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

Array = jax.Array

# Reference knob defaults — tutorial/tutorial.go:26-30.
DEFAULT_ITERS = 1000
DEFAULT_THRESHOLD = 1e-6
DEFAULT_RATE = 0.01


class OptResult(NamedTuple):
    x: Array  # optimized parameter vector
    value: Array  # logp at x
    iters: Array  # iterations actually taken
    converged: Array  # True if the gradient threshold was hit
    # True if LBFGS stopped making progress (zero update from a failed
    # linesearch) before converging — the analogue of gonum
    # optimize.Minimize returning an error (reference tutorial.go:144-155:
    # tolerated unless it happens before MINITERS, then logged).
    stalled: Array


def _run_optax(
    value_and_grad: Callable[[Array], tuple[Array, Array]],
    opt: optax.GradientTransformation,
    x0: Array,
    iters: int,
    threshold: float,
    needs_extras: bool,
    neg_fn: Callable[[Array], Array] | None = None,
) -> OptResult:
    """Shared while_loop driver.  ``value_and_grad`` evaluates -logp."""

    opt_state = opt.init(x0)

    def cond(carry):
        _, _, step, gmax, _, _ = carry
        return jnp.logical_and(step < iters, gmax >= threshold)

    def body(carry):
        x, opt_state, step, _, prev_value, bad = carry
        value, grad = value_and_grad(x)
        # Non-finite guard: a step into NaN/inf territory (e.g. an extreme
        # theta making the model blow up) keeps the last finite iterate and
        # exits, flagged stalled — the jit-compatible version of the
        # reference's tolerated optimizer failure (tutorial.go:144-155) and
        # this repo's NaN degradation policy (DESIGN §7).
        finite = jnp.logical_and(
            jnp.isfinite(value), jnp.all(jnp.isfinite(grad))
        )
        grad = jnp.where(finite, grad, jnp.zeros_like(grad))
        value_safe = jnp.where(finite, value, prev_value)
        if needs_extras:
            updates, new_state = opt.update(
                grad, opt_state, x, value=value_safe, grad=grad, value_fn=neg_fn
            )
        else:
            updates, new_state = opt.update(grad, opt_state, x)
        updates = jax.tree.map(
            lambda u: jnp.where(finite, u, jnp.zeros_like(u)), updates
        )
        new_x = optax.apply_updates(x, updates)
        gmax_raw = jnp.max(jnp.abs(grad)) if grad.size else jnp.asarray(0.0, x.dtype)
        gmax = jnp.where(finite, gmax_raw, jnp.asarray(0.0, x.dtype))
        return new_x, new_state, step + 1, gmax, value_safe, jnp.logical_or(bad, ~finite)

    init_val = (
        x0,
        opt_state,
        jnp.asarray(0),
        jnp.asarray(jnp.inf, x0.dtype),
        jnp.asarray(0.0, x0.dtype),
        jnp.asarray(False),
    )
    x, _, step, gmax, value, bad = jax.lax.while_loop(cond, body, init_val)
    return OptResult(x, -value, step, jnp.logical_and(gmax < threshold, ~bad), bad)


def adam(
    value_and_grad_logp: Callable[[Array], tuple[Array, Array]],
    x0: Array,
    iters: int | Array = DEFAULT_ITERS,
    rate: float = DEFAULT_RATE,
    threshold: float = DEFAULT_THRESHOLD,
) -> OptResult:
    """Adam ascent on ``logp`` — reference "adam" branch (tutorial.go:156-168).

    ``value_and_grad_logp`` may carry a gradient mask
    (gogp.models.masked_value_and_grad) to pin coordinates, replacing the
    tutorials' Gradient() surgery.

    ``iters`` may be a traced scalar: under vmap, rows that should not
    optimize at all (the Evaluate protocol's MINOPT skip) pass 0 and leave
    the loop immediately instead of burning the full budget.
    """
    x0 = jnp.asarray(x0)

    def neg_vg(x):
        v, g = value_and_grad_logp(x)
        return -v, -g

    return _run_optax(neg_vg, optax.adam(rate), x0, iters, threshold, False)


def lbfgs(
    logp: Callable[[Array], Array],
    x0: Array,
    iters: int | Array = DEFAULT_ITERS,
    threshold: float = DEFAULT_THRESHOLD,
    memory_size: int = 15,
    free: Array | None = None,
) -> OptResult:
    """LBFGS with zoom linesearch — reference "lbfgs" branch
    (tutorial.go:131-142, gonum optimize.Minimize).

    ``free`` is an optional 0/1 mask pinning coordinates (gradient zeroed
    before the update, so pinned coordinates keep their initialization —
    the same constrained optimum as the reference's Gradient() overrides).
    """
    x0 = jnp.asarray(x0)
    mask = None if free is None else jnp.asarray(free, dtype=x0.dtype)

    def neg(x):
        return -logp(x)

    opt = optax.lbfgs(memory_size=memory_size)

    def run(x0):
        opt_state = opt.init(x0)

        def cond(carry):
            _, _, step, gmax, _, stalled = carry
            return (step < iters) & (gmax >= threshold) & ~stalled

        def body(carry):
            x, opt_state, step, _, _, _ = carry
            value, grad = optax.value_and_grad_from_state(neg)(x, state=opt_state)
            if mask is not None:
                grad = grad * mask
            updates, new_state = opt.update(
                grad, opt_state, x, value=value, grad=grad, value_fn=neg
            )
            new_x = optax.apply_updates(x, updates)
            if grad.size:
                gmax = jnp.max(jnp.abs(grad))
                # an exactly-zero step with the gradient still above
                # threshold = the linesearch failed to move: a stall
                stalled = jnp.max(jnp.abs(updates)) <= jnp.asarray(0.0, x.dtype)
            else:
                gmax = jnp.asarray(0.0, x.dtype)
                stalled = jnp.asarray(False)
            return new_x, new_state, step + 1, gmax, value, stalled

        init = (
            x0,
            opt_state,
            jnp.asarray(0),
            jnp.asarray(jnp.inf, x0.dtype),
            jnp.asarray(0.0, x0.dtype),
            jnp.asarray(False),
        )
        x, _, step, gmax, value, stalled = jax.lax.while_loop(cond, body, init)
        converged = gmax < threshold
        return OptResult(x, -value, step, converged, stalled & ~converged)

    return run(x0)
