"""Warmup adaptation for HMC/NUTS: dual-averaging step size + diagonal mass.

The reference delegates all inference to Infergo/gonum and has no sampler
adaptation of its own; this module is part of the north-star inference layer
(BASELINE.json) built fresh.  Design follows the standard Stan windowed
scheme: dual averaging (Nesterov 2009 as used in Hoffman & Gelman 2014) for
the step size, Welford accumulators for a diagonal mass matrix, with the
warmup split into an initial fast interval, doubling slow windows, and a
final fast interval.

Everything is a pure pytree-state + update function, so it jits, vmaps over
chains, and — for cross-device chains — the Welford accumulators can be
combined with ``psum`` (counts and moment sums are additive), which is how
gogp.parallel shares one mass matrix across a sharded chain population.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class DualAveragingState(NamedTuple):
    log_step: Array  # current log step size
    log_step_avg: Array  # averaged iterate (used after warmup)
    gradient_avg: Array  # running average of (target - accept_prob)
    t: Array  # iteration counter
    mu: Array  # shrinkage point = log(10 * init_step)


def da_init(step_size: float | Array) -> DualAveragingState:
    """Dual-averaging state at ``step_size``, in the dtype of an array
    ``step_size`` (a Python float takes JAX's default float dtype)."""
    step_size = jnp.asarray(step_size)
    if not jnp.issubdtype(step_size.dtype, jnp.floating) or step_size.weak_type:
        step_size = step_size.astype(jnp.result_type(float))
    log_step = jnp.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=jnp.zeros_like(log_step),
        gradient_avg=jnp.zeros_like(log_step),
        t=jnp.asarray(0, dtype=jnp.int32),
        mu=jnp.log(10.0) + log_step,
    )


def da_update(
    state: DualAveragingState,
    accept_prob: Array,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    t = state.t + 1
    tf = t.astype(state.log_step.dtype)
    w = 1.0 / (tf + t0)
    gradient_avg = (1.0 - w) * state.gradient_avg + w * (target - accept_prob)
    log_step = state.mu - jnp.sqrt(tf) / gamma * gradient_avg
    eta = tf ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, gradient_avg, t, state.mu)


class WelfordState(NamedTuple):
    count: Array  # ()
    mean: Array  # (dim,)
    m2: Array  # (dim,) sum of squared deviations


def welford_init(dim: int, dtype=jnp.float32) -> WelfordState:
    return WelfordState(
        count=jnp.zeros((), dtype=dtype),
        mean=jnp.zeros((dim,), dtype=dtype),
        m2=jnp.zeros((dim,), dtype=dtype),
    )


def welford_update(state: WelfordState, x: Array) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Merge two accumulators (Chan et al.) — additive, so psum-able across
    a sharded chain population."""
    count = a.count + b.count
    safe = jnp.maximum(count, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * b.count / safe
    m2 = a.m2 + b.m2 + delta * delta * a.count * b.count / safe
    return WelfordState(count, mean, m2)


def welford_variance(state: WelfordState, regularize: bool = True) -> Array:
    """Sample variance with Stan's shrinkage toward unit scale."""
    var = state.m2 / jnp.maximum(state.count - 1.0, 1.0)
    if regularize:
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


class WarmupSchedule(NamedTuple):
    """Per-step flags for the Stan three-phase windowed warmup."""

    update_mass: Array  # (num_warmup,) bool: feed sample into Welford
    window_end: Array  # (num_warmup,) bool: refresh mass + reset Welford/DA


def build_schedule(
    num_warmup: int, init_buffer: int = 75, term_buffer: int = 50, base_window: int = 25
) -> WarmupSchedule:
    """Static (host-side) schedule, indexed by step inside the warmup scan."""
    import numpy as np

    update_mass = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return WarmupSchedule(jnp.asarray(update_mass), jnp.asarray(window_end))
    if init_buffer + base_window + term_buffer > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    start = init_buffer
    end_slow = num_warmup - term_buffer
    size = base_window
    while start < end_slow:
        stop = min(start + size, end_slow)
        # last window absorbs the remainder
        if stop + size > end_slow:
            stop = end_slow
        update_mass[start:stop] = True
        window_end[stop - 1] = True
        start = stop
        size *= 2
    return WarmupSchedule(jnp.asarray(update_mass), jnp.asarray(window_end))
