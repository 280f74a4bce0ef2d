"""Sequential Monte Carlo sampler: adaptive tempering + HMC mutation.

North-star inference engine (BASELINE.json: "SMC over hyperparameters on
multi-host pod" for the large-N config).  Fresh accelerator-first design — the
reference has no sampler at all.

Algorithm (Del Moral et al. 2006 SMC sampler, likelihood-tempering path):

- particles start from a Gaussian reference q0 = N(mu0, sigma0^2 I);
- the bridge is logp_beta(v) = (1-beta) log q0(v) + beta logp(v), beta: 0->1;
- each stage picks the next beta *adaptively* by bisection so the effective
  sample size of the incremental weights stays near ``ess_target`` — the
  bisection is a fixed-iteration ``fori_loop``, so the whole sampler is one
  compiled ``while_loop`` over stages (bounded by ``max_stages``);
- systematic resampling, then ``num_mcmc_steps`` HMC transitions targeting
  logp_beta with a step size set from the particle population spread.

The particle axis is the sharding axis for multi-chip runs: reweighting and
ESS are psum-reductions and resampling is an all-gather, wired up in
gogp.parallel.smc_sharded.  Log evidence (sum of stage logsumexp
increments) comes out for free.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer.hmc import IntegratorState, kinetic

Array = jax.Array
LogDensity = Callable[[Array], Array]

_LOG_2PI = 1.8378770664093453


class SMCResult(NamedTuple):
    particles: Array  # (num_particles, dim) final (beta = 1) particles
    log_evidence: Array  # () estimate of log integral of exp(logp - log q0)... see docstring
    num_stages: Array  # () tempering stages actually used
    betas_hit_one: Array  # () bool: annealing completed within max_stages
    accept_rate: Array  # () mean HMC accept rate of the final stage


def _systematic_resample(key: Array, log_weights: Array) -> Array:
    """Indices of resampled particles (systematic / stratified-uniform)."""
    p = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    cum = jnp.cumsum(w)
    u = jax.random.uniform(key, (), dtype=w.dtype)
    pts = (jnp.arange(p, dtype=w.dtype) + u) / p
    return jnp.clip(jnp.searchsorted(cum, pts), 0, p - 1)


def _ess(log_weights: Array) -> Array:
    lw = log_weights - jax.scipy.special.logsumexp(log_weights)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * lw))


def _rwm_mutate(logp_beta, positions, keys, step_scale, free):
    """One vmapped random-walk Metropolis transition (gradient-free — used
    when the target's gradient is unavailable or too expensive, e.g. the
    large-N sharded LML whose blocked factorization loop is not
    reverse-differentiable)."""

    def one(q, k):
        k_prop, k_acc = jax.random.split(k)
        step = step_scale * jax.random.normal(k_prop, q.shape, q.dtype)
        if free is not None:
            step = step * free
        q_new = q + step
        delta = logp_beta(q_new) - logp_beta(q)
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        accept_prob = jnp.minimum(1.0, jnp.exp(delta))
        accept = jax.random.uniform(k_acc, dtype=q.dtype) < accept_prob
        return jnp.where(accept, q_new, q), accept_prob

    return jax.vmap(one)(positions, keys)


def _hmc_mutate(
    vg_beta, positions, keys, step_size, inv_mass, n_leapfrog: int, free
):
    """One vmapped HMC transition targeting the tempered density.

    ``keys``: one PRNG key per particle — derived from *global* particle
    indices by the caller so sharded and serial runs use identical streams.
    """

    def one(q, k):
        k_mom, k_acc = jax.random.split(k)
        logp_q, grad_q = vg_beta(q)
        r0 = jax.random.normal(k_mom, q.shape, q.dtype) / jnp.sqrt(inv_mass)
        if free is not None:
            r0 = r0 * free
            grad_q = grad_q * free
        e0 = -logp_q + kinetic(r0, inv_mass)

        def leap(s, _):
            r = s.momentum + 0.5 * step_size * s.grad
            qn = s.position + step_size * inv_mass * r
            if free is not None:
                qn = jnp.where(free > 0, qn, s.position)
            lp, g = vg_beta(qn)
            if free is not None:
                g = g * free
            return IntegratorState(qn, r, lp, g), None

        s, _ = jax.lax.scan(
            leap, IntegratorState(q, r0, logp_q, grad_q), None, length=n_leapfrog
        )
        e1 = -s.logp + kinetic(s.momentum, inv_mass)
        delta = jnp.where(jnp.isnan(e1 - e0), jnp.inf, e1 - e0)
        accept_prob = jnp.minimum(1.0, jnp.exp(-delta))
        accept = jax.random.uniform(k_acc, dtype=q.dtype) < accept_prob
        return jnp.where(accept, s.position, q), accept_prob

    return jax.vmap(one)(positions, keys)


def run_smc(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    num_particles: int = 512,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    n_leapfrog: int = 10,
    ess_target: float = 0.5,
    max_stages: int = 100,
    bisection_iters: int = 20,
    free: Array | None = None,
    mutation: str = "hmc",
) -> SMCResult:
    """Anneal from N(position0, sigma0^2 I) to ``logp``; returns particles.

    ``log_evidence`` estimates log Z where logp = log(Z * pi(v)) relative to
    the Gaussian reference — i.e. log E_{q0}[exp(logp - log q0)].

    ``mutation``: "hmc" (default) or "rwm" — random-walk Metropolis for
    targets whose gradient is unavailable (e.g. the fori_loop-based
    distributed LML).
    """
    if mutation not in ("hmc", "rwm"):
        raise ValueError(f"unknown mutation {mutation!r}")
    position0 = jnp.asarray(position0)
    dim = position0.shape[0]
    dtype = position0.dtype
    if free is not None:
        free = jnp.asarray(free, dtype=dtype)

    key_init, key_loop = jax.random.split(jnp.asarray(rng))
    eps = jax.random.normal(key_init, (num_particles, dim), dtype)
    if free is not None:
        eps = eps * free[None, :]
    particles = position0[None, :] + sigma0 * eps

    def log_q0(v):
        z = (v - position0) / sigma0
        if free is not None:
            z = z * free
            n_free = jnp.sum(free)
        else:
            n_free = dim
        return -0.5 * jnp.sum(z * z) - n_free * (0.5 * _LOG_2PI + jnp.log(sigma0))

    # incremental weight for moving beta -> beta': (beta'-beta)*(logp - log q0)
    def log_ratio(v):
        return logp(v) - log_q0(v)

    def vg_beta_fn(beta):
        def f(v):
            return (1.0 - beta) * log_q0(v) + beta * logp(v)

        return jax.value_and_grad(f)

    def next_beta(beta, log_ratios):
        """Largest beta' in (beta, 1] keeping ESS >= ess_target * P."""

        def ess_at(b):
            return _ess((b - beta) * log_ratios)

        target = ess_target * num_particles
        lo, hi = beta, jnp.asarray(1.0, dtype)

        def bis(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        ok_full = ess_at(hi) >= target
        lo, hi = jax.lax.fori_loop(0, bisection_iters, bis, (lo, hi))
        return jnp.where(ok_full, 1.0, lo)

    def cond(carry):
        _, _, beta, stage, _, _, _ = carry
        return (beta < 1.0) & (stage < max_stages)

    def body(carry):
        particles, key, beta, stage, log_z, _, _ = carry
        key, k_res, k_mut = jax.random.split(key, 3)

        log_ratios = jax.vmap(log_ratio)(particles)
        log_ratios = jnp.where(jnp.isnan(log_ratios), -jnp.inf, log_ratios)
        beta_new = next_beta(beta, log_ratios)
        lw = (beta_new - beta) * log_ratios
        log_z = log_z + jax.scipy.special.logsumexp(lw) - jnp.log(float(num_particles))

        idx = _systematic_resample(k_res, lw)
        particles = particles[idx]

        # mutation step size from the resampled population spread
        std = jnp.std(particles, axis=0)
        if free is not None:
            std = jnp.where(free > 0, std, 1.0)
        inv_mass = jnp.maximum(std * std, 1e-10)
        step_size = 0.5 / jnp.sqrt(jnp.asarray(dim, dtype))

        if mutation == "hmc":
            vg = vg_beta_fn(beta_new)

            def mutate(i, pa):
                parts, acc = pa
                keys = jax.random.split(jax.random.fold_in(k_mut, i), num_particles)
                parts, accept_probs = _hmc_mutate(
                    vg, parts, keys, step_size, inv_mass, n_leapfrog, free
                )
                return parts, jnp.mean(accept_probs)

        else:  # rwm

            def logp_b(v):
                return (1.0 - beta_new) * log_q0(v) + beta_new * logp(v)

            # Roberts/Rosenthal optimal RWM scaling from the population std
            rwm_scale = (2.38 / jnp.sqrt(jnp.asarray(dim, dtype))) * std

            def mutate(i, pa):
                parts, acc = pa
                keys = jax.random.split(jax.random.fold_in(k_mut, i), num_particles)
                parts, accept_probs = _rwm_mutate(logp_b, parts, keys, rwm_scale, free)
                return parts, jnp.mean(accept_probs)

        particles, accept_rate = jax.lax.fori_loop(
            0, num_mcmc_steps, mutate, (particles, jnp.asarray(0.0, dtype))
        )
        return particles, key, beta_new, stage + 1, log_z, accept_rate, beta

    init = (
        particles,
        key_loop,
        jnp.asarray(0.0, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
    )
    particles, _, beta, stage, log_z, accept_rate, _ = jax.lax.while_loop(
        cond, body, init
    )
    return SMCResult(particles, log_z, stage, beta >= 1.0, accept_rate)
