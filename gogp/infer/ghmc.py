"""Generalized (persistent-momentum) HMC with cross-fold ensemble adaptation.

In the spirit of MEADS (Hoffman & Sountsov, AISTATS 2022, "Tuning-free
generalized Hamiltonian Monte Carlo"): instead of long adapted trajectories
(ChEES) or per-chain U-turn recursion (NUTS), every transition is ONE
leapfrog step with a partially-refreshed persistent momentum,

    u' = damping * u + sqrt(1 - damping^2) * xi,   xi ~ N(0, I),

followed by a Metropolis test that NEGATES the momentum on rejection (the
flip is what makes persistent momentum a valid MCMC kernel).  Persistent
momentum strings accepted steps into supra-diffusive trajectories of
expected length ~ step / (1 - damping) without ever choosing a trajectory
length — the knob whose noisy adaptation dominates ChEES's seed-to-seed
ESS/s variance on multimodal GP posteriors.

Why this is accelerator-shaped: the whole chain population advances in ONE batched
gradient evaluation per transition — pure lockstep vmapped leapfrog, no
data-dependent loop bounds at all (ChEES integrates to the jittered
trajectory bound; NUTS to the deepest tree).  All adaptation statistics
are cross-chain means/stds, so the sharded form is a pmean like
parallel.sample's other kernels.

Cross-fold adaptation (the MEADS idea that makes ensemble tuning valid):
chains split into two folds; the preconditioner each fold USES is computed
from the OTHER fold's positions, so no chain's kernel depends on its own
state and detailed balance per fold is preserved.  Deviations from the
paper, by design (consistency with this codebase's other samplers):

- step size: dual averaging on the population-mean accept toward a high
  target (0.9 — persistent momentum wants few rejections, each flip costs
  a trajectory), frozen at the averaged iterate, instead of the paper's
  largest-eigenvalue heuristic;
- damping: exp(-step / sigma_max_ratio) with the ratio from the running
  preconditioner — after per-dimension standardization the slowest
  oscillation has period ~2*pi, so a damping time of ~1 preserves
  coherence across it; frozen with the step size;
- preconditioner: per-dimension complementary-fold std (diagonal), updated
  every transition during warmup from the live fold states, frozen at
  finalize.

Reference context: the reference delegates inference entirely
(tutorial/tutorial.go:128-169); this sampler joins NUTS/HMC/ChEES/PT/
ADVI/SMC/ESS in the north-star inference layer (BASELINE.json).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer import adapt
from gogp.infer.hmc import Samples

Array = jax.Array
LogDensity = Callable[[Array], Array]

TARGET_ACCEPT = 0.9


class GHMCState(NamedTuple):
    """Whole-population state; chains split into two folds by index parity.

    ``sigma`` is the per-FOLD diagonal preconditioner: sigma[f] is the
    scale each chain of fold f uses, computed from fold 1-f's positions.
    """

    positions: Array  # (chains, dim)
    momenta: Array  # (chains, dim) standardized persistent momentum u
    logps: Array  # (chains,)
    grads: Array  # (chains, dim)
    step_size: Array  # () shared
    sigma: Array  # (2, dim) per-fold preconditioner (other fold's std)
    accept_probs: Array  # (chains,)
    da: adapt.DualAveragingState
    step: Array  # () int32
    rng: Array


def _fold_ids(chains: int) -> Array:
    return jnp.arange(chains) % 2


def _pmean(x: Array, axis_name):
    if axis_name is None:
        return x
    return jax.lax.pmean(x, axis_name)


def _fold_stats(positions: Array, axis_name, free: Array | None = None) -> Array:
    """(2, dim) per-fold std of the OTHER fold's positions.

    Chains interleave folds by index parity; with sharding, every device
    holds an equal slab of both folds (chain counts are even per device by
    construction), so cross-device pmean of per-fold moments is exact.

    Pinned coordinates (``free`` mask 0) never move, so their cross-fold
    std floors at ~1e-6 and would blow the damping ratio up to ~1e6,
    collapsing the momentum refresh to near-deterministic flow (wrong
    posteriors).  They get a neutral sigma of 1 instead (their
    motion is masked out separately in the transition).
    """
    chains, dim = positions.shape
    ids = _fold_ids(chains)

    def other_std(f):
        m = (ids != f).astype(positions.dtype)[:, None]
        cnt = _pmean(jnp.sum(m), axis_name)
        mean = _pmean(jnp.sum(positions * m, axis=0), axis_name) / cnt
        var = _pmean(
            jnp.sum(m * (positions - mean) ** 2, axis=0), axis_name
        ) / cnt
        std = jnp.sqrt(jnp.maximum(var, 1e-12))
        if free is not None:
            std = jnp.where(free > 0, std, 1.0)
        return std

    return jnp.stack([other_std(0), other_std(1)])


def ghmc_init(
    logp: LogDensity,
    positions: Array,
    rng: Array,
    step_size: float = 0.1,
    chain_offset: Array | int = 0,
) -> GHMCState:
    positions = jnp.atleast_2d(jnp.asarray(positions))
    chains, dim = positions.shape
    # even so the parity folds balance; a sharded slab may hold as few as
    # 2 chains (fold stats pmean globally) — run_ghmc enforces >= 4 for
    # the single-device case where the local fold IS the whole fold
    if chains < 2 or chains % 2 != 0:
        raise ValueError(
            f"ghmc needs an even population (got {chains}): cross-fold "
            "adaptation splits chains by index parity"
        )
    vals, grads = jax.vmap(jax.value_and_grad(logp))(positions)
    dt = positions.dtype
    key, km = jax.random.split(jnp.asarray(rng))
    # per-chain persistent-momentum init keyed by GLOBAL chain index —
    # device-count invariance (a shape-keyed batch draw would give each
    # sharded slab different momenta than the single-device run)
    idx = jnp.asarray(chain_offset) + jnp.arange(chains)
    u0 = jax.vmap(
        lambda i: jax.random.normal(jax.random.fold_in(km, i), (dim,), dt)
    )(idx)
    return GHMCState(
        positions=positions,
        momenta=u0,
        logps=vals,
        grads=grads,
        step_size=jnp.asarray(step_size, dt),
        sigma=jnp.ones((2, dim), dt),
        accept_probs=jnp.zeros((chains,), dt),
        da=adapt.da_init(jnp.asarray(step_size, dt)),
        step=jnp.asarray(0, jnp.int32),
        rng=key,
    )


def _damping(state: GHMCState, free: Array | None = None) -> Array:
    """exp(-step / max scale ratio): after standardization the stiffest
    direction has scale ~1; the ratio of largest to smallest fold scales
    bounds the number of steps the slowest direction needs, and damping
    over that horizon keeps momentum coherent across it.

    Pinned coordinates are excluded from the ratio: a degenerate (never-
    moving) dimension's floored std would otherwise drive damping -> 1 and
    degenerate the sampler."""
    sig = state.sigma
    if free is not None:
        keep = jnp.broadcast_to(free[None, :] > 0, sig.shape)
        hi = jnp.max(jnp.where(keep, sig, -jnp.inf))
        lo = jnp.min(jnp.where(keep, sig, jnp.inf))
    else:
        hi = jnp.max(sig)
        lo = jnp.min(sig)
    ratio = hi / jnp.maximum(lo, 1e-12)
    ratio = jnp.where(jnp.isfinite(ratio), ratio, 1.0)
    return jnp.exp(-state.step_size / jnp.maximum(ratio, 1.0))


def ghmc_transition(
    logp: LogDensity,
    state: GHMCState,
    adapt_sigma: bool | Array = False,
    free: Array | None = None,
    divergence_threshold: float = 1000.0,
    axis_name=None,
    chain_offset: Array | int = 0,
) -> GHMCState:
    """One population transition: partial momentum refresh, ONE leapfrog
    step in preconditioned coordinates, per-chain Metropolis with momentum
    flip on rejection.

    ``chain_offset``: global index of this shard's first chain (device-
    count-invariant randomness, the parallel.sample idiom)."""
    vg = jax.value_and_grad(logp)
    if free is not None:
        freea = jnp.asarray(free, state.positions.dtype)

        def vg_masked(q):
            v, g = jax.value_and_grad(logp)(q)
            return v, g * freea

        vg = vg_masked
    else:
        freea = None

    chains, dim = state.positions.shape
    dt = state.positions.dtype
    key, key_iter = jax.random.split(state.rng)
    idx = jnp.asarray(chain_offset) + jnp.arange(chains)
    ids = _fold_ids(chains)
    sig = state.sigma[ids]  # (chains, dim) each chain's fold preconditioner
    if freea is not None:
        sig = jnp.where(freea[None, :] > 0, sig, 0.0)

    def chain_draws(i):
        km, ka = jax.random.split(jax.random.fold_in(key_iter, i))
        return jax.random.normal(km, (dim,), dt), jax.random.uniform(ka, (), dt)

    xi, u_acc = jax.vmap(chain_draws)(idx)

    gamma = _damping(state, freea)
    u = gamma * state.momenta + jnp.sqrt(1.0 - gamma * gamma) * xi
    if freea is not None:
        u = u * freea[None, :]

    # one leapfrog step: q' = q + eps * sig * (u + eps/2 * sig * g)
    eps = state.step_size
    kin0 = 0.5 * jnp.sum(u * u, axis=1)
    energy0 = -state.logps + kin0
    u_half = u + 0.5 * eps * sig * state.grads
    q_new = state.positions + eps * sig * u_half
    if freea is not None:
        q_new = jnp.where(freea[None, :] > 0, q_new, state.positions)
    lp_new, g_new = jax.vmap(vg)(q_new)
    u_new = u_half + 0.5 * eps * sig * g_new

    kin1 = 0.5 * jnp.sum(u_new * u_new, axis=1)
    energy1 = -lp_new + kin1
    delta = energy1 - energy0
    delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
    accept_probs = jnp.where(
        delta > divergence_threshold, 0.0, jnp.minimum(1.0, jnp.exp(-delta))
    )
    accept = u_acc < accept_probs
    acc = accept[:, None]
    positions = jnp.where(acc, q_new, state.positions)
    logps = jnp.where(accept, lp_new, state.logps)
    grads = jnp.where(acc, g_new, state.grads)
    # momentum flip on rejection — the GHMC correctness requirement
    momenta = jnp.where(acc, u_new, -u)

    sigma = jax.lax.cond(
        jnp.asarray(adapt_sigma),
        lambda _: _fold_stats(positions, axis_name, freea),
        lambda s: s,
        state.sigma,
    )
    return state._replace(
        positions=positions,
        momenta=momenta,
        logps=logps,
        grads=grads,
        accept_probs=accept_probs,
        sigma=sigma,
        step=state.step + 1,
        rng=key,
    )


def ghmc_warmup_step(state: GHMCState, axis_name=None) -> GHMCState:
    mean_accept = _pmean(jnp.mean(state.accept_probs), axis_name)
    da = adapt.da_update(state.da, mean_accept, target=TARGET_ACCEPT)
    return state._replace(step_size=jnp.exp(da.log_step), da=da)


def ghmc_warm_chunk(
    logp: LogDensity,
    state: GHMCState,
    num: int,
    free: Array | None = None,
    axis_name=None,
    chain_offset: Array | int = 0,
) -> GHMCState:
    """``num`` warmup transitions in one scan (chunk-callable)."""

    def step(s, _):
        s = ghmc_transition(
            logp, s, adapt_sigma=True, free=free, axis_name=axis_name,
            chain_offset=chain_offset,
        )
        s = ghmc_warmup_step(s, axis_name)
        return s, None

    state, _ = jax.lax.scan(step, state, None, length=num)
    return state


def finalize_ghmc_warmup(state: GHMCState) -> GHMCState:
    """Freeze the kernel: step size at the dual-averaging average iterate
    (sigma and the derived damping freeze by no longer being updated)."""
    return state._replace(step_size=jnp.exp(state.da.log_step_avg))


def ghmc_sample_chunk(
    logp: LogDensity,
    state: GHMCState,
    num: int,
    free: Array | None = None,
    axis_name=None,
    chain_offset: Array | int = 0,
) -> tuple[GHMCState, tuple[Array, Array, Array]]:
    """``num`` frozen-kernel transitions; returns (state, (positions,
    logps, accept_probs)) with positions (num, chains, dim)."""

    def step(s, _):
        s = ghmc_transition(
            logp, s, adapt_sigma=False, free=free, axis_name=axis_name,
            chain_offset=chain_offset,
        )
        return s, (s.positions, s.logps, s.accept_probs)

    return jax.lax.scan(step, state, None, length=num)


def run_ghmc(
    logp: LogDensity,
    positions0: Array,
    rng: Array,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    free: Array | None = None,
) -> Samples:
    """One-call driver (thinning-free; every transition is one gradient).

    Returns infer.hmc.Samples: positions (num_samples, chains, dim)."""
    positions0 = jnp.atleast_2d(jnp.asarray(positions0))
    if positions0.shape[0] < 4:
        raise ValueError(
            f"ghmc needs an even population of >= 4 chains (got "
            f"{positions0.shape[0]}): each fold's preconditioner is the "
            "other fold's std"
        )
    state = ghmc_init(logp, positions0, rng, init_step_size)
    if num_warmup > 0:
        state = ghmc_warm_chunk(logp, state, num_warmup, free)
        state = finalize_ghmc_warmup(state)
    state, (pos, lps, acc) = ghmc_sample_chunk(logp, state, num_samples, free)
    return Samples(pos, lps, acc, state)


__all__ = [
    "GHMCState",
    "finalize_ghmc_warmup",
    "ghmc_init",
    "ghmc_sample_chunk",
    "ghmc_transition",
    "ghmc_warm_chunk",
    "ghmc_warmup_step",
    "run_ghmc",
]
