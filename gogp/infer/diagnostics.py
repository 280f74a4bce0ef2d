"""MCMC diagnostics: effective sample size and split-R-hat.

Needed for the driver's north-star metric "ESS/s per chip on hyperpriors
NUTS" (BASELINE.json).  Implementations follow the standard Stan/Vehtari
et al. (2021) definitions: split chains, rank-free version, ESS from
Geyer's initial monotone positive sequence of autocorrelations.

``ess`` splits each chain in half by default (Vehtari et al. split chains
precisely to catch the within-chain nonstationarity — a drifting or stuck
chain — that inflates short-run ESS estimates).

Pure jnp — usable inside jit (FFT autocorrelation) or on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def _autocovariance(x: Array) -> Array:
    """Biased autocovariance per chain via FFT. x: (chains, draws)."""
    n = x.shape[-1]
    xc = x - jnp.mean(x, axis=-1, keepdims=True)
    size = 2 * n  # zero-pad to avoid circular wrap
    f = jnp.fft.rfft(xc, n=size, axis=-1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=size, axis=-1)[..., :n]
    return acov / n


def _split(x: Array) -> Array:
    """(m, n) -> (2m, n//2): first/second chain halves as separate chains."""
    m, n = x.shape
    half = n // 2
    return jnp.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def ess(samples: Array, split: bool = True) -> Array:
    """Effective sample size of (chains, draws) or (draws,) scalar samples.

    Multi-parameter arrays (chains, draws, dim) return per-dim ESS.
    ``split=True`` (default, Vehtari et al. 2021) halves each chain first
    so within-chain drift registers as between-chain variance and deflates
    the estimate; ``split=False`` is the plain cross-chain form.
    """
    x = jnp.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim == 3:
        return jax.vmap(lambda c: ess(c, split), in_axes=2)(x)
    if split:
        x = _split(x)
    m, n = x.shape

    acov = _autocovariance(x)  # (m, n)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = jnp.mean(chain_var)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + jnp.var(jnp.mean(x, axis=1), ddof=1)

    rho = 1.0 - (mean_var - jnp.mean(acov, axis=0)) / var_plus  # (n,)

    # Geyer: sum consecutive pairs, keep while positive, enforce monotone.
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    # make monotone nonincreasing
    pair_mono = jax.lax.associative_scan(jnp.minimum, pair)
    # keep only the initial positive sequence
    positive = jnp.cumprod(pair_mono > 0.0) > 0
    tau = -1.0 + 2.0 * jnp.sum(jnp.where(positive, pair_mono, 0.0))
    tau = jnp.maximum(tau, 1.0 / jnp.log10(float(n)) if n > 10 else 1e-8)
    return m * n / tau


def split_rhat(samples: Array) -> Array:
    """Split-R-hat of (chains, draws) samples (rank-free version)."""
    x = jnp.asarray(samples)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim == 3:
        return jax.vmap(lambda c: split_rhat(c), in_axes=2)(x)
    x = _split(x)
    chain_means = jnp.mean(x, axis=1)
    chain_vars = jnp.var(x, axis=1, ddof=1)
    half = x.shape[1]
    w = jnp.mean(chain_vars)
    b = jnp.var(chain_means, ddof=1) * half
    var_plus = (half - 1.0) / half * w + b / half
    return jnp.sqrt(var_plus / w)


def rank_normalize(samples: Array) -> Array:
    """Rank-normalize (chains, draws[, dim]) draws per parameter
    (Vehtari et al. 2021 §4.1): pooled fractional ranks mapped through the
    normal quantile function, z = Phi^-1((r - 3/8) / (S + 1/4)).

    Rank normalization is what makes split-R-hat/ESS well-behaved on
    heavy-tailed marginals (e.g. a GP noise theta's low-noise funnel
    tail): on the raw scale, rare tail excursions dominate the
    within/between variance ratio and the diagnostics measure tail
    heaviness instead of mixing.  Stan's reported ESS/R-hat are the
    rank-normalized ("bulk") forms.
    """
    x = jnp.asarray(samples)
    if x.ndim == 3:
        return jax.vmap(rank_normalize, in_axes=2, out_axes=2)(x)
    m, n = x.shape
    flat = x.reshape(-1)
    s = flat.shape[0]
    ranks = jnp.empty_like(flat).at[jnp.argsort(flat)].set(
        jnp.arange(1, s + 1, dtype=x.dtype)
    )
    from jax.scipy.special import ndtri

    z = ndtri((ranks - 0.375) / (s + 0.25))
    return z.reshape(m, n)


def bulk_ess(samples: Array) -> Array:
    """Rank-normalized split-chain ESS (Stan's "bulk ESS")."""
    return ess(rank_normalize(samples))


def bulk_rhat(samples: Array) -> Array:
    """Rank-normalized split-R-hat (Stan's reported R-hat)."""
    return split_rhat(rank_normalize(samples))


def gated_min_ess(positions, rhat_threshold: float = 1.01):
    """Convergence-gated summary of (chains, draws, dim) posterior draws.

    Returns (min_bulk_ess, max_bulk_rhat, ok): the minimum rank-normalized
    split-chain ESS across parameters, the maximum rank-normalized
    split-R-hat, and whether every parameter clears ``rhat_threshold``
    (the Vehtari et al. 2021 criterion, as in Stan).  Benchmarks must not
    report an ESS/s from a non-converged run — a mixing-collapsed sampler
    still produces a number otherwise.  Raw-scale
    variants are available via :func:`diagnose` for side-by-side
    reporting.
    """
    e = bulk_ess(positions)
    r = bulk_rhat(positions)
    max_rhat = float(jnp.max(r))
    return float(jnp.min(e)), max_rhat, bool(max_rhat <= rhat_threshold)


@jax.jit
def _diagnose_jit(x):
    z = rank_normalize(x)
    return (jnp.min(ess(x)), jnp.max(split_rhat(x)),
            jnp.min(ess(z)), jnp.max(split_rhat(z)))


def diagnose(positions) -> dict:
    """Raw + rank-normalized split diagnostics of (chains, draws, dim).

    One jitted program: eager jnp here would pay one dispatch per
    FFT/argsort op.
    """
    er, rr, eb, rb = _diagnose_jit(jnp.asarray(positions))
    return {
        "min_ess_raw": float(er),
        "max_rhat_raw": float(rr),
        "min_ess_bulk": float(eb),
        "max_rhat_bulk": float(rb),
    }
