"""gogp — a Gaussian-process probabilistic-programming engine in JAX.

A from-scratch JAX/XLA framework with the full model surface of the
infergo-ml/gogp reference (composable differentiable kernels, GP marginal
log-likelihood, GP-as-elemental-model composition with hyperparameter priors,
latent inputs and non-Gaussian noise), plus the inference engines the
reference delegates to external libraries: MLE (Adam/LBFGS), HMC/NUTS, ADVI
and SMC, all jit/vmap/shard_map-native.

Layer map (mirrors reference layers, SURVEY.md §1, but functional):

- ``gogp.kernels``   — pure-function kernels (reference: kernel/*.go and
  the generated kernel/ad/*; here ``jax.grad`` replaces the codegen AD).
- ``gogp.gp``        — GP core: covariance assembly, LML, prediction
  (reference: gp/gp.go).
- ``gogp.models``    — log-density composition + parameter packing/masks
  (reference: gp/model.go + per-tutorial Gradient overrides).
- ``gogp.infer``     — optimizers and samplers (reference delegates to
  gonum optimize / infergo infer).
- ``gogp.ops``       — dense linear algebra: XLA Cholesky / triangular
  solves with the analytic LML pullback (reference delegates to gonum
  mat.Cholesky).
- ``gogp.parallel``  — mesh / sharding / collectives (no counterpart in
  the single-process reference).
- ``gogp.tutorial``  — the five case studies + the rolling-forecast Evaluate loop
  (reference: tutorial/).
- ``gogp.bo``        — Bayesian optimization on the serving/streaming
  stack (no counterpart; the canonical production consumer of a GP).
- ``gogp.search``    — greedy compositional kernel-structure discovery
  scored by BIC/AIC/exact-LOO (the reference picks kernels by hand).
"""

__version__ = "0.1.0"

from gogp.gp.core import GP  # noqa: F401
from gogp.kernels import (  # noqa: F401
    constant_noise,
    matern32,
    matern52,
    matern52_ref,
    normal,
    periodic,
    uniform_noise,
)
