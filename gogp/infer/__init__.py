"""Inference engines: MLE (Adam/LBFGS), HMC, NUTS, ADVI, SMC + diagnostics.

The reference's inference layer is external (Infergo optimizers/samplers,
gonum LBFGS — tutorial/tutorial.go:128-169); here it is a first-class
subsystem per BASELINE.json's north star.
"""

from gogp.infer import adapt, diagnostics, mle
from gogp.infer.advi import (
    ADVIResult,
    FullRankADVIResult,
    elbo,
    elbo_fullrank,
    run_advi,
    run_advi_fullrank,
    sample_posterior,
    sample_posterior_fullrank,
)
from gogp.infer.chees import (
    ChEESState,
    chees_init,
    chees_sample_chunk,
    chees_transition,
    chees_warm_chunk,
    finalize_chees_warmup,
    run_chees,
    run_chees_pops,
)
from gogp.infer.diagnostics import ess, split_rhat
from gogp.infer.ghmc import (
    GHMCState,
    ghmc_init,
    ghmc_sample_chunk,
    ghmc_warm_chunk,
    run_ghmc,
)
from gogp.infer.elliptical import (
    ESSResult,
    ess_predict,
    ess_predict_prob,
    ess_update,
    run_ess,
    run_ess_gp,
)
from gogp.infer.pt_chees import (
    PTChEESResult,
    pt_chees_init,
    pt_chees_sample_chunk,
    pt_chees_warm_chunk,
    run_pt_chees,
)
from gogp.infer.hmc import (
    HMCState,
    IntegratorState,
    Samples,
    hmc_transition,
    init_state,
    leapfrog,
    run_hmc,
)
from gogp.infer.mle import OptResult, adam, lbfgs
from gogp.infer.nuts import nuts_transition, run_nuts
from gogp.infer.smc import SMCResult, run_smc
from gogp.infer.tempering import (
    PTFlow,
    PTResult,
    geometric_ladder,
    place_rungs,
    run_pt_nuts,
    tune_ladder,
)

__all__ = [
    "ADVIResult",
    "ChEESState",
    "chees_init",
    "chees_sample_chunk",
    "chees_transition",
    "chees_warm_chunk",
    "finalize_chees_warmup",
    "run_chees",
    "run_chees_pops",
    "HMCState",
    "IntegratorState",
    "OptResult",
    "Samples",
    "SMCResult",
    "adam",
    "adapt",
    "diagnostics",
    "ESSResult",
    "elbo",
    "ess",
    "ess_predict",
    "ess_predict_prob",
    "ess_update",
    "run_ess",
    "run_ess_gp",
    "hmc_transition",
    "init_state",
    "lbfgs",
    "leapfrog",
    "mle",
    "PTChEESResult",
    "PTFlow",
    "PTResult",
    "geometric_ladder",
    "nuts_transition",
    "place_rungs",
    "pt_chees_init",
    "pt_chees_sample_chunk",
    "pt_chees_warm_chunk",
    "run_pt_chees",
    "run_pt_nuts",
    "tune_ladder",
    "run_advi",
    "run_hmc",
    "run_nuts",
    "run_smc",
    "sample_posterior",
    "split_rhat",
]
