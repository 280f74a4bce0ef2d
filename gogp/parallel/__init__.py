"""Multi-chip parallelism: device meshes, sharded MCMC chains, sharded SMC.

The reference's only concurrency is goroutines in one process (SURVEY.md §5);
this package is the multi-device scaling layer built fresh: jax.sharding
meshes, shard_map + psum/all_gather collectives between devices.
"""

from gogp.parallel.mesh import (
    CHAIN_AXIS,
    DATA_AXIS,
    chain_sharding,
    data_sharding,
    init_multihost,
    make_mesh,
    replicated,
    shard_leading,
)
from gogp.parallel.sample import (
    run_hmc_sharded,
    run_mcmc_sharded,
    run_chees_pops_sharded,
    run_ess_sharded,
    run_chees_sharded,
    run_ghmc_sharded,
    run_nuts_sharded,
    run_pt_chees_distributed,
    run_pt_chees_sharded,
    run_pt_distributed,
    run_pt_sharded,
)
from gogp.parallel.large_n import (
    make_rowsharded_logp,
    run_chees_large_n,
    run_smc_large_n,
)
from gogp.parallel.serving import (
    serve_predict_mixture_sharded,
    serve_predict_sharded,
    shard_mixture,
)
from gogp.parallel.smc_sharded import run_smc_sharded

__all__ = [
    "CHAIN_AXIS",
    "DATA_AXIS",
    "chain_sharding",
    "data_sharding",
    "init_multihost",
    "make_mesh",
    "make_rowsharded_logp",
    "replicated",
    "run_chees_large_n",
    "run_smc_large_n",
    "run_hmc_sharded",
    "run_mcmc_sharded",
    "run_chees_pops_sharded",
    "run_ess_sharded",
    "run_chees_sharded",
    "run_ghmc_sharded",
    "run_nuts_sharded",
    "run_pt_chees_distributed",
    "run_pt_chees_sharded",
    "run_pt_distributed",
    "run_pt_sharded",
    "run_smc_sharded",
    "serve_predict_mixture_sharded",
    "serve_predict_sharded",
    "shard_leading",
    "shard_mixture",
]
