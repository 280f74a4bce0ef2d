from gogp.gp.core import (  # noqa: F401
    GP,
    Posterior,
    absorb,
    lml,
    lml_from_posterior,
    lml_iterative,
    lml_iterative_matfree,
    lml_toeplitz,
    predict,
    predict_iterative,
    predict_toeplitz,
    predict_from_posterior,
    predict_y_from_posterior,
    predict_mixture,
    predict_prior,
)
from gogp.gp.model_selection import (  # noqa: F401
    LOOResult,
    aic,
    bic,
    loo,
    loo_from_posterior,
    loo_score,
)
from gogp.gp.pathwise import (  # noqa: F401
    PathFeatures,
    PathState,
    SparsePathState,
    eval_paths,
    eval_paths_sparse,
    eval_prior_paths,
    prior_paths,
    sample_features,
    sample_paths,
    sample_paths_laplace,
    sample_paths_ski,
    sample_paths_svgp,
)
from gogp.gp.ski import lml_ski, predict_ski  # noqa: F401
from gogp.gp.serve import (  # noqa: F401
    ServingMixture,
    ServingPosterior,
    compile_mixture,
    compile_posterior,
    fit_serving,
    serve_predict,
    serve_predict_cov,
    serve_predict_mixture,
    serve_sample,
)
from gogp.gp.streaming import (  # noqa: F401
    absorb_append,
    absorb_stream,
    streaming_posterior,
)
from gogp.gp.laplace import (  # noqa: F401
    LaplacePosterior,
    compile_laplace_serving,
    laplace_fit,
    laplace_fit_ovr,
    laplace_lml,
    laplace_predict,
    laplace_predict_ovr,
    laplace_predict_prob,
    make_laplace_logp,
    predict_expect,
)
from gogp.gp.laplace import serve_predict_prob  # noqa: F401
from gogp.gp import likelihoods  # noqa: F401
from gogp.gp.ep import (  # noqa: F401
    EPPosterior,
    compile_ep_serving,
    ep_fit,
    ep_lml,
    ep_predict,
    ep_predict_prob,
    make_ep_logp,
)
from gogp.gp.tprocess import (  # noqa: F401
    make_tp_logp,
    tp_absorb,
    tp_lml,
    tp_predict,
)
from gogp.gp.sparse import (  # noqa: F401
    SGPRPosterior,
    SVGPParams,
    SVGPState,
    make_sgpr_logp,
    sgpr_elbo,
    sgpr_fit,
    sgpr_predict,
    svgp_elbo,
    svgp_fit,
    svgp_fit_natgrad,
    svgp_fit_stream,
    svgp_init,
    svgp_natgrad_step,
    svgp_optimal_state,
    svgp_predict,
)
