from gogp.models.model import (  # noqa: F401
    add_logps,
    free_mask_anynoise,
    free_mask_warpedtime,
    masked_value_and_grad,
)
from gogp.models.params import (  # noqa: F401
    GPParams,
    gp_observe,
    gp_posterior,
    join_params,
    make_gp_logp,
    split_params,
)
