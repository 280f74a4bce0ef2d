from gogp.kernels.base import Kernel, NoiseKernel  # noqa: F401
from gogp.kernels import deep  # noqa: F401
from gogp.kernels.multioutput import (  # noqa: F401
    icm,
    init_icm_theta,
    lmc,
    stack_tasks,
    task_inputs,
)
from gogp.kernels.noise import (  # noqa: F401
    constant_noise,
    jitter_only_noise,
    uniform_noise,
)
from gogp.kernels.stationary import (  # noqa: F401
    SQRT3,
    SQRT5,
    linear,
    matern32,
    matern52,
    matern52_ref,
    exponential,
    matern12,
    normal,
    periodic,
    spectral_mixture,
    rational_quadratic,
    rbf,
    white,
)
