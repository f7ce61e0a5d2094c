from .estep import estep_update
from .moments import (
    kl_divergence, lambda0_given_logA, lambda_moments, lambda_moments_star,
    mean_f_given_lambda_moments, poisson_ell,
)
