"""gaussian_processes_tpu_torch -- the PyTorch/CUDA port of the spatial-GP
framework.

The JAX package ``gaussian_processes_tpu`` stays the reference; this package
mirrors its layout and names module by module.  It runs the single-cell
sparse-variational Poisson GP fit (``models.fit.fit``) and the noise-corrected
r^2 evaluation (``models.inference.evaluate``) on CPU tensors or on one
NVIDIA Hopper GPU, where every arc-cosine Gram goes through the hand-written
CUDA kernel in ``csrc/acos_gram.cu`` (``ops.gram_cuda``).  It never imports
jax or optax.
"""

from . import config, params
from .config import FitConfig
from .params import (
    default_f_params, fromlogbetasam_to_logbetaexpr,
    fromlogrhosam_to_logrhoexpr, generate_theta, get_sta,
    logbetaexpr_to_beta, logrhoexpr_to_rho, theta_bounds,
)

__version__ = "0.1.0"
