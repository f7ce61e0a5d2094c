from .kernels import (
    acos_J, acosker, gram_matrices, local_envelope, materialize_C,
    pixel_coords, smooth_factor,
)
from .stabilize import (
    Eigenspace, compute_eigenspace, logdet_with_fallback, masked_inverse_spd,
    project_gram, reproject,
)
