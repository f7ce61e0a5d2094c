"""Configuration of the PyTorch/CUDA port.

The constants are the reference's (Spatial_GP_repo/utils.py:31-41), as in
``gaussian_processes_tpu/config.py``.  ``FitConfig`` carries only the knobs
this port implements: the exact-semantics per-iteration EM fit (full-rank
eigh stabilization, Cholesky E-step solves, exact M-step inverse and Cholesky
log-determinant, exact Gram).

Precision: float32 matrix products run in full IEEE float32.  PyTorch's
cuBLAS path already defaults to that, but cuDNN does not, so
``use_full_fp32`` sets both TF32 switches off explicitly; ``fit`` and
``predict_rates`` call it whenever their tensors are on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Tolerance below which a matrix is not considered symmetric / posdef
# (reference: Spatial_GP_repo/utils.py:37).
MIN_TOLERANCE = 1.0e-11

# Relative eigenvalue cutoff for the stabilizing eigenspace projection
# (reference: Spatial_GP_repo/utils.py:39).
EIGVAL_TOL = 1.0e-4

# Pixels with envelope alpha < ALPHA_THRESHOLD carry exactly zero kernel
# weight (the reference crops them, Spatial_GP_repo/utils.py:883-887).
ALPHA_THRESHOLD = 1.0e-3

# Additive guard in the cosine-angle denominator
# (reference: Spatial_GP_repo/utils.py:984).
COSDELTA_JITTER = 1.0e-7


def use_full_fp32() -> None:
    """Turn TF32 off for CUDA matmuls and convolutions (float32 products
    then keep ~7 decimal digits instead of TF32's ~3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """One EM fit (the reference's ``fit_parameters`` dict,
    Spatial_GP_repo/utils.py:1632-1645, with identical defaults)."""

    ntilde: Optional[int] = None      # inducing points (None -> min(100, nt))
    maxiter: int = 50                 # outer EM iterations
    n_estep: int = 50                 # E-step Newton iterations per outer
    n_mstep: int = 20                 # L-BFGS iterations on theta per outer
    n_fparamstep: int = 10            # L-BFGS iterations on logA per E-step
    n_px_side: int = 108              # stimulus is n_px_side x n_px_side
    cellid: int = 0
    eigval_tol: float = EIGVAL_TOL
    alpha_threshold: float = ALPHA_THRESHOLD
    track_variational: bool = True    # record (m_b, V_b) per iteration
    # Crop window around the RF (exact: cropped pixels carry zero kernel
    # weight).  Each EM iteration crops to a window covering the alpha mask
    # of the theta it starts from, with ``crop_margin`` of slack; the side is
    # rounded up to a multiple of ``crop_bucket``.
    crop_window: bool = True
    crop_margin: float = 1.25
    crop_bucket: int = 16
    # Strong-Wolfe zoom line-search trial budget per L-BFGS step.
    max_linesearch_steps: int = 15

    def resolve_ntilde(self, nt: int) -> int:
        if self.ntilde is not None:
            return self.ntilde
        return 100 if nt > 100 else nt
