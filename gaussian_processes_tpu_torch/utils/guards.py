"""Numerical invariant guards (counterpart of
``gaussian_processes_tpu/utils/guards.py``; reference:
Spatial_GP_repo/utils.py:633-685).

Host-side diagnostics for tests and interactive use; the fit itself detects
non-finite iterations and rolls back instead (models/fit.py).  Matrices may
be numpy arrays or tensors on any device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import MIN_TOLERANCE


def _numpy(M) -> np.ndarray:
    if isinstance(M, torch.Tensor):
        return M.detach().cpu().numpy()
    return np.asarray(M)


def is_symmetric(M, name: str = "M", tol: float = MIN_TOLERANCE) -> bool:
    M = _numpy(M)
    diff = np.abs(M - M.T)
    if np.any(diff > tol):
        warnings.warn(f"Matrix {name} is not symmetric, max difference "
                      f"{diff.max():.3e}")
        return False
    return True


# the reference spells it 'is_simmetric'
is_simmetric = is_symmetric


def is_posdef(M, name: str = "M", tol: float = MIN_TOLERANCE) -> bool:
    if not is_symmetric(M, name=name):
        warnings.warn(f"Matrix {name} is not symmetric, cannot check "
                      "positive definiteness")
        return False
    smallest = float(np.linalg.eigvalsh(_numpy(M)).min())
    if smallest <= 0.0:
        warnings.warn(f"Matrix {name} has an eigenvalue <= 0 ({smallest:.3e})")
        return False
    if smallest <= tol:
        warnings.warn(f"Matrix {name} has an eigenvalue below tolerance "
                      f"{tol:.1e} ({smallest:.3e})")
        return False
    return True


def safe_log(x) -> torch.Tensor:
    """log with a hard error on non-positive or tiny input
    (reference: utils.py:665-673)."""
    x = torch.as_tensor(x)
    if bool(torch.any(x <= 0)):
        raise ValueError("Negative or zero input to log detected")
    if bool(torch.any(x < 1e-10)):
        raise ValueError("Very small input to log detected")
    return torch.log(x)


def safe_acos(x) -> torch.Tensor:
    """arccos with clamping near the domain edges
    (reference: utils.py:675-685)."""
    x = torch.as_tensor(x)
    return torch.arccos(torch.clamp(x, -1 + 1e-6, 1 - 1e-6))


def print_hyp(theta) -> None:
    """Pretty-print theta with derived beta/rho
    (reference: utils.py:1461-1472)."""
    from ..params import logbetaexpr_to_beta, logrhoexpr_to_rho
    for key, val in theta.items():
        v = float(val)
        if key == "-2log2beta":
            print(f" {key:<12}: {v:>8.4f} --> beta: "
                  f"{float(logbetaexpr_to_beta(v)):>8.4f}")
        elif key == "-log2rho2":
            print(f" {key:<12}: {v:>8.4f} --> rho : "
                  f"{float(logrhoexpr_to_rho(v)):>8.4f}")
        else:
            print(f" {key:<12}: {v:>8.4f}")
