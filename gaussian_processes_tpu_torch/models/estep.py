"""Closed-form Newton E-step on the variational parameters (m_b, V_b)
(counterpart of ``gaussian_processes_tpu/models/estep.py``; reference:
Spatial_GP_repo/utils.py:1402-1459 with alpha = 1).

With g = A a^T (r - f) and G = A^2 a^T (a . f), the update is
``V_new = (I + K_tilde G)^-1 K_tilde`` and ``m_new = V_new (G m + g)``.  In
the stabilized basis K_tilde_b = S^2 is diagonal, so
``V_new = S (I + S G S)^-1 S`` with I + S G S symmetric positive definite:
one Cholesky factorization.  Dropped eigendirections (S = 0) collapse to identity
rows and V_new stays exactly zero there.  A leading cell axis on every
argument (f-params (L,)) runs the update cell by cell.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.stabilize import mv


def estep_update(r: torch.Tensor, a: torch.Tensor, m_b: torch.Tensor,
                 f_mean: torch.Tensor, k_tilde_b_diag: torch.Tensor,
                 f_params: Dict[str, torch.Tensor],
                 weight: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Newton update of (m_b, V_b).  ``a`` is KKtilde_inv_b; ``weight``
    (0/1) masks padded training points out of the Newton sums.  A failed
    factorization (non-finite or indefinite system) returns NaN, which the
    fit's rollback catches."""
    A = torch.exp(f_params["logA"])[..., None]
    resid = r - f_mean
    fw = f_mean
    if weight is not None:
        resid = resid * weight
        fw = fw * weight
    g = A * mv(a.mT, resid)
    G = (A * A)[..., None] * (a.mT @ (a * fw[..., :, None]))
    s = torch.sqrt(k_tilde_b_diag)
    eye = torch.eye(k_tilde_b_diag.shape[-1], dtype=a.dtype, device=a.device)
    M = eye + s[..., :, None] * G * s[..., None, :]
    L, info = torch.linalg.cholesky_ex(M)
    # L^-T L^-1 by a triangular solve (a batched cholesky_solve on the card
    # synchronizes the host inside the library)
    L_inv = torch.linalg.solve_triangular(L, eye.expand_as(M), upper=False)
    Minv = L_inv.mT @ L_inv
    Minv = torch.where((info == 0)[..., None, None], Minv, float("nan"))
    V_new = Minv * s[..., :, None] * s[..., None, :]
    m_new = mv(V_new, mv(G, m_b) + g)
    V_new = 0.5 * (V_new + V_new.mT)
    return m_new, V_new
