"""Closed-form Newton E-step on the variational parameters (m_b, V_b)
(counterpart of ``gaussian_processes_tpu/models/estep.py``; reference:
Spatial_GP_repo/utils.py:1402-1459 with alpha = 1).

With g = A a^T (r - f) and G = A^2 a^T (a . f), the update is
``V_new = (I + K_tilde G)^-1 K_tilde`` and ``m_new = V_new (G m + g)``.  In
the stabilized basis K_tilde_b = S^2 is diagonal, so
``V_new = S (I + S G S)^-1 S`` with I + S G S symmetric positive definite:
one Cholesky factorization.  Dropped eigendirections (S = 0) collapse to identity
rows and V_new stays exactly zero there.  A leading cell axis on every
argument (f-params (L,)) runs the update cell by cell.  Successive Newton
steps move (I + S G S) less and less, so the previous step's inverse can
seed a Newton-Schulz iteration instead (``Minv_warm``), with the Cholesky
inverse where its residual guard fails.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.stabilize import _spd_inverse, mv, schulz_iterations
from ..utils.tracing import read_guard


def estep_update(r: torch.Tensor, a: torch.Tensor, m_b: torch.Tensor,
                 f_mean: torch.Tensor, k_tilde_b_diag: torch.Tensor,
                 f_params: Dict[str, torch.Tensor],
                 weight: Optional[torch.Tensor] = None,
                 Minv_warm: Optional[torch.Tensor] = None,
                 use_warm: bool = False, schulz_steps: int = 12,
                 schulz_tol: float = 1e-3, return_minv: bool = False,
                 rows=None):
    """One Newton update of (m_b, V_b).  ``a`` is KKtilde_inv_b; ``weight``
    (0/1) masks padded training points out of the Newton sums.  A failed
    factorization (non-finite or indefinite system) returns NaN, which the
    fit's rollback catches.

    ``Minv_warm`` with ``use_warm`` (a host bool: False on an E-step's
    first Newton step, where no seed exists): the inverse of I + S G S by
    ``schulz_steps`` Newton-Schulz steps from ``Minv_warm``, and by the
    Cholesky route where the residual guard (``schulz_tol``) fails, read
    on the host once per call.  ``return_minv`` also returns that inverse,
    the next step's seed.  ``rows``: the training-point arguments hold this
    rank's rows of the mesh's "data" axis (``parallel/collectives.Rows``),
    and g and G are summed over every rank's."""
    A = torch.exp(f_params["logA"])[..., None]
    resid = r - f_mean
    fw = f_mean
    if weight is not None:
        resid = resid * weight
        fw = fw * weight
    g = A * mv(a.mT, resid)
    G = (A * A)[..., None] * (a.mT @ (a * fw[..., :, None]))
    if rows is not None:
        n = g.shape[-1]
        gG = rows.sum(torch.cat([g, G.flatten(-2)], dim=-1))
        g, G = gG[..., :n], gG[..., n:].unflatten(-1, (n, n))
    s = torch.sqrt(k_tilde_b_diag)
    eye = torch.eye(k_tilde_b_diag.shape[-1], dtype=a.dtype, device=a.device)
    M = eye + s[..., :, None] * G * s[..., None, :]
    if Minv_warm is not None and use_warm:
        Minv, resid = schulz_iterations(M, Minv_warm, schulz_steps,
                                        tol=schulz_tol)
        ok = resid < schulz_tol
        if read_guard(ok, "estep.schulz", "estep.exact") < ok.numel():
            Minv = torch.where(ok[..., None, None], Minv, _spd_inverse(M))
    else:
        Minv = _spd_inverse(M)
    V_new = Minv * s[..., :, None] * s[..., None, :]
    m_new = mv(V_new, mv(G, m_b) + g)
    V_new = 0.5 * (V_new + V_new.mT)
    if return_minv:
        return m_new, V_new, Minv
    return m_new, V_new
