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

The reference's other updates, which no fit calls, are here too, one cell
at a time: the damped E-step (``estep_update_damped``), the explicit
inverse of V^-1 (``estep_update_V_inv``) and the legacy joint Newton
update of the f-params (``update_f_params_newton``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.stabilize import _spd_inverse, mv, schulz_iterations
from ..utils.tracing import host_read, read_guard
from .moments import mean_f_given_lambda_moments, poisson_ell


def _newton_sums(r, a, f_mean, f_params, weight):
    """g = A a^T (r - f) and G = A^2 a^T (a . f), with padded points
    masked out by ``weight``; of one cell or of each cell of a stack."""
    A = torch.exp(f_params["logA"])[..., None]
    resid = r - f_mean
    fw = f_mean
    if weight is not None:
        resid = resid * weight
        fw = fw * weight
    return (A * mv(a.mT, resid),
            (A * A)[..., None] * (a.mT @ (a * fw[..., :, None])))


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
    g, G = _newton_sums(r, a, f_mean, f_params, weight)
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
        host_read("estep.schulz")
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


def estep_update_damped(r: torch.Tensor, a: torch.Tensor, m_b: torch.Tensor,
                        V_b: torch.Tensor, f_mean: torch.Tensor,
                        k_tilde_b_diag: torch.Tensor,
                        f_params: Dict[str, torch.Tensor],
                        alpha: float = 0.5,
                        weight: Optional[torch.Tensor] = None):
    """Damped (alpha != 1) Newton E-step, the reference's path that it
    flags as risking a non-positive-definite V_new (utils.py:1423-1436):

        V_new = V ((1-alpha) K + alpha V + alpha K G V)^-1 K
        m_new = m - alpha (I + K G)^-1 (m - K g)

    Unlike ``estep_update`` it reads the current V.  Both systems by LU
    (``torch.linalg.solve``): the first is not symmetric.  No fit calls
    it."""
    g, G = _newton_sums(r, a, f_mean, f_params, weight)
    n = k_tilde_b_diag.shape[0]
    K = torch.diag(k_tilde_b_diag)
    KG = k_tilde_b_diag[:, None] * G
    lhs_V = (1.0 - alpha) * K + alpha * V_b + alpha * (KG @ V_b)
    V_new = V_b @ torch.linalg.solve(lhs_V, K)
    lhs_m = torch.eye(n, dtype=a.dtype, device=a.device) + KG
    m_new = m_b - alpha * torch.linalg.solve(lhs_m, m_b - k_tilde_b_diag * g)
    V_new = 0.5 * (V_new + V_new.T)
    return m_new, V_new


def estep_update_V_inv(r: torch.Tensor, a: torch.Tensor, m_b: torch.Tensor,
                       f_mean: torch.Tensor, k_tilde_inv_diag: torch.Tensor,
                       f_params: Dict[str, torch.Tensor],
                       weight: Optional[torch.Tensor] = None):
    """The reference's ``update_V_inv=True`` E-step (utils.py:1441-1457):
    V_new = (K^-1 + G)^-1 by an explicit inverse, with the eps-scale
    diagonal it adds (less stable than the solve form, the reference
    warns).  No fit calls it."""
    g, G = _newton_sums(r, a, f_mean, f_params, weight)
    n = k_tilde_inv_diag.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    eps = torch.finfo(a.dtype).eps * 1.0e-7
    V_inv = torch.diag(k_tilde_inv_diag) + G
    V_inv = 0.5 * (V_inv + V_inv.T) + eps * eye
    V_new = torch.linalg.inv(V_inv)
    m_new = V_new @ (G @ m_b + g)
    V_new = 0.5 * (V_new + V_new.T) + eps * eye
    return m_new, V_new


def update_f_params_newton(f_params: Dict[str, torch.Tensor],
                           r: torch.Tensor, lambda_m: torch.Tensor,
                           lambda_var: torch.Tensor, nit: int = 1000,
                           eta: float = 0.25, tol: float = 1e-6):
    """Legacy joint Newton update of (A, lambda0) with the explicit 2 x 2
    Hessian (reference: utils.py:1339-1400 ``updateA``; superseded there
    and in the fit by L-BFGS on logA with the closed-form lambda0).

    Each iteration takes the step from the residual R of the state it
    starts from and then stops if that R had ||R||_1 < tol -- the step is
    applied all the same -- or after ``nit`` iterations: the JAX package's
    ``lax.while_loop``.  The stop test is read on the host, one
    synchronization per iteration, counted in ``utils.tracing.decisions``
("fparams_newton.stop" once if it met tol, "fparams_newton.step" for
every other iteration).  Returns ({"logA", "lambda0"}, the final
    expected log-likelihood, the final f_mean)."""
    A = torch.exp(f_params["logA"])
    lam0 = f_params["lambda0"]
    sum_r = torch.sum(r)
    rlm = torch.dot(r, lambda_m)
    for _ in range(nit):
        f_mean = torch.exp(A * lambda_m + 0.5 * A * A * lambda_var + lam0)
        d_exp = lambda_m + A * lambda_var
        f_star = d_exp * f_mean
        sum_f_star = torch.sum(f_star)
        sum_f_mean = torch.sum(f_mean)
        R = torch.stack([rlm - sum_f_star, sum_r - sum_f_mean])
        H = -torch.stack([
            torch.stack([torch.dot(lambda_var, f_mean)
                         + torch.dot(d_exp, f_star), sum_f_star]),
            torch.stack([sum_f_star, sum_f_mean])])
        step = torch.linalg.solve(H, R)
        A = A - eta * step[0]
        lam0 = lam0 - eta * step[1]
        if read_guard(torch.sum(torch.abs(R)) < tol, "fparams_newton.stop",
                      "fparams_newton.step"):
            break
    out = {"logA": torch.log(torch.clamp(A, min=torch.finfo(A.dtype).tiny)),
           "lambda0": lam0}
    f_mean = mean_f_given_lambda_moments(out, lambda_m, lambda_var)
    return out, poisson_ell(r, f_mean, lambda_m, out), f_mean
