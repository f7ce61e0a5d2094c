"""Posterior moments, firing-rate link, Poisson expected log-likelihood, KL
(counterpart of ``gaussian_processes_tpu/models/moments.py``; formulas of
Spatial_GP_repo/utils.py:1072-1337).  Hyperparameter gradients come from
autograd.

Every function also takes a leading cell axis (vectors (L, n), matrices
(L, n, n), f-params (L,)), and the f-param functions further batch axes in
the f-params (the line-search trials, (L, T) against (L, 1, nt) moments).

``rows`` (``parallel/collectives.Rows``; None on one device) is this rank's
share of the training points under the mesh's "data" axis: the arguments
over training points then hold this rank's rows, and the sums over them
are completed across the axis.  ``lambda_moments`` and
``mean_f_given_lambda_moments`` are row by row and need nothing."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.stabilize import (Eigenspace, dot, logdet_with_fallback,
                             masked_logdet_chol, mv)

FParams = Dict[str, torch.Tensor]


def lambda_moments(a: torch.Tensor, K_b: torch.Tensor, Kvec: torch.Tensor,
                   m_b: torch.Tensor, V_b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal posterior mean/variance of lambda at the training points:
    lambda_m = a m ;  lambda_var = Kvec + sum(-K_b . a + a . (a V), axis=1)
    (reference: utils.py:1072-1124)."""
    lambda_m = mv(a, m_b)
    lambda_var = Kvec + torch.sum(-K_b * a + a * (a @ V_b), dim=-1)
    return lambda_m, lambda_var


def mean_f_given_lambda_moments(f_params: FParams, lambda_m: torch.Tensor,
                                lambda_var: torch.Tensor) -> torch.Tensor:
    """<f> = exp(A lambda_m + 0.5 A^2 lambda_var + lambda0)
    (reference: utils.py:1126-1141)."""
    A = torch.exp(f_params["logA"])[..., None]
    return torch.exp(A * lambda_m + 0.5 * A * A * lambda_var
                     + f_params["lambda0"][..., None])


def lambda0_given_logA(logA: torch.Tensor, r: torch.Tensor,
                       lambda_m: torch.Tensor, lambda_var: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       rows=None) -> torch.Tensor:
    """Closed-form optimal lambda0 = log sum(r) - logsumexp(A lam_m +
    0.5 A^2 lam_var) (reference: utils.py:1215-1229).  ``weight`` (0/1)
    masks padded training points out of both sums.  With ``rows`` the
    result is whole on every rank and marked where it enters the rows."""
    A = torch.exp(logA)[..., None]
    z = A * lambda_m + 0.5 * A * A * lambda_var
    if weight is not None:
        z = torch.where(weight > 0, z, float("-inf"))
        r = r * weight
    if rows is None:
        return torch.log(torch.sum(r, dim=-1)) - torch.logsumexp(z, dim=-1)
    # the distributed logsumexp, as torch.logsumexp computes it: the max
    # over every rank's rows (infinite -> 0; detached, the result does not
    # depend on it), then the shifted exponentials' sum, in one reduction
    # with sum(r)
    m = rows.max(z)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    sums = rows.sum(torch.stack(torch.broadcast_tensors(
        torch.sum(r, dim=-1), torch.sum(torch.exp(z - m[..., None]), dim=-1)),
        dim=-1))
    lam0 = torch.log(sums[..., 0]) - (torch.log(sums[..., 1]) + m)
    return rows.enter(lam0)


def poisson_ell(r: torch.Tensor, f_mean: torch.Tensor, lambda_m: torch.Tensor,
                f_params: FParams, weight: Optional[torch.Tensor] = None,
                rows=None) -> torch.Tensor:
    """Expected Poisson log-likelihood A r^T lambda_m + lambda0 sum(r) -
    sum(f) (reference: utils.py:1231-1243; log r! dropped there too).
    ``weight`` (0/1) masks padded training points.  With ``rows``, the sum
    of every rank's share."""
    A = torch.exp(f_params["logA"])
    if weight is not None:
        r = r * weight
        f_mean = f_mean * weight
    ell = (A * dot(r, lambda_m) + f_params["lambda0"] * torch.sum(r, dim=-1)
           - torch.sum(f_mean, dim=-1))
    return ell if rows is None else rows.sum(ell)


def ell_grad_f_params(r: torch.Tensor, f_mean: torch.Tensor,
                      lambda_m: torch.Tensor, lambda_var: torch.Tensor,
                      f_params: FParams) -> Dict[str, torch.Tensor]:
    """Hand-derived ELL gradients with respect to (logA, lambda0)
    (reference: utils.py:1248-1259), an oracle for autograd; no fit calls
    it."""
    A = torch.exp(f_params["logA"])
    return {
        "logA": A * (dot(r, lambda_m)
                     - dot(lambda_m + A[..., None] * lambda_var, f_mean)),
        "lambda0": torch.sum(r, dim=-1) - torch.sum(f_mean, dim=-1),
    }


def kl_divergence(m_b: torch.Tensor, V_b: torch.Tensor, es: Eigenspace,
                  K_tilde_b: Optional[torch.Tensor] = None,
                  K_tilde_inv_b: Optional[torch.Tensor] = None,
                  skip_logdet_V: bool = False,
                  chol_only: bool = False,
                  logdet_K: Optional[torch.Tensor] = None,
                  logdet_V: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(q || p) in the stabilized basis (reference: utils.py:1306-1337):

        KL = -1/2 log|V| + 1/2 log|K_tilde| + 1/2 m^T K_tilde^-1 m
             + 1/2 tr(V K_tilde^-1)

    With the E-step basis K_tilde_b is diagonal (kept eigenvalues); the
    M-step passes a dense ``K_tilde_b``/``K_tilde_inv_b`` pair.
    ``skip_logdet_V`` drops -1/2 log|V| (constant in theta);
    ``chol_only`` uses the Cholesky log-determinant without the eigh
    fallback (a failed factorization gives NaN, which the M-step maps to an
    infinite loss); ``logdet_K`` supplies log|K_tilde_b| for the dense pair
    (the M-step's trace series, ``ops/stabilize.masked_logdet_series``);
    ``logdet_V`` supplies log|V| when it has a closed form.
    """
    keep = es.keep
    if K_tilde_inv_b is None:
        kinv = es.k_tilde_inv_diag
        quad = dot(m_b, kinv * m_b)
        tr = dot(torch.diagonal(V_b, dim1=-2, dim2=-1), kinv)
        safe = torch.where(keep, es.eigvals, torch.ones_like(es.eigvals))
        logdet_K = torch.sum(torch.log(safe), dim=-1)
    else:
        quad = dot(m_b, mv(K_tilde_inv_b, m_b))
        tr = torch.diagonal(V_b @ K_tilde_inv_b, dim1=-2,
                            dim2=-1).sum(-1)
        if logdet_K is None:
            logdet_K = (masked_logdet_chol(K_tilde_b, keep) if chol_only
                        else logdet_with_fallback(K_tilde_b, keep))
    if skip_logdet_V:
        return 0.5 * logdet_K + 0.5 * quad + 0.5 * tr
    if logdet_V is None:
        logdet_V = logdet_with_fallback(V_b, keep)
    return -0.5 * logdet_V + 0.5 * logdet_K + 0.5 * quad + 0.5 * tr


def lambda_moments_star(a_star: torch.Tensor, K_star_b: torch.Tensor,
                        Kvec_star: torch.Tensor, m_b: torch.Tensor,
                        V_b: torch.Tensor, K_tilde_b_diag: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched test-point posterior moments (reference: utils.py:326-412):
    mu* = a m ;  sigma*^2 = K*_diag + diag(a (V - K_tilde) a^T)."""
    mu = a_star @ m_b
    aV = a_star @ (V_b - torch.diag(K_tilde_b_diag))
    return mu, Kvec_star + torch.sum(aV * a_star, dim=1)
