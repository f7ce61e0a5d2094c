"""Mutual-information acquisition for closed-loop active learning
(counterpart of ``gaussian_processes_tpu/models/acquisition.py``).

Every unseen stimulus is scored by U = H(r|x,D) - <H(r|f,x)>, the mutual
information between the response and the firing rate (PNAS eqs 27-34), with
a Laplace approximation of p(r|x,D) whose mode needs one Lambert-W per
(candidate, count) pair (reference: Spatial_GP_repo/utils.py:416-525).  The
whole pool is scored in one batched pass on the pool's device; its K* goes
through ``ops/kernels._gram_core``, so through the CUDA Gram kernel on a
CUDA tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import use_full_fp32
from ..ops.kernels import gram_matrices, gram_matrices_windowed
from ..ops.lambertw import lambertw
from .moments import lambda_moments


def nd_lambda_r_mean(r: torch.Tensor, sigma2: torch.Tensor, mu: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mode of the Laplace-approximated log p(r|x,D) for each count r and
    candidate (PNAS eq 32; reference: utils.py:436-469).  Entries where
    ``z = sigma2 exp(r sigma2 + mu)`` overflows are masked out of the count
    sum exactly as the reference does (far more of them in float32)."""
    rsigma2 = torch.outer(r, sigma2)
    z = torch.exp(rsigma2 + mu[None, :]) * sigma2[None, :]
    sum_mask = torch.isfinite(z)
    z = torch.where(sum_mask, z, 0.0)
    rsigma2 = torch.where(sum_mask, rsigma2, 0.0)
    lam = rsigma2 + mu[None, :] - lambertw(z)
    return lam, sum_mask


def nd_p_r_given_xD(r: torch.Tensor, sigma2: torch.Tensor, mu: torch.Tensor):
    """Laplace approximation of p(r|x,D) (PNAS eq 31; reference:
    utils.py:471-498)."""
    lam, sum_mask = nd_lambda_r_mean(r, sigma2, mu)
    ex_lam = torch.exp(lam)
    log_r_fact = torch.lgamma(r + 1.0)
    r2d = torch.where(sum_mask, r[:, None], 0.0)
    log_r_fact2d = torch.where(sum_mask, log_r_fact[:, None], 0.0)
    log_p = (lam * r2d - ex_lam
             - (lam - mu[None, :]) ** 2 / (2.0 * sigma2[None, :])
             - 0.5 * torch.log(ex_lam * sigma2[None, :] + 1.0)
             - log_r_fact2d)
    return torch.exp(log_p), log_p, r2d, log_r_fact2d


def nd_mean_noise_entropy(p_response, log_r_fact2d, sigma2, mu):
    """<H(r|f,x)> (PNAS eq 33; reference: utils.py:416-434)."""
    p_times_logr = torch.sum(p_response * log_r_fact2d, dim=0)
    return (-torch.exp(mu + 0.5 * sigma2) * (mu + sigma2 - 1.0)
            + p_times_logr)


def nd_utility(sigma2: torch.Tensor, mu: torch.Tensor,
               r_cutoff: int = 100) -> torch.Tensor:
    """Batched utility U = H(r|x,D) - <H(r|f,x)> (PNAS eq 27; reference:
    utils.py:500-525).  sigma2/mu are the variance/mean of log f for each
    candidate; returns (nstar,) utilities."""
    sigma2 = torch.atleast_1d(sigma2)
    mu = torch.atleast_1d(mu)
    r = torch.arange(r_cutoff, dtype=sigma2.dtype, device=sigma2.device)
    p, log_p, _, log_r_fact2d = nd_p_r_given_xD(r, sigma2, mu)
    H_r_xD = -torch.sum(p * log_p, dim=0)
    E_H_r_f = nd_mean_noise_entropy(p, log_r_fact2d, sigma2, mu)
    return H_r_xD - E_H_r_f


def utility(sigma2, mu, r_cutoff: int = 100) -> torch.Tensor:
    """Scalar-candidate wrapper (reference legacy path, utils.py:527-629)."""
    return nd_utility(torch.atleast_1d(torch.as_tensor(sigma2)),
                      torch.atleast_1d(torch.as_tensor(mu)), r_cutoff)[0]


def score_candidates(xstar: torch.Tensor, xtilde: torch.Tensor,
                     theta: Dict[str, torch.Tensor],
                     f_params: Dict[str, torch.Tensor],
                     m_b: torch.Tensor, V_b: torch.Tensor, B: torch.Tensor,
                     k_tilde_inv_diag: torch.Tensor,
                     n_px_side: int = 108, alpha_threshold: float = 1e-3,
                     r_cutoff: int = 100,
                     win_i0: Optional[int] = None,
                     win_j0: Optional[int] = None,
                     win_w: Optional[int] = None,
                     backend: Optional[str] = None):
    """Utility of every candidate stimulus (the reference's acquisition
    region, one_cell_active_training.ipynb:cell17): posterior
    lambda-moments of all candidates, then the log-f moments
    ``mu = A lam_m + lambda0`` and ``sigma2 = A^2 lam_var``, then the
    batched utility.  ``win_*`` crop the Gram to a window covering the RF;
    ``backend`` as in ``ops/kernels._gram_core``.

    Returns (utilities, index of the largest) as device tensors.
    """
    if xstar.is_cuda:
        use_full_fp32()
    with torch.no_grad():
        # gram_matrices also builds K_tilde, which the scorer does not use
        # (the JAX scorer does the same)
        if win_w is not None:
            _, K_star, Kvec_star = gram_matrices_windowed(
                theta, xstar, xtilde, n_px_side, False, win_i0, win_j0,
                win_w, alpha_threshold, backend)
        else:
            _, K_star, Kvec_star = gram_matrices(
                theta, xstar, xtilde, n_px_side, shared=False,
                alpha_threshold=alpha_threshold, backend=backend)
        K_star_b = K_star @ B
        a_star = K_star_b * k_tilde_inv_diag[None, :]
        lam_m, lam_var = lambda_moments(a_star, K_star_b, Kvec_star, m_b, V_b)
        A = torch.exp(f_params["logA"])
        logf_mean = A * lam_m + f_params["lambda0"]
        logf_var = A * A * lam_var
        u = nd_utility(logf_var, logf_mean, r_cutoff)
    return u, torch.argmax(u)
