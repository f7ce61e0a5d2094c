"""Test-point inference and reliability-corrected evaluation
(counterpart of ``gaussian_processes_tpu/models/inference.py``; reference
``test()``, Spatial_GP_repo/utils.py:326-412 and 1502-1541).

Prediction is one batched pass over every test stimulus.  The bootstrap of
the explained variance draws its repeat permutations from a
``torch.Generator`` seeded with ``seed``, or takes them as ``perms``; the
JAX package draws them from ``jax.random``, so the two agree exactly on the
point estimate and on sigma only when handed the same permutations.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import use_full_fp32
from ..ops.kernels import gram_matrices
from ..ops.stabilize import Eigenspace, compute_eigenspace
from .moments import lambda_moments_star


def predict_rates(xstar: torch.Tensor, xtilde: torch.Tensor,
                  theta: Dict[str, torch.Tensor],
                  f_params: Dict[str, torch.Tensor],
                  m_b: torch.Tensor, V_b: torch.Tensor, B: torch.Tensor,
                  k_tilde_b_diag: torch.Tensor,
                  k_tilde_inv_diag: torch.Tensor,
                  n_px_side: int = 108, alpha_threshold: float = 1e-3
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Posterior predictive firing rate for a batch of stimuli:
    (rates, mu_star, sigma_star2) with ``rate = exp(A mu* + 0.5 A^2
    sigma*^2 + lambda0)`` (reference: utils.py:388-397).  The basis B is
    (ntilde, rank) at any rank."""
    if xstar.is_cuda:
        use_full_fp32()
    with torch.no_grad():
        _, K_star, Kvec_star = gram_matrices(theta, xstar, xtilde, n_px_side,
                                             shared=False,
                                             alpha_threshold=alpha_threshold)
        K_star_b = K_star @ B
        a_star = K_star_b * k_tilde_inv_diag[None, :]
        mu, var = lambda_moments_star(a_star, K_star_b, Kvec_star, m_b, V_b,
                                      k_tilde_b_diag)
        A = torch.exp(f_params["logA"])
        rates = torch.exp(A * mu + 0.5 * A * A * var + f_params["lambda0"])
    return rates, mu, var


def predict(result, xstar: torch.Tensor):
    """``predict_rates`` over a FitResult."""
    xstar = xstar.to(dtype=result.xtilde.dtype, device=result.xtilde.device)
    return predict_rates(
        xstar, result.xtilde, result.theta, result.f_params, result.m_b,
        result.V_b, result.B, result.k_tilde_b_diag, result.k_tilde_inv_diag,
        n_px_side=result.config.n_px_side,
        alpha_threshold=result.config.alpha_threshold)


def state_at_iteration(result, iteration: int):
    """The model state at a tracked iteration (the reference's ``test(...,
    at_iteration=k)``, utils.py:358-386): ``(theta, f_params, m_b, V_b,
    es)``, with m_b, V_b and the basis at full width (a reduced-rank
    iteration's coordinates left-padded, as tracked).

    * Basis tracked (``cfg.track_basis``): the stored basis B of that
      iteration with the tracked (m_b, V_b); ``k_tilde_b_diag`` is
      ``diag(B^T K_tilde B)`` at the tracked theta: the fit's eigenvalues
      up to the eigensolver's rounding (in float32 about n eps lambda_max,
      which moves the smallest kept ones most).
    * Basis not tracked: a fresh full eigh of K_tilde(theta_i), which is
      the fit's basis whenever that came from a full eigh -- always here;
      a result whose bases came from a warm-started eigensolver
      (``used_warm_basis``, a converted JAX fit) raises instead of pairing
      the state with another basis.
    """
    t = result.track
    if t.m_b.shape[1] == 0:
        raise ValueError("track_variational was off; per-iteration state "
                         "was not recorded")
    theta = {k: v[iteration] for k, v in t.theta.items()}
    f_params = {"logA": t.logA[iteration], "lambda0": t.lambda0[iteration]}
    m_b = t.m_b[iteration]
    V_b = t.V_b[iteration]
    cfg = result.config
    with torch.no_grad():
        K_tilde, _, _ = gram_matrices(theta, result.xtilde, result.xtilde,
                                      cfg.n_px_side, shared=True,
                                      alpha_threshold=cfg.alpha_threshold)
        if t.B.shape[2] > 0:
            B = t.B[iteration]
            keep = torch.sum(B * B, dim=0) > 0.5     # zero columns: dropped
            keepf = keep.to(B.dtype)
            kb = torch.sum(B * (K_tilde @ B), dim=0) * keepf
            safe = torch.where(keep, kb, torch.ones_like(kb))
            es = Eigenspace(B=B, eigvals=kb, keep=keep, k_tilde_b_diag=kb,
                            k_tilde_inv_diag=keepf / safe)
            return theta, f_params, m_b, V_b, es
        if getattr(result, "used_warm_basis", False):
            raise ValueError(
                "this fit used a warm-started subspace eigensolver: its "
                "per-iteration bases are Rayleigh-Ritz bases that a fresh "
                "eigh of K_tilde(theta_i) does not reproduce, so iteration "
                f"{iteration} cannot be reconstructed from theta alone.  "
                "Refit with FitConfig(track_basis=True), or evaluate the "
                "final state (at_iteration=None).")
        es = compute_eigenspace(K_tilde, cfg.eigval_tol)
    return theta, f_params, m_b, V_b, es


def _corrcoef(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pearson correlation along the last axis (batched over leading)."""
    uc = u - u.mean(-1, keepdim=True)
    vc = v - v.mean(-1, keepdim=True)
    return (uc * vc).sum(-1) / torch.sqrt((uc * uc).sum(-1)
                                          * (vc * vc).sum(-1))


def explained_variance(rtst: torch.Tensor, f_pred: torch.Tensor,
                       sigma: bool = True, nbootstrap: int = 1000,
                       seed: int = 0, perms: Optional[torch.Tensor] = None):
    """Noise-corrected r^2 (reference: utils.py:1502-1541).

    rtst: (nrep, nimages) repeated responses; f_pred: (nimages,).  With
    ``sigma=True`` returns the bootstrap (mean r2, std r2) over repeat
    permutations (``perms``: (nbootstrap, nrep) indices, else drawn from a
    CPU generator seeded with ``seed``); otherwise the even/odd point
    estimate and None."""
    f_pred = f_pred.to(rtst.dtype)
    reven = rtst[0::2].mean(0)
    rodd = rtst[1::2].mean(0)
    reliability = torch.abs(_corrcoef(reven, rodd))
    if not sigma:
        r2_point = 0.5 * (_corrcoef(f_pred, rodd)
                          + _corrcoef(f_pred, reven)) / reliability
        return r2_point, None
    nrep = rtst.shape[0]
    if perms is None:
        gen = torch.Generator().manual_seed(seed)
        perms = torch.stack([torch.randperm(nrep, generator=gen)
                             for _ in range(nbootstrap)])
    perms = perms.to(rtst.device)
    reven_b = rtst[perms[:, 0::2]].mean(1)      # (nbootstrap, nimages)
    rodd_b = rtst[perms[:, 1::2]].mean(1)
    rel = torch.abs(_corrcoef(reven_b, rodd_b))
    r2s = 0.5 * (_corrcoef(f_pred, rodd_b) + _corrcoef(f_pred, reven_b)) / rel
    return r2s.mean(), r2s.std(unbiased=False)


def evaluate(result, X_test: torch.Tensor, R_test: torch.Tensor,
             cellid: Optional[int] = None, at_iteration: Optional[int] = None,
             nbootstrap: int = 1000, seed: int = 0):
    """The reference's ``test()``: predict every test image and score
    against repeated responses (utils.py:326-412), with the final state or
    the state of a tracked iteration (``at_iteration``,
    ``state_at_iteration``).

    X_test: (nimg, npx, npx[, 1]) or (nimg, nx); R_test: (nrep, nimg,
    ncells) or (nrep, nimg).  Returns (R_test_cell, R_pred, r2, sigma_r2).
    """
    if X_test.dim() > 2:
        X_test = X_test.reshape(X_test.shape[0], -1)
    if R_test.dim() == 3:
        cid = result.config.cellid if cellid is None else cellid
        R_test = R_test[:, :, cid]
    if at_iteration is not None:
        theta, f_params, m_b, V_b, es = state_at_iteration(result,
                                                           at_iteration)
        rates, _, _ = predict_rates(
            X_test.to(dtype=result.xtilde.dtype, device=result.xtilde.device),
            result.xtilde, theta, f_params, m_b, V_b, es.B,
            es.k_tilde_b_diag, es.k_tilde_inv_diag,
            n_px_side=result.config.n_px_side,
            alpha_threshold=result.config.alpha_threshold)
    else:
        rates, _, _ = predict(result, X_test)
    R_test = R_test.to(dtype=rates.dtype, device=rates.device)
    r2, sigma_r2 = explained_variance(R_test, rates, sigma=True,
                                      nbootstrap=nbootstrap, seed=seed)
    return R_test, rates, r2, sigma_r2
