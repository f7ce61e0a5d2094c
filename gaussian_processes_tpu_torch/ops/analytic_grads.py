"""Hand-derived analytic gradients, kept as oracles for autograd
(counterpart of ``gaussian_processes_tpu/ops/analytic_grads.py``).

The reference computes every hyperparameter gradient analytically
(Spatial_GP_repo/utils.py:900-910 for dC, 992-1045 for dK, 1105-1121 for the
lambda-moment derivatives, 1261-1267 for the ELL, 1328-1335 for the KL) and
checks them in moments_gradients.ipynb.  The port differentiates its M-step
objective with autograd (through the Gram kernel's backward on the card);
these dense re-derivations give a gradient that does not depend on autograd
at all.  They materialize the nx x nx prior C and its five derivatives on
purpose: oracles, not the hot path, and nothing differentiates through them.
Every function takes its device and dtype from its tensor arguments.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import ALPHA_THRESHOLD, COSDELTA_JITTER
from ..models.moments import lambda_moments, mean_f_given_lambda_moments
from .kernels import pixel_coords
from .stabilize import Eigenspace, masked_inverse_spd

Theta = Dict[str, torch.Tensor]
Grads = Dict[str, torch.Tensor]

GRAD_KEYS = ("sigma_0", "eps_0x", "eps_0y", "-2log2beta", "-log2rho2", "Amp")


def localker_with_grads(theta: Theta, n_px_side: int,
                        alpha_threshold: float = ALPHA_THRESHOLD):
    """Dense C with masked rows and columns zeroed, the pixel mask, and
    dC/dtheta for the five C-hypers (reference: utils.py:861-914).  Masked
    pixels carry exactly zero C and dC, the reference's crop semantics."""
    amp = theta["Amp"]
    xcord, ycord = pixel_coords(n_px_side, amp.dtype, amp.device)
    gb = torch.exp(theta["-2log2beta"])
    logalpha = -gb * ((xcord - theta["eps_0x"]) ** 2 +
                      (ycord - theta["eps_0y"]) ** 2)
    alpha = torch.exp(logalpha)
    mask = alpha >= alpha_threshold
    maskf = mask.to(amp.dtype)
    alpha = alpha * maskf

    gr = torch.exp(theta["-log2rho2"])
    logCsmooth = -gr * ((xcord[:, None] - xcord[None, :]) ** 2 +
                        (ycord[:, None] - ycord[None, :]) ** 2)
    C = amp * alpha[:, None] * torch.exp(logCsmooth) * alpha[None, :]
    C = 0.5 * (C + C.T)

    mm = maskf[:, None] * maskf[None, :]
    dC = {
        "Amp": C / amp,
        "eps_0x": 2.0 * gb * C * (xcord[:, None] + xcord[None, :]
                                  - 2.0 * theta["eps_0x"]),
        "eps_0y": 2.0 * gb * C * (ycord[:, None] + ycord[None, :]
                                  - 2.0 * theta["eps_0y"]),
        "-2log2beta": C * (logalpha[:, None] + logalpha[None, :]) * mm,
        "-log2rho2": C * logCsmooth * mm,
    }
    return C, mask, dC


def acosker_with_grads(theta: Theta, x1: torch.Tensor,
                       x2: Optional[torch.Tensor], C: torch.Tensor,
                       dC: Grads, diag: bool = False):
    """Dense arc-cosine kernel and dK/dtheta (reference: utils.py:939-1050),
    dK covering sigma_0 and the five C-hypers.  ``diag=True`` gives the
    nt-vector diag(K(x1, x1)); x2 None gives K(x1, x1), symmetrized."""
    sigma_0 = theta["sigma_0"]
    s02 = sigma_0 * sigma_0

    if diag:
        K = torch.sum(x1 * (x1 @ C.T), dim=1) + s02
        dK = {"sigma_0": 2.0 * s02 * torch.ones(
            x1.shape[0], dtype=C.dtype, device=C.device) / sigma_0}
        for key, dCk in dC.items():
            dK[key] = torch.sum(x1 * (x1 @ dCk.T), dim=1)
        return K, dK

    same = x2 is None
    x2c = x1 if same else x2
    Cx1 = x1 @ C.T
    Cx2 = Cx1 if same else x2c @ C.T
    X1 = torch.sqrt(torch.sum(x1 * Cx1, dim=1) + s02)
    X2 = torch.sqrt(torch.sum(x2c * Cx2, dim=1) + s02)
    X1X2 = torch.outer(X1, X2)
    x1x2 = x1 @ Cx2.T + s02
    cosdelta = torch.clamp(x1x2 / (X1X2 + COSDELTA_JITTER), -1.0, 1.0)
    delta = torch.acos(cosdelta)
    J = (torch.sqrt(torch.clamp(1.0 - cosdelta ** 2, min=0.0))
         + math.pi * cosdelta - delta * cosdelta) / math.pi
    K = X1X2 * J

    dK = {}
    dX1X2_s = s02 * (X2[None, :] / X1[:, None] + X1[:, None] / X2[None, :])
    dcos_s = (2.0 * s02 - cosdelta * dX1X2_s) / X1X2
    dJ_s = -(delta - math.pi) * dcos_s / math.pi
    dK["sigma_0"] = (X1X2 * dJ_s + dX1X2_s * J) / sigma_0

    for key, dCk in dC.items():
        dX1 = 0.5 * torch.sum(x1 * (x1 @ dCk.T), dim=1) / X1
        dX2 = 0.5 * torch.sum(x2c * (x2c @ dCk.T), dim=1) / X2
        dX1X2 = torch.outer(dX1, X2) + torch.outer(X1, dX2)
        dcos = (x1 @ (x2c @ dCk.T).T - cosdelta * dX1X2) / X1X2
        dJ = -(delta - math.pi) * dcos / math.pi
        dK[key] = X1X2 * dJ + dX1X2 * J

    if x1.shape[0] == x2c.shape[0] and same:
        K = 0.5 * (K + K.T)
    return K, dK


def lambda_moment_grads(a: torch.Tensor, K_b: torch.Tensor,
                        m_b: torch.Tensor, V_b: torch.Tensor, dK_b: Grads,
                        dK_tilde_b: Grads, dKvec: Grads,
                        K_tilde_inv_b: torch.Tensor) -> Tuple[Grads, Grads]:
    """d(lambda_m)/dtheta and d(lambda_var)/dtheta through
    ``da = (dK - a dK_tilde) K_tilde^-1`` (reference: utils.py:1105-1121)."""
    dlm, dlv = {}, {}
    Va = V_b @ a.T
    for key in dK_b:
        da = (dK_b[key] - a @ dK_tilde_b[key]) @ K_tilde_inv_b
        dlm[key] = da @ m_b
        dlv[key] = (dKvec[key]
                    + torch.einsum("ij,ji->i", 2.0 * da, Va)
                    - torch.einsum("ij,ij->i", dK_b[key], a)
                    - torch.einsum("ij,ij->i", K_b, da))
    return dlm, dlv


def ell_grads_theta(r: torch.Tensor, f_mean: torch.Tensor,
                    logA: torch.Tensor, dlambda_m: Grads,
                    dlambda_var: Grads) -> Grads:
    """dELL/dtheta (reference: utils.py:1261-1267)."""
    A = torch.exp(logA)
    out = {}
    for key in dlambda_m:
        out[key] = (A * r @ dlambda_m[key]
                    - A * f_mean @ dlambda_m[key]
                    - 0.5 * A * A * f_mean @ dlambda_var[key])
    return out


def kl_grads_theta(m_b: torch.Tensor, V_b: torch.Tensor,
                   K_tilde_inv_b: torch.Tensor, dK_tilde_b: Grads) -> Grads:
    """dKL/dtheta through ``Bk = dK_tilde K_tilde^-1``:
    0.5 tr(Bk) - 0.5 tr(V K^-1 Bk) - 0.5 (K^-1 m)^T Bk m
    (reference: utils.py:1328-1335)."""
    c = V_b @ K_tilde_inv_b
    b = K_tilde_inv_b @ m_b
    out = {}
    for key in dK_tilde_b:
        Bk = dK_tilde_b[key] @ K_tilde_inv_b
        out[key] = (0.5 * torch.trace(Bk) - 0.5 * torch.trace(c @ Bk)
                    - 0.5 * b @ (Bk @ m_b))
    return out


def analytic_mstep_grad(theta: Theta, x: torch.Tensor, xtilde: torch.Tensor,
                        r: torch.Tensor, es: Eigenspace, m_b: torch.Tensor,
                        V_b: torch.Tensor, f_params: Dict[str, torch.Tensor],
                        n_px_side: int,
                        alpha_threshold: float = ALPHA_THRESHOLD) -> Grads:
    """The gradient of the M-step objective -(ELL - KL) at the fixed
    eigenspace ``es`` (``models/fit._mstep_objective``, full-rank exact
    inverse), composed from the functions above on the full pixel grid:
    the reference's moments_gradients.ipynb chain, as the JAX package's
    tests/test_gradients.py composes it."""
    C, _, dC = localker_with_grads(theta, n_px_side, alpha_threshold)
    K_tilde, dK_tilde = acosker_with_grads(theta, xtilde, None, C, dC)
    K, dK = acosker_with_grads(theta, x, xtilde, C, dC)
    Kvec, dKvec = acosker_with_grads(theta, x, None, C, dC, diag=True)
    del C, dC

    B = es.B
    K_tilde_b = B.T @ K_tilde @ B
    K_tilde_b = 0.5 * (K_tilde_b + K_tilde_b.T)
    K_b = K @ B
    K_tilde_inv_b = masked_inverse_spd(K_tilde_b, es.keep)
    a = K_b @ K_tilde_inv_b
    dK_tilde_b = {k: B.T @ v @ B for k, v in dK_tilde.items()}
    dK_b = {k: v @ B for k, v in dK.items()}

    lam_m, lam_var = lambda_moments(a, K_b, Kvec, m_b, V_b)
    f_mean = mean_f_given_lambda_moments(f_params, lam_m, lam_var)
    dlm, dlv = lambda_moment_grads(a, K_b, m_b, V_b, dK_b, dK_tilde_b,
                                   dKvec, K_tilde_inv_b)
    dell = ell_grads_theta(r, f_mean, f_params["logA"], dlm, dlv)
    dkl = kl_grads_theta(m_b, V_b, K_tilde_inv_b, dK_tilde_b)
    return {k: -(dell[k] - dkl[k]) for k in GRAD_KEYS}
