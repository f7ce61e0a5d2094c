"""Hyperparameter encodings, bounds and initialization
(counterpart of ``gaussian_processes_tpu/params.py``).

theta is a dict of six 0-d tensors with the reference's keys
(Spatial_GP_repo/utils.py:824); the encodings follow
Spatial_GP_repo/hyperparameters_conversion.txt and utils.py:713-734.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

THETA_KEYS = ("sigma_0", "eps_0x", "eps_0y", "-2log2beta", "-log2rho2", "Amp")

Theta = Dict[str, torch.Tensor]


def logbetaexpr_to_beta(logbetaexpr):
    """Learning-space encoding -> paper beta (reference: utils.py:713-717)."""
    return torch.exp(-0.5 * torch.as_tensor(logbetaexpr)) * 0.5


def beta_to_logbetaexpr(beta):
    return -2.0 * torch.log(2.0 * torch.as_tensor(beta))


def logrhoexpr_to_rho(logrhoexpr):
    """Learning-space encoding -> paper rho (reference: utils.py:719-724)."""
    return torch.exp(-0.5 * torch.as_tensor(logrhoexpr)) / math.sqrt(2.0)


def rho_to_logrhoexpr(rho):
    rho = torch.as_tensor(rho)
    return -torch.log(2.0 * rho * rho)


def fromlogbetasam_to_logbetaexpr(logbetasam):
    """NumPy-ancestor encoding -> this encoding (reference: utils.py:726-729)."""
    return logbetasam - math.log(2.0)


def fromlogrhosam_to_logrhoexpr(logrhosam):
    """NumPy-ancestor encoding -> this encoding (reference: utils.py:731-734)."""
    return logrhosam - math.log(2.0)


def get_sta(x: torch.Tensor, r: torch.Tensor, n_px_side: int):
    """Spike-triggered average and its peak pixel (reference:
    utils.py:736-753).  x: (nt, nx), r: (nt,).
    Returns (sta, sta_variance, (row_idx, col_idx))."""
    nt = r.shape[0]
    img_mean = x.T @ torch.ones_like(r) / nt
    sta = x.T @ r / nt - img_mean
    max_idx = torch.argmax(torch.abs(sta))
    row_idx = max_idx // n_px_side
    col_idx = max_idx % n_px_side
    sta_variance = torch.tensor(10.0, dtype=x.dtype, device=x.device)
    return sta, sta_variance, (row_idx, col_idx)


def theta_bounds() -> Tuple[Dict[str, float], Dict[str, float]]:
    """Box constraints on theta (reference: utils.py:854-855)."""
    inf = float("inf")
    lower = {"sigma_0": 0.0, "eps_0x": -1.0, "eps_0y": -1.0,
             "-2log2beta": -inf, "-log2rho2": -inf, "Amp": 0.0}
    upper = {"sigma_0": inf, "eps_0x": 1.0, "eps_0y": 1.0,
             "-2log2beta": inf, "-log2rho2": inf, "Amp": inf}
    return lower, upper


def generate_theta(x: torch.Tensor, r: torch.Tensor, n_px_side: int,
                   **overrides) -> Tuple[Theta, Dict[str, float],
                                         Dict[str, float]]:
    """Initial theta + bounds (reference defaults, utils.py:755-857):
    sigma_0 = Amp = 1, RF centre at the origin, beta from a 10 px^2 RF
    width, rho = beta / 2.  ``overrides`` replace individual entries."""
    rf_width_pxl = math.sqrt(10.0)
    beta = (rf_width_pxl / n_px_side) * 2.0   # to [-1, 1] coordinates
    rho = beta / 2.0
    values = {
        "sigma_0": 1.0, "eps_0x": 0.0, "eps_0y": 0.0,
        "-2log2beta": -2.0 * math.log(2.0 * beta),
        "-log2rho2": -math.log(2.0 * rho * rho),
        "Amp": 1.0,
    }
    for key, value in overrides.items():
        if key in values:
            values[key] = value
    theta = {k: torch.as_tensor(v, dtype=x.dtype, device=x.device)
             for k, v in values.items()}
    lower, upper = theta_bounds()
    return theta, lower, upper


def generate_xtilde(ntilde: int, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random inducing subset of x with a tiny jitter so duplicated stimuli
    cannot make K_tilde exactly singular (reference: utils.py:705-711).

    ``idx`` picks the rows; without it they come from a permutation drawn
    from ``generator`` (a CPU ``torch.Generator``).  The jitter is drawn
    from the same generator."""
    if idx is None:
        idx = torch.randperm(x.shape[0], generator=generator)[:ntilde]
    xt = x[idx.to(x.device)]
    eps = torch.finfo(x.dtype).eps * 10
    noise = torch.randn(xt.shape, generator=generator, dtype=x.dtype)
    return xt + eps * noise.to(x.device)


def theta_from_samuele(logsigma_b, logrho_sam, eps_0x, eps_0y, logbeta_sam,
                       Amp=1.0, dtype=torch.float32, device=None) -> Theta:
    """Import hyperparameters in the NumPy-ancestor ("Samuele") encoding
    (the workflow of the reference's import_initialized_theta.ipynb;
    Spatial_GP_repo/hyperparameters_conversion.txt:40-85):

        sigma_0    = exp(logsigma_b)
        -2log2beta = logbeta_sam - log 2
        -log2rho2  = logrho_sam - log 2

    0-d tensors of ``dtype`` on ``device`` (torch's default when None), as
    ``default_f_params`` makes them."""
    values = {
        "sigma_0": math.exp(float(logsigma_b)),
        "eps_0x": float(eps_0x),
        "eps_0y": float(eps_0y),
        "-2log2beta": float(logbeta_sam) - math.log(2.0),
        "-log2rho2": float(logrho_sam) - math.log(2.0),
        "Amp": float(Amp),
    }
    return {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in values.items()}


def default_f_params(dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Firing-rate parameters {logA, lambda0}
    (reference: one_cell_fit.ipynb:cell6 -- A=0.01, lambda0=1)."""
    return {"logA": torch.tensor(math.log(0.01), dtype=dtype, device=device),
            "lambda0": torch.tensor(1.0, dtype=dtype, device=device)}


def theta_in_bounds(theta: Theta, lower=None, upper=None) -> torch.Tensor:
    """0-d bool: every entry inside its box (reference: utils.py:2022-2028)."""
    if lower is None or upper is None:
        lower, upper = theta_bounds()
    ok = torch.ones((), dtype=torch.bool, device=theta["Amp"].device)
    for key in THETA_KEYS:
        v = theta[key]
        ok = ok & (v >= lower[key]) & (v <= upper[key])
    return ok


def clip_theta(theta: Theta, lower=None, upper=None) -> Theta:
    """Project theta onto its box (keeps gradients finite while the line
    search rejects out-of-bounds trial points with an inf loss).  A
    ``maximum``/``minimum`` pair, so a value exactly on a bound passes half
    the gradient, as ``jnp.clip`` does."""
    if lower is None or upper is None:
        lower, upper = theta_bounds()
    out = {}
    for key in THETA_KEYS:
        v = theta[key]
        # full_like, not as_tensor: no host-to-device copy of the bound
        lo = torch.full_like(v, lower[key])
        hi = torch.full_like(v, upper[key])
        out[key] = torch.minimum(torch.maximum(v, lo), hi)
    return out
