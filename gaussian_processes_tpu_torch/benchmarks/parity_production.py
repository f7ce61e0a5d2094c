"""Posterior parity at production shape: the float32 pipeline against
float64 (counterpart of ``benchmarks/parity_production.py``; BASELINE.json's
acceptance: the posterior mean and variance within 1e-5 relative).

    python -m gaussian_processes_tpu_torch.benchmarks.parity_production

The script's pipeline (``posterior_pipeline``, the same code in every
precision): ``gram_matrices`` (K_tilde, K, Kvec), the eigendecomposition
of K_tilde and its keep mask (an ``Eigenspace``), 8 Newton E-steps
(``estep_update``) each after the closed-form lambda0
(``lambda0_given_logA``, ``mean_f_given_lambda_moments``,
``lambda_moments``), then the posterior moments at 64 held-out points
(``lambda_moments_star``), at nt 3,160, 108 x 108 px and ntilde 1,050.  The
keep count is the float64 arm's in every arm, so the comparison reads
arithmetic, not a borderline eigendirection that one precision keeps and
the other drops (the moments do not depend on the kept subspace's basis).

Arms, each against the float64 arm (``rel_mu``, ``rel_var``: the largest
absolute difference over the largest float64 magnitude; ``pass``: both
<= 1e-5):

* ``float64``: every stage in float64, the plain Gram (the reference);
* ``kernel``: every stage in float32 with TF32 off, the Gram through the
  3xTF32 kernel: the port's recorded choice (docs/torch_precision.md) and
  what ``value`` reports;
* ``plain32``: every stage in float32, the plain Gram (the kernel's share
  of the error is the difference from ``kernel``);
* one stage at a time in float32, the rest in float64: ``gram32`` (the
  Gram through the kernel), ``eigh32`` (the eigendecomposition) and
  ``estep32`` (the projections, moments and E-steps);
* ``eigh64``: as ``kernel``, with the eigendecomposition in float64;
* ``tf32_smoothing``: as ``kernel``, with TF32 on while the Grams are
  built, where only the smoothing products run as cuBLAS matmuls.

On the CPU the kernel arms run the kernel's plain forward, and TF32 does
not exist.  ``main`` exits 1 when the ``kernel`` arm misses 1e-5.

Not ported: the script's CPU-only set-up (``JAX_PLATFORMS=cpu``, float64
switched on), which the card does not need.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from ..bench import card_info
from ..config import EIGVAL_TOL, resolve_device, use_full_fp32
from ..models.estep import estep_update
from ..models.moments import (lambda0_given_logA, lambda_moments,
                              lambda_moments_star,
                              mean_f_given_lambda_moments)
from ..ops.kernels import gram_matrices
from ..ops.stabilize import Eigenspace
from . import common

NT = 3160
N_PX = 108
NTILDE = 1050
N_STAR = 64
N_NEWTON = 8
TARGET = 1e-5
THETA = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
         "-2log2beta": float(-2 * np.log(2 * 0.1)),
         "-log2rho2": float(-np.log(2 * 0.1 ** 2)), "Amp": 1.0}
F_PARAMS = {"logA": float(np.log(0.01)), "lambda0": 1.0}

F32, F64 = torch.float32, torch.float64
# name: (Gram dtype, eigh dtype, E-step dtype, Gram backend, TF32 in the
# Gram); backend None is the kernel on the card
ARMS = {
    "float64": (F64, F64, F64, "torch", False),
    "kernel": (F32, F32, F32, None, False),
    "plain32": (F32, F32, F32, "torch", False),
    "gram32": (F32, F64, F64, None, False),
    "eigh32": (F64, F32, F64, "torch", False),
    "estep32": (F64, F64, F32, "torch", False),
    "eigh64": (F32, F64, F32, None, False),
    "tf32_smoothing": (F32, F32, F32, None, True),
}


def make_data(nt: int = NT, n_px: int = N_PX, ntilde: int = NTILDE,
              n_star: int = N_STAR):
    """The script's arrays, float64: (X, R, Xtilde, Xstar)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((nt, n_px * n_px))
    Xstar = rng.standard_normal((n_star, n_px * n_px))
    w = common.planted_rf(n_px, 0.1, -0.2)
    R = rng.poisson(np.exp(0.8 * X @ w)).astype(np.float64)
    Xtilde = X[rng.permutation(nt)[:ntilde]]
    return X, R, Xtilde, Xstar


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 on in the block (on the card), off after it."""
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        use_full_fp32()


def posterior_pipeline(data, n_px: int, arm=ARMS["float64"], n_keep=None,
                       n_newton: int = N_NEWTON, device=None):
    """Grams -> stabilized eigenspace -> Newton E-steps -> the held-out
    posterior moments, each stage in its dtype of ``arm`` (an ``ARMS``
    value).  Returns (mu*, sigma*^2, n_keep) in float64."""
    g_dt, e_dt, s_dt, backend, tf32 = arm
    X, R, Xtilde, Xstar = (torch.as_tensor(a, dtype=g_dt, device=device)
                           for a in data)
    theta = {k: torch.tensor(v, dtype=g_dt, device=device)
             for k, v in THETA.items()}
    with torch.no_grad(), _tf32(tf32):
        K_tilde, K, Kvec = gram_matrices(theta, X, Xtilde, n_px,
                                         shared=False, backend=backend)
        _, K_star, Kvec_star = gram_matrices(theta, Xstar, Xtilde, n_px,
                                             shared=False, backend=backend)
    with torch.no_grad():
        eigvals, eigvecs = torch.linalg.eigh(K_tilde.to(e_dt))
        n = eigvals.shape[0]
        if n_keep is None:
            thresh = max(float(eigvals[-1]) * EIGVAL_TOL, EIGVAL_TOL)
            n_keep = int(torch.sum(eigvals > thresh))
        eigvals, eigvecs = eigvals.to(s_dt), eigvecs.to(s_dt)
        keep = torch.arange(n, device=eigvals.device) >= n - n_keep
        keepf = keep.to(s_dt)
        safe = torch.where(keep, eigvals, torch.ones_like(eigvals))
        es = Eigenspace(B=eigvecs * keepf[None, :], eigvals=eigvals,
                        keep=keep, k_tilde_b_diag=eigvals * keepf,
                        k_tilde_inv_diag=keepf / safe)
        K, Kvec, R = K.to(s_dt), Kvec.to(s_dt), R.to(s_dt)
        K_b = K @ es.B
        a = K_b * es.k_tilde_inv_diag[None, :]
        m_b = torch.zeros(n, dtype=s_dt, device=eigvals.device)
        V_b = torch.diag(es.k_tilde_b_diag)
        f_params = {k: torch.tensor(v, dtype=s_dt, device=eigvals.device)
                    for k, v in F_PARAMS.items()}
        lam_m, lam_var = lambda_moments(a, K_b, Kvec, m_b, V_b)
        for _ in range(n_newton):
            lam0 = lambda0_given_logA(f_params["logA"], R, lam_m, lam_var)
            f_params = {"logA": f_params["logA"], "lambda0": lam0}
            f_mean = mean_f_given_lambda_moments(f_params, lam_m, lam_var)
            m_b, V_b = estep_update(R, a, m_b, f_mean, es.k_tilde_b_diag,
                                    f_params)
            lam_m, lam_var = lambda_moments(a, K_b, Kvec, m_b, V_b)
        K_star_b = K_star.to(s_dt) @ es.B
        a_star = K_star_b * es.k_tilde_inv_diag[None, :]
        mu, var = lambda_moments_star(a_star, K_star_b, Kvec_star.to(s_dt),
                                      m_b, V_b, es.k_tilde_b_diag)
    return mu.double().cpu(), var.double().cpu(), n_keep


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.max(torch.abs(got - want))
                 / torch.max(torch.abs(want)))


def run(nt: int = NT, n_px: int = N_PX, ntilde: int = NTILDE,
        n_star: int = N_STAR, n_newton: int = N_NEWTON, device=None,
        dtype=torch.float32):
    """Every arm of ``ARMS`` against the float64 arm (see the module
    docstring).  ``dtype`` is the production arm's and
    must be float32.  Returns ``(record, values)``: ``values[name]`` =
    (mu*, sigma*^2) in float64 on the CPU."""
    if dtype != torch.float32:
        raise ValueError(f"the production arm is float32, got {dtype}")
    device = resolve_device(None, device)
    if device.type == "cuda":
        use_full_fp32()
    data = make_data(nt, n_px, ntilde, n_star)
    values, detail, seconds = {}, {}, {}
    n_keep = None
    for name in ARMS:
        t0 = time.perf_counter()
        mu, var, n_keep = posterior_pipeline(data, n_px, ARMS[name], n_keep,
                                             n_newton, device)
        seconds[name] = time.perf_counter() - t0
        values[name] = (mu, var)
        if name == "float64":
            continue
        mu64, var64 = values["float64"]
        rel_mu, rel_var = _rel(mu, mu64), _rel(var, var64)
        detail[name] = {"rel_mu": rel_mu, "rel_var": rel_var,
                        "pass": bool(max(rel_mu, rel_var) <= TARGET),
                        "seconds": seconds[name]}
    mu64, var64 = values["float64"]
    finite = bool(torch.all(torch.isfinite(mu64))
                  and torch.all(torch.isfinite(var64)))
    prod = detail.get("kernel")
    worst = max(prod["rel_mu"], prod["rel_var"]) if prod else float("nan")
    record = {
        "metric": "posterior_parity_f32_vs_f64",
        "value": worst,
        "unit": "max_rel_err",
        "vs_baseline": TARGET / worst if prod and worst > 0 else 0.0,
        "detail": {"nt": nt, "nx": n_px * n_px, "ntilde": ntilde,
                   "n_star": n_star, "n_keep": n_keep, "target": TARGET,
                   "float64_s": seconds["float64"],
                   **({k: prod[k] for k in ("rel_mu", "rel_var", "pass")}
                      if prod else {})},
        "arms": detail,
        "device": card_info(device),
        "ok": bool(finite and prod is not None and prod["pass"]),
    }
    return record, values


def main() -> int:
    record, _ = run()
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
