"""Training dashboards and fit-quality plots (counterpart of
``gaussian_processes_tpu/utils/plotting.py``; reference
Spatial_GP_repo/utils.py:111-310 ``plot_loss_and_theta_notebook``,
1543-1563 ``plot_fit``), driven by a FitResult.  matplotlib is imported
inside each function, so nothing else in the package needs it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import logbetaexpr_to_beta, logrhoexpr_to_rho


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def plot_training_dashboard(result, figsize=(14, 10), xlim=None):
    """4-panel dashboard: loss decomposition, hyperparameters, f-params,
    kept eigenvalue count / variational summaries."""
    import matplotlib.pyplot as plt

    t = result.track
    logm = _host(t.logmarginal)
    ell = _host(t.loglikelihood)
    kl = _host(t.KL)
    theta = {k: _host(v) for k, v in t.theta.items()}
    it = np.arange(len(logm))

    fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=figsize)

    ax1.plot(it, -logm, "o-", color="tab:blue", label="-logmarginal")
    ax1b = ax1.twinx()
    ax1b.plot(it, ell, "s--", color="tab:green", label="loglikelihood")
    ax1b.plot(it, kl, "^--", color="tab:red", label="KL")
    ax1.set_xlabel("iteration"); ax1.set_ylabel("-logmarginal")
    ax1.set_title("loss = KL - loglikelihood")
    ax1.grid(alpha=0.3)

    beta = _host(logbetaexpr_to_beta(theta["-2log2beta"]))
    rho = _host(logrhoexpr_to_rho(theta["-log2rho2"]))
    for key in ("sigma_0", "eps_0x", "eps_0y", "Amp"):
        ax2.plot(it, theta[key], label=key)
    ax2.plot(it, beta, label="beta")
    ax2.plot(it, rho, label="rho")
    ax2.set_xlabel("iteration"); ax2.set_title("hyperparameters")
    ax2.legend(fontsize=8); ax2.grid(alpha=0.3)

    ax3.plot(it, np.exp(_host(t.logA)), "o-", color="tab:purple", label="A")
    ax3b = ax3.twinx()
    ax3b.plot(it, _host(t.lambda0), "s-", color="tab:orange",
              label="lambda0")
    ax3.set_xlabel("iteration"); ax3.set_ylabel("A")
    ax3b.set_ylabel("lambda0")
    ax3.set_title("firing-rate parameters"); ax3.grid(alpha=0.3)

    ax4.plot(it, _host(t.n_eigen), "o", color="tab:blue", label="n_eigen")
    if t.m_b.shape[1] > 0:
        m_b, V_b = _host(t.m_b), _host(t.V_b)
        ax4b = ax4.twinx()
        ax4b.plot(it, m_b.mean(axis=1), "s--", color="tab:green",
                  label="mean m_b")
        ax4b.plot(it, np.diagonal(V_b, axis1=1, axis2=2).mean(axis=1), "^--",
                  color="tab:orange", label="mean diag V_b")
    ax4.set_xlabel("iteration"); ax4.set_title("eigenspace / variational")
    ax4.grid(alpha=0.3)

    if xlim is not None:
        for ax in (ax1, ax2, ax3, ax4):
            ax.set_xlim(xlim)
    fig.suptitle(
        f"maxiter={result.config.maxiter} nEstep={result.config.n_estep} "
        f"nMstep={result.config.n_mstep} cell={result.config.cellid}")
    fig.tight_layout()
    return fig


def plot_fit(R_predicted, rtst, r2, sigma_r2, cellid=0, dt=0.05):
    """Prediction vs trial-averaged data (reference: utils.py:1543-1563)."""
    import matplotlib.pyplot as plt

    R_predicted = _host(R_predicted)
    rtst = _host(rtst)
    tvals = dt * np.arange(len(R_predicted))
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(tvals, rtst.mean(axis=0), "k", linewidth=1, label="data")
    ax.plot(tvals, R_predicted, color="red", label="GP")
    ax.set_title(f"adjusted r^2 = {float(r2):.2f} +/- "
                 f"{float(sigma_r2):.2f}  cell {cellid}")
    ax.legend()
    return fig


def plot_receptive_field(result, figsize=(5, 5)):
    """The learned RF envelope alpha over the pixel grid."""
    import matplotlib.pyplot as plt
    from ..ops.kernels import local_envelope

    n = result.config.n_px_side
    alpha, _, _ = local_envelope(result.theta, n)
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(_host(alpha).reshape(n, n), cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title("RF envelope alpha(theta)")
    return fig
