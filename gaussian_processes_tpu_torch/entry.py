"""The entry point (counterpart of ``__graft_entry__.py::entry``): a
forward step of the flagship model -- batched posterior-predictive firing
rates of a fitted spatial GP (the Kronecker-factored localized + smooth
prior through the Gram kernel, the stabilized posterior moments, the
exponential Poisson link).  The multi-device dry run waits for the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .models.inference import predict_rates
from .ops.kernels import gram_matrices
from .ops.stabilize import compute_eigenspace
from .params import default_f_params, generate_theta

N_PX, NTILDE, BATCH = 108, 128, 32


def entry(device=None):
    """``(forward, example_args)``: 32 stimuli of 108 x 108 px against 128
    inducing points in float32, drawn from ``np.random.default_rng(0)`` as
    the JAX entry draws them, with the prior state (m = 0, V = K_tilde) of
    the start theta.  On the CUDA card unless ``device`` says otherwise.
    ``forward(*example_args)`` returns the rates, through the Gram kernel
    on the card."""
    device = resolve_device(None, device)
    rng = np.random.default_rng(0)
    dtype = torch.float32
    xtilde = torch.as_tensor(rng.standard_normal((NTILDE, N_PX * N_PX)),
                             dtype=dtype, device=device)
    xstar = torch.as_tensor(rng.standard_normal((BATCH, N_PX * N_PX)),
                            dtype=dtype, device=device)
    theta, _, _ = generate_theta(
        xtilde, torch.ones(NTILDE, dtype=dtype, device=device), N_PX)
    f_params = default_f_params(dtype, device)

    # a fitted-model-like state (the prior: m = 0, V = K_tilde)
    with torch.no_grad():
        K_tilde, _, _ = gram_matrices(theta, xtilde, xtilde, N_PX,
                                      shared=True)
        es = compute_eigenspace(K_tilde)
    m_b = torch.zeros(NTILDE, dtype=dtype, device=device)
    V_b = torch.diag(es.k_tilde_b_diag)

    def forward(xstar, theta, f_params, m_b, V_b, B, kdiag, kinv):
        rates, _, _ = predict_rates(xstar, xtilde, theta, f_params, m_b, V_b,
                                    B, kdiag, kinv, n_px_side=N_PX)
        return rates

    example_args = (xstar, theta, f_params, m_b, V_b, es.B,
                    es.k_tilde_b_diag, es.k_tilde_inv_diag)
    return forward, example_args


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
