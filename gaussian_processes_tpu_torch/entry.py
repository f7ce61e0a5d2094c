"""The entry points (counterpart of ``__graft_entry__.py``):
``entry``, a forward step of the flagship model -- batched
posterior-predictive firing rates of a fitted spatial GP (the
Kronecker-factored localized + smooth prior through the Gram kernel, the
stabilized posterior moments, the exponential Poisson link) -- and
``dryrun_multichip``, the parity gate of the population EM over a
("cells", "data") mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .config import FitConfig, resolve_device
from .models.inference import predict_rates
from .ops.kernels import gram_matrices
from .ops.stabilize import compute_eigenspace
from .params import default_f_params, generate_theta

N_PX, NTILDE, BATCH = 108, 128, 32
# the dry run (__graft_entry__.py:118-137): 24 x 24 px, 256 training
# points, 64 inducing rows, 3 EM iterations of 3/3/3 steps
DRY_PX, DRY_NT, DRY_NTILDE = 24, 256, 64
# sharded against unsharded: JAX's gate in float64; in float32 on the cards
# the two summation orders of the collectives part by rounding
DRY_RTOL = {torch.float64: 1e-6, torch.float32: 1e-4}


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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The parity gate of ``__graft_entry__.dryrun_multichip``: the whole
    population EM (kernels, eigh stabilization, Newton E-steps, the f-param
    and M-step L-BFGS) run sharded over a ("cells", "data") mesh of
    ``n_devices`` ranks -- (n/2, 2) when n is even and >= 4, else (n, 1) --
    and unsharded, at JAX's shapes and depth; every log-marginal finite,
    the sharded trajectory and m_b within DRY_RTOL of the unsharded run's,
    and the last log-marginal above the first.  Raises on a failure.

    ``device=None``: n ranks on n cards over NCCL in float32 (raises with
    fewer cards); ``device="cpu"``: a gloo world of n CPU processes in
    float64 (JAX's own gate runs on virtual CPU devices in float64).  A
    caller that is already a rank of a world of n runs its share inline,
    on its group's device.  The inducing rows are drawn by
    ``numpy.random.default_rng(0).permutation`` (JAX draws them with
    ``PRNGKey(0)``; no stream reproduces it)."""
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        backend_device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if device is not None and torch.device(device).type != (
                backend_device):
            raise ValueError(f"this world's {dist.get_backend()} group runs "
                             f"on {backend_device!r}, not {device!r}")
        _dryrun_rank()
        return
    from .parallel.mesh import run_world
    if device is not None and torch.device(device).type != "cpu":
        raise ValueError(f"device must be None (the cards) or 'cpu', not "
                         f"{device!r}")
    run_world(_dryrun_rank, n_devices,
              backend="nccl" if device is None else "gloo")


def _dryrun_rank() -> None:
    """One rank's share of ``dryrun_multichip`` (a world is initialized)."""
    from .parallel import fit_population, make_mesh

    n = dist.get_world_size()
    mesh = (make_mesh(n // 2, 2) if n % 2 == 0 and n >= 4
            else make_mesh(n, 1))
    on_cuda = mesh.device_type == "cuda"
    device = torch.device("cuda") if on_cuda else torch.device("cpu")
    dtype = torch.float32 if on_cuda else torch.float64
    ncells = mesh.size(0)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((DRY_NT, DRY_PX * DRY_PX))
    lin = np.linspace(-1, 1, DRY_PX)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2)).ravel()
    w = w / np.linalg.norm(w)
    R = rng.poisson(np.exp(0.6 * X @ w)[None, :].repeat(ncells, 0))
    idx = np.random.default_rng(0).permutation(DRY_NT)[:DRY_NTILDE]
    x = torch.as_tensor(X, dtype=dtype, device=device)
    r = torch.as_tensor(R, dtype=dtype, device=device)
    cfg = FitConfig(ntilde=DRY_NTILDE, maxiter=3, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=DRY_PX, track_variational=True)
    xtilde = x[torch.as_tensor(idx, device=device)]
    sharded, _ = fit_population(x, r, cfg, xtilde=xtilde, mesh=mesh)
    loss = sharded.track.logmarginal.double().cpu().numpy()
    if loss.shape != (ncells, cfg.maxiter) or not np.all(np.isfinite(loss)):
        raise RuntimeError(f"the multichip dry run's log-marginals are not "
                           f"finite of shape {(ncells, cfg.maxiter)}: {loss}")
    # the same program unsharded
    unsharded, _ = fit_population(x, r, cfg, xtilde=xtilde)
    loss_un = unsharded.track.logmarginal.double().cpu().numpy()
    rtol = DRY_RTOL[dtype]
    np.testing.assert_allclose(
        loss, loss_un, rtol=rtol, err_msg="sharded population loss "
        "trajectory diverged from the unsharded run")
    np.testing.assert_allclose(
        sharded.m_b.double().cpu().numpy(),
        unsharded.m_b.double().cpu().numpy(), rtol=rtol, atol=1e-8,
        err_msg="sharded posterior mean diverged")
    # a frozen or rolled-back fit would pass the parity checks alone
    if not np.all(loss[:, -1] > loss[:, 0]):
        raise RuntimeError("population EM failed to improve the "
                           "log-marginal")


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
