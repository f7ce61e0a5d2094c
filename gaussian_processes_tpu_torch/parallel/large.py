"""The large-ntilde path: the arc-cosine Gram and its Cholesky factor at
>= 50k points, on one device or over the mesh's "data" axis
(counterpart of ``gaussian_processes_tpu/parallel/large.py``).

What it serves is the conjugate (Gaussian-likelihood) limit of the model at
a scale the reference never attempts: the posterior-mean weights
``alpha = (K_tilde + noise_var I)^-1 y`` and the predictive mean
``mu* = K* alpha``.  At n = 50,000 the float32 Gram is 10 GB.

``large_gram`` computes the O(n) pieces once and then each row block of
``nb`` rows through the Gram kernel straight into its rows of one (n, n)
buffer (``acos_gram(..., out=K[r0:r0 + nb])``); the split pass re-splits
the smoothed images for every block.  ``large_cholesky`` adds the jitter to
the diagonal in place and factors with ``torch.linalg.cholesky`` into the
same buffer.  The JAX single-device route is a host loop of donated
left-looking block steps with a ~6x FLOP overcount, a workaround for the
TPU's memory and compiler; one cuSOLVER call replaces it.

``mesh=``: the JAX package's rule, the mesh route only when
``mesh[axis]`` has more than one rank, else the single-device route.  On
the mesh each rank builds its row block of K_tilde in
``sharded_linalg.distributed_cholesky``'s layout (``block_rows``), in row
blocks of ``nb`` rows through the kernel's ``out=``, and the factor is that
function's; ``large_posterior_mean`` returns mu* and alpha whole on every
rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import resolve_device, use_full_fp32
from ..ops.gram_cuda import acos_gram
from ..ops.kernels import local_envelope, smooth_apply, smooth_factor
from .mesh import check_device
from .sharded_linalg import (block_rows, distributed_cholesky,
                             distributed_cholesky_solve)


def _on(theta, xtilde, device):
    device = resolve_device(xtilde, device)
    xtilde = torch.as_tensor(xtilde, device=device)
    if xtilde.is_cuda:
        use_full_fp32()
    theta = {k: torch.as_tensor(v, dtype=xtilde.dtype, device=device)
             for k, v in theta.items()}
    return theta, xtilde


def _gram_prep(theta: Dict[str, torch.Tensor], xtilde: torch.Tensor,
               n_px_side: int):
    """The O(n) pieces of the Gram: weighted images times Amp, smoothed
    images, and the diagonal quadratic forms."""
    alpha_eff, _, _ = local_envelope(theta, n_px_side, xtilde.dtype)
    S = smooth_factor(theta, n_px_side, xtilde.dtype)
    amp = theta["Amp"].to(xtilde.dtype)
    ut = xtilde * alpha_eff
    st = smooth_apply(S, ut, n_px_side)
    qd = amp * torch.sum(ut * st, dim=1)
    return ut * amp, st, qd


def _on_mesh(mesh, axis: str) -> bool:
    """The JAX package's rule: the mesh route when the axis has more than
    one rank."""
    return mesh is not None and mesh[axis].size() > 1


def _row_blocks(prep, sigma0: torch.Tensor, nb: int,
                rows: slice = slice(None)) -> torch.Tensor:
    """Rows ``rows`` (default all) of the (n, n) Gram from ``_gram_prep``'s
    pieces, ``nb`` rows per kernel launch, each block written in place."""
    ut_amp, st, qd = prep
    n = st.shape[0]
    lo, hi, _ = rows.indices(n)
    K = torch.empty((hi - lo, n), dtype=st.dtype, device=st.device)
    for r0 in range(lo, hi, nb):
        r1 = min(r0 + nb, hi)
        acos_gram(ut_amp[r0:r1], st, qd[r0:r1], qd, sigma0,
                  out=K[r0 - lo:r1 - lo])
    return K


def large_gram(theta, xtilde, n_px_side: int, nb: int = 8192,
               device=None, mesh=None, axis: str = "data") -> torch.Tensor:
    """K_tilde = gram(xtilde, xtilde), (n, n), built in row blocks of
    ``nb`` rows written in place; not symmetrized (the product is symmetric
    up to rounding, and the Cholesky reads the lower triangle).  ``device``:
    as ``fit_population``'s (xtilde's own, else the card).  On the mesh
    (module docstring), this rank's ``block_rows`` of it, (rows, n)."""
    theta, xtilde = _on(theta, xtilde, device)
    rows = slice(None)
    if _on_mesh(mesh, axis):
        check_device(mesh, xtilde, "xtilde")
        rows = block_rows(xtilde.shape[0], mesh, axis)
    with torch.no_grad():
        return _row_blocks(_gram_prep(theta, xtilde, n_px_side),
                           theta["sigma_0"], nb, rows)


def large_cholesky(A: torch.Tensor, jitter: float = 0.0,
                   nb: int = 4096, mesh=None,
                   axis: str = "data") -> torch.Tensor:
    """Lower Cholesky factor of A + jitter I, computed in A's own buffer
    (A is overwritten, as the JAX route donates it).  ``nb`` is the JAX
    route's block size, kept for its signature; cuSOLVER blocks on its
    own.  On the mesh, A is this rank's row block (``large_gram``'s) and
    the result its row block of the factor (``distributed_cholesky``)."""
    del nb
    if _on_mesh(mesh, axis):
        return distributed_cholesky(A, mesh, axis, jitter=jitter)
    with torch.no_grad():
        A.diagonal().add_(jitter)
        return torch.linalg.cholesky(A, out=A)


def large_posterior_mean(theta, xtilde, y, xstar, n_px_side: int,
                         noise_var: float = 1.0, nb: int = 8192,
                         device=None, mesh=None, axis: str = "data"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conjugate-limit posterior mean at >= 50k points: ``(mu_star,
    alpha)`` with alpha = (K_tilde + noise_var I)^-1 y by two triangular
    solves against ``large_cholesky``'s factor of ``large_gram``'s (``nb``
    rows per block), and mu* = K(xstar, xtilde) alpha, K* in one kernel
    launch from the same smoothed images.  On the mesh (module docstring)
    alpha comes from ``distributed_cholesky_solve``, and both are whole on
    every rank."""
    theta, xtilde = _on(theta, xtilde, device)
    sigma0 = theta["sigma_0"]
    with torch.no_grad():
        prep = _gram_prep(theta, xtilde, n_px_side)
        if _on_mesh(mesh, axis):
            check_device(mesh, xtilde, "xtilde")
            K_rows = _row_blocks(prep, sigma0, nb,
                                 block_rows(xtilde.shape[0], mesh, axis))
            L_rows = distributed_cholesky(K_rows, mesh, axis,
                                          jitter=noise_var)
            y = torch.as_tensor(y, dtype=L_rows.dtype, device=L_rows.device)
            alpha = distributed_cholesky_solve(L_rows, y, mesh, axis)
            del K_rows, L_rows
        else:
            L = large_cholesky(_row_blocks(prep, sigma0, nb),
                               jitter=noise_var)
            y = torch.as_tensor(y, dtype=L.dtype, device=L.device)[:, None]
            alpha = torch.linalg.solve_triangular(L, y, upper=False)
            alpha = torch.linalg.solve_triangular(L.mT, alpha,
                                                  upper=True)[:, 0]
            del L
        xstar = torch.as_tensor(xstar, dtype=xtilde.dtype,
                                device=xtilde.device)
        us_amp, _, qs = _gram_prep(theta, xstar, n_px_side)
        _, st, qd = prep
        K_star = acos_gram(us_amp, st, qs, qd, sigma0)
        return K_star @ alpha, alpha
