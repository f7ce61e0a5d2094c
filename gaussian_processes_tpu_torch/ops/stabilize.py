"""Eigenspace stabilization (the reference's "_b projection";
counterpart of ``gaussian_processes_tpu/ops/stabilize.py``).

The projection keeps its full (ntilde, ntilde) shape and encodes the rank
truncation as a boolean ``keep`` vector: dropped eigendirections have their B
column zeroed, so downstream products carry exact zeros in the dropped
coordinates (reference: Spatial_GP_repo/utils.py:1682-1694, 1808-1841).
Determinants and inverses over the kept subspace pad the dropped diagonal
with ones.  The reduced-rank fit keeps only the top ``rank`` eigenpairs
(``compute_eigenspace(..., rank=)``): the same layout at width rank.

Every function also takes a leading cell axis (matrices (L, n, n), vectors
(L, n)), item by item; ``torch.linalg`` batches natively.

NaN-poison contract: a non-finite input yields NaN outputs, never an
exception, so the fit's rollback sees the failure.  ``torch.linalg.eigh``
and ``cholesky`` raise on bad input where JAX on CPU returns NaN, hence the
``isfinite`` guard in ``_eigh_safe`` and ``cholesky_ex`` with its ``info``
mapped to NaN.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import EIGVAL_TOL


class Eigenspace(NamedTuple):
    """Stabilizing eigenspace of K_tilde.

    B:               (ntilde, ntilde) eigenvectors; dropped columns zeroed.
    eigvals:         (ntilde,) raw eigenvalues (ascending).
    keep:            (ntilde,) bool; True where the eigenvalue is retained.
    k_tilde_b_diag:  (ntilde,) kept eigenvalues, 0 where dropped.
    k_tilde_inv_diag:(ntilde,) 1/eigval where kept, 0 where dropped.
    """
    B: torch.Tensor
    eigvals: torch.Tensor
    keep: torch.Tensor
    k_tilde_b_diag: torch.Tensor
    k_tilde_inv_diag: torch.Tensor


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _finite(M: torch.Tensor) -> torch.Tensor:
    """Per matrix: all entries finite (0-d, or (L,) for a batch)."""
    return torch.isfinite(M).flatten(-2).all(-1)


def _eigh_safe(M: torch.Tensor):
    """eigh with a non-finite-input guard: the factorization runs on an
    identity stand-in when M is bad, and the returned ``finite`` flag (0-d,
    or (L,) for a batch) lets the caller poison its outputs."""
    finite = _finite(M)
    M_safe = torch.where(finite[..., None, None], M, _eye_like(M))
    eigvals, eigvecs = torch.linalg.eigh(M_safe)
    return eigvals, eigvecs, finite


def _eigvalsh_safe(M: torch.Tensor):
    """``_eigh_safe`` without the eigenvectors."""
    finite = _finite(M)
    M_safe = torch.where(finite[..., None, None], M, _eye_like(M))
    return torch.linalg.eigvalsh(M_safe), finite


def _poison(ok: torch.Tensor, dtype) -> torch.Tensor:
    """0 where ``ok``, NaN otherwise (add it to poison an output)."""
    nan = torch.full((), float("nan"), dtype=dtype, device=ok.device)
    return torch.where(ok, torch.zeros((), dtype=dtype, device=ok.device),
                       nan)


def compute_eigenspace(K_tilde: torch.Tensor,
                       eigval_tol: float = EIGVAL_TOL,
                       rank: Optional[int] = None) -> Eigenspace:
    """eigh + keep-mask truncation: keep eigenvalues above
    max(lam_max * eigval_tol, eigval_tol) (reference: utils.py:1682-1694).
    A non-finite K_tilde yields NaN-poisoned outputs.

    ``rank`` keeps only the top ``rank`` eigenpairs (the LAST columns of the
    ascending eigh), so every product downstream runs at (..., rank): the
    keep-masked full-shape algebra with always-zero coordinates removed
    whenever rank covers the kept eigenvalues."""
    eigvals, eigvecs, finite = _eigh_safe(K_tilde)
    poison = _poison(finite, K_tilde.dtype)[..., None]
    eigvals = eigvals + poison
    eigvecs = eigvecs + poison[..., None]
    if rank is not None and rank < K_tilde.shape[-1]:
        eigvals = eigvals[..., -rank:]
        eigvecs = eigvecs[..., :, -rank:]
    thresh = torch.clamp(eigvals[..., -1:] * eigval_tol, min=eigval_tol)
    keep = eigvals > thresh
    keepf = keep.to(K_tilde.dtype)
    B = eigvecs * keepf[..., None, :]
    safe = torch.where(keep, eigvals, torch.ones_like(eigvals))
    return Eigenspace(
        B=B,
        eigvals=eigvals,
        keep=keep,
        k_tilde_b_diag=torch.where(keep, eigvals, 0.0) + poison,
        k_tilde_inv_diag=keepf / safe + poison,
    )


def project_gram(es: Eigenspace, K: torch.Tensor, shared: bool) -> torch.Tensor:
    """KKtilde_inv_b = K B diag(1/eig) -- the 'a' matrix of the reference
    (utils.py:1693-1694); B itself when inducing points == training
    points."""
    if shared:
        return es.B
    return (K @ es.B) * es.k_tilde_inv_diag[..., None, :]


def reproject(es_new: Eigenspace, es_old: Eigenspace,
              m_b: torch.Tensor, V_b: torch.Tensor):
    """Carry the variational state across a change of eigenspace:
    ``V_b' = R V_b R^T``, ``m_b' = R m_b`` with R = B_new^T B_old
    (reference: utils.py:1833-1841)."""
    R = es_new.B.mT @ es_old.B
    return mv(R, m_b), (R @ V_b) @ R.mT


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product, (n, k) @ (k,) or batched (L, n, k) @ (L, k)."""
    return A @ v if v.dim() == 1 else (A @ v[..., None])[..., 0]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the last axis (0-d for vectors, (L,) batched)."""
    return torch.dot(a, b) if a.dim() == 1 else (a * b).sum(-1)


def _pad_dropped(M: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return M + torch.diag_embed(1.0 - keep.to(M.dtype))


def masked_logdet_chol(M: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """log|M| on the kept subspace via Cholesky of ``M + diag(1 - keep)``.
    NaN when the kept block is not positive definite (the reference's
    raised Cholesky error, utils.py:1271-1304)."""
    L, info = torch.linalg.cholesky_ex(_pad_dropped(M, keep))
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                         dim=-1)
    return ld + _poison(info == 0, M.dtype)


def masked_logdet_eigh(M: torch.Tensor, keep: torch.Tensor,
                       eigval_tol: float = EIGVAL_TOL) -> torch.Tensor:
    """Fallback log-determinant: eigenvalues, keeping those above the
    relative threshold (reference's except-branch, utils.py:1282-1301).
    NaN when M is non-finite."""
    eigvals, finite = _eigvalsh_safe(_pad_dropped(M, keep))
    thresh = torch.clamp(eigvals[..., -1:] * eigval_tol, min=eigval_tol)
    big = eigvals > thresh
    safe = torch.where(big, eigvals, torch.ones_like(eigvals))
    return torch.sum(torch.log(safe), dim=-1) + _poison(finite, M.dtype)


def logdet_with_fallback(M: torch.Tensor, keep: torch.Tensor,
                         eigval_tol: float = EIGVAL_TOL) -> torch.Tensor:
    """Cholesky log-determinant, with the eigenvalue route where the
    factorization fails (reference: utils.py:1271-1304), per item of a
    batch.  One host sync decides whether the eigenvalue route runs at all
    (a batched eigvalsh on the card synchronizes the host several times per
    matrix)."""
    ld = masked_logdet_chol(M, keep)
    if bool(torch.isfinite(ld).all()):
        return ld
    return torch.where(torch.isfinite(ld), ld,
                       masked_logdet_eigh(M, keep, eigval_tol))


def masked_inverse_spd(M: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Inverse of the kept block of M, zero-padded on dropped rows/cols
    (reference: utils.py:2067), for a matrix whose padded kept block is
    positive definite (the M-step's K_tilde_b), from its Cholesky factor:
    L^-T L^-1 by one triangular solve.  Equal to the JAX package's LU
    ``masked_inverse`` up to rounding; NaN where the padded matrix is not
    positive definite, where the M-step's Cholesky log-determinant makes
    the loss +inf anyway.  ``cholesky_ex``
    and ``solve_triangular`` never synchronize the host, where a batched
    LU inverse on the card does, inside the library."""
    keepf = keep.to(M.dtype)
    L, info = torch.linalg.cholesky_ex(_pad_dropped(M, keep))
    L_inv = torch.linalg.solve_triangular(L, _eye_like(M).expand_as(L),
                                          upper=False)
    inv = L_inv.mT @ L_inv + _poison(info == 0, M.dtype)[..., None, None]
    return inv * keepf[..., :, None] * keepf[..., None, :]


def block_matrix_inverse(orig_inv: torch.Tensor,
                         new_column: torch.Tensor) -> torch.Tensor:
    """Inverse of the (N+1, N+1) matrix [[K, b], [b^T, d]] from inv(K) and
    new_column = [b; d] by the block (Sherman-Morrison) update: the
    reference's rank-1 growth of K_tilde (utils.py:1055-1070)."""
    b = new_column[:-1]
    d = new_column[-1]
    e = orig_inv @ b
    g = 1.0 / (d - b @ e)
    top = torch.cat([orig_inv + g * torch.outer(e, e), (-g * e)[:, None]],
                    dim=1)
    bottom = torch.cat([-g * e, g[None]])[None, :]
    return torch.cat([top, bottom], dim=0)
