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
(L, n)), item by item; ``torch.linalg`` batches natively.  The warm-started
subspace eigensolver (``subspace_eigenspace``, ``_cholqr``) serves the
single-cell reduced-rank fit and takes one matrix.

The warm solvers (``schulz_iterations``, ``masked_inverse_warm``,
``masked_logdet_series``, ``subspace_eigenspace``) replace the JAX
package's in-graph ``lax.cond`` / ``while_loop`` by a fixed number of steps
and, for their guards, never one host read per Newton-Schulz step.  The
M-step's two guards (``masked_inverse_warm``'s fallback and
``masked_logdet_series``) are decided on the device as ``lax.cond`` is:
both forms are computed and one is selected, with no host read, so a CUDA
graph can hold a whole M-step evaluation (``optim/graphed``); they are
counted on the device (``utils.tracing.decisions.count_on_device``).  The
subspace eigensolver's guard is read on the host once per call
(``models/fit._eigenspace``).

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
from ..utils.tracing import decisions


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


def _cholqr(Y: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Orthonormalize the columns of Y by (repeated) Cholesky-QR: Y L^-T
    with L the Cholesky factor of Y^T Y.  A rank-deficient or non-finite Y
    gives NaN, which the caller's fallback catches."""
    for _ in range(iters):
        G = Y.mT @ Y
        L, info = torch.linalg.cholesky_ex(G)
        L = L + _poison((info == 0) & _finite(G), Y.dtype)[..., None, None]
        Y = torch.linalg.solve_triangular(L, Y.mT, upper=False).mT
    return Y


def subspace_eigenspace(K_tilde: torch.Tensor, B_warm: torch.Tensor,
                        eigval_tol: float = EIGVAL_TOL, n_power: int = 2):
    """Warm-started top-r eigenspace of K_tilde (n, n) by ``n_power`` steps
    of subspace iteration (K_tilde Y, columns normalized, CholQR) from the
    previous basis ``B_warm`` (n, r), then Rayleigh-Ritz: an eigh at r
    instead of n.  Dead (all-zero) columns of ``B_warm`` -- dropped
    directions, or the zero padding of a grown budget -- start from
    deterministic canonical vectors (rows j * max(n // r, 1) mod n), which
    the power steps rotate into the escaped directions.

    Returns ``(es, ok)``: ``ok`` (0-d bool) is False when the iteration
    failed numerically (a rank-deficient CholQR, a non-finite input); the
    caller then takes the full eigh.

    The iteration runs in float64 whatever K_tilde's dtype, and the
    eigenspace is cast back.  Each power step leaves a direction of
    eigenvalue lambda at lambda / lambda_max of the column it came from, so
    CholQR's Gram has condition (lambda_max / lambda)^2 over the basis; the
    budget keeps columns past the kept rank, whose eigenvalues lie below
    eigval_tol lambda_max = 1e-4 lambda_max by definition, and in float32
    every such Gram (condition above 1e8) fails its Cholesky, so the warm
    solve would never hold.  In float64 it holds down to ~1e-8 lambda_max.
    On float64 inputs this is the JAX package's arithmetic."""
    n, r = B_warm.shape
    out_dtype, dev = K_tilde.dtype, K_tilde.device
    dtype = torch.float64
    K_tilde, B_warm = K_tilde.to(dtype), B_warm.to(dtype)
    rows = (torch.arange(r, device=dev) * max(n // r, 1)) % n
    filler = (torch.arange(n, device=dev)[:, None] == rows[None, :]).to(dtype)
    alive = torch.sum(B_warm * B_warm, dim=0) > 0
    Y = torch.where(alive[None, :], B_warm, filler)
    tiny = torch.finfo(dtype).tiny
    for _ in range(n_power):
        Y = K_tilde @ Y
        # unit columns before CholQR keep its Gram well scaled across the
        # spectrum's spread
        norm = torch.sqrt(torch.sum(Y * Y, dim=0))
        Y = _cholqr(Y / torch.clamp(norm, min=tiny)[None, :], iters=1)
    M = Y.mT @ (K_tilde @ Y)
    M = 0.5 * (M + M.mT)
    eigvals, U, finite = _eigh_safe(M)
    B = Y @ U
    thresh = torch.clamp(eigvals[-1] * eigval_tol, min=eigval_tol)
    keep = (eigvals > thresh) & finite
    keepf = keep.to(dtype)
    B = B * keepf[None, :]
    safe = torch.where(keep, eigvals, torch.ones_like(eigvals))
    ok = (finite & torch.isfinite(B).all()
          & torch.isfinite(eigvals).all())
    es = Eigenspace(B=torch.where(ok, B, torch.zeros_like(B)),
                    eigvals=eigvals, keep=keep,
                    k_tilde_b_diag=eigvals * keepf,
                    k_tilde_inv_diag=keepf / safe)
    return Eigenspace(*(t if t.dtype == torch.bool else t.to(out_dtype)
                        for t in es)), ok


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
    inv = _spd_inverse(_pad_dropped(M, keep))
    return inv * keepf[..., :, None] * keepf[..., None, :]


def _spd_inverse(P: torch.Tensor) -> torch.Tensor:
    """P^-1 = L^-T L^-1 from the Cholesky factor L of P by a triangular
    solve (a batched cholesky_solve on the card synchronizes the host
    inside the library); NaN where P is not positive definite."""
    L, info = torch.linalg.cholesky_ex(P)
    L_inv = torch.linalg.solve_triangular(L, _eye_like(P).expand_as(L),
                                          upper=False)
    return L_inv.mT @ L_inv + _poison(info == 0, P.dtype)[..., None, None]


def masked_logdet_series(M: torch.Tensor, keep: torch.Tensor,
                         inv_diag_warm: torch.Tensor,
                         tol: float = 0.25) -> torch.Tensor:
    """log|M| on the kept subspace by an 8th-order trace series around
    the diagonal seed ``inv_diag_warm`` (the exact inverse of the kept
    block where the eigenspace was computed): with D = diag(inv_diag_warm)
    and A = D^(1/2) M D^(1/2) = I + E,

        logdet(M_kept) = logdet(A) - sum(log inv_diag_warm),
        logdet(A) = tr(E) - tr(E^2)/2 + ... - tr(E^8)/8,

    every trace from E^2, E^3, E^4 (three matrix products) and elementwise
    sums, truncation error <= rank |E|_2^9 / 9.  Where |E|_F >= ``tol`` or
    E is not finite, the Cholesky log-determinant instead
    (``masked_logdet_chol``).  The guard is decided on the device, item by
    item: both forms are computed and selected, each on a stand-in where
    the other is selected (E = 0, M = I) so that neither carries NaN or inf
    into the selected items' gradient.  Counted on the device under
    ``mstep.series`` / ``mstep.chol``."""
    keepf = keep.to(M.dtype)
    Mp = _pad_dropped(M, keep)
    d = inv_diag_warm + (1.0 - keepf)
    s = torch.sqrt(d)
    E = s[..., :, None] * Mp * s[..., None, :] - _eye_like(M)
    fro2 = torch.sum(E * E, dim=(-2, -1))
    ok = torch.isfinite(fro2) & (fro2 < tol * tol)
    decisions.count_on_device(ok, "mstep.series", "mstep.chol")

    def series(E):
        E2 = E @ E
        E3 = E2 @ E
        E4 = E2 @ E2

        def tr(a, b):
            return torch.sum(a * b, dim=(-2, -1))
        ld_A = (torch.diagonal(E, dim1=-2, dim2=-1).sum(-1) - tr(E, E) / 2
                + tr(E2, E) / 3 - tr(E2, E2) / 4 + tr(E3, E2) / 5
                - tr(E3, E3) / 6 + tr(E4, E3) / 7 - tr(E4, E4) / 8)
        return ld_A - torch.sum(torch.log(d), dim=-1)

    sel = ok[..., None, None]
    E = torch.where(sel, E, torch.zeros_like(E))
    M = torch.where(sel, _eye_like(M).expand_as(M), M)
    return torch.where(ok, series(E), masked_logdet_chol(M, keep))


def schulz_iterations(M: torch.Tensor, X: torch.Tensor, steps: int = 12,
                      guard_lag: int = 3, tol: float = 1e-3):
    """Newton-Schulz inverse iteration ``X <- X (2I - M X)`` from seed X
    (quadratically convergent whenever ||I - M X0|| < 1): two matrix
    products a step, no factorization.

    ``steps - guard_lag`` guarded steps, each measuring the residual
    max|M X - I| before its update, then ``guard_lag`` more.  Returns
    ``(X, resid)`` with ``resid`` the smallest residual measured (0-d, or
    (L,) for a batch; NaN-free): acceptance ``resid < tol`` is exactly the
    JAX package's, whose loop exits at the first residual below ``tol``
    and runs the same ``guard_lag`` steps after it.  The residual squares
    each step, so an accepted X sits at the rounding floor, where the
    port's further steps keep it: the two agree to rounding.  No host
    synchronization."""
    eye = _eye_like(M)
    resid = torch.full(M.shape[:-2], float("inf"), dtype=M.dtype,
                       device=M.device)
    for _ in range(max(steps - guard_lag, 1)):
        P = M @ X
        resid = torch.fmin(resid, torch.abs(P - eye).amax(dim=(-2, -1)))
        X = X @ (2.0 * eye - P)
    for _ in range(guard_lag):
        X = X @ (2.0 * eye - M @ X)
    return X, resid


class _PaddedInverseWarm(torch.autograd.Function):
    """inv(padded) by Newton-Schulz from diag(x0), with the fallback
    ``fallback`` where its guard fails: "exact" the Cholesky inverse
    (``_spd_inverse``, computed on every call and selected item by item on
    the device; counted there under ``mstep.schulz`` / ``mstep.exact``),
    "poison" NaN.  No host read.  The backward treats the output X as the
    true inverse, d padded = -X^T g X^T, with non-finite entries zeroed: it
    reads only X, so the form not selected never reaches the gradient, and
    a poisoned trial (whose loss is +inf) still hands the line search a
    finite gradient."""

    @staticmethod
    def forward(ctx, padded, x0, steps, tol, fallback):
        X, resid = schulz_iterations(padded, torch.diag_embed(x0), steps,
                                     tol=tol)
        ok = resid < tol
        if fallback == "exact":
            decisions.count_on_device(ok, "mstep.schulz", "mstep.exact")
            X = torch.where(ok[..., None, None], X, _spd_inverse(padded))
        else:
            X = X + _poison(ok, X.dtype)[..., None, None]
        ctx.save_for_backward(X)
        return X

    @staticmethod
    def backward(ctx, g):
        (X,) = ctx.saved_tensors
        gp = -(X.mT @ (g @ X.mT))
        return (torch.where(torch.isfinite(gp), gp, torch.zeros_like(gp)),
                None, None, None, None)


def masked_inverse_warm(M: torch.Tensor, keep: torch.Tensor,
                        inv_diag_warm: torch.Tensor, steps: int = 12,
                        tol: float = 1e-3,
                        fallback: str = "exact") -> torch.Tensor:
    """``masked_inverse_spd`` by warm-seeded Newton-Schulz: the kept block
    of M inverted from the diagonal seed ``inv_diag_warm`` (on the M-step,
    ``es.k_tilde_inv_diag``: inv(K_tilde_b) exactly at the theta where the
    eigenspace was computed, so nearby line-search trials converge in a few
    steps).  ``fallback="exact"`` gives the Cholesky inverse where the
    iteration does not converge (so the result is ``masked_inverse_spd``'s
    to rounding: NaN where the kept block is not positive definite, where
    the JAX package's LU inverse is finite; the M-step's loss is +inf there
    either way), "poison" NaN there.  Differentiable in M
    (``_PaddedInverseWarm``)."""
    if fallback not in ("exact", "poison"):
        raise ValueError(f"fallback must be 'exact' or 'poison', got "
                         f"{fallback!r}")
    keepf = keep.to(M.dtype)
    x0 = inv_diag_warm + (1.0 - keepf)
    inv = _PaddedInverseWarm.apply(_pad_dropped(M, keep), x0, steps, tol,
                                   fallback)
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
