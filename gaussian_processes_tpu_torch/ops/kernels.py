"""Kernel construction for the spatial GP
(counterpart of ``gaussian_processes_tpu/ops/kernels.py``).

Same math as the JAX module: the separable smoothness prior is applied as
``S W S`` on each (n, n) image instead of materializing the n^2 x n^2 prior
matrix C; pixels whose envelope alpha is below the threshold get weight
exactly zero; and the arc-cosine angular factor J carries its analytic
derivative.  The two big Gram contractions (K_tilde and K) go through
``_gram_core``, whose ``backend`` picks the fused kernel
(``ops/gram_cuda.acos_gram``, the default on CUDA tensors) or the plain
PyTorch composite (the default on CPU tensors).  The M-step's projected
Gram (``gram_matrices_projected``) hands its cross forms, at contraction
R^2 instead of w^2, to the same kernel.

theta is a dict of 0-d tensors; every function takes its device and dtype
from its tensor arguments.  The Gram functions also take a batch: theta a
dict of (B,) tensors (one item per cell, or per (cell, line-search trial)
of the population fit), per-item crop corners (B,) with one shared side,
and stimuli shared by all items or given per item; every output then
carries the leading item axis, and on CUDA tensors each of the two big
contractions is one batched kernel launch.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ALPHA_THRESHOLD, COSDELTA_JITTER

Theta = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=8)
def _grid_1d_np(n_px_side: int):
    return np.linspace(-1.0, 1.0, n_px_side)


@functools.lru_cache(maxsize=32)
def _lin(n_px_side: int, dtype, device) -> torch.Tensor:
    """The 1-D pixel grid, copied to the device once per grid, dtype and
    device (a copy per Gram would be a host synchronization on the card).
    Callers must not write into it."""
    return torch.as_tensor(_grid_1d_np(n_px_side), dtype=dtype, device=device)


def pixel_coords(n_px_side: int, dtype=torch.float32, device=None):
    """Flattened (xcord, ycord) of the n x n grid, 'ij' indexing: pixel
    p = i * n + j has ycord = lin[i], xcord = lin[j]
    (reference: utils.py:876-879)."""
    lin = _lin(n_px_side, dtype, device)
    ycord = lin.repeat_interleave(n_px_side)
    xcord = lin.repeat(n_px_side)
    return xcord, ycord


def _envelope(theta: Theta, xcord, ycord, alpha_threshold):
    gb = torch.exp(theta["-2log2beta"])[..., None]     # 1 / (4 beta^2)
    logalpha = -gb * ((xcord - theta["eps_0x"][..., None]) ** 2 +
                      (ycord - theta["eps_0y"][..., None]) ** 2)
    alpha = torch.exp(logalpha)
    mask = alpha >= alpha_threshold
    alpha_eff = torch.where(mask, alpha, torch.zeros_like(alpha))
    return alpha_eff, logalpha, mask


def local_envelope(theta: Theta, n_px_side: int, dtype=None,
                   alpha_threshold: float = ALPHA_THRESHOLD):
    """Localized RF envelope alpha over the flattened grid, hard-thresholded
    to zero below ``alpha_threshold`` (reference crops instead,
    utils.py:880-887).  Returns (alpha_eff, logalpha, mask)."""
    amp = theta["Amp"]
    dtype = amp.dtype if dtype is None else dtype
    xcord, ycord = pixel_coords(n_px_side, dtype, amp.device)
    return _envelope(theta, xcord, ycord, alpha_threshold)


def _smooth_1d(theta: Theta, lin: torch.Tensor) -> torch.Tensor:
    gr = torch.exp(theta["-log2rho2"]).to(lin.dtype)     # 1 / (2 rho^2)
    return torch.exp(-gr[..., None, None]
                     * (lin[..., :, None] - lin[..., None, :]) ** 2)


def smooth_factor(theta: Theta, n_px_side: int, dtype=None) -> torch.Tensor:
    """1-D RBF factor S of the separable smoothness prior:
    ``C_smooth = S (row) (x) S (col)``, S[a,b] = exp(-g_rho (lin_a-lin_b)^2)
    (reference materializes the full C_smooth, utils.py:890-892)."""
    amp = theta["Amp"]
    dtype = amp.dtype if dtype is None else dtype
    return _smooth_1d(theta, _lin(n_px_side, dtype, amp.device))


def materialize_C(theta: Theta, n_px_side: int, dtype=None,
                  alpha_threshold: float = ALPHA_THRESHOLD):
    """Dense nx-by-nx prior matrix C with masked rows/cols zeroed, plus the
    boolean mask.  For tests and small problems (reference ``localker``,
    utils.py:861-914); the fit never calls it."""
    alpha_eff, _, mask = local_envelope(theta, n_px_side, dtype,
                                        alpha_threshold)
    S = smooth_factor(theta, n_px_side, dtype)
    nx = n_px_side * n_px_side
    C_smooth = torch.einsum("ik,jl->ijkl", S, S).reshape(nx, nx)
    C = theta["Amp"] * alpha_eff[:, None] * C_smooth * alpha_eff[None, :]
    C = 0.5 * (C + C.T)
    return C, mask


def smooth_apply(S: torch.Tensor, w: torch.Tensor, n_px_side: int,
                 Sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the separable smoothness prior to flattened images w
    ((B,) b, nx): reshape to ((B,) b, n, n), compute Sy W Sx, flatten back.
    ``Sx`` defaults to S (full grid); a crop window passes distinct row and
    column factors.  Factors (B, n, n) apply item by item to w (B, b, nx)."""
    if Sx is None:
        Sx = S
    if S.dim() == 3:
        S, Sx = S[:, None], Sx[:, None]
    imgs = w.reshape(*w.shape[:-1], n_px_side, n_px_side)
    out = torch.matmul(torch.matmul(S, imgs), Sx)
    return out.reshape(*w.shape[:-1], n_px_side * n_px_side)


# ---------------------------------------------------------------------------
# Crop window: exact contraction-length cut around the RF
# ---------------------------------------------------------------------------

def crop_window_from_scalars(lb: float, eps_x: float, eps_y: float,
                             n_px_side: int,
                             alpha_threshold: float = ALPHA_THRESHOLD,
                             margin: float = 1.25, bucket: int = 16):
    """(i0, j0, w) covering {alpha >= threshold} with a safety margin, from
    host scalars (theta's '-2log2beta', 'eps_0x', 'eps_0y').  Returns
    w == n_px_side when the RF covers most of the grid."""
    gb = math.exp(lb)
    # alpha >= t  <=>  d^2 <= ln(1/t) / gb
    radius = math.sqrt(max(math.log(1.0 / alpha_threshold) / max(gb, 1e-12),
                           0.0)) * margin
    # [-1, 1] grid: pixel spacing 2 / (n - 1)
    half_px = radius * (n_px_side - 1) / 2.0
    w = int(2 * half_px) + 2
    w = min(((w + bucket - 1) // bucket) * bucket, n_px_side)
    if w >= n_px_side:
        return 0, 0, n_px_side
    cx = (eps_x + 1.0) * (n_px_side - 1) / 2.0
    cy = (eps_y + 1.0) * (n_px_side - 1) / 2.0
    i0 = int(round(cy)) - w // 2
    j0 = int(round(cx)) - w // 2
    i0 = max(0, min(i0, n_px_side - w))
    j0 = max(0, min(j0, n_px_side - w))
    return i0, j0, w


def crop_window_for_theta(theta: Theta, n_px_side: int,
                          alpha_threshold: float = ALPHA_THRESHOLD,
                          margin: float = 1.25, bucket: int = 16):
    """``crop_window_from_scalars`` at theta's tensors: one host transfer of
    the three scalars it needs."""
    lb, ex, ey = torch.stack([theta["-2log2beta"], theta["eps_0x"],
                              theta["eps_0y"]]).tolist()
    return crop_window_from_scalars(lb, ex, ey, n_px_side, alpha_threshold,
                                    margin, bucket)


def _per_item(i0) -> bool:
    return isinstance(i0, torch.Tensor) and i0.dim() == 1


def crop_images(x: torch.Tensor, i0, j0, w: int,
                n_px_side: int) -> torch.Tensor:
    """Crop flattened images (nt, n^2) to the (w, w) window -> (nt, w^2),
    as a contiguous copy.  With per-item corners i0, j0 (B,) tensors, a
    gather -> (B, nt, w^2), each item's images cropped at its own corner."""
    if _per_item(i0):
        a = torch.arange(w, device=x.device)
        rows = (i0.to(x.device)[:, None] + a)[:, :, None]
        cols = (j0.to(x.device)[:, None] + a)[:, None, :]
        idx = (rows * n_px_side + cols).reshape(i0.shape[0], w * w)
        return x[:, idx].movedim(1, 0).contiguous()
    imgs = x.reshape(x.shape[0], n_px_side, n_px_side)
    return imgs[:, i0:i0 + w, j0:j0 + w].reshape(x.shape[0], w * w)


def window_coords(i0, j0, w: int, n_px_side: int, dtype, device=None):
    """(xcord, ycord) of the flattened window, plus the 1-D coordinate
    slices used for the smoothness factors; with per-item corners (B,)
    each is per item, (B, w^2) and (B, w)."""
    lin = _lin(n_px_side, dtype, device)
    if _per_item(i0):
        a = torch.arange(w, device=lin.device)
        lin_y = lin[i0.to(lin.device)[:, None] + a]
        lin_x = lin[j0.to(lin.device)[:, None] + a]
        b = i0.shape[0]
        return (lin_x[:, None, :].expand(b, w, w).reshape(b, w * w),
                lin_y[:, :, None].expand(b, w, w).reshape(b, w * w),
                lin_y, lin_x)
    if isinstance(i0, torch.Tensor):
        # a corner held in 0-d tensors on lin's device (a CUDA graph's
        # buffers): gathered, where an int corner slices (a slice bound
        # would be read on the host); the same values either way
        a = torch.arange(w, device=lin.device)
        lin_y, lin_x = lin[i0 + a], lin[j0 + a]
    else:
        lin_y = lin[i0:i0 + w]
        lin_x = lin[j0:j0 + w]
    return lin_x.repeat(w), lin_y.repeat_interleave(w), lin_y, lin_x


def quad_forms(theta: Theta, x1: torch.Tensor, x2: Optional[torch.Tensor],
               n_px_side: int, alpha_threshold: float = ALPHA_THRESHOLD,
               with_cross: bool = True):
    """Quadratic forms through C: ``(q11, q22, q12)`` with
    q11 = diag(x1^T C x1), q22 = diag(x2^T C x2), q12 = x1^T C x2 (None
    when with_cross=False or x2 is None)."""
    alpha_eff, _, _ = local_envelope(theta, n_px_side, x1.dtype,
                                     alpha_threshold)
    S = smooth_factor(theta, n_px_side, x1.dtype)
    amp = theta["Amp"].to(x1.dtype)
    u1 = x1 * alpha_eff
    s1 = smooth_apply(S, u1, n_px_side)
    q11 = amp * torch.sum(u1 * s1, dim=1)
    if x2 is None:
        return q11, None, None
    u2 = x2 * alpha_eff
    s2 = smooth_apply(S, u2, n_px_side)
    q22 = amp * torch.sum(u2 * s2, dim=1)
    q12 = amp * (u1 @ s2.T) if with_cross else None
    return q11, q22, q12


# ---------------------------------------------------------------------------
# Arc-cosine kernel, order 1 (reference: utils.py:939-1050)
# ---------------------------------------------------------------------------

class _AcosJ(torch.autograd.Function):
    """J(c) = (sqrt(1 - c^2) + (pi - acos c) c) / pi with the exact
    derivative dJ/dc = (pi - acos c) / pi (autodiff of the formula gives
    inf - inf = NaN at |c| = 1)."""

    @staticmethod
    def forward(ctx, c):
        ctx.save_for_backward(c)
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
        return (s + (math.pi - torch.acos(c)) * c) / math.pi

    @staticmethod
    def backward(ctx, g):
        (c,) = ctx.saved_tensors
        return g * (math.pi - torch.acos(c)) / math.pi


def acos_J(c: torch.Tensor) -> torch.Tensor:
    return _AcosJ.apply(c)


def _acos_from_quads(theta: Theta, q11, q22, q12, symmetrize: bool):
    sigma0 = theta["sigma_0"].to(q11.dtype)
    s02 = (sigma0 * sigma0)[..., None]
    X1 = torch.sqrt(q11 + s02)
    X2 = torch.sqrt(q22 + s02)
    X1X2 = X1[..., :, None] * X2[..., None, :]
    x1x2 = q12 + s02[..., None]
    one = torch.ones((), dtype=q11.dtype, device=q11.device)
    # maximum/minimum rather than clamp: a value exactly on a bound passes
    # half the gradient, as jnp.clip does
    cosdelta = torch.minimum(torch.maximum(x1x2 / (X1X2 + COSDELTA_JITTER),
                                           -one), one)
    K = X1X2 * acos_J(cosdelta)
    if symmetrize:
        K = 0.5 * (K + K.mT)
    return K


def acosker(theta: Theta, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
            n_px_side: int = 108, diag: bool = False,
            alpha_threshold: float = ALPHA_THRESHOLD) -> torch.Tensor:
    """Arc-cosine (order-1) covariance through the localized + smooth prior.
    ``diag=True`` returns diag(K(x1, x1)) = q11 + sigma_0^2
    (reference: utils.py:1027-1030); otherwise the full Gram, symmetrized
    when x1 is x2 (reference: utils.py:1024-1025)."""
    if diag:
        q11, _, _ = quad_forms(theta, x1, None, n_px_side, alpha_threshold)
        s0 = theta["sigma_0"].to(q11.dtype)
        return q11 + s0 * s0
    same = x2 is None or x2 is x1
    x2c = x1 if x2 is None else x2
    q11, q22, q12 = quad_forms(theta, x1, x2c, n_px_side, alpha_threshold)
    if x2 is None:
        q22 = q11
    return _acos_from_quads(theta, q11, q22, q12, symmetrize=same)


def linker(theta: Theta, x1: torch.Tensor, x2: Optional[torch.Tensor] = None,
           n_px_side: int = 108, diag: bool = False,
           alpha_threshold: float = ALPHA_THRESHOLD) -> torch.Tensor:
    """Linear kernel k(x1, x2) = x1^T C x2 through the localized + smooth
    prior (the reference's vestigial ``linker``, utils.py:916-937, marked
    "does not work" there): ``diag=True`` gives diag(x1^T C x1); x1 with
    itself a symmetrized Gram with 1e-9 on the diagonal; else the cross
    Gram.  Not used by any fit."""
    if diag:
        q11, _, _ = quad_forms(theta, x1, None, n_px_side, alpha_threshold)
        return q11
    same = x2 is None or x2 is x1
    x2c = x1 if x2 is None else x2
    _, _, q12 = quad_forms(theta, x1, x2c, n_px_side, alpha_threshold)
    if same:
        eye = torch.eye(q12.shape[0], dtype=q12.dtype, device=q12.device)
        q12 = 0.5 * (q12 + q12.T) + 1e-9 * eye
    return q12


def gram_matrices(theta: Theta, x: torch.Tensor, xtilde: torch.Tensor,
                  n_px_side: int, shared: bool,
                  alpha_threshold: float = ALPHA_THRESHOLD,
                  backend: Optional[str] = None):
    """K_tilde (ntilde, ntilde), K (nt, ntilde), Kvec (nt,) in one pass,
    sharing the smoothed images (reference: utils.py:1675-1680).
    ``shared=True`` means xtilde is x, so K = K_tilde.  A theta of (B,)
    tensors gives (B, ...) outputs, one item per entry."""
    alpha_eff, _, _ = local_envelope(theta, n_px_side, x.dtype,
                                     alpha_threshold)
    S = smooth_factor(theta, n_px_side, x.dtype)
    return _gram_core(theta, x, xtilde, alpha_eff, S, S, n_px_side, shared,
                      backend)


def _gram_core(theta: Theta, x, xtilde, alpha_eff, Sy, Sx, side: int,
               shared: bool, backend: Optional[str] = None):
    """Gram assembly over a (side x side) pixel set (full grid or crop
    window) from a precomputed envelope and smoothing factors.  Batched:
    theta (B,), alpha_eff (B, side^2), Sy/Sx (B, side, side), and x/xtilde
    either shared (rows, side^2) or per item (B, rows, side^2)."""
    amp = theta["Amp"].to(x.dtype)[..., None]
    alpha_rows = alpha_eff[..., None, :]

    def forms(rows):
        u = rows * alpha_rows
        s = smooth_apply(Sy, u, side, Sx)
        return u, s, amp * torch.sum(u * s, dim=-1)
    return _grams_from_forms(theta, forms, x, xtilde, shared, backend)


def _grams_from_forms(theta: Theta, forms, x, xtilde, shared: bool,
                      backend: Optional[str] = None):
    """K_tilde, K and Kvec from the quadratic forms of the rows:
    ``forms(rows)`` gives (u, s, q_diag) with the cross form
    q12 = Amp u1 s2^T and q_diag = diag(q11), so that
    K = X1X2 J(clip((q12 + s0^2) / (X1X2 + 1e-7), -1, 1)).

    ``backend``: "cuda" routes both cross forms and the epilogue through
    the fused kernel wrapper ``ops/gram_cuda.acos_gram`` (float32 on the
    card; on a CPU tensor the wrapper runs its plain forward, with the same
    hand-written backward); "torch" is the plain composite.  None picks
    "cuda" for CUDA tensors and "torch" otherwise."""
    if backend is None:
        backend = "cuda" if x.is_cuda else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"backend must be 'cuda' or 'torch', got {backend!r}")
    dtype = x.dtype
    amp = theta["Amp"].to(dtype)[..., None]
    sigma0 = theta["sigma_0"].to(dtype)
    s02 = (sigma0 * sigma0)[..., None]

    ut, st, qtt_diag = forms(xtilde)

    if backend == "cuda":
        from .gram_cuda import acos_gram
        # the kernel computes in float32, as the Pallas kernel did; Amp is
        # folded into one side so the kernel's q12 is the whole form
        kdt = torch.float32 if x.is_cuda else dtype

        def gram(u, q, q2):
            return acos_gram((u * amp[..., None]).to(kdt), st.to(kdt),
                             q.to(kdt), q2.to(kdt),
                             sigma0.to(kdt)).to(dtype)

        K_tilde = gram(ut, qtt_diag, qtt_diag)
        K_tilde = 0.5 * (K_tilde + K_tilde.mT)
    else:
        qtt = amp[..., None] * (ut @ st.mT)
        K_tilde = _acos_from_quads(theta, qtt_diag, qtt_diag, qtt,
                                   symmetrize=True)

    if shared:
        Kvec = qtt_diag + s02
        return K_tilde, K_tilde, Kvec

    u, _, q_diag = forms(x)
    if backend == "cuda":
        K = gram(u, q_diag, qtt_diag)
    else:
        q = amp[..., None] * (u @ st.mT)
        K = _acos_from_quads(theta, q_diag, qtt_diag, q, symmetrize=False)
    Kvec = q_diag + s02
    return K_tilde, K, Kvec


# ---------------------------------------------------------------------------
# Spectrally projected Gram: the M-step's contraction cut from w^2 to R^2
# ---------------------------------------------------------------------------
#
# The smoothing factor S(gr) = exp(-gr d^2) of a w-pixel window is a Gaussian
# kernel matrix whose spectrum decays super-exponentially.  Projecting both
# sides of the separable smoothing onto its top-R eigenbasis E (w, R), taken
# once per EM iteration at the iteration-start theta, turns each image pair's
# q12 = Amp tr(U1^T S U2 S) into Amp <vec(Z1), vec(M Z2 M)> with Z = E^T U E
# and M = E^T S E: the (n1, w^2) x (w^2, n2) contraction becomes
# (n1, R^2) x (R^2, n2).  The result is the exact arc-cosine kernel of the
# smoothing operator P S P (P = E E^T), whose distance from S is known in
# closed form per evaluation, ||S - P S P||_F^2 = ||S||_F^2 - ||M||_F^2
# (orthonormal E): the guard ``ok`` certifies it within a relative ``tol``.

@functools.lru_cache(maxsize=32)
def window_smooth_d2(w: int, n_px_side: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """(w, w) squared pixel distances of any w-pixel window of the uniform
    [-1, 1] grid (only differences enter, so the window's place does not),
    copied to the device once per size, dtype and device.  Callers must
    not write into it."""
    delta = 2.0 / (n_px_side - 1)
    idx = np.arange(w) * delta
    return torch.as_tensor((idx[:, None] - idx[None, :]) ** 2, dtype=dtype,
                           device=device)


def suggest_proj_rank(gr: float, w: int, n_px_side: int,
                      tol: float = 1e-8, slack: int = 8,
                      bucket: int = 8) -> int:
    """Host-side rank for ``gram_matrices_projected``: the smallest R whose
    dropped spectrum of S(gr) on a w-pixel window has relative Frobenius
    mass <= ``tol``, plus ``slack`` directions of headroom for the M-step's
    drift of rho, rounded up to a multiple of ``bucket`` (at most w, at
    least ``bucket``).  numpy ``eigvalsh`` at (w, w)."""
    delta = 2.0 / (n_px_side - 1)
    idx = np.arange(w) * delta
    S = np.exp(-float(gr) * (idx[:, None] - idx[None, :]) ** 2)
    ev = np.linalg.eigvalsh(S)[::-1]
    tail = np.cumsum((ev * ev)[::-1])[::-1]   # tail[k] = sum_{j>=k} ev_j^2
    ok = tail <= (tol * tol) * tail[0]
    R = int(np.argmax(ok)) if ok.any() else w
    R = ((R + slack + bucket - 1) // bucket) * bucket
    return max(min(R, w), bucket)


def _smooth_window(theta: Theta, w: int, n_px_side: int, dtype,
                   device) -> torch.Tensor:
    """S(gr) on a w-pixel window ((B, w, w) for a theta of (B,) tensors)."""
    gr = torch.exp(theta["-log2rho2"]).to(dtype)
    return torch.exp(-gr[..., None, None]
                     * window_smooth_d2(w, n_px_side, dtype, device))


def smooth_projection_basis(theta: Theta, w: int, n_px_side: int,
                            rank: int, dtype=None) -> torch.Tensor:
    """Top-``rank`` eigenbasis E (w, rank) of the 1-D smoothing factor
    S(gr) on a w-pixel window ((B, w, rank) for a theta of (B,) tensors).
    A non-finite theta gives zeros, which drive the projection's residual
    to ||S||_F, so the guard refuses it."""
    from .stabilize import _eigh_safe
    amp = theta["Amp"]
    dtype = amp.dtype if dtype is None else dtype
    _, vecs, finite = _eigh_safe(_smooth_window(theta, w, n_px_side, dtype,
                                                amp.device))
    E = vecs[..., -rank:]
    return torch.where(finite[..., None, None], E, torch.zeros_like(E))


def gram_matrices_projected(theta: Theta, xc: torch.Tensor,
                            xtc: torch.Tensor, E: torch.Tensor, i0, j0,
                            n_px_side: int, shared: bool,
                            alpha_threshold: float = ALPHA_THRESHOLD,
                            tol: float = 3e-6,
                            backend: Optional[str] = None):
    """``gram_matrices_precropped`` through the projected smoothing
    operator P S P (P = E E^T): returns ``(K_tilde, K, Kvec, ok)``, where
    ``ok`` certifies that the projection's relative Frobenius residual is
    within ``tol``; the caller falls back to the exact Gram or poisons the
    trial where it is not.

    ``xc``/``xtc`` are the window's crops (n, w^2) at corner (i0, j0) (on
    the full frame: the images and corner 0, 0), cropped once per EM
    iteration; ``E`` (w, R) the basis.  Batched as the other Gram functions
    (theta (B,), per-item corners and crops), with E (B, w, R).  The cross
    forms go through ``_grams_from_forms``, so on CUDA tensors through the
    fused kernel at contraction R^2.

    S, M = E^T S E and the residual ||S||_F^2 - ||M||_F^2 are computed in
    float64 whatever the fit's dtype: in float32 each of the two sums
    carries ~1e-7 relative rounding, far above the guard's tol^2 = 9e-12,
    so the comparison would be noise.  For the same reason the basis must
    be orthonormal to float64 rounding (the fit builds it in float64); the
    forms take E and M cast to the fit's dtype."""
    dtype, dev = xc.dtype, xc.device
    w, R = E.shape[-2:]
    amp = theta["Amp"].to(dtype)[..., None]
    xcord, ycord, _, _ = window_coords(i0, j0, w, n_px_side, dtype, dev)
    alpha_eff, _, _ = _envelope(theta, xcord, ycord, alpha_threshold)
    alpha_rows = alpha_eff[..., None, :]

    S = _smooth_window(theta, w, n_px_side, torch.float64, dev)
    E64 = E.to(torch.float64)
    M64 = E64.mT @ S @ E64
    s_fro2 = torch.sum(S * S, dim=(-2, -1))
    resid2 = s_fro2 - torch.sum(M64 * M64, dim=(-2, -1))
    ok = torch.isfinite(resid2) & (resid2 <= (tol * tol) * s_fro2)
    E, M = E.to(dtype), M64.to(dtype)
    # per item: the basis and M against the item's (rows, w, w) images
    Eb, Mb = (E, M) if E.dim() == 2 else (E[:, None], M[:, None])

    def forms(rows):
        u = rows * alpha_rows
        Z = Eb.mT @ u.reshape(*u.shape[:-1], w, w) @ Eb
        Y = Mb @ Z @ Mb
        Z = Z.reshape(*Z.shape[:-2], R * R)
        Y = Y.reshape(*Y.shape[:-2], R * R)
        return Z, Y, amp * torch.sum(Z * Y, dim=-1)

    return (*_grams_from_forms(theta, forms, xc, xtc, shared, backend), ok)


def gram_matrices_windowed(theta: Theta, x: torch.Tensor,
                           xtilde: torch.Tensor, n_px_side: int, shared: bool,
                           i0: int, j0: int, w: int,
                           alpha_threshold: float = ALPHA_THRESHOLD,
                           backend: Optional[str] = None):
    """gram_matrices restricted to the (w, w) crop window at (i0, j0) (or
    at per-item corners (B,) with a batched theta).  Equal to the full-grid
    result (up to summation order) whenever the window covers the
    {alpha >= threshold} mask."""
    if w >= n_px_side:
        return gram_matrices(theta, x, xtilde, n_px_side, shared,
                             alpha_threshold, backend)
    xc = crop_images(x, i0, j0, w, n_px_side)
    xtc = xc if shared else crop_images(xtilde, i0, j0, w, n_px_side)
    return gram_matrices_precropped(theta, xc, xtc, n_px_side, shared,
                                    i0, j0, w, alpha_threshold, backend)


def gram_matrices_precropped(theta: Theta, xc: torch.Tensor,
                             xtc: torch.Tensor, n_px_side: int, shared: bool,
                             i0: int, j0: int, w: int,
                             alpha_threshold: float = ALPHA_THRESHOLD,
                             backend: Optional[str] = None):
    """``gram_matrices_windowed`` on already-cropped stimuli: the crop is
    theta-independent, so the M-step crops once per EM iteration and every
    line-search evaluation starts from here.  Batched: theta (B,), corners
    (B,), and crops shared (rows, w^2) or per item (B, rows, w^2)."""
    xcord, ycord, lin_y, lin_x = window_coords(i0, j0, w, n_px_side,
                                               xc.dtype, xc.device)
    alpha_eff, _, _ = _envelope(theta, xcord, ycord, alpha_threshold)
    Sy = _smooth_1d(theta, lin_y)
    Sx = _smooth_1d(theta, lin_x)
    return _gram_core(theta, xc, xtc, alpha_eff, Sy, Sx, w, shared, backend)
