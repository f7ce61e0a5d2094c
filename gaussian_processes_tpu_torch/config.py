"""Configuration of the PyTorch/CUDA port.

The constants are the reference's (Spatial_GP_repo/utils.py:31-41), as in
``gaussian_processes_tpu/config.py``.  ``FitConfig`` carries the knobs of
the JAX package's per-iteration EM fit: the stabilization at full rank or
at a reduced rank budget and its eigensolver, the E-step solver, the M-step
inverse, log-determinant and Gram, the five inner line searches and the
convergence gates.  The solver knobs default to their exact forms (eigh,
Cholesky, the exact inverse and log-determinant, the exact Gram, and full
rank), where the JAX package defaults to its warm solvers (subspace,
Newton-Schulz, the trace series, reduced rank): the port switches only once
its bench has priced them on the card.

Precision: float32 matrix products run in full IEEE float32.  PyTorch's
cuBLAS path already defaults to that, but cuDNN does not, so
``use_full_fp32`` sets both TF32 switches off explicitly; ``fit`` and
``predict_rates`` call it whenever their tensors are on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Tolerance below which a matrix is not considered symmetric / posdef
# (reference: Spatial_GP_repo/utils.py:37).
MIN_TOLERANCE = 1.0e-11

# Relative eigenvalue cutoff for the stabilizing eigenspace projection
# (reference: Spatial_GP_repo/utils.py:39).
EIGVAL_TOL = 1.0e-4

# Pixels with envelope alpha < ALPHA_THRESHOLD carry exactly zero kernel
# weight (the reference crops them, Spatial_GP_repo/utils.py:883-887).
ALPHA_THRESHOLD = 1.0e-3

# Additive guard in the cosine-angle denominator
# (reference: Spatial_GP_repo/utils.py:984).
COSDELTA_JITTER = 1.0e-7


def resolve_device(x, device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    device of ``x`` when it is a tensor, else (numpy input) the CUDA card.
    There is no fallback to the CPU: without a card, numpy input and no
    ``device`` raise."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for numpy input: pass device="
                           "\"cpu\" (or a CPU tensor) to run on the CPU")
    return torch.device("cuda")


def use_full_fp32() -> None:
    """Turn TF32 off for CUDA matmuls and convolutions (float32 products
    then keep ~7 decimal digits instead of TF32's ~3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """One EM fit (the reference's ``fit_parameters`` dict,
    Spatial_GP_repo/utils.py:1632-1645, with identical defaults)."""

    ntilde: Optional[int] = None      # inducing points (None -> min(100, nt))
    maxiter: int = 50                 # outer EM iterations
    n_estep: int = 50                 # E-step Newton iterations per outer
    n_mstep: int = 20                 # L-BFGS iterations on theta per outer
    n_fparamstep: int = 10            # L-BFGS iterations on logA per E-step
    n_px_side: int = 108              # stimulus is n_px_side x n_px_side
    cellid: int = 0
    eigval_tol: float = EIGVAL_TOL
    alpha_threshold: float = ALPHA_THRESHOLD
    track_variational: bool = True    # record (m_b, V_b) per iteration
    # Also record the stabilized basis B per iteration (with
    # track_variational): ``state_at_iteration`` then pairs the tracked
    # (m_b, V_b) with the basis the fit used instead of a fresh eigh.  Off
    # by default (maxiter x ntilde x ntilde memory).
    track_basis: bool = False
    # Reduced-rank stabilization: each EM iteration runs the '_b' algebra at
    # a rank budget = bucketed(kept-rank * rank_slack + rank_pad), a
    # multiple of rank_bucket, instead of the full ntilde; the budget is the
    # top of the ascending eigh, so it is exact whenever it covers the kept
    # rank (the dropped coordinates are exact zeros).  The budget follows
    # the largest kept rank of the last three iterations, read with the
    # crop window's scalars.  The JAX package defaults to True; the port
    # keeps False until its bench has priced it.
    reduced_rank: bool = False
    rank_slack: float = 1.25
    rank_pad: int = 16
    rank_bucket: int = 64
    # Crop window around the RF (exact: cropped pixels carry zero kernel
    # weight).  Each EM iteration crops to a window covering the alpha mask
    # of the theta it starts from, with ``crop_margin`` of slack; the side is
    # rounded up to a multiple of ``crop_bucket``.
    crop_window: bool = True
    crop_margin: float = 1.25
    crop_bucket: int = 16
    # Eigensolver of the reduced-rank fit's kernel rebuild (an iteration
    # whose budget is below ntilde): "eigh" = the full factorization, top
    # of the ascending eigh; "subspace" = ``subspace_power_steps`` steps of
    # subspace iteration + Rayleigh-Ritz warm-started from the previous
    # iteration's basis (theta moves little between EM iterations), with
    # the full eigh as the refresh every ``eigh_refresh_every`` iterations
    # (i % eigh_refresh_every == 0) and wherever the warm solve fails
    # numerically (one host read per iteration).  The JAX default is
    # "subspace".
    eigensolver: str = "eigh"
    subspace_power_steps: int = 2
    eigh_refresh_every: int = 8
    # The E-step Newton update's SPD inverse (I + S G S)^-1: "chol" = a
    # Cholesky factor and a triangular solve every step; "schulz" = from
    # the second Newton step of an E-step, Newton-Schulz from the previous
    # step's inverse, with the Cholesky inverse where its residual guard
    # fails (one host read per step).  The JAX default is "schulz".
    estep_solver: str = "chol"
    # The M-step objective's inverse of K_tilde_b: "exact" = the Cholesky
    # inverse; "schulz" = Newton-Schulz seeded with the eigenspace's
    # diagonal inverse (exact at the iteration-start theta), with
    # ``schulz_fallback`` where its guard fails: "exact" the Cholesky
    # inverse (one host read per evaluation), "poison" a NaN inverse, so
    # the trial's loss is +inf and the line search backs off (branch-free,
    # the population's form).  The JAX default is "schulz".
    mstep_inverse: str = "exact"
    # Newton-Schulz steps of both solvers (steps - 3 guarded, then 3 more).
    schulz_steps: int = 12
    schulz_fallback: str = "exact"
    # log|K_tilde_b| in the M-step objective: "chol" = from its Cholesky
    # factor; "series" = an 8th-order trace series around the eigenspace's
    # diagonal seed, with the Cholesky log-determinant where the seed is
    # too far (|E|_F >= 0.25, one host read per evaluation).  The JAX
    # default is "series".
    mstep_logdet: str = "chol"
    # The M-step objective's Gram: "exact" = the crop window's (contraction
    # w^2); "projected" = both sides of the separable smoothing projected
    # on the top ``mstep_proj_rank`` eigenvectors of the 1-D smoothing
    # factor at the iteration-start theta (contraction rank^2), guarded per
    # evaluation by the projection's relative Frobenius residual against
    # ``mstep_proj_tol``; out of tolerance ``mstep_proj_fallback`` "exact"
    # builds the exact Gram (one host read per evaluation), "poison" makes
    # the trial's loss +inf.  ``mstep_proj_rank`` None: ``fit`` sizes it
    # from the start theta (ops/kernels.suggest_proj_rank).  The JAX
    # default is "exact".
    mstep_gram: str = "exact"
    mstep_proj_rank: Optional[int] = None
    mstep_proj_tol: float = 3e-6
    mstep_proj_fallback: str = "exact"
    # Trial budget per L-BFGS step of the strong-Wolfe zoom search and of
    # the backtracking search.
    max_linesearch_steps: int = 15
    # Inner L-BFGS line search at both call sites (E-step f-params and
    # M-step), ``optim/lbfgs``:
    # - "zoom": strong Wolfe (``lbfgs_minimize``), optax's zoom search;
    # - "zoom_carry": zoom, with the M-step's optimizer state carried across
    #   EM iterations under ``mstep_memory`` (``lbfgs_minimize_zoom_carry``);
    #   the f-param updates run plain zoom;
    # - "speculative": value and gradient at one step at a carried scale,
    #   and on an Armijo failure one batched value-only call over a ladder
    #   of ``armijo_trials`` smaller steps (``lbfgs_minimize_speculative``);
    #   under ``mstep_memory`` the M-step's curvature pairs are carried
    #   across EM iterations;
    # - "backtracking": optax's Armijo backtracking, halving from a carried
    #   step (``lbfgs_minimize_backtracking``);
    # - "armijo": a fixed ladder of ``armijo_trials`` steps evaluated as one
    #   batched call (``lbfgs_minimize_armijo``); the population fit's
    #   branch-free search, and the only one it runs.
    linesearch: str = "zoom"
    # Carry the M-step's L-BFGS memory across EM iterations
    # (linesearch "speculative" or "zoom_carry").
    mstep_memory: bool = True
    # The "armijo" search's ladder length and the "speculative" search's
    # rejection ladder.
    armijo_trials: int = 6
    # M-step early termination for "zoom" and "zoom_carry" (off at 0): stop
    # the L-BFGS steps once the gradient's inf-norm is <= mstep_gtol, or the
    # objective's change between accepted steps is < mstep_ftol +
    # mstep_ftol_rel * |f| (the reference's torch.optim.LBFGS tolerances are
    # gtol 1e-7 and ftol 1e-9).  The remaining steps cost no evaluation.
    mstep_gtol: float = 0.0
    mstep_ftol: float = 0.0
    mstep_ftol_rel: float = 0.0
    # E-step early termination (off at 0): stop the Newton steps once the
    # posterior mean moved by max|dm| <= estep_tol * (1 + max|m|), keeping
    # that step; each skipped step also skips its f-param L-BFGS run.
    estep_tol: float = 0.0

    def __post_init__(self):
        if self.eigensolver not in ("eigh", "subspace"):
            raise ValueError(
                f"eigensolver must be 'eigh' or 'subspace', got "
                f"{self.eigensolver!r}")
        if self.linesearch not in ("zoom", "zoom_carry", "speculative",
                                   "backtracking", "armijo"):
            raise ValueError(
                f"linesearch must be 'zoom', 'zoom_carry', 'speculative', "
                f"'backtracking' or 'armijo', got {self.linesearch!r}")
        if self.estep_solver not in ("chol", "schulz"):
            raise ValueError(
                f"estep_solver must be 'chol' or 'schulz', got "
                f"{self.estep_solver!r}")
        if self.mstep_inverse not in ("exact", "schulz"):
            raise ValueError(
                f"mstep_inverse must be 'exact' or 'schulz', got "
                f"{self.mstep_inverse!r}")
        if self.mstep_logdet not in ("chol", "series"):
            raise ValueError(
                f"mstep_logdet must be 'chol' or 'series', got "
                f"{self.mstep_logdet!r}")
        if self.mstep_gram not in ("exact", "projected"):
            raise ValueError(
                f"mstep_gram must be 'exact' or 'projected', got "
                f"{self.mstep_gram!r}")
        if self.mstep_proj_fallback not in ("exact", "poison"):
            raise ValueError(
                f"mstep_proj_fallback must be 'exact' or 'poison', got "
                f"{self.mstep_proj_fallback!r}")
        if self.schulz_fallback not in ("exact", "poison"):
            raise ValueError(
                f"schulz_fallback must be 'exact' or 'poison', got "
                f"{self.schulz_fallback!r}")
        if self.rank_bucket < 1 or self.rank_slack <= 0 or self.rank_pad < 0:
            raise ValueError(
                f"rank_bucket must be >= 1, rank_slack > 0 and rank_pad >= "
                f"0, got {self.rank_bucket}, {self.rank_slack}, "
                f"{self.rank_pad}")

    def resolve_ntilde(self, nt: int) -> int:
        if self.ntilde is not None:
            return self.ntilde
        return 100 if nt > 100 else nt
