"""The EM trainer: sparse variational GP fit with Poisson observations
(counterpart of ``gaussian_processes_tpu/models/fit.py`` in its
per-iteration mode; reference ``varGP``, Spatial_GP_repo/utils.py:1569-2316).

Each EM iteration rebuilds the kernels and the stabilizing eigenspace at the
current theta, runs ``n_estep`` closed-form Newton E-steps on (m, V) (each
followed by an L-BFGS update of logA with closed-form lambda0), records the
loss decomposition, and runs ``n_mstep`` L-BFGS steps on the six kernel
hyperparameters with the eigenspace fixed; the last iteration skips the
M-step so the final state matches its eigenspace.  A non-finite iteration
reverts to the state it started from and freezes the fit (``failed``,
``failed_at``), the reference's rollback (utils.py:2127-2189).

The solver knobs default to the JAX package's exact forms: eigh
stabilization, Cholesky E-step solves, exact M-step inverse, Cholesky
log-determinant and the exact Gram.  Its warm forms are opt-in: the
subspace eigensolver warm-started from the previous iteration's basis at a
reduced rank (``eigensolver="subspace"``, with the full eigh as periodic
refresh and fallback), Newton-Schulz for the E-step's SPD inverse carried
across Newton steps (``estep_solver``) and for the M-step's inverse
(``mstep_inverse``), the trace-series log-determinant (``mstep_logdet``)
and the spectrally projected M-step Gram (``mstep_gram="projected"``, basis
at the iteration-start theta, crop hoisted out of the line search).  Where
JAX branches in the graph (``lax.cond``), the port decides on the host, at
most once per decision, except for the M-step's two guards (the series
log-determinant's and the Newton-Schulz inverse's), which it decides on the
device as JAX does (``utils.tracing.decisions`` counts them all).  The crop
window of iteration i is computed from the theta iteration
i starts from; after the iteration the fit checks that the window still
covers the margin-1.0 alpha mask of the resulting theta, and re-runs with
the margin doubled (finally on the full frame) if it does not -- a covering
window gives the same Gram up to rounding.

Reduced rank (``cfg.reduced_rank``, JAX's per-iteration mode with
``eigensolver="eigh"``): iteration i runs the '_b' algebra at a rank budget
bucketed from the largest kept rank of the last three iterations
(``_rank_bucket``), read in the same host transfer as the crop window's
scalars; the carry is sliced to the top of the ascending eigh or
left-padded with dropped coordinates when the budget changes
(``_slice_carry``).  JAX decides from the carry of one iteration earlier
(its lag-1 pipelined probe), so the two budgets can differ by an
iteration; the values agree wherever both budgets cover the kept rank.

Every Gram goes through ``ops/kernels._gram_core``: on CUDA tensors through
the fused kernel (``ops/gram_cuda``), forward and hand-written backward.
The single-cell fit's zoom f-param search (no mesh) goes through
``ops/fparam_search``: on CUDA tensors one kernel launch a search, which
keeps the whole L-BFGS on the card as JAX's compiled E-step does.

On CUDA tensors the single-cell zoom fit's M-step (no mesh, the exact
Gram) evaluates each trial as one CUDA graph replay (``_mstep_graph``,
``optim/graphed``): the Grams, ``_mstep_loss`` and the gradient, captured
once per crop width, rank budget and layout of the state, with one host
read a trial, the value and gradient the line search needs.  JAX's
compiled EM iteration reads none; the L-BFGS itself stays on the host.

The inner L-BFGS runs (``_minimize``, by ``cfg.linesearch``) take one of
five line searches.  The speculative and Armijo searches evaluate their
step ladders in one batched call: the f-params' against (1, nt) moments,
the M-step's as the (cell, trial) items of one cell of
``_mstep_objective_cells`` (``_mstep_ladder``), so its Grams go through
the batched kernel.  Under ``cfg.mstep_memory`` the speculative and
zoom_carry searches carry the M-step's L-BFGS memory across EM iterations
in ``Carry.mem``.  ``cfg.estep_tol`` ends a converged E-step's Newton loop
early, and ``mstep_gtol``/``mstep_ftol``/``mstep_ftol_rel`` a converged
zoom M-step.

Pad-and-mask (the active loop's fixed-capacity buffers): 0/1
``sample_weight`` and ``inducing_weight`` zero the inactive rows and
columns of the Grams and mask those points out of the E-step sums, the
closed-form lambda0 and the expected log-likelihood, so the fit on the
active points runs inside buffers of a fixed shape.

The mesh's "data" axis (``fit(mesh=)``, ``fit_cells_program(rows=)``):
each rank holds its rows of the training points (x, r, K, Kvec, K_b, a,
the moments) and ``rows`` (``parallel/collectives.Rows``) completes every
sum over them -- the Newton sums, lambda0's logsumexp, the expected
log-likelihood -- across the axis; K_tilde, the eigenspace, theta, the
f-params and the variational state are whole on every rank.  In the two
differentiated objectives each rank evaluates its share (its rows' terms
and 1/P of the M-step's KL) and ``rows.enter`` sums the shares' gradients
where theta, logA and lambda0 enter them.  Every value the host reads to
decide (a line search's values and gradients, the gates, the guards, the
crop window, the rank budget, the rollback) is therefore the same on every
rank, and so is every branch.  With a shared inducing set every rank
builds K_tilde whole and takes its rows as K.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from functools import partial
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import FitConfig, use_full_fp32
from ..ops.fparam_search import fparam_search
from ..ops.kernels import (crop_images, crop_window_from_scalars,
                           gram_matrices, gram_matrices_precropped,
                           gram_matrices_projected, gram_matrices_windowed,
                           local_envelope, smooth_projection_basis,
                           suggest_proj_rank)
from ..ops.stabilize import (Eigenspace, _eigvalsh_safe, compute_eigenspace,
                             masked_inverse_spd, masked_inverse_warm,
                             masked_logdet_series, mv, reproject,
                             subspace_eigenspace)
from ..optim.graphed import GraphedValueAndGrad
from ..optim.lbfgs import (empty_lbfgs_memory, lbfgs_minimize,
                           lbfgs_minimize_armijo,
                           lbfgs_minimize_backtracking,
                           lbfgs_minimize_speculative,
                           lbfgs_minimize_zoom_carry, zoom_carry_init)
from ..params import (THETA_KEYS, clip_theta, default_f_params,
                      generate_theta, theta_bounds, theta_in_bounds)
from ..utils.tracing import (count, decisions, host_read, read_guard,
                             trace_annotation)
from .estep import estep_update
from .moments import (kl_divergence, lambda0_given_logA, lambda_moments,
                      mean_f_given_lambda_moments, poisson_ell)

Theta = Dict[str, torch.Tensor]
FParams = Dict[str, torch.Tensor]
Window = Optional[Tuple[int, int, int]]     # (i0, j0, w) or None = full frame


class KernelState(NamedTuple):
    """Kernels + stabilizing eigenspace for the current theta."""
    K_tilde: torch.Tensor   # (ntilde, ntilde)
    K: torch.Tensor         # (nt, ntilde) -- K_tilde itself when shared
    Kvec: torch.Tensor      # (nt,)
    es: Eigenspace
    K_b: torch.Tensor       # (nt, rank) = K @ B
    a: torch.Tensor         # (nt, rank) = K_b K_tilde_b^-1 (B when shared)


class Track(NamedTuple):
    """Per-iteration history (the reference's values_track,
    utils.py:1713-1727).  A reduced-rank iteration's state is left-padded
    into the full-width slots, so tracked coordinates align with a full
    ascending eigh."""
    logmarginal: torch.Tensor
    loglikelihood: torch.Tensor
    KL: torch.Tensor
    theta: Dict[str, torch.Tensor]
    logA: torch.Tensor
    lambda0: torch.Tensor
    n_eigen: torch.Tensor
    m_b: torch.Tensor       # (maxiter, ntilde) or (maxiter, 0)
    V_b: torch.Tensor       # (maxiter, ntilde, ntilde) or (maxiter, 0, 0)
    B: torch.Tensor         # (maxiter, ntilde, ntilde) under cfg.track_basis,
                            # else (maxiter, ntilde, 0)


class Carry(NamedTuple):
    theta: Theta
    f_params: FParams
    m_b: torch.Tensor
    V_b: torch.Tensor
    kern: KernelState
    lambda_m: torch.Tensor
    lambda_var: torch.Tensor
    track: Track
    failed: bool
    failed_at: int          # -1 if clean
    # the M-step's L-BFGS memory carried across EM iterations (CPU tensors):
    # (S, Y, rho, age) of the speculative search or the zoom_carry state
    # when _mstep_carries_memory(cfg), else ()
    mem: Any = ()


@dataclasses.dataclass
class FitResult:
    """What the reference's ``fit_model`` dict returns
    (utils.py:2271-2288), as a typed result."""
    config: FitConfig
    xtilde: torch.Tensor
    theta: Theta
    theta_lower: Dict[str, float]
    theta_upper: Dict[str, float]
    f_params: FParams
    m_b: torch.Tensor
    V_b: torch.Tensor
    B: torch.Tensor
    keep: torch.Tensor
    eigvals: torch.Tensor
    k_tilde_b_diag: torch.Tensor
    k_tilde_inv_diag: torch.Tensor
    K_tilde: torch.Tensor
    K: torch.Tensor
    Kvec: torch.Tensor
    K_b: torch.Tensor
    a: torch.Tensor
    track: Track
    failed: bool
    failed_at: int
    timing: Optional[Dict[str, Any]] = None
    # True when an EM iteration ran the warm-started subspace eigensolver:
    # its bases are Rayleigh-Ritz bases that a fresh eigh does not
    # reproduce, so ``state_at_iteration`` then needs ``track_basis``.
    used_warm_basis: bool = False

    @property
    def mask(self) -> torch.Tensor:
        """Boolean pixel mask of the final theta."""
        _, _, mask = local_envelope(self.theta, self.config.n_px_side,
                                    alpha_threshold=self.config.alpha_threshold)
        return mask

    @property
    def eigenspace(self) -> Eigenspace:
        return Eigenspace(self.B, self.eigvals, self.keep, self.k_tilde_b_diag,
                          self.k_tilde_inv_diag)

    @property
    def kernel_state(self) -> KernelState:
        """The final kernels + eigenspace, reusable as ``fit(...,
        init_kernel=)`` (the reference's ``init_kernel`` warm start,
        utils.py:1674-1694)."""
        return KernelState(self.K_tilde, self.K, self.Kvec, self.eigenspace,
                           self.K_b, self.a)

    def values_track(self) -> Dict[str, Any]:
        """Reference-shaped values_track dict (utils.py:1713-1727)."""
        t = self.track
        return {
            "loss_track": {"logmarginal": t.logmarginal,
                           "loglikelihood": t.loglikelihood, "KL": t.KL},
            "theta_track": dict(t.theta),
            "f_par_track": {"logA": t.logA, "lambda0": t.lambda0},
            "variation_par_track": {"m_b": t.m_b, "V_b": t.V_b},
            "n_eigen_track": t.n_eigen,
        }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _masked_grams(theta: Theta, x, xtilde, shared: bool, cfg: FitConfig,
                  win: Window = None, backend: Optional[str] = None,
                  wt=None, wi=None, rows=None):
    """(K_tilde, K, Kvec), on the crop window when one is given, with the
    pad weights applied (K and Kvec: this rank's rows under ``rows``)."""
    if win is not None:
        grams = gram_matrices_windowed(theta, x, xtilde, cfg.n_px_side,
                                       shared, win[0], win[1], win[2],
                                       cfg.alpha_threshold, backend)
    else:
        grams = gram_matrices(theta, x, xtilde, cfg.n_px_side, shared,
                              cfg.alpha_threshold, backend)
    return _apply_pad_weights(*grams, shared, wt, wi, rows)


def _apply_pad_weights(K_tilde, K, Kvec, shared: bool, wt=None, wi=None,
                       rows=None):
    """Zero the inactive inducing rows/columns of K_tilde and the inactive
    training rows of K and Kvec: the eigh keep-mask, the E-step and the
    moments then see only the active subproblem, at an unchanged shape.
    With a shared inducing set under ``rows``, K and Kvec are this rank's
    rows of the whole ones (``wt`` its rows of the one mask)."""
    if wi is not None:
        K_tilde = K_tilde * (wi[:, None] * wi[None, :])
        K = K_tilde if shared else K * wi[None, :]
    if shared and rows is not None:
        K, Kvec = rows.take(K, -2), rows.take(Kvec, -1)
    if wt is not None:
        if not shared:
            K = K * wt[:, None]
        Kvec = Kvec * wt
    return K_tilde, K, Kvec


def _shared_a(B: torch.Tensor, rows) -> torch.Tensor:
    """``a`` of a shared inducing set: the basis (its rows under
    ``rows``)."""
    return B if rows is None else rows.take(B, -2)


def _build_kernel_state(theta: Theta, x, xtilde, shared: bool,
                        cfg: FitConfig, win: Window = None,
                        backend: Optional[str] = None,
                        wt=None, wi=None, rank: Optional[int] = None,
                        es_warm: Optional[Eigenspace] = None,
                        refresh: bool = False, log: Optional[list] = None,
                        rows=None) -> KernelState:
    """Grams and kernel state at theta; with ``es_warm`` the eigenspace
    comes from ``_eigenspace``'s warm route, whose route goes to ``log``."""
    grams = _masked_grams(theta, x, xtilde, shared, cfg, win, backend, wt, wi,
                          rows)
    es = None
    if es_warm is not None:
        es, route = _eigenspace(grams[0], cfg, rank, es_warm, refresh)
        if log is not None:
            log.append(route)
    return _kernel_state(*grams, shared, cfg, rank, es, rows)


def _eigenspace(K_tilde, cfg: FitConfig, rank: int, es_warm: Eigenspace,
                refresh: bool = False):
    """The reduced-rank eigenspace at ``rank`` by the warm-started subspace
    eigensolver from ``es_warm``'s basis (JAX ``_build_kernel_state``'s
    warm route), or by the full eigh (top of the ascending eigh) when
    ``refresh`` or when the warm solve failed (its ``ok``, read on the
    host once).  Returns ``(es, route)``, route "warm", "refresh" or
    "fallback"."""
    route = "refresh"
    if not refresh:
        es, ok = subspace_eigenspace(K_tilde, es_warm.B, cfg.eigval_tol,
                                     n_power=cfg.subspace_power_steps)
        if read_guard(ok, "eigensolver.warm", "eigensolver.fallback"):
            return es, "warm"
        route = "fallback"
    else:
        decisions["eigensolver.refresh"] += 1
    return compute_eigenspace(K_tilde, cfg.eigval_tol, rank=rank), route


def _kernel_state(K_tilde, K, Kvec, shared: bool, cfg: FitConfig,
                  rank: Optional[int] = None,
                  es: Optional[Eigenspace] = None, rows=None) -> KernelState:
    """Eigenspace (``es``, else the top ``rank`` eigenpairs of the eigh, or
    all) and projections of the Grams (of one cell or a stack)."""
    if es is None:
        es = compute_eigenspace(K_tilde, cfg.eigval_tol, rank=rank)
    K_b = K @ es.B
    a = (_shared_a(es.B, rows) if shared
         else K_b * es.k_tilde_inv_diag[..., None, :])
    return KernelState(K_tilde, K, Kvec, es, K_b, a)


def _map(fn, x):
    """fn over each tensor of a dict, or over the tensor itself."""
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _minimize(cfg: FitConfig, fun, x0, num_steps: int, lanes: bool = False,
              ladder=None, gtol: float = 0.0, ftol: float = 0.0,
              ftol_rel: float = 0.0, vg=None):
    """The inner L-BFGS of both call sites by ``cfg.linesearch``, without a
    carried memory (JAX ``models/fit.py::_minimize``): "zoom" and
    "zoom_carry" run the zoom search, gated by ``gtol``/``ftol``/
    ``ftol_rel`` (the M-step's site passes them), "backtracking" and
    "speculative" their own searches, "armijo" the batched ladder as one
    lane.  ``ladder`` evaluates ``fun`` at a stack of trial points (x0's
    structure with a leading trial axis) in one batched call: the Armijo
    and speculative searches take their ladders through it.  ``lanes``: x0
    carries a leading cell axis and ``fun`` takes the (cells, trials) form
    of ``lbfgs_minimize_armijo`` (the cell-batched program, which has the
    Armijo search only).  ``vg``: the zoom search's value-and-gradient
    function in place of fun's (``lbfgs_minimize``).  Under a mesh every
    value and gradient the searches read on the host is the whole
    objective's, the same on every rank, so the ranks take the same
    steps."""
    search = cfg.linesearch
    if lanes:
        if search != "armijo":
            raise ValueError("the cell-batched fit runs the Armijo search "
                             "only: linesearch='armijo'")
        return lbfgs_minimize_armijo(fun, x0, num_steps,
                                     ls_trials=cfg.armijo_trials)
    if search == "armijo":
        x, f = lbfgs_minimize_armijo(
            lambda p: ladder(_map(lambda v: v[0], p))[None],
            _map(lambda v: v[None], x0), num_steps,
            ls_trials=cfg.armijo_trials)
        return _map(lambda v: v[0], x), f[0]
    if search == "backtracking":
        return lbfgs_minimize_backtracking(
            fun, x0, num_steps, max_linesearch_steps=cfg.max_linesearch_steps)
    if search == "speculative":
        x, f, _ = lbfgs_minimize_speculative(
            fun, x0, num_steps, max_backtracks=cfg.armijo_trials,
            ladder_fun=ladder)
        return x, f
    return lbfgs_minimize(fun, x0, num_steps,
                          max_linesearch_steps=cfg.max_linesearch_steps,
                          gtol=gtol, ftol=ftol, ftol_rel=ftol_rel, vg=vg)


def _mstep_carries_memory(cfg: FitConfig) -> bool:
    """True when the M-step's L-BFGS memory is carried through the EM
    iterations (the speculative or zoom_carry search under
    ``mstep_memory``)."""
    return (cfg.linesearch in ("speculative", "zoom_carry")
            and cfg.mstep_memory and cfg.n_mstep > 0)


def _fparam_objective(logA, r, lambda_m, lambda_var, wt=None, rows=None):
    """Profiled negative ELL: lambda0 at its closed-form optimum for the
    trial logA (reference: utils.py:1892-1934).  Under ``rows`` each rank
    evaluates its rows' share; logA and lambda0 enter the shares, so the
    gradient is the whole objective's on every rank."""
    if rows is not None:
        logA = rows.enter(logA)
    lam0 = lambda0_given_logA(logA, r, lambda_m, lambda_var, weight=wt,
                              rows=rows)
    f_params = {"logA": logA, "lambda0": lam0}
    f_mean = mean_f_given_lambda_moments(f_params, lambda_m, lambda_var)
    return -poisson_ell(r, f_mean, lambda_m, f_params, weight=wt, rows=rows)


def _estep_block(r, kern: KernelState, m_b, V_b, f_params, lambda_m,
                 lambda_var, cfg: FitConfig, wt=None, lanes: bool = False,
                 rows=None, backend: Optional[str] = None):
    """n_estep Newton updates on (m_b, V_b), each followed by an L-BFGS
    update of logA with closed-form lambda0 (reference:
    utils.py:1859-1943).  Under ``cfg.estep_solver == "schulz"`` every
    Newton step after the first seeds its SPD inverse with the previous
    step's (``estep_update``'s ``Minv_warm``).  ``cfg.estep_tol`` > 0
    stops after the first step that moved m_b by max|dm| <= estep_tol
    (1 + max|m_b|), keeping it (one host read per step).  The f-param searches' ladders evaluate their
    trials against (1, nt) moments in one call.  ``lanes``: every argument
    carries a leading cell axis and the f-param L-BFGS is batched over
    cells (its trial axis against (L, 1, nt) moments); the gate is then
    refused (``fit_population`` zeroes it).

    The single-cell zoom searches ("zoom", "zoom_carry": both run the
    f-param search without a carried memory) without a mesh go through
    ``ops/fparam_search.fparam_search``, which on the card is one kernel
    launch a search (``backend``: "torch" keeps the host-driven search);
    the cell-batched Armijo search, the mesh's rows and the speculative
    and backtracking searches run on the host."""
    early = cfg.estep_tol > 0.0
    on_card = (not lanes and rows is None
               and cfg.linesearch in ("zoom", "zoom_carry"))
    if lanes and early:
        raise ValueError("the cell-batched fit runs without convergence "
                         "gates: estep_tol=0")
    trial_axis = (lambda t: t[:, None]) if lanes else (lambda t: t)
    schulz = cfg.estep_solver == "schulz"
    Minv = None
    for step in range(cfg.n_estep):
        m_old = m_b
        with trace_annotation("fit.estep.newton"):
            f_mean = mean_f_given_lambda_moments(f_params, lambda_m,
                                                 lambda_var)
            if schulz:
                m_b, V_b, Minv = estep_update(
                    r, kern.a, m_b, f_mean, kern.es.k_tilde_b_diag, f_params,
                    weight=wt, Minv_warm=Minv, use_warm=step > 0,
                    schulz_steps=cfg.schulz_steps, return_minv=True,
                    rows=rows)
            else:
                m_b, V_b = estep_update(r, kern.a, m_b, f_mean,
                                        kern.es.k_tilde_b_diag, f_params,
                                        weight=wt, rows=rows)
            lambda_m, lambda_var = lambda_moments(kern.a, kern.K_b,
                                                  kern.Kvec, m_b, V_b)
        with trace_annotation("fit.estep.fparams"):
            if on_card:
                logA, _ = fparam_search(
                    f_params["logA"], r, lambda_m, lambda_var, wt,
                    cfg.n_fparamstep, cfg.max_linesearch_steps,
                    backend=backend)
            else:
                logA, _ = _minimize(
                    cfg, partial(_fparam_objective, r=trial_axis(r),
                                 lambda_m=trial_axis(lambda_m),
                                 lambda_var=trial_axis(lambda_var), wt=wt,
                                 rows=rows),
                    f_params["logA"], cfg.n_fparamstep, lanes,
                    ladder=None if lanes else partial(
                        _fparam_objective, r=r[None],
                        lambda_m=lambda_m[None],
                        lambda_var=lambda_var[None], wt=wt, rows=rows))
        lam0 = lambda0_given_logA(logA, r, lambda_m, lambda_var, weight=wt,
                                  rows=rows)
        f_params = {"logA": logA, "lambda0": lam0}
        if early:
            # m_b is whole, and the same, on every rank of a mesh
            host_read("estep.early_stop")
            dm, m_max = torch.stack([torch.max(torch.abs(m_b - m_old)),
                                     torch.max(torch.abs(m_old))]).tolist()
            if dm <= cfg.estep_tol * (1.0 + m_max):
                break
    return m_b, V_b, f_params, lambda_m, lambda_var


def _mstep_objective(theta: Theta, x, xtilde, r, es: Eigenspace, m_b, V_b,
                     f_params, shared: bool, cfg: FitConfig, lower, upper,
                     win: Window = None, xcrop=None,
                     backend: Optional[str] = None, wt=None, wi=None,
                     proj=None, rows=None):
    """Negative log-marginal as a function of theta with the eigenspace B
    fixed (reference closure: utils.py:2017-2112).  Out-of-bounds trial
    points return +inf (utils.py:2020-2028); the loss is evaluated on the
    clipped theta so its gradient stays finite.  ``xcrop`` holds the
    window's pre-cropped (x, xtilde), cropped once per EM iteration.

    ``proj`` (``cfg.mstep_gram == "projected"``): ``(E, xc, xtc, i0, j0)``,
    the smoothing basis at the iteration-start theta with the crops (or
    the images and corner 0, 0 on the full frame); the Gram is then
    ``gram_matrices_projected``'s, and out of tolerance the exact one (one
    host read) or, under ``mstep_proj_fallback="poison"``, +inf.  Under
    ``rows`` theta enters this rank's share (``_mstep_loss``)."""
    if rows is not None:
        theta = rows.enter(theta)
    ok = theta_in_bounds(theta, lower, upper)
    theta_c = clip_theta(theta, lower, upper)

    def exact():
        if xcrop is not None and win is not None:
            return gram_matrices_precropped(
                theta_c, xcrop[0], xcrop[1], cfg.n_px_side, shared, win[0],
                win[1], win[2], cfg.alpha_threshold, backend)
        return _masked_grams(theta_c, x, xtilde, shared, cfg, win, backend)

    if proj is None:
        grams = exact()
    else:
        E, xc, xtc, i0, j0 = proj
        *grams, p_ok = gram_matrices_projected(
            theta_c, xc, xtc, E, i0, j0, cfg.n_px_side, shared,
            cfg.alpha_threshold, cfg.mstep_proj_tol, backend)
        if cfg.mstep_proj_fallback == "exact":
            # theta is whole: every rank of a mesh reads the same guard
            if not read_guard(p_ok, "mstep.projected", "mstep.exact_gram"):
                grams = exact()
        else:
            ok = ok & p_ok
    K_tilde, K, Kvec = _apply_pad_weights(*grams, shared, wt, wi, rows)
    loss = _mstep_loss(K_tilde, K, Kvec, es, m_b, V_b, f_params, r, shared,
                       cfg, wt, rows)
    return torch.where(ok & torch.isfinite(loss), loss, float("inf"))


def _mstep_graph_route(x, cfg: FitConfig, rows) -> bool:
    """True where the fit's M-step evaluates its trials as CUDA graph
    replays: CUDA tensors, no mesh (its collectives cannot be captured),
    the exact Gram (the projected Gram's guard is read on the host) and a
    zoom search (the other searches read values alone, or evaluate their
    trials as a batch)."""
    return (x.is_cuda and rows is None and cfg.n_mstep > 0
            and cfg.mstep_gram == "exact"
            and cfg.linesearch in ("zoom", "zoom_carry"))


def _mstep_graph(x, xtilde, r, theta0: Theta, shared: bool, cfg: FitConfig,
                 bounds, backend: Optional[str] = None, wt=None, wi=None,
                 rows=None):
    """The M-step's graphed evaluator (``optim/graphed``), as a context
    manager, on ``_mstep_graph_route``; elsewhere a null context (None).
    ``_mstep_state`` gives the state it binds each EM iteration; its
    objective is ``_mstep_objective``, called through this module's name
    for it."""
    if not _mstep_graph_route(x, cfg, rows):
        return contextlib.nullcontext()
    lower, upper = bounds

    def objective(theta: Theta, state) -> torch.Tensor:
        return _mstep_objective(theta, x, xtilde, r, shared=shared, cfg=cfg,
                                lower=lower, upper=upper, backend=backend,
                                wt=wt, wi=wi, **state)
    return GraphedValueAndGrad(objective, theta0)


def _mstep_state(es: Eigenspace, m_b, V_b, f_params, win: Window, xcrop):
    """What ``_mstep_graph``'s objective reads that changes between EM
    iterations, for its buffers: the crop window's corner as 0-d tensors
    on the device (an int corner would be part of the captured graph)."""
    if win is not None:
        dev = xcrop[0].device
        win = tuple(torch.full((), v, dtype=torch.int64, device=dev)
                    for v in win[:2]) + (win[2],)
    return dict(es=es, m_b=m_b, V_b=V_b, f_params=f_params, win=win,
                xcrop=xcrop)


def _mstep_ladder(x, xtilde, r, es: Eigenspace, m_b, V_b, f_params,
                  shared: bool, cfg: FitConfig, lower, upper,
                  win: Window = None, xcrop=None,
                  backend: Optional[str] = None, wt=None, wi=None,
                  proj=None, rows=None):
    """The batched evaluator of ``_mstep_objective``'s line-search ladders
    (same arguments): theta a dict of (T,) trial tensors -> (T,) values in
    one evaluation, the trials being the (cell, trial) items of one cell of
    ``_mstep_objective_cells``.  Every trial reads the window's crop (or
    the full frame) and the projection basis as views, and the Grams run
    in chunks of ``ladder_items`` items, sized from the card's free
    memory (the least of every rank's under ``rows``)."""
    # imported here: parallel/population imports this module
    from ..parallel.population import ladder_items
    stim = (x, xtilde, None)
    if win is not None:
        if xcrop is None:
            xc = crop_images(x, win[0], win[1], win[2], cfg.n_px_side)
            xcrop = (xc, xc if shared else crop_images(
                xtilde, win[0], win[1], win[2], cfg.n_px_side))
        corner = torch.tensor(win[:2], device=x.device)
        stim = (xcrop[0][None], xcrop[1][None],
                (corner[:1], corner[1:], win[2]))
    max_items = ladder_items(x.shape[0], xtilde.shape[0], stim[0].shape[-1],
                             x.device)
    if rows is not None:
        # each chunk holds a reduction: every rank runs the same chunks
        max_items = rows.agree_min(max_items)
    cell = dict(stim=stim, r=r[None], es=Eigenspace(*(t[None] for t in es)),
                m_b=m_b[None], V_b=V_b[None],
                f_params={k: v[None] for k, v in f_params.items()},
                shared=shared, cfg=cfg, lower=lower, upper=upper,
                backend=backend, wt=wt, wi=wi, max_items=max_items,
                proj=None if proj is None else proj[0][None], rows=rows)

    def ladder(theta: Theta) -> torch.Tensor:
        return _mstep_objective_cells({k: v[None] for k, v in theta.items()},
                                      **cell)[0]
    return ladder


def _mstep_loss(K_tilde, K, Kvec, es: Eigenspace, m_b, V_b, f_params, r,
                shared: bool, cfg: FitConfig, wt=None, rows=None):
    """The M-step's negative log-marginal from the trial Grams, with the
    eigenspace fixed (of one cell, or of a stack of items).  The inverse of
    K_tilde_b and its log-determinant by ``cfg.mstep_inverse`` and
    ``cfg.mstep_logdet``: the warm forms start from the eigenspace's
    diagonal ``k_tilde_inv_diag``, exact at the iteration-start theta.
    Under ``rows`` (K, Kvec, r: this rank's rows) the sum of every rank's
    share: its rows' ELL less 1/P of the KL, which every rank computes
    whole."""
    B = es.B
    K_tilde_b = B.mT @ (K_tilde @ B)
    K_tilde_b = 0.5 * (K_tilde_b + K_tilde_b.mT)
    K_b = K @ B
    if cfg.mstep_inverse == "schulz":
        K_tilde_inv_b = masked_inverse_warm(
            K_tilde_b, es.keep, es.k_tilde_inv_diag, steps=cfg.schulz_steps,
            fallback=cfg.schulz_fallback)
    else:
        K_tilde_inv_b = masked_inverse_spd(K_tilde_b, es.keep)
    a = _shared_a(B, rows) if shared else K_b @ K_tilde_inv_b
    lambda_m, lambda_var = lambda_moments(a, K_b, Kvec, m_b, V_b)
    f_mean = mean_f_given_lambda_moments(f_params, lambda_m, lambda_var)
    ell = poisson_ell(r, f_mean, lambda_m, f_params, weight=wt)
    # log|V| is constant in theta: omitted.  Cholesky-only logdet: a
    # non-PSD trial K_tilde_b gives NaN -> inf loss -> rejected step.
    ld_K = None
    if cfg.mstep_logdet == "series":
        ld_K = masked_logdet_series(K_tilde_b, es.keep, es.k_tilde_inv_diag)
    kl = kl_divergence(m_b, V_b, es, K_tilde_b=K_tilde_b,
                       K_tilde_inv_b=K_tilde_inv_b, skip_logdet_V=True,
                       chol_only=True, logdet_K=ld_K)
    if rows is None:
        return -(ell - kl)
    return -rows.sum(ell - kl / rows.size)


def _track_update(track: Track, i: int, ell, kl, theta, f_params,
                  es: Eigenspace, m_b, V_b, cfg: FitConfig) -> None:
    """Record iteration i (in place: the track belongs to this fit)."""
    track.logmarginal[i] = ell - kl
    track.loglikelihood[i] = ell
    track.KL[i] = kl
    for k in THETA_KEYS:
        track.theta[k][i] = theta[k]
    track.logA[i] = f_params["logA"]
    track.lambda0[i] = f_params["lambda0"]
    track.n_eigen[i] = torch.sum(es.keep)
    if cfg.track_variational:
        # a reduced-rank state fills the LAST columns of its full-width slot
        # (the sliced basis is the top of the ascending eigh)
        off = track.m_b.shape[1] - m_b.shape[0]
        track.m_b[i, off:] = m_b
        track.V_b[i, off:, off:] = V_b
        if track.B.shape[2] > 0:
            track.B[i, :, track.B.shape[2] - es.B.shape[1]:] = es.B


def _fit_init(x, r, xtilde, theta0: Theta, f_params0: FParams, m0, V0,
              has_V: bool, shared: bool, cfg: FitConfig, win: Window = None,
              backend: Optional[str] = None, wt=None, wi=None,
              kern0: Optional[KernelState] = None, rows=None) -> Carry:
    """Kernels, eigenspace, variational state and tracking
    (reference: utils.py:1667-1791).  ``kern0`` is a precomputed
    KernelState (the reference's ``init_kernel`` warm start,
    utils.py:1674-1694) that skips the initial Gram + eigh."""
    dtype, device = x.dtype, x.device
    ntilde = xtilde.shape[0]
    kern = kern0 if kern0 is not None else _build_kernel_state(
        theta0, x, xtilde, shared, cfg, win, backend, wt, wi, rows=rows)
    es = kern.es
    m_b = es.B.T @ m0
    if has_V:
        V_b = es.B.T @ (V0 @ es.B)
        ld_V0 = None
    else:
        # V init = K_tilde (utils.py:1700): V_b is exactly diagonal, so its
        # kept-block log-determinant is a sum of logs
        V_b = torch.diag(es.k_tilde_b_diag)
        ld_V0 = torch.sum(torch.log(torch.where(
            es.keep, es.eigvals, torch.ones_like(es.eigvals))))
    lambda_m, lambda_var = lambda_moments(kern.a, kern.K_b, kern.Kvec,
                                          m_b, V_b)
    f_mean = mean_f_given_lambda_moments(f_params0, lambda_m, lambda_var)
    ell0 = poisson_ell(r, f_mean, lambda_m, f_params0, weight=wt, rows=rows)
    kl0 = kl_divergence(m_b, V_b, es, logdet_V=ld_V0)

    maxiter = cfg.maxiter
    nvar = ntilde if cfg.track_variational else 0
    nbas = ntilde if (cfg.track_variational and cfg.track_basis) else 0

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    track = Track(
        logmarginal=zeros(maxiter), loglikelihood=zeros(maxiter),
        KL=zeros(maxiter), theta={k: zeros(maxiter) for k in THETA_KEYS},
        logA=zeros(maxiter), lambda0=zeros(maxiter),
        n_eigen=zeros(maxiter, dt=torch.int32),
        m_b=zeros(maxiter, nvar), V_b=zeros(maxiter, nvar, nvar),
        B=zeros(maxiter, ntilde, nbas))
    _track_update(track, 0, ell0, kl0, theta0, f_params0, es, m_b, V_b, cfg)
    mem = ()
    if _mstep_carries_memory(cfg):
        mem = (zoom_carry_init(theta0) if cfg.linesearch == "zoom_carry"
               else empty_lbfgs_memory(len(THETA_KEYS), dtype))
    return Carry(theta0, f_params0, m_b, V_b, kern, lambda_m, lambda_var,
                 track, False, -1, mem)


def _fit_iteration(i: int, c: Carry, x, r, xtilde, shared: bool,
                   cfg: FitConfig, bounds, win: Window = None,
                   do_mstep: bool = True,
                   backend: Optional[str] = None, wt=None, wi=None,
                   warm: bool = False, log: Optional[list] = None,
                   rows=None,
                   mstep_graph: Optional[GraphedValueAndGrad] = None
                   ) -> Carry:
    """One EM iteration (reference loop body: utils.py:1794-2125); a no-op
    once the fit has failed.  ``warm``: the kernel rebuild takes the
    reduced-rank eigenspace from the warm-started subspace eigensolver,
    refreshed by the full eigh when i % eigh_refresh_every == 0 (its route
    goes to ``log``).  ``mstep_graph`` (``_mstep_graph``): the M-step's
    trials are its replays."""
    if c.failed:
        return c
    lower, upper = bounds
    theta, f_params = c.theta, c.f_params
    m_b, V_b, kern = c.m_b, c.V_b, c.kern

    # Rebuild kernels + eigenspace and reproject the variational state
    # (utils.py:1801-1841), at the carry's rank (a width below ntilde is the
    # reduced-rank budget, see _slice_carry).
    if cfg.n_mstep > 0:
        rank = m_b.shape[0]
        refresh = (cfg.eigh_refresh_every > 0
                   and i % cfg.eigh_refresh_every == 0)
        with trace_annotation("fit.kernel_state"):
            kern_new = _build_kernel_state(
                theta, x, xtilde, shared, cfg, win, backend, wt, wi,
                rank=rank if rank < xtilde.shape[0] else None,
                es_warm=kern.es if warm else None, refresh=refresh, log=log,
                rows=rows)
            m_b, V_b = reproject(kern_new.es, kern.es, m_b, V_b)
        kern = kern_new

    # moments + closed-form lambda0 at iteration start (utils.py:1870-1874)
    lambda_m, lambda_var = lambda_moments(kern.a, kern.K_b, kern.Kvec,
                                          m_b, V_b)
    lam0 = lambda0_given_logA(f_params["logA"], r, lambda_m, lambda_var,
                              weight=wt, rows=rows)
    f_params = {"logA": f_params["logA"], "lambda0": lam0}

    if cfg.n_estep > 0:
        with trace_annotation("fit.estep"):
            m_b, V_b, f_params, lambda_m, lambda_var = _estep_block(
                r, kern, m_b, V_b, f_params, lambda_m, lambda_var, cfg, wt,
                rows=rows, backend=backend)

    # loss decomposition (utils.py:1953-1991)
    f_mean = mean_f_given_lambda_moments(f_params, lambda_m, lambda_var)
    ell = poisson_ell(r, f_mean, lambda_m, f_params, weight=wt, rows=rows)
    kl = kl_divergence(m_b, V_b, kern.es)
    theta_start = theta

    # M-step on theta with the eigenspace fixed (utils.py:1999-2114)
    mem = c.mem
    if cfg.n_mstep > 0 and do_mstep:
        xcrop = None
        if win is not None:
            # the theta-independent crop, once per iteration instead of
            # once per line-search evaluation
            xc = crop_images(x, win[0], win[1], win[2], cfg.n_px_side)
            xtc = (xc if shared else
                   crop_images(xtilde, win[0], win[1], win[2], cfg.n_px_side))
            xcrop = (xc, xtc)
        proj = None
        if cfg.mstep_gram == "projected":
            # the smoothing basis at the iteration-start theta (theta moves
            # little within one line search), on the crops; float64 for the
            # projection's guard (gram_matrices_projected)
            side = cfg.n_px_side if win is None else win[2]
            E = smooth_projection_basis(theta, side, cfg.n_px_side,
                                        min(cfg.mstep_proj_rank, side),
                                        dtype=torch.float64)
            proj = ((E, x, xtilde, 0, 0) if win is None
                    else (E, *xcrop, win[0], win[1]))
        obj = partial(_mstep_objective, x=x, xtilde=xtilde, r=r, es=kern.es,
                      m_b=m_b, V_b=V_b, f_params=f_params, shared=shared,
                      cfg=cfg, lower=lower, upper=upper, win=win, xcrop=xcrop,
                      backend=backend, wt=wt, wi=wi, proj=proj, rows=rows)
        vg = None
        if mstep_graph is not None:
            vg = mstep_graph.bind(_mstep_state(kern.es, m_b, V_b, f_params,
                                               win, xcrop))
        ladder = None
        if cfg.linesearch in ("armijo", "speculative"):
            ladder = _mstep_ladder(x, xtilde, r, kern.es, m_b, V_b, f_params,
                                   shared, cfg, lower, upper, win, xcrop,
                                   backend, wt, wi, proj, rows)
        with trace_annotation("fit.mstep"):
            if not _mstep_carries_memory(cfg):
                theta, _ = _minimize(cfg, obj, theta, cfg.n_mstep,
                                     ladder=ladder, gtol=cfg.mstep_gtol,
                                     ftol=cfg.mstep_ftol,
                                     ftol_rel=cfg.mstep_ftol_rel, vg=vg)
            elif cfg.linesearch == "zoom_carry":
                theta, _, mem = lbfgs_minimize_zoom_carry(
                    obj, theta, cfg.n_mstep, state=c.mem,
                    max_linesearch_steps=cfg.max_linesearch_steps,
                    gtol=cfg.mstep_gtol, ftol=cfg.mstep_ftol,
                    ftol_rel=cfg.mstep_ftol_rel, vg=vg)
            else:
                theta, _, mem = lbfgs_minimize_speculative(
                    obj, theta, cfg.n_mstep, max_backtracks=cfg.armijo_trials,
                    memory=c.mem, ladder_fun=ladder)

    # Rollback on numerical failure (utils.py:2127-2189): keep the state
    # this iteration started from and freeze.  Every value read here is
    # whole, and the same, on every rank of a mesh.
    finite = (torch.isfinite(ell - kl) & torch.all(torch.isfinite(m_b))
              & torch.all(torch.isfinite(V_b))
              & torch.all(torch.isfinite(
                  torch.stack([theta[k] for k in THETA_KEYS]))))
    if not bool(finite):
        return c._replace(failed=True, failed_at=i)
    _track_update(c.track, i, ell, kl, theta_start, f_params, kern.es, m_b,
                  V_b, cfg)
    return Carry(theta, f_params, m_b, V_b, kern, lambda_m, lambda_var,
                 c.track, False, -1, mem)


def _fit_finalize(c: Carry, cfg: FitConfig) -> Carry:
    """Final V_b symmetry / PSD repair (utils.py:2243-2248), of one cell or
    of each cell of a stack."""
    V_b = 0.5 * (c.V_b + c.V_b.mT)
    keepf = c.kern.es.keep.to(V_b.dtype)
    ev, finite = _eigvalsh_safe(V_b + torch.diag_embed(1.0 - keepf))
    min_eig = torch.where(finite, ev.amin(-1), float("nan"))
    eye = torch.eye(V_b.shape[-1], dtype=V_b.dtype, device=V_b.device)
    V_b = torch.where((min_eig <= 0)[..., None, None],
                      V_b + eye * cfg.eigval_tol * keepf[..., :, None]
                      * keepf[..., None, :], V_b)
    return c._replace(V_b=V_b)


def _slice_carry(c: Carry, rank: int, shared: bool, rows=None) -> Carry:
    """The carry's stabilized-basis state at another ``rank``.

    Shrinking keeps the LAST ``rank`` coordinates (the top of the ascending
    eigh: exactly the keep-masked subspace whenever rank covers the kept
    eigenvalues, since dropped coordinates are exact zeros).  Growing
    left-pads with zero coordinates (keep=False), which contribute nothing
    until the next kernel rebuild derives the eigenspace at the larger
    rank."""
    es = c.kern.es
    r_in = c.m_b.shape[0]
    if rank == r_in:
        return c
    if rank < r_in:
        sl = slice(r_in - rank, None)
        es_new = Eigenspace(es.B[:, sl], es.eigvals[sl], es.keep[sl],
                            es.k_tilde_b_diag[sl], es.k_tilde_inv_diag[sl])
        K_b = c.kern.K_b[:, sl]
        a = _shared_a(es_new.B, rows) if shared else c.kern.a[:, sl]
        m_b = c.m_b[sl]
        V_b = c.V_b[sl, sl]
    else:
        pad = rank - r_in

        def left(t):
            """t with ``pad`` zero entries (columns) in front."""
            z = t.new_zeros(t.shape[:-1] + (pad,))
            return torch.cat([z, t], dim=-1)

        es_new = Eigenspace(*(left(t) for t in es))
        K_b = left(c.kern.K_b)
        a = _shared_a(es_new.B, rows) if shared else left(c.kern.a)
        m_b = left(c.m_b)
        V_b = c.V_b.new_zeros((rank, rank))
        V_b[pad:, pad:] = c.V_b
    kern = c.kern._replace(es=es_new, K_b=K_b, a=a)
    return c._replace(m_b=m_b, V_b=V_b, kern=kern)


def _rank_bucket(n_eigen: int, cfg: FitConfig, ntilde: int) -> int:
    """Rank budget for a measured kept rank: slack + pad, rounded up to a
    multiple of ``rank_bucket`` so the budget survives modest growth, at
    most ntilde."""
    r = int(n_eigen * cfg.rank_slack) + cfg.rank_pad
    r = ((r + cfg.rank_bucket - 1) // cfg.rank_bucket) * cfg.rank_bucket
    return min(r, ntilde)


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def fit(x: torch.Tensor, r: torch.Tensor, cfg: Optional[FitConfig] = None,
        xtilde: Optional[torch.Tensor] = None,
        theta: Optional[Dict[str, Any]] = None,
        f_params: Optional[Dict[str, Any]] = None,
        m: Optional[torch.Tensor] = None,
        V: Optional[torch.Tensor] = None,
        sample_weight: Optional[torch.Tensor] = None,
        inducing_weight: Optional[torch.Tensor] = None,
        init_kernel: Optional[KernelState] = None,
        generator: Optional[torch.Generator] = None,
        backend: Optional[str] = None,
        profile: bool = False, mesh=None) -> FitResult:
    """Fit the spatial GP to (x, r): the ``varGP`` equivalent.

    x: (nt, nx) stimuli, r: (nt,) spike counts; the fit runs on their
    device and in x's dtype.  ``xtilde``/``theta``/``f_params``/``m``/``V``
    are the reference's warm starts (utils.py:1651-1704).  Without
    ``xtilde`` the inducing rows are a permutation drawn from ``generator``
    (a CPU ``torch.Generator``).

    ``sample_weight`` (nt,) / ``inducing_weight`` (ntilde,) are 0/1 masks
    for the active loop's fixed-capacity buffers: masked points are
    excluded from the fit exactly (with a shared inducing set one mask
    serves both).  ``init_kernel`` is a precomputed KernelState (e.g.
    ``prev.kernel_state`` at the same theta and xtilde) that skips the
    initial Gram + eigh.

    ``backend`` ("cuda" or "torch") overrides the Gram backend chosen from
    the device.  ``profile`` records host wall-clock per iteration (after a
    device synchronize), each iteration's rank budget and, under the
    subspace eigensolver, its route ("warm", "refresh", "fallback"; "eigh"
    at full rank) in ``timing``.  The fit's layers are ``fit.*`` spans
    (``utils/tracing``).

    Under ``mstep_gram="projected"`` with ``mstep_proj_rank`` None, the
    rank is sized from the start theta on the full grid
    (``suggest_proj_rank``, one host read) and the result's config carries
    it.  The warm-started subspace eigensolver runs at every iteration whose
    rank budget is below ntilde (``reduced_rank`` with
    ``eigensolver="subspace"``); ``FitResult.used_warm_basis`` then holds.

    ``mesh`` (``parallel/mesh.make_mesh``; x on its device type, else
    ValueError): the training points are split over its "data" axis (the
    big-nt scale-out of one cell; the cells axis is ``fit_population``'s).
    Every rank passes the whole x and r, as a JAX global array holds them;
    the start theta, the inducing draw, the crop window and the projection
    rank come from them whole, then each rank keeps its rows of x, r and
    ``sample_weight`` and the sums over rows are completed across the axis
    (the module docstring).  Every rank returns the whole result: K, Kvec,
    K_b and a are gathered at the end.
    """
    cfg = cfg or FitConfig()
    dtype, device = x.dtype, x.device
    if x.is_cuda:
        use_full_fp32()
    r = r.to(dtype=dtype, device=device)
    nt = x.shape[0]
    ntilde = cfg.resolve_ntilde(nt)
    if xtilde is None:
        if ntilde == nt:
            xtilde = x
        else:
            idx = torch.randperm(nt, generator=generator)[:ntilde]
            xtilde = x[idx.to(device)]
    else:
        xtilde = xtilde.to(dtype=dtype, device=device)
    if ntilde != xtilde.shape[0]:
        cfg = dataclasses.replace(cfg, ntilde=xtilde.shape[0])
    # inducing set identical to the training set -> shared fast path
    # (reference: K = K_tilde, KKtilde_inv_b = B, utils.py:1677-1694)
    shared = xtilde is x or (xtilde.shape == x.shape
                             and bool(torch.equal(xtilde, x)))

    if theta is None:
        theta0, lower, upper = generate_theta(x, r, cfg.n_px_side)
    else:
        theta0 = {k: torch.as_tensor(v, dtype=dtype, device=device)
                  for k, v in theta.items()}
        lower, upper = theta_bounds()
    if f_params is None:
        fp0 = default_f_params(dtype, device)
    else:
        fp0 = {k: torch.as_tensor(v, dtype=dtype, device=device)
               for k, v in f_params.items()}
    if cfg.mstep_gram == "projected" and cfg.mstep_proj_rank is None:
        gr0 = math.exp(float(theta0["-log2rho2"]))
        cfg = dataclasses.replace(cfg, mstep_proj_rank=suggest_proj_rank(
            gr0, cfg.n_px_side, cfg.n_px_side))
    n = xtilde.shape[0]
    has_V = V is not None
    m0 = (torch.zeros(n, dtype=dtype, device=device) if m is None
          else m.to(dtype=dtype, device=device))
    V0 = V.to(dtype=dtype, device=device) if has_V else None
    wt = (None if sample_weight is None
          else sample_weight.to(dtype=dtype, device=device))
    wi = (None if inducing_weight is None
          else inducing_weight.to(dtype=dtype, device=device))
    if shared and (wt is not None or wi is not None):
        # one buffer, one mask
        wt = wt if wt is not None else wi
        wi = wi if wi is not None else wt

    def probe(th: Theta, es: Optional[Eigenspace] = None):
        """ONE host transfer of what the schedule reads: the crop window's
        theta scalars (-2log2beta, eps_0x, eps_0y) and, for the rank
        budget, the kept rank of ``es``; none when neither is in use."""
        read_rank = es is not None and cfg.reduced_rank
        vals = ([th["-2log2beta"], th["eps_0x"], th["eps_0y"]]
                if cfg.crop_window else [])
        if read_rank:
            vals.append(es.keep.sum().to(dtype))
        got = torch.stack(vals).tolist() if vals else []
        return (tuple(got[:3]) if cfg.crop_window else None,
                int(got[-1]) if read_rank else None)

    def window(scalars) -> Window:
        if not cfg.crop_window:
            return None
        i0, j0, w = crop_window_from_scalars(
            *scalars, cfg.n_px_side, cfg.alpha_threshold, cfg.crop_margin,
            cfg.crop_bucket)
        return None if w >= cfg.n_px_side else (i0, j0, w)

    def covers(win: Window, scalars) -> bool:
        """The window still covers the margin-1.0 alpha mask of the theta
        with these scalars."""
        if win is None:
            return True
        fi0, fj0, fw = crop_window_from_scalars(
            *scalars, cfg.n_px_side, cfg.alpha_threshold, 1.0, 1)
        i0, j0, w = win
        return (fi0 >= i0 and fj0 >= j0
                and fi0 + fw <= i0 + w and fj0 + fw <= j0 + w)

    def clock() -> float:
        if x.is_cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    # this rank's rows under a mesh (a shared inducing set keeps x whole:
    # its Grams read only xtilde, and K is this rank's rows of K_tilde)
    rows, xr, rr, wtr, kern0 = None, x, r, wt, init_kernel
    if mesh is not None:
        # imported here: parallel/ imports this module
        from ..parallel.collectives import data_rows
        rows = data_rows(mesh, nt, x)
        rr = rows.take(r, 0)
        wtr = None if wt is None else rows.take(wt, 0)
        if not shared:
            xr = rows.take(x, 0)
        if kern0 is not None:
            kern0 = kern0._replace(K=rows.take(kern0.K, 0),
                                   Kvec=rows.take(kern0.Kvec, 0),
                                   K_b=rows.take(kern0.K_b, 0),
                                   a=rows.take(kern0.a, 0))

    bounds = (lower, upper)
    timing = ({"per_iteration": [], "rank": [], "eigensolver": []}
              if profile else None)
    n_eig_hist: List[int] = []
    used_warm = False
    with torch.no_grad(), _mstep_graph(xr, xtilde, rr, theta0, shared, cfg,
                                       bounds, backend, wtr, wi,
                                       rows) as mstep_graph:
        t0 = clock() if profile else 0.0
        with trace_annotation("fit.init"):
            carry = _fit_init(xr, rr, xtilde, theta0, fp0, m0, V0, has_V,
                              shared, cfg, window(probe(theta0)[0]), backend,
                              wtr, wi, kern0, rows)
        if profile:
            timing["init"] = clock() - t0
        # theta and the eigenspace are whole, and the same, on every rank of
        # a mesh: so are the window, the budget and the cover test
        scalars, n_eig = probe(carry.theta, carry.kern.es)
        for i in range(1, cfg.maxiter):
            ti = clock() if profile else 0.0
            win = window(scalars)
            if cfg.reduced_rank:
                # the budget from the largest kept rank of the last three
                # iterations, so it does not flap between two buckets
                n_eig_hist.append(n_eig)
                budget = _rank_bucket(max(n_eig_hist[-3:]), cfg, n)
                carry = _slice_carry(carry, budget, shared, rows)
            # the warm-started eigensolver at every reduced-rank iteration
            # (the first one starts from init's full eigh, so it is exact)
            warm = (cfg.reduced_rank and cfg.eigensolver == "subspace"
                    and carry.m_b.shape[0] < n)
            used_warm = used_warm or warm
            routes: List[str] = []
            with trace_annotation("fit.iteration"):
                carry = _fit_iteration(i, carry, xr, rr, xtilde, shared, cfg,
                                       bounds, win,
                                       do_mstep=(i < cfg.maxiter - 1),
                                       backend=backend, wt=wtr, wi=wi,
                                       warm=warm, log=routes, rows=rows,
                                       mstep_graph=mstep_graph)
                scalars, n_eig = probe(carry.theta, carry.kern.es)
            if profile:
                timing["per_iteration"].append(clock() - ti)
                timing["rank"].append(carry.m_b.shape[0])
                timing["eigensolver"].append(routes[0] if routes else "eigh")
            if not carry.failed and not covers(win, scalars):
                # the window no longer covers the RF: that iteration's
                # kernels were inexact -- never return such a fit
                if cfg.crop_margin * 2.0 <= 8.0:
                    grown = dataclasses.replace(
                        cfg, crop_margin=cfg.crop_margin * 2.0)
                    how = f"crop_margin {cfg.crop_margin} -> {grown.crop_margin}"
                else:
                    grown = dataclasses.replace(cfg, crop_window=False)
                    how = "crop_window=False (full frame)"
                warnings.warn(
                    f"crop window used at EM iteration {i} no longer covers "
                    "the RF alpha mask of the resulting theta; re-running "
                    f"the fit with {how}")
                if mstep_graph is not None:
                    # the re-run captures its own graphs: free this one's
                    mstep_graph.close()
                return fit(x, r, grown, xtilde=xtilde, theta=theta,
                           f_params=f_params, m=m, V=V,
                           sample_weight=sample_weight,
                           inducing_weight=inducing_weight,
                           init_kernel=init_kernel, backend=backend,
                           profile=profile, mesh=mesh)
        with trace_annotation("fit.finalize"):
            carry = _fit_finalize(carry, cfg)
        if profile:
            timing["total"] = clock() - t0
    decisions.fold()

    # row-major copies of eigh's column-major basis and of sliced views:
    # a result then computes the same as its checkpoint (utils/io), whose
    # arrays load row-major
    kern = carry.kern._replace(K_b=carry.kern.K_b.contiguous(),
                               a=carry.kern.a.contiguous())
    if rows is not None:
        kern = kern._replace(**{name: rows.gather(getattr(kern, name), 0)
                                for name in ("K", "Kvec", "K_b", "a")})
    es = Eigenspace(*(t.contiguous() for t in kern.es))
    return FitResult(
        config=cfg, xtilde=xtilde, theta=carry.theta, theta_lower=lower,
        theta_upper=upper, f_params=carry.f_params,
        m_b=carry.m_b.contiguous(), V_b=carry.V_b.contiguous(), B=es.B,
        keep=es.keep, eigvals=es.eigvals, k_tilde_b_diag=es.k_tilde_b_diag,
        k_tilde_inv_diag=es.k_tilde_inv_diag, K_tilde=kern.K_tilde,
        K=kern.K, Kvec=kern.Kvec, K_b=kern.K_b, a=kern.a, track=carry.track,
        failed=carry.failed, failed_at=carry.failed_at, timing=timing,
        used_warm_basis=used_warm)


# ---------------------------------------------------------------------------
# The whole-fit program on a cell axis (the JAX ``_fit_program`` as
# ``parallel/population.py`` vmaps it)
# ---------------------------------------------------------------------------
#
# Every tensor of the carry has a leading cell axis: theta and f-params are
# dicts of (L,) tensors, m_b (L, ntilde), the track (L, maxiter, ...),
# failed (L,) and failed_at (L,).  The program is branch-free in the data:
# kernels and eigenspace are rebuilt every iteration, both inner
# optimizations are the batched Armijo L-BFGS, and rollback and freeze are
# per-cell selections.  The crop window is fixed for the whole program:
# per-cell corners with one shared side.

Cells = Tuple[torch.Tensor, torch.Tensor, Optional[Tuple[Any, Any, int]]]


def cell_stimuli(x, xtilde, shared: bool, cfg: FitConfig,
                 win=None) -> Cells:
    """The program's theta-independent stimuli: (x, xtilde, None) on the
    full frame, or each cell's crop at its corner ``win = (i0s, j0s, w)``:
    (xc (L, nt, w^2), xtc (L, ntilde, w^2), win), cropped once."""
    if win is None:
        return x, xtilde, None
    i0s, j0s, w = win
    xc = crop_images(x, i0s, j0s, w, cfg.n_px_side)
    xtc = xc if shared else crop_images(xtilde, i0s, j0s, w, cfg.n_px_side)
    return xc, xtc, win


# An item's value and gradient hold about twice the device memory of its
# value alone (the backward's planes beside the forward's saved ones), so
# the M-step's gradient call runs in chunks of half the ladder's items.
GRAD_CHUNK_DIVISOR = 2


def _chunks(n: int, max_items: Optional[int]) -> List[slice]:
    """Slices of at most ``max_items`` items that cover range(n) (one slice
    when max_items is None)."""
    size = n if max_items is None else max(1, max_items)
    return [slice(s0, min(s0 + size, n)) for s0 in range(0, n, size)]


def _take(t: torch.Tensor, cells) -> torch.Tensor:
    """t[cells] of a cell-stacked tensor; for an index tensor into a stack
    of one cell, a view of that cell expanded to len(cells) (a single-cell
    ladder's trials share the cell's stimuli and state without copies)."""
    if t.shape[0] == 1 and isinstance(cells, torch.Tensor):
        return t.expand(cells.shape[0], *t.shape[1:])
    return t[cells]


def _cell_grams(theta: Theta, stim: Cells, lane, shared: bool,
                cfg: FitConfig, backend: Optional[str] = None,
                max_items: Optional[int] = None, proj=None):
    """(K_tilde, K, Kvec) of a stack of items at theta (B,): item b belongs
    to cell ``lane[b]`` (None: item b is cell b).  The items run in chunks
    of at most ``max_items`` (the memory budget of one chunk of Grams; None:
    one chunk).

    ``proj``: the cells' projection bases (L, w, R); each item's Gram is
    then ``gram_matrices_projected``'s and the result (K_tilde, K, Kvec,
    ok).  Under ``mstep_proj_fallback="exact"`` the items out of tolerance
    take the exact Gram (one host read per chunk; when any fails, the exact
    Grams of the chunk are built and selected item by item, as the JAX
    package's vmapped fallback computes both branches) and ``ok`` holds
    everywhere.  Inside ``collect_spans`` each chunk adds 1 to
    ``grams.chunks`` and its items to ``grams.items``."""
    x, xtilde, win = stim
    parts = []
    for sl in _chunks(theta["Amp"].shape[0], max_items):
        count("grams.chunks")
        count("grams.items", sl.stop - sl.start)
        th = {k: v[sl] for k, v in theta.items()}
        cells = sl if lane is None else lane[sl]
        if win is None:
            xc, xtc, i0, j0 = x, xtilde, 0, 0

            def exact():
                return gram_matrices(th, x, xtilde, cfg.n_px_side, shared,
                                     cfg.alpha_threshold, backend)
        else:
            xc = _take(x, cells)
            xtc = xc if shared else _take(xtilde, cells)
            i0, j0 = _take(win[0], cells), _take(win[1], cells)

            def exact():
                return gram_matrices_precropped(
                    th, xc, xtc, cfg.n_px_side, shared, i0, j0, win[2],
                    cfg.alpha_threshold, backend)
        if proj is None:
            parts.append(exact())
            continue
        *grams, ok = gram_matrices_projected(
            th, xc, xtc, _take(proj, cells), i0, j0, cfg.n_px_side, shared,
            cfg.alpha_threshold, cfg.mstep_proj_tol, backend)
        if cfg.mstep_proj_fallback == "exact":
            if read_guard(ok, "mstep.projected",
                          "mstep.exact_gram") < ok.numel():
                grams = [torch.where(ok.view(-1, *[1] * (g.dim() - 1)), g, e)
                         for g, e in zip(grams, exact())]
            ok = torch.ones_like(ok)
        parts.append((*grams, ok))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(p) for p in zip(*parts))


class _Precomputed(torch.autograd.Function):
    """``value`` (items,) whose gradient with respect to each input (items,)
    is the matching precomputed one, item by item (each item's value
    depends on its own entry of each input alone)."""

    @staticmethod
    def forward(ctx, value, *inputs_then_grads):
        ctx.save_for_backward(*inputs_then_grads[len(inputs_then_grads) // 2:])
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        grads = ctx.saved_tensors
        return (None, *(g * d for d in grads), *(None for _ in grads))


def _gradient_now(loss: torch.Tensor, inputs: Theta) -> torch.Tensor:
    """``loss`` (items,) with its gradient with respect to ``inputs`` taken
    at once: the result has the same values and hands that gradient back to
    the caller's backward, so the graph behind ``loss`` (the Grams' saved
    planes) is freed now instead of living until then."""
    xs = list(inputs.values())
    grads = torch.autograd.grad(loss.sum(), xs, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d
             for x, d in zip(xs, grads)]
    return _Precomputed.apply(loss.detach(), *xs, *grads)


def _mstep_objective_cells(theta: Theta, stim: Cells, r, es: Eigenspace,
                           m_b, V_b, f_params, shared: bool, cfg: FitConfig,
                           lower, upper, backend: Optional[str] = None,
                           max_items: Optional[int] = None, wt=None, wi=None,
                           proj=None, rows=None):
    """The M-step objective of every (cell, trial) item: theta a dict of
    (L, T) tensors, the other arguments the cells' (L, ...) state; returns
    (L, T).  The L x T items run in chunks of at most ``max_items`` (the
    memory budget of one chunk of Grams); under autograd, in chunks of
    ``max_items // GRAD_CHUNK_DIVISOR``, each chunk's gradient taken before
    the next chunk is built.  ``wt``/``wi``: pad weights (nt,)/(ntilde,)
    shared by every cell (a single-cell ladder's).  ``proj``: the cells'
    projection bases (L, w, R) under ``mstep_gram="projected"``
    (``_cell_grams``); an item whose projection fails its guard under the
    "poison" fallback is +inf.  With L = 1 (the single-cell ladder), every
    item is ``_mstep_objective`` at its trial.  ``rows``: the mesh's "data"
    axis, as ``_mstep_objective``'s (every rank runs the same chunks).
    A call is a ``fit.mstep.grad`` span under autograd (the chunks'
    gradients included), else a ``fit.mstep.ladder`` span."""
    if rows is not None:
        theta = rows.enter(theta)
    L, T = theta["Amp"].shape
    n = L * T
    flat = {k: v.reshape(n) for k, v in theta.items()}
    lane = torch.arange(n, device=m_b.device) // T
    grad = torch.is_grad_enabled()
    if grad and max_items is not None:
        max_items = max_items // GRAD_CHUNK_DIVISOR
    out = []
    with trace_annotation("fit.mstep.grad" if grad else "fit.mstep.ladder"):
        for sl in _chunks(n, max_items):
            ln = lane[sl]
            th = {k: v[sl] for k, v in flat.items()}
            ok = theta_in_bounds(th, lower, upper)
            grams = _cell_grams(clip_theta(th, lower, upper), stim, ln,
                                shared, cfg, backend, proj=proj)
            if proj is not None:
                *grams, p_ok = grams
                ok = ok & p_ok
            es_i = Eigenspace(*(_take(t, ln) for t in es))
            loss = _mstep_loss(
                *_apply_pad_weights(*grams, shared, wt, wi, rows), es_i,
                _take(m_b, ln), _take(V_b, ln),
                {k: _take(v, ln) for k, v in f_params.items()},
                _take(r, ln), shared, cfg, wt, rows)
            loss = torch.where(ok & torch.isfinite(loss), loss,
                               float("inf"))
            if grad and loss.requires_grad:
                loss = _gradient_now(loss, th)
            out.append(loss)
    return torch.cat(out).reshape(L, T)


def _track_update_cells(track: Track, i: int, ell, kl, theta, f_params,
                        es: Eigenspace, m_b, V_b, cfg: FitConfig,
                        commit=None) -> None:
    """Write row i of each cell's track in place; a cell where ``commit``
    (L,) is False keeps its old row."""
    def put(buf, val):
        val = val.to(buf.dtype)
        if commit is not None:
            val = torch.where(commit.view(-1, *[1] * (val.dim() - 1)), val,
                              buf[:, i])
        buf[:, i] = val

    put(track.logmarginal, ell - kl)
    put(track.loglikelihood, ell)
    put(track.KL, kl)
    for k in THETA_KEYS:
        put(track.theta[k], theta[k])
    put(track.logA, f_params["logA"])
    put(track.lambda0, f_params["lambda0"])
    put(track.n_eigen, es.keep.sum(-1))
    if cfg.track_variational:
        put(track.m_b, m_b)
        put(track.V_b, V_b)


def _where_cells(mask, a, b):
    """Per cell: ``a`` where mask (L,), else ``b``, over tensors, dicts and
    named tuples alike."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.view(-1, *[1] * (a.dim() - 1)), a, b)
    if isinstance(a, dict):
        return {k: _where_cells(mask, a[k], b[k]) for k in a}
    parts = [_where_cells(mask, u, v) for u, v in zip(a, b)]
    return type(a)(*parts) if hasattr(a, "_fields") else tuple(parts)


def _cell_kernel_state(theta: Theta, stim: Cells, shared: bool,
                       cfg: FitConfig, backend: Optional[str],
                       max_items: Optional[int], rows) -> KernelState:
    """Every cell's kernel state at theta (L,) (K and Kvec: this rank's rows
    under ``rows``)."""
    grams = _cell_grams(theta, stim, None, shared, cfg, backend, max_items)
    return _kernel_state(*_apply_pad_weights(*grams, shared, rows=rows),
                         shared, cfg, rows=rows)


def _fit_init_cells(stim: Cells, rs, theta0: Theta, f_params0: FParams,
                    shared: bool, cfg: FitConfig,
                    backend: Optional[str] = None,
                    max_items: Optional[int] = None, rows=None) -> Carry:
    """``_fit_init`` for every cell at once, from m = 0 and V = K_tilde."""
    L, ntilde = rs.shape[0], stim[1].shape[-2]
    dtype, device = rs.dtype, rs.device
    with trace_annotation("fit.kernel_state"):
        kern = _cell_kernel_state(theta0, stim, shared, cfg, backend,
                                  max_items, rows)
    es = kern.es
    m_b = mv(es.B.mT, torch.zeros((L, ntilde), dtype=dtype, device=device))
    V_b = torch.diag_embed(es.k_tilde_b_diag)
    ld_V0 = torch.sum(torch.log(torch.where(
        es.keep, es.eigvals, torch.ones_like(es.eigvals))), dim=-1)
    lambda_m, lambda_var = lambda_moments(kern.a, kern.K_b, kern.Kvec,
                                          m_b, V_b)
    f_mean = mean_f_given_lambda_moments(f_params0, lambda_m, lambda_var)
    ell0 = poisson_ell(rs, f_mean, lambda_m, f_params0, rows=rows)
    kl0 = kl_divergence(m_b, V_b, es, logdet_V=ld_V0)

    maxiter = cfg.maxiter
    nvar = ntilde if cfg.track_variational else 0

    def zeros(*shape, dt=dtype):
        return torch.zeros((L, maxiter) + shape, dtype=dt, device=device)

    track = Track(
        logmarginal=zeros(), loglikelihood=zeros(), KL=zeros(),
        theta={k: zeros() for k in THETA_KEYS}, logA=zeros(),
        lambda0=zeros(), n_eigen=zeros(dt=torch.int32),
        m_b=zeros(nvar), V_b=zeros(nvar, nvar), B=zeros(ntilde, 0))
    _track_update_cells(track, 0, ell0, kl0, theta0, f_params0, es, m_b,
                        V_b, cfg)
    return Carry(theta0, f_params0, m_b, V_b, kern, lambda_m, lambda_var,
                 track, torch.zeros(L, dtype=torch.bool, device=device),
                 torch.full((L,), -1, dtype=torch.int32, device=device), ())


def _fit_iteration_cells(i: int, c: Carry, stim: Cells, rs, shared: bool,
                         cfg: FitConfig, bounds, do_mstep: bool = True,
                         backend: Optional[str] = None,
                         max_items: Optional[int] = None, rows=None) -> Carry:
    """One EM iteration of every cell (JAX ``_fit_iteration`` under vmap):
    no host branch on the data.  A cell whose iteration is not finite
    reverts to the state it started from and is marked failed at i; a
    failed cell stays frozen."""
    lower, upper = bounds
    theta, f_params = c.theta, c.f_params
    m_b, V_b, kern = c.m_b, c.V_b, c.kern

    if cfg.n_mstep > 0:
        with trace_annotation("fit.kernel_state"):
            kern_new = _cell_kernel_state(theta, stim, shared, cfg, backend,
                                          max_items, rows)
            m_b, V_b = reproject(kern_new.es, kern.es, m_b, V_b)
        kern = kern_new

    lambda_m, lambda_var = lambda_moments(kern.a, kern.K_b, kern.Kvec,
                                          m_b, V_b)
    lam0 = lambda0_given_logA(f_params["logA"], rs, lambda_m, lambda_var,
                              rows=rows)
    f_params = {"logA": f_params["logA"], "lambda0": lam0}
    if cfg.n_estep > 0:
        with trace_annotation("fit.estep"):
            m_b, V_b, f_params, lambda_m, lambda_var = _estep_block(
                rs, kern, m_b, V_b, f_params, lambda_m, lambda_var, cfg,
                lanes=True, rows=rows)

    f_mean = mean_f_given_lambda_moments(f_params, lambda_m, lambda_var)
    ell = poisson_ell(rs, f_mean, lambda_m, f_params, rows=rows)
    kl = kl_divergence(m_b, V_b, kern.es)
    theta_start = theta

    if cfg.n_mstep > 0 and do_mstep:
        proj = None
        if cfg.mstep_gram == "projected":
            # each cell's smoothing basis at its iteration-start theta
            side = cfg.n_px_side if stim[2] is None else stim[2][2]
            proj = smooth_projection_basis(theta, side, cfg.n_px_side,
                                           min(cfg.mstep_proj_rank, side),
                                           dtype=torch.float64)
        obj = partial(_mstep_objective_cells, stim=stim, r=rs, es=kern.es,
                      m_b=m_b, V_b=V_b, f_params=f_params, shared=shared,
                      cfg=cfg, lower=lower, upper=upper, backend=backend,
                      max_items=max_items, proj=proj, rows=rows)
        with trace_annotation("fit.mstep"):
            theta, _ = _minimize(cfg, obj, theta, cfg.n_mstep, lanes=True)

    finite = (torch.isfinite(ell - kl) & torch.isfinite(m_b).all(-1)
              & torch.isfinite(V_b).flatten(-2).all(-1)
              & torch.isfinite(torch.stack([theta[k] for k in THETA_KEYS],
                                           -1)).all(-1))
    commit = finite & ~c.failed
    _track_update_cells(c.track, i, ell, kl, theta_start, f_params, kern.es,
                        m_b, V_b, cfg, commit)
    new = Carry(theta, f_params, m_b, V_b, kern, lambda_m, lambda_var,
                c.track, c.failed, c.failed_at)
    out = _where_cells(commit, new[:7], c[:7])
    failed_now = ~finite & ~c.failed
    return Carry(*out, c.track, c.failed | failed_now,
                 torch.where(failed_now, i, c.failed_at).to(torch.int32),
                 c.mem)


def fit_cells_program(stim: Cells, rs, theta0: Theta, f_params0: FParams,
                      shared: bool, cfg: FitConfig, bounds,
                      backend: Optional[str] = None,
                      max_items: Optional[int] = None, rows=None) -> Carry:
    """The whole EM fit of every cell (JAX ``_fit_program`` vmapped over
    cells, at full rank): init, maxiter - 1 iterations (the last without an
    M-step), finalize.  ``max_items`` bounds the items of one chunk of Grams
    (None: every item at once; under ``rows`` the same on every rank).
    ``rows``: the stimuli and ``rs`` hold this rank's rows of the mesh's
    "data" axis (a shared set: x whole), as ``fit``'s.  Returns the
    cell-stacked carry (this rank's rows of its row leaves).

    Its spans are the single-cell fit's: ``fit.init``, ``fit.iteration``,
    ``fit.kernel_state`` (the batched Grams, eigh and reprojection, in the
    init too), ``fit.estep`` (with ``fit.estep.newton`` and
    ``fit.estep.fparams``), ``fit.mstep`` and ``fit.finalize``; inside
    ``fit.mstep``, ``fit.mstep.ladder`` around each value-only ladder call
    of the batched Armijo search and ``fit.mstep.grad`` around each
    value-and-gradient call (``_mstep_objective_cells``).  Inside ``collect_spans`` the Grams' chunks
    are counted (``grams.chunks``, ``grams.items``: ``_cell_grams``)."""
    with torch.no_grad():
        with trace_annotation("fit.init"):
            carry = _fit_init_cells(stim, rs, theta0, f_params0, shared, cfg,
                                    backend, max_items, rows)
        for i in range(1, cfg.maxiter):
            with trace_annotation("fit.iteration"):
                carry = _fit_iteration_cells(i, carry, stim, rs, shared, cfg,
                                             bounds,
                                             do_mstep=(i < cfg.maxiter - 1),
                                             backend=backend,
                                             max_items=max_items, rows=rows)
        with trace_annotation("fit.finalize"):
            carry = _fit_finalize(carry, cfg)
    decisions.fold()
    return carry
