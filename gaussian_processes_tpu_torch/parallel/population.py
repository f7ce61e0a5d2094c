"""Population fits: many cells, one stimulus set
(counterpart of ``gaussian_processes_tpu/parallel/population.py``).

The reference fits one retinal ganglion cell at a time; a recording holds
tens of cells' responses to the same stimuli.  ``fit_population`` runs the
whole EM fit of every cell at once on a leading cell axis
(``models/fit.fit_cells_program``): each cell keeps its own
hyperparameters, kernels, eigenspace and variational state, every Gram of
every cell and line-search trial goes through one batched kernel launch,
and no step reads a value back to the host to decide what to do next.
``fit_cells_sequential`` fits the cells one after another through the
single-cell ``fit``.

``mesh=`` (``parallel/mesh.make_mesh``) spreads the program over a
("cells", "data") mesh as the JAX package's GSPMD program does: each
"cells" coordinate fits its slice of the cells, with their training points
split over "data" (``models/fit.fit_cells_program(rows=)``), and every
rank returns the whole carry.  The JAX package's ahead-of-time lowering
hook (``lower_only=``) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from ..config import FitConfig, resolve_device, use_full_fp32
from ..models.fit import (Carry, FitResult, KernelState, cell_stimuli, fit,
                          fit_cells_program)
from ..ops.kernels import crop_window_for_theta, suggest_proj_rank
from ..params import default_f_params, generate_theta, theta_bounds
from .collectives import data_rows, gather_cat
from .mesh import population_shardings

# Bytes of device memory one (cell, trial) item of the M-step's trial ladder
# takes, per float32 element of its stimuli (rows nt + ntilde, times the
# contraction: the weighted images, the smoothing pass, the kernel's input
# and its split planes) and per element of its (nt + ntilde, ntilde) state
# (its two Grams, the basis and V_b gathered for it, the projections, the
# Newton-Schulz iterates and the moments' products).  Fitted to an item's
# value call on an H100 at nt 3160, ntilde 2100: 247, 589 and 1,235 MB at
# contraction 1,024, 4,096 and 11,664, which the two terms cover with 3-15%
# to spare (284, 608 and 1,404 MB); the gradient call's 540, 1,035 and
# 2,273 MB take GRAD_CHUNK_DIVISOR items' room (``models/fit.py``).
LADDER_BYTES_PER_ELEMENT = 5 * 4
LADDER_STATE_BYTES_PER_ELEMENT = 4 * 4
# Share of the free device memory one chunk of the ladder may take.
LADDER_MEMORY_SHARE = 0.5


def _vmap_safe_config(cfg: FitConfig) -> FitConfig:
    """The knobs of the batched program (JAX ``_vmap_safe_config``): the
    branch-free batched Armijo L-BFGS at both inner call sites (the zoom
    search maps to it, as in the JAX ``fit_population``), no convergence
    gates (mstep_gtol, mstep_ftol, mstep_ftol_rel and estep_tol zeroed),
    the warm M-step inverse's and the projected Gram's fallbacks "poison"
    (a NaN inverse or +inf loss per item, no host read), and the exact
    forms of the E-step solver ("schulz" -> "chol") and of the M-step
    log-determinant ("series" -> "chol"), whose fallbacks every cell
    would otherwise pay on top.  The per-cell results carry this config,
    so the single-cell ``fit`` under it (on the program's window) is each
    lane's oracle.

    The speculative, backtracking and zoom_carry searches raise: JAX vmaps
    those single-lane searches, while this program runs the batched Armijo
    search only; ``fit_cells_sequential`` runs each cell through ``fit``,
    which has them all.

    The JAX ``fit_population`` also caps ``max_linesearch_steps`` at 5, a
    budget of the zoom search the program never runs, and sets
    ``remat_gram``, which the port does not have (here chunks of Grams
    sized by ``ladder_items`` bound the memory instead)."""
    if cfg.linesearch in ("speculative", "backtracking", "zoom_carry"):
        raise ValueError(
            f"fit_population runs the batched Armijo search only, not the "
            f"single-lane linesearch={cfg.linesearch!r}: fit the cells with "
            f"fit_cells_sequential, which supports every search")
    if cfg.linesearch == "zoom":
        cfg = dataclasses.replace(cfg, linesearch="armijo")
    if cfg.mstep_inverse == "schulz" and cfg.schulz_fallback == "exact":
        cfg = dataclasses.replace(cfg, schulz_fallback="poison")
    if cfg.mstep_gram == "projected" and cfg.mstep_proj_fallback == "exact":
        cfg = dataclasses.replace(cfg, mstep_proj_fallback="poison")
    if cfg.mstep_gtol or cfg.mstep_ftol or cfg.mstep_ftol_rel or cfg.estep_tol:
        cfg = dataclasses.replace(cfg, mstep_gtol=0.0, mstep_ftol=0.0,
                                  mstep_ftol_rel=0.0, estep_tol=0.0)
    if cfg.estep_solver == "schulz":
        cfg = dataclasses.replace(cfg, estep_solver="chol")
    if cfg.mstep_logdet == "series":
        cfg = dataclasses.replace(cfg, mstep_logdet="chol")
    return cfg


def _per_cell(values, ncells: int, dtype, device) -> Dict[str, torch.Tensor]:
    """A dict of scalars or (ncells,) values as (ncells,) tensors."""
    return {k: torch.as_tensor(v, dtype=dtype, device=device).expand(
        ncells).clone() for k, v in values.items()}


def ladder_item_bytes(nt: int, ntilde: int, k: int) -> int:
    """Device bytes one (cell, trial) item of the ladder takes: its
    stimuli's planes and its state (``LADDER_BYTES_PER_ELEMENT``,
    ``LADDER_STATE_BYTES_PER_ELEMENT``)."""
    return (nt + ntilde) * (LADDER_BYTES_PER_ELEMENT * k
                            + LADDER_STATE_BYTES_PER_ELEMENT * ntilde)


def ladder_items(nt: int, ntilde: int, k: int, device) -> Optional[int]:
    """The number of items (cells, or (cell, trial) pairs) of one chunk of
    Grams: of the M-step's ladder and of each kernel rebuild (the gradient
    call takes 1/GRAD_CHUNK_DIVISOR of it, ``models/fit.py``).
    LADDER_MEMORY_SHARE of the card's free memory (the driver's free bytes
    plus what PyTorch's allocator holds unused) over one item's bytes
    (``ladder_item_bytes``).  None (one chunk) off the card."""
    if torch.device(device).type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return max(1, int(free * LADDER_MEMORY_SHARE)
               // ladder_item_bytes(nt, ntilde, k))


def population_window(thetas: Dict[str, torch.Tensor], cfg: FitConfig):
    """The program's fixed crop window (JAX ``population.py:166-183``):
    each cell's window at ``crop_margin * 1.5`` from its initial theta, the
    widest side shared by all and the corners clamped into the frame;
    None when that side is the full frame."""
    if not cfg.crop_window:
        return None
    ncells = thetas["Amp"].shape[0]
    wins = [crop_window_for_theta({k: v[c] for k, v in thetas.items()},
                                  cfg.n_px_side, cfg.alpha_threshold,
                                  cfg.crop_margin * 1.5, cfg.crop_bucket)
            for c in range(ncells)]
    w_max = max(w for _, _, w in wins)
    if w_max >= cfg.n_px_side:
        return None
    hi = cfg.n_px_side - w_max
    i0s = [max(0, min(i, hi)) for i, _, _ in wins]
    j0s = [max(0, min(j, hi)) for _, j, _ in wins]
    device = thetas["Amp"].device
    return (torch.tensor(i0s, device=device), torch.tensor(j0s, device=device),
            w_max)


def _tree_map(fn, tree):
    """fn over every tensor of a carry (tensors, dicts, tuples and named
    tuples)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    parts = [_tree_map(fn, v) for v in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def _gather_carry(carry: Carry, mesh, rows) -> Carry:
    """The whole cell-stacked carry from every rank's: the row leaves (the
    Grams' rows and the moments) gathered over "data", then every leaf
    over "cells"."""
    def row(t):
        return rows.gather(t, 1)
    kern = carry.kern
    carry = carry._replace(
        kern=KernelState(kern.K_tilde, row(kern.K), row(kern.Kvec), kern.es,
                         row(kern.K_b), row(kern.a)),
        lambda_m=row(carry.lambda_m), lambda_var=row(carry.lambda_var))
    group = mesh.get_group("cells")
    n_coords = mesh.size(0)
    return _tree_map(lambda t: gather_cat(t, group, [t.shape[0]] * n_coords),
                     carry)


def fit_population(x, rs, cfg: Optional[FitConfig] = None, xtilde=None,
                   thetas: Optional[Dict] = None,
                   f_params: Optional[Dict] = None, seed: int = 0,
                   device=None, backend: Optional[str] = None, mesh=None):
    """Fit every cell of ``rs`` (ncells, nt) against the stimuli ``x`` (nt,
    nx) in one batched program.

    ``device``: where the fit runs (default: x's device when x is a tensor,
    else the CUDA card; numpy input without a card raises).  ``thetas`` and
    ``f_params`` may carry a leading cell axis or be scalars (broadcast);
    without ``thetas`` every cell starts from ``generate_theta`` of the
    first cell.  Without ``xtilde`` the inducing rows are a permutation of
    x's drawn from ``torch.Generator().manual_seed(seed)`` (the JAX package
    draws them from ``jax.random.PRNGKey(seed)``, so the rows differ).
    The Grams of the M-step's trial ladder, its gradient call and every
    kernel rebuild run in chunks of items sized by ``ladder_items`` from
    the card's free memory (one chunk on the CPU), so the memory does not
    grow with the number of cells beyond their (ntilde, ntilde) and (nt,
    ntilde) state.
    ``backend`` overrides the Gram backend.  The program marks its layers
    with the single-cell fit's spans (``fit.init``, ``fit.iteration``,
    ``fit.kernel_state``, ``fit.estep``, ``fit.mstep`` with
    ``fit.mstep.ladder`` and ``fit.mstep.grad``, ``fit.finalize``) and,
    inside ``utils.tracing.collect_spans``, counts its chunks of Grams
    (``grams.chunks``) and their items (``grams.items``):
    ``models/fit.fit_cells_program``.

    ``mesh`` (x on its device type, else ValueError): every rank passes the
    whole x and rs; the start thetas, the inducing draw, the crop window
    and the projection rank come from them whole, then each rank fits its
    slice of the cells on its rows (``population_shardings``; ncells must
    divide by the "cells" axis), the chunks sized from its rows and agreed
    over "data".  Every rank returns the whole carry.

    Returns ``(carry, (lower, upper))``: the cell-stacked carry (leading
    axis = cell) and the theta bounds; ``population_results`` splits it.
    """
    device = resolve_device(x, device)
    x = torch.as_tensor(x, device=device)
    dtype = x.dtype
    if x.is_cuda:
        use_full_fp32()
    rs = torch.as_tensor(rs, dtype=dtype, device=device)
    cfg = cfg or FitConfig()
    ncells, nt = rs.shape
    ntilde = cfg.resolve_ntilde(nt)
    if xtilde is None:
        if ntilde == nt:
            xtilde = x
        else:
            gen = torch.Generator().manual_seed(seed)
            xtilde = x[torch.randperm(nt, generator=gen)[:ntilde].to(device)]
    else:
        xtilde = torch.as_tensor(xtilde, dtype=dtype, device=device)
    cfg = _vmap_safe_config(dataclasses.replace(cfg,
                                                ntilde=xtilde.shape[0]))
    shared = xtilde is x or (xtilde.shape == x.shape
                             and bool(torch.equal(xtilde, x)))

    lower, upper = theta_bounds()
    if thetas is None:
        theta1, _, _ = generate_theta(x, rs[0], cfg.n_px_side)
        thetas = theta1
    thetas = _per_cell(thetas, ncells, dtype, device)
    f_params = _per_cell(f_params or default_f_params(dtype, device),
                         ncells, dtype, device)

    if cfg.mstep_gram == "projected" and cfg.mstep_proj_rank is None:
        # one rank for every cell, sized for the sharpest cell's smoothing
        # spectrum (the rank grows with gr)
        gr_max = math.exp(float(thetas["-log2rho2"].max()))
        cfg = dataclasses.replace(cfg, mstep_proj_rank=suggest_proj_rank(
            gr_max, cfg.n_px_side, cfg.n_px_side))

    win = population_window(thetas, cfg)
    rows = None
    if mesh is not None:
        rows = data_rows(mesh, nt, x)
        cells, row_sl = population_shardings(mesh, ncells, nt)
        rs = rs[cells, row_sl]
        thetas = {k: v[cells] for k, v in thetas.items()}
        f_params = {k: v[cells] for k, v in f_params.items()}
        if win is not None:
            win = (win[0][cells], win[1][cells], win[2])
        if not shared:
            x = x[row_sl]
    stim = cell_stimuli(x, xtilde, shared, cfg, win)
    k = cfg.n_px_side ** 2 if win is None else win[2] ** 2
    max_items = ladder_items(rs.shape[-1], xtilde.shape[0], k, device)
    if rows is not None:
        max_items = rows.agree_min(max_items)
    carry = fit_cells_program(stim, rs, thetas, f_params, shared, cfg,
                              (lower, upper), backend, max_items, rows)
    if mesh is not None:
        carry = _gather_carry(carry, mesh, rows)
    return carry, (lower, upper)


def fit_cells_sequential(x, rs, cfg: Optional[FitConfig] = None, xtilde=None,
                         thetas: Optional[Dict] = None,
                         f_params: Optional[Dict] = None, seed: int = 0,
                         device=None,
                         backend: Optional[str] = None) -> List[FitResult]:
    """Fit the cells one after another through the single-cell ``fit``
    (its knobs as given: any line search and gate, per-iteration crop
    window).
    ``thetas``/``f_params`` are scalars or carry a leading cell axis; the
    device rule is ``fit_population``'s.  Without ``xtilde`` every cell
    draws its inducing rows from ``torch.Generator().manual_seed(seed)``."""
    device = resolve_device(x, device)
    x = torch.as_tensor(x, device=device)
    rs = torch.as_tensor(rs, dtype=x.dtype, device=device)
    if xtilde is not None:
        xtilde = torch.as_tensor(xtilde, dtype=x.dtype, device=device)

    def cell(values, c):
        if values is None:
            return None
        return {k: (v[c] if torch.as_tensor(v).dim() > 0 else v)
                for k, v in values.items()}

    return [fit(x, rs[c], cfg, xtilde=xtilde, theta=cell(thetas, c),
                f_params=cell(f_params, c),
                generator=torch.Generator().manual_seed(seed),
                backend=backend)
            for c in range(rs.shape[0])]


def population_results(carry: Carry, cfg: FitConfig, xtilde, lower,
                       upper) -> List[FitResult]:
    """Split a cell-stacked carry into per-cell ``FitResult`` objects."""
    out = []
    for c in range(carry.m_b.shape[0]):
        one = _tree_map(lambda t: t[c], carry)
        kern, es = one.kern, one.kern.es
        out.append(FitResult(
            config=cfg, xtilde=xtilde, theta=one.theta, theta_lower=lower,
            theta_upper=upper, f_params=one.f_params, m_b=one.m_b,
            V_b=one.V_b, B=es.B, keep=es.keep, eigvals=es.eigvals,
            k_tilde_b_diag=es.k_tilde_b_diag,
            k_tilde_inv_diag=es.k_tilde_inv_diag, K_tilde=kern.K_tilde,
            K=kern.K, Kvec=kern.Kvec, K_b=kern.K_b, a=kern.a,
            track=one.track, failed=bool(one.failed),
            failed_at=int(one.failed_at)))
    return out
