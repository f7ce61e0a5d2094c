"""Closed-loop active learning: fit -> score -> select -> grow -> refit
(counterpart of ``gaussian_processes_tpu/models/active.py``; reference:
one_cell_active_training.ipynb:cell17).

The loop runs at a fixed capacity, n_start + n_add, with pad-and-mask
buffers: the stimuli and responses in use fill the first n rows and a 0/1
``sample_weight`` masks the rest out of every refit (``models/fit.fit``).
The warm start follows the reference: the variational state is carried in
the original (unprojected) coordinates, the new point gets unit prior
variance and the mean of the current variational mean, and theta and the
f-params continue from the previous fit.

Every refit is the per-iteration fit at full rank: the port has no
whole-fit program, so the JAX loops' rank budget (set only under
``jit_whole_fit``) has no counterpart here.

Two drivers:

* ``active_loop`` reads the pool's utilities to the host each round and
  picks there (the reference's protocol), and can evaluate r^2 and a
  held-out log-likelihood after every refit;
* ``active_loop_pipelined`` keeps scoring, masking, the argmax, buffer
  growth and the warm-start update on the device and reads the picks back
  once, after the loop.  The fit itself still reads a few scalars to the
  host every EM iteration (the crop window, the rollback check), so on the
  card this removes only the scorer's readback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import FitConfig, resolve_device
from ..ops.kernels import crop_window_for_theta, gram_matrices
from .acquisition import score_candidates
from .fit import FitResult, fit
from .inference import evaluate
from .moments import lambda_moments, mean_f_given_lambda_moments, poisson_ell

SELECTIONS = ("utility", "random")


@dataclasses.dataclass
class ActiveLoopResult:
    selected_idx: List[int]          # pool index chosen at each round
    utilities: List[float]           # utility of the chosen candidate
    r2_history: List[float]          # test r2 after each refit (if test set)
    r2_sigma_history: List[float]
    test_ll_history: List[float]     # held-out log-likelihood per round
    final_fit: FitResult
    in_use_idx: np.ndarray           # all pool indices in the final model


def _test_loglikelihood(res: FitResult, X_ll: torch.Tensor,
                        R_ll: torch.Tensor) -> torch.Tensor:
    """Held-out expected log-likelihood (the reference's fixed-image track,
    one_cell_active_training.ipynb:cell17), as a 0-d tensor on the fit's
    device: the loop reads the floats once, at its end."""
    with torch.no_grad():
        _, K_t, Kvec_t = gram_matrices(
            res.theta, X_ll, res.xtilde, res.config.n_px_side, shared=False,
            alpha_threshold=res.config.alpha_threshold)
        K_t_b = K_t @ res.B
        a_t = K_t_b * res.k_tilde_inv_diag[None, :]
        lam_m, lam_var = lambda_moments(a_t, K_t_b, Kvec_t, res.m_b, res.V_b)
        f_mean = mean_f_given_lambda_moments(res.f_params, lam_m, lam_var)
        return poisson_ell(R_ll, f_mean, lam_m, res.f_params)


def _clock(device: torch.device) -> float:
    """Host seconds after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _warm_start(B, m_b, V_b, n: int):
    """The variational state of the grown buffer in original coordinates
    (cell17 "Update variational parameters"): m = B m_b, V = B V_b B^T
    symmetrised, then unit prior variance and the mean of m[:n] for the new
    row n.  On the device, with no host transfer."""
    m = B @ m_b
    V = (B @ V_b) @ B.T
    V = 0.5 * (V + V.T)
    # fill_ on a view: assigning a Python number would copy it from the host
    V[n, n].fill_(1.0)
    m[n] = m[:n].mean()
    return m, V


def _check_select(select: str) -> None:
    if select not in SELECTIONS:
        raise ValueError(f"unknown selection strategy {select!r}; expected "
                         f"one of {SELECTIONS}")


def _start_buffers(X_pool, R_pool, start_idx, n_add: int, exclude_idx,
                   device):
    """Pool tensors on ``device``, the capacity buffers holding the start
    set, and the host mask of pool rows never to pick."""
    X_pool = torch.as_tensor(X_pool, device=resolve_device(X_pool, device))
    R_pool = torch.as_tensor(R_pool, dtype=X_pool.dtype, device=X_pool.device)
    start_idx = np.asarray(start_idx)
    n_start = len(start_idx)
    capacity = n_start + n_add
    x_buf = X_pool.new_zeros((capacity, X_pool.shape[1]))
    r_buf = X_pool.new_zeros(capacity)
    rows = torch.as_tensor(start_idx, device=X_pool.device)
    x_buf[:n_start] = X_pool[rows]
    r_buf[:n_start] = R_pool[rows]
    used = np.zeros(X_pool.shape[0], bool)
    used[start_idx] = True
    if exclude_idx is not None:
        used[np.asarray(exclude_idx)] = True
    return X_pool, R_pool, start_idx, x_buf, r_buf, used


def active_loop(X_pool, R_pool, start_idx, n_add: int,
                cfg: Optional[FitConfig] = None,
                theta: Optional[Dict] = None,
                f_params: Optional[Dict] = None,
                select: str = "utility",
                X_test=None, R_test=None,
                X_test_ll=None, R_test_ll=None,
                exclude_idx=None,
                r_cutoff: int = 100,
                nbootstrap: int = 200,
                seed: int = 0,
                verbose: bool = False,
                device=None,
                round_times: Optional[list] = None,
                utility_history: Optional[list] = None,
                refits: Optional[list] = None
                ) -> ActiveLoopResult:
    """Run ``n_add`` acquisition rounds starting from ``start_idx``.

    X_pool: (npool, nx) candidate stimuli; R_pool: (npool,) responses (the
    simulated experiment's answers); both go to ``device`` (default: X_pool's
    own, or the CUDA card for numpy input; numpy input without ``device``
    and without a card raises) in X_pool's dtype.  ``select`` is
    "utility" (information maximisation, the scorer on the crop window of
    the fitted theta) or "random" (the reference's A/B control,
    one_cell_active_training.ipynb:cell19/23), whose picks come from
    ``np.random.default_rng(seed)``.  ``exclude_idx`` marks pool rows never
    to acquire.  With ``X_test``/``R_test`` each refit is scored by r^2
    (``evaluate`` with ``nbootstrap`` draws); with ``X_test_ll``/
    ``R_test_ll`` by the held-out log-likelihood.

    ``round_times`` (a list) receives one dict per round of host seconds,
    each ending in a device synchronize: "refit", "evaluate" (with a test
    set) and "select" (scoring, the pick and the buffer growth; not in the
    last round).  ``utility_history`` (a list) receives each round's pool
    utilities as read for the pick, used rows at -inf.  ``refits`` (a
    list) receives each refit's (failed, final log-marginal).
    """
    _check_select(select)
    X_pool, R_pool, start_idx, x_buf, r_buf, used = _start_buffers(
        X_pool, R_pool, start_idx, n_add, exclude_idx, device)
    device, dtype = X_pool.device, X_pool.dtype
    capacity = x_buf.shape[0]
    cfg = dataclasses.replace(cfg or FitConfig(), ntilde=capacity)
    rng = np.random.default_rng(seed)

    def on_device(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)

    X_test, R_test = on_device(X_test), on_device(R_test)
    X_test_ll, R_test_ll = on_device(X_test_ll), on_device(R_test_ll)
    score_r2 = X_test is not None and R_test is not None
    score_ll = X_test_ll is not None and R_test_ll is not None
    lanes = torch.arange(capacity, device=device)
    n = len(start_idx)
    m_warm = V_warm = None
    selected, utilities = [], []
    r2_hist, r2_sig_hist, ll_hist = [], [], []

    res = None
    for round_i in range(n_add + 1):
        t0 = _clock(device) if round_times is not None else 0.0
        res = fit(x_buf, r_buf, cfg, xtilde=x_buf, theta=theta,
                  f_params=f_params, m=m_warm, V=V_warm,
                  sample_weight=(lanes < n).to(dtype))
        theta, f_params = res.theta, res.f_params
        if round_times is not None:
            t1 = _clock(device)
            times = {"refit": t1 - t0}
            round_times.append(times)
        if refits is not None:
            refits.append((bool(res.failed),
                           float(res.track.logmarginal[-1])))

        if score_r2:
            _, _, r2, s = evaluate(res, X_test, R_test, nbootstrap=nbootstrap)
            r2_hist.append(float(r2))
            r2_sig_hist.append(float(s))
        if score_ll:
            ll_hist.append(_test_loglikelihood(res, X_test_ll, R_test_ll))
        if round_times is not None and (score_r2 or score_ll):
            t2 = _clock(device)
            times["evaluate"] = t2 - t1
            t1 = t2
        if verbose:
            msg = f"round {round_i}: n={n}"
            if r2_hist:
                msg += f" r2={r2_hist[-1]:.3f}"
            print(msg)

        if round_i == n_add:
            break

        # ---- score remaining candidates and select ----
        if select == "utility":
            win = {}
            if cfg.crop_window:
                wi0, wj0, ww = crop_window_for_theta(
                    res.theta, cfg.n_px_side, cfg.alpha_threshold,
                    cfg.crop_margin, cfg.crop_bucket)
                if ww < cfg.n_px_side:
                    win = dict(win_i0=wi0, win_j0=wj0, win_w=ww)
            u, _ = score_candidates(
                X_pool, res.xtilde, res.theta, res.f_params, res.m_b,
                res.V_b, res.B, res.k_tilde_inv_diag,
                n_px_side=cfg.n_px_side,
                alpha_threshold=cfg.alpha_threshold, r_cutoff=r_cutoff,
                **win)
            u = u.cpu().numpy().copy()
            u[used] = -np.inf
            best = int(np.argmax(u))
            utilities.append(float(u[best]))
            if utility_history is not None:
                utility_history.append(u)
        else:
            best = int(rng.choice(np.flatnonzero(~used)))
            utilities.append(float("nan"))
        selected.append(best)
        used[best] = True

        # ---- grow the buffers (cell17 "Update indices and Kernels") ----
        x_buf[n] = X_pool[best]
        r_buf[n] = R_pool[best]
        m_warm, V_warm = _warm_start(res.B, res.m_b, res.V_b, n)
        n += 1
        if round_times is not None:
            times["select"] = _clock(device) - t1

    return ActiveLoopResult(
        selected_idx=selected, utilities=utilities, r2_history=r2_hist,
        r2_sigma_history=r2_sig_hist,
        test_ll_history=[float(v) for v in ll_hist],
        final_fit=res,
        in_use_idx=np.concatenate([start_idx, np.asarray(selected, int)]),
    )


def ab_experiment(X_pool, R_pool, n_start: int, n_add: int, seeds,
                  cfg: Optional[FitConfig] = None, **loop_kwargs):
    """Active-vs-random A/B control from identical starting models across
    seeds (the reference's scientific control,
    one_cell_active_training.ipynb:cell19/cell23).

    Each seed draws a fresh random starting set from
    ``np.random.default_rng(seed)``; both arms share it.  Returns
    {"active": [ActiveLoopResult...], "random": [...]} in seed order.
    """
    npool = len(X_pool)
    out = {"active": [], "random": []}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        start_idx = rng.permutation(npool)[:n_start]
        for arm, select in (("active", "utility"), ("random", "random")):
            out[arm].append(active_loop(
                X_pool, R_pool, start_idx=start_idx, n_add=n_add, cfg=cfg,
                select=select, seed=seed, **loop_kwargs))
    return out


# ---------------------------------------------------------------------------
# Device-resident loop
# ---------------------------------------------------------------------------

def _select_and_grow(u, X_pool, R_pool, x_buf, r_buf, used, B, m_b, V_b,
                     n: int):
    """On-device pick + buffer growth + warm-start update (cell17's
    "Update indices / Update variational parameters" block) with no host
    transfer: the used rows are masked to -inf and the pick is
    ``torch.argmax``'s (the first maximum, a NaN counting as the maximum,
    as the host loop's ``np.argmax``), kept as a 0-d device tensor.  ``x_buf``, ``r_buf`` and ``used`` are updated in
    place and returned with the warm start, the pick and its utility."""
    u = torch.where(used, float("-inf"), u)
    best = torch.argmax(u)
    idx = best.view(1)
    used.index_fill_(0, idx, True)
    x_buf[n] = X_pool.index_select(0, idx)[0]
    r_buf[n] = R_pool.index_select(0, idx)[0]
    m_orig, V_orig = _warm_start(B, m_b, V_b, n)
    return x_buf, r_buf, used, m_orig, V_orig, best, u.index_select(0, idx)[0]


def _grow_random(best: int, X_pool, x_buf, r_buf, used, R_pool, B, m_b, V_b,
                 n: int):
    """Random-arm twin of ``_select_and_grow`` for a host-chosen pool index:
    the same growth and warm-start update, in place."""
    used[best].fill_(True)
    x_buf[n] = X_pool[best]
    r_buf[n] = R_pool[best]
    m_orig, V_orig = _warm_start(B, m_b, V_b, n)
    return x_buf, r_buf, used, m_orig, V_orig


def active_loop_pipelined(X_pool, R_pool, start_idx, n_add: int,
                          cfg: Optional[FitConfig] = None,
                          theta: Optional[Dict] = None,
                          f_params: Optional[Dict] = None,
                          select: str = "utility",
                          exclude_idx=None,
                          r_cutoff: int = 100,
                          seed: int = 0,
                          device=None,
                          round_times: Optional[list] = None
                          ) -> ActiveLoopResult:
    """The closed loop with the pick on the device.

    Scoring (on the full frame), masking, the argmax, buffer growth and the
    warm-start update stay on the pool's device; the picks and their
    utilities are read back in one transfer after the loop.  The random
    arm picks on the host from its own copy of the used set (as
    ``active_loop`` does, with the same ``default_rng(seed)`` draws) and
    only grows the buffers on the device.  Pool stimuli and responses must
    both be given, as in the reference's simulated experiment.

    ``round_times`` as in ``active_loop`` ("refit" and "select"); its
    synchronizes add host syncs the loop otherwise avoids.  ``device`` as
    in ``active_loop``.
    """
    _check_select(select)
    X_pool, R_pool, start_idx, x_buf, r_buf, used_h = _start_buffers(
        X_pool, R_pool, start_idx, n_add, exclude_idx, device)
    device, dtype = X_pool.device, X_pool.dtype
    capacity = x_buf.shape[0]
    n_start = len(start_idx)
    cfg = dataclasses.replace(cfg or FitConfig(), ntilde=capacity,
                              track_variational=False)
    rng = np.random.default_rng(seed)
    used = torch.as_tensor(used_h, device=device)
    lanes = torch.arange(capacity, device=device)

    m_warm = V_warm = None
    res = None
    best_dev, ubest_dev = [], []     # device scalars, read after the loop
    random_picks = []

    for round_i in range(n_add + 1):
        n = n_start + round_i
        t0 = _clock(device) if round_times is not None else 0.0
        res = fit(x_buf, r_buf, cfg, xtilde=x_buf, theta=theta,
                  f_params=f_params, m=m_warm, V=V_warm,
                  sample_weight=(lanes < n).to(dtype))
        theta, f_params = res.theta, res.f_params
        if round_times is not None:
            t1 = _clock(device)
            round_times.append({"refit": t1 - t0})
        if round_i == n_add:
            break
        if select == "utility":
            u, _ = score_candidates(
                X_pool, res.xtilde, res.theta, res.f_params, res.m_b,
                res.V_b, res.B, res.k_tilde_inv_diag,
                n_px_side=cfg.n_px_side,
                alpha_threshold=cfg.alpha_threshold, r_cutoff=r_cutoff)
            (x_buf, r_buf, used, m_warm, V_warm, best,
             ubest) = _select_and_grow(u, X_pool, R_pool, x_buf, r_buf,
                                       used, res.B, res.m_b, res.V_b, n)
            best_dev.append(best)
            ubest_dev.append(ubest)
        else:
            pick = int(rng.choice(np.flatnonzero(~used_h)))
            used_h[pick] = True
            random_picks.append(pick)
            x_buf, r_buf, used, m_warm, V_warm = _grow_random(
                pick, X_pool, x_buf, r_buf, used, R_pool, res.B, res.m_b,
                res.V_b, n)
        if round_times is not None:
            round_times[-1]["select"] = _clock(device) - t1

    if select == "utility":
        selected = (torch.stack(best_dev).cpu().tolist() if best_dev
                    else [])
        utilities = (torch.stack(ubest_dev).cpu().tolist() if ubest_dev
                     else [])
    else:
        selected = random_picks
        utilities = [float("nan")] * len(random_picks)

    return ActiveLoopResult(
        selected_idx=selected, utilities=utilities, r2_history=[],
        r2_sigma_history=[], test_ll_history=[], final_fit=res,
        in_use_idx=np.concatenate([start_idx, np.asarray(selected, int)]),
    )
