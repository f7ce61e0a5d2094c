"""The plain reference of the population configuration (``pop108``): what
the port's population program (``fit_population``) does that the
single-cell fit does not, written out for one lane (one cell) at a time
in plain PyTorch, on top of ``gp.py``'s Grams, moments and losses.

It imports nothing of the program, and computes in the dtype of its
inputs: ``fit_lane`` with TF32 off (``gp.precision(False)``), the other
functions in their caller's precision (the checks: float64 inside
``gp.precision(False)``; the control: float32 inside
``gp.precision(True)``, TF32 products on).

* ``population_window``: every cell's crop window at ``crop_margin *
  1.5`` from its start theta (the rule of ``gp.crop_window``), the widest
  side shared by all cells, each corner clamped into the frame at that
  side; the whole frame when the widest side covers it;
* ``eigenspace``: the full-rank basis, the eigh of K_tilde with the
  eigenvalues at or below max(lam_max, 1) * ``EIGVAL_TOL`` dropped (their
  columns zeroed);
* ``armijo_minimize``: the batched search of the program, one lane: the
  ladder ``0.5 ** arange(trials)`` along the two-loop direction (memory
  8, newest pair's scaling), the first trial that passes Armijo with c1
  1e-4 taken, then value and gradient there; -g on a non-descent
  direction; a curvature pair stored in slot ``step % 8`` only when s.y >
  1e-10 max(s.s, 1e-30); a step with no passing trial, or with a value or
  point not finite, keeps the state; +inf never accepted; the best finite
  iterate returned;
* ``estep``: ``n_estep`` Newton updates (Cholesky), each followed by the
  Armijo search on logA (``n_fparamstep`` steps, lambda0 at its closed
  form);
* ``mstep``: the Armijo search on theta (``n_mstep`` steps) over the
  M-step's objective on the fixed window;
* ``fit_lane``: the EM loop: the init (m = 0, V = K_tilde in the basis),
  then ``maxiter - 1`` iterations (kernels and basis rebuilt at the
  iteration's theta, the state reprojected, lambda0 at its closed form,
  the E-step, the loss recorded, the M-step), the last with no M-step; an
  iteration whose loss, state or theta is not finite is rolled back and
  the lane frozen there; then the final V symmetrised and, where not
  positive definite on its kept block, lifted by ``EIGVAL_TOL``.

Departures from ``models/fit.fit_cells_program``:

* one lane at a time, with no chunks of items, no mesh and no pad
  weights; the program runs every lane and trial at once;
* the Grams on a window by an envelope zeroed outside it (``gp.grams``),
  where the program crops the images to the window;
* the M-step's inverse of K_tilde_b by Cholesky on the kept block, where
  the program iterates Newton-Schulz from the basis's diagonal: the
  reference runs the same iteration only for its guard and poisons a
  trial (+inf) where the guard fails, as the program's ``"poison"``
  fallback does;
* the E-step's scaling S^2 is diag(B^T K_tilde B) (``gp.basis_terms``),
  where the program takes the eigenvalues;
* the log-determinants by Cholesky of the kept blocks, with no eigenvalue
  fallback (the program's track falls back to eigenvalues where V's
  factorization fails);
* the eigenvectors' signs are torch.linalg.eigh's, free: what is compared
  (losses, theta, the f-params, B m_b, rates) does not depend on them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import gp

EIGVAL_TOL = 1.0e-4
ARMIJO_C1 = 1e-4
ARMIJO_MEMORY = 8
SCHULZ_TOL = 1e-3
SCHULZ_GUARD_LAG = 3
KEYS = ("-2log2beta", "-log2rho2", "Amp", "eps_0x", "eps_0y", "sigma_0")


def population_window(thetas, n_px: int, crop_margin: float,
                      bucket: int = 16):
    """Each cell's (i0, j0, w) for the start thetas ``thetas`` (a list of
    dicts of floats, one a cell): every cell's ``gp.crop_window`` at
    ``crop_margin * 1.5``, the widest side w for all, each corner clamped
    into the frame at w; None when a cell's window is the whole frame."""
    wins = [gp.crop_window(t, n_px, crop_margin * 1.5, bucket)
            for t in thetas]
    if any(w is None for w in wins):
        return None
    w = max(side for _, _, side in wins)
    return [(min(i, n_px - w), min(j, n_px - w), w) for i, j, _ in wins]


def eigenspace(K_tilde: torch.Tensor):
    """(B, keep, eigvals): the full-rank basis of K_tilde, dropped columns
    zeroed."""
    vals, vecs = torch.linalg.eigh(K_tilde)
    keep = vals > torch.clamp(vals[-1] * EIGVAL_TOL, min=EIGVAL_TOL)
    return vecs * keep.to(vecs.dtype)[None, :], keep, vals


def _two_loop(g, pairs):
    """-H g over the stored pairs (s, y, rho, age), newest first; the
    scaling s.y / y.y of the newest."""
    pairs = sorted(pairs, key=lambda p: -p[3])
    q, alphas = g, []
    for s, y, rho, _ in pairs:
        a = rho * torch.dot(s, q)
        q = q - a * y
        alphas.append(a)
    if pairs:
        s, y, rho, _ = pairs[0]
        q = (1.0 / rho) / torch.dot(y, y) * q
    for (s, y, rho, _), a in reversed(list(zip(pairs, alphas))):
        q = q + (a - rho * torch.dot(y, q)) * s
    return -q


def armijo_minimize(value, vg, x0: torch.Tensor, num_steps: int,
                    trials: int = 6, record: list = None):
    """The program's batched Armijo L-BFGS for one lane (the module
    docstring): ``value(x)`` and ``vg(x) -> (value, grad)`` on a flat
    vector.  Returns (the best finite iterate, its value).

    ``record``: a list that gets each call the program makes, in its
    order, as a dict of its points (rows), their values and, for a ladder,
    the step's start: the first value-and-gradient call; each step's
    ladder (every rung evaluated; the first that passes is taken, as
    without ``record``); the step's value-and-gradient call, at the start
    with its value where no rung passed."""
    alphas = [0.5 ** i for i in range(trials)]
    x = x0
    f, g = vg(x)
    if record is not None:
        record.append(dict(points=x[None], values=f.reshape(1)))
    best, f_best = x, (f if bool(torch.isfinite(f)) else
                       torch.full_like(f, math.inf))
    slots: Dict[int, tuple] = {}
    for k in range(num_steps):
        d = _two_loop(g, list(slots.values()))
        gd = torch.dot(g, d)
        if not bool(torch.isfinite(gd)) or bool(gd >= 0):
            d, gd = -g, -torch.dot(g, g)

        def passes(a, fa):
            return bool(fa <= f + ARMIJO_C1 * a * gd)
        if record is None:
            alpha = next((a for a in alphas if passes(a, value(x + a * d))),
                         None)
        else:
            points = torch.stack([x + a * d for a in alphas])
            values = torch.stack([value(p) for p in points])
            record.append(dict(points=points, values=values, start=x))
            alpha = next((a for a, fa in zip(alphas, values)
                          if passes(a, fa)), None)
        if alpha is None:
            if record is not None:
                record.append(dict(points=x[None], values=f.reshape(1)))
            continue
        x_new = x + alpha * d
        f_new, g_new = vg(x_new)
        if record is not None:
            record.append(dict(points=x_new[None], values=f_new.reshape(1)))
        if not (bool(torch.isfinite(f_new))
                and bool(torch.all(torch.isfinite(x_new)))):
            continue
        s, y = x_new - x, g_new - g
        sy = torch.dot(s, y)
        if bool(sy > 1e-10 * torch.clamp(torch.dot(s, s), min=1e-30)):
            slots[k % ARMIJO_MEMORY] = (s, y, 1.0 / sy, k)
        if bool(f_new < f_best):
            best, f_best = x_new, f_new
        x, f, g = x_new, f_new, g_new
    return best, f_best


def _flat_vg(fn):
    """(value, vg) of a scalar function of a flat vector, the gradient by
    autograd."""
    def value(x):
        with torch.no_grad():
            return fn(x)

    def vg(x):
        p = x.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = fn(p)
            g, = torch.autograd.grad(v, p)
        return v.detach(), g
    return value, vg


def fparam_objective(logA, r, lam_m, lam_var):
    """The profiled negative ELL in logA, lambda0 at its closed form."""
    return -gp.ell(logA, gp.lambda0_given_logA(logA, r, lam_m, lam_var), r,
                   lam_m, lam_var)


def estep(st: gp.State, K_tilde, K, Kvec, r, n_estep: int,
          n_fparamstep: int, trials: int):
    """The E-step from ``st`` (m_b, V_b in its basis B, its logA):
    ``n_estep`` Newton updates (``gp.estep``'s), each followed by the
    Armijo search on logA.  Returns (m_b, V_b, logA, lambda0)."""
    k, kinv = gp.basis_terms(st, K_tilde)
    K_b = K @ st.B
    a = K_b * kinv[None, :]
    s = torch.sqrt(k)
    eye = torch.eye(len(k), dtype=k.dtype, device=k.device)
    m, V, logA = st.m_b, st.V_b, st.f["logA"]

    def lam(m, V):
        return a @ m, Kvec + torch.sum(-K_b * a + a * (a @ V), dim=1)
    lam_m, lam_var = lam(m, V)
    lam0 = gp.lambda0_given_logA(logA, r, lam_m, lam_var)
    for _ in range(n_estep):
        A = torch.exp(logA)
        f = torch.exp(A * lam_m + 0.5 * A * A * lam_var + lam0)
        g = A * (a.T @ (r - f))
        G = A * A * (a.T @ (a * f[:, None]))
        M = eye + s[:, None] * G * s[None, :]
        L, info = torch.linalg.cholesky_ex(M)
        if int(info) != 0 or not bool(torch.all(torch.isfinite(M))):
            L = L + math.nan        # the iteration rolls back
        V = torch.cholesky_inverse(L) * s[:, None] * s[None, :]
        m = V @ (G @ m + g)
        V = 0.5 * (V + V.T)
        lam_m, lam_var = lam(m, V)
        value, vg = _flat_vg(lambda p: fparam_objective(p[0], r, lam_m,
                                                        lam_var))
        logA = armijo_minimize(value, vg, logA.reshape(1), n_fparamstep,
                               trials)[0][0]
        lam0 = gp.lambda0_given_logA(logA, r, lam_m, lam_var)
    return m, V, logA, lam0


def schulz_guard(M, x0, steps: int) -> bool:
    """Whether the program's Newton-Schulz inverse of M from diag(x0)
    passes its guard: the least of max|M X - I| over its ``steps -
    SCHULZ_GUARD_LAG`` guarded steps below ``SCHULZ_TOL``."""
    with torch.no_grad():
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        X, resid = torch.diag(x0), math.inf
        for _ in range(max(steps - SCHULZ_GUARD_LAG, 1)):
            P = M @ X
            resid = min(resid, float(torch.max(torch.abs(P - eye))))
            X = X @ (2.0 * eye - P)
    return resid < SCHULZ_TOL


def mstep_loss(theta: Dict[str, torch.Tensor], st: gp.State, x, xtilde, r,
               n_px: int, window, kinv, schulz_steps: int) -> torch.Tensor:
    """``gp.mstep_loss`` with the program's Newton-Schulz guard: +inf where
    the iteration from the basis's diagonal inverse ``kinv`` fails it, and
    where theta is out of the box or the value is not finite, as the
    program's trials are."""
    keep = st.keep
    ok = all(bool((theta[k] >= gp.LOWER[k]) & (theta[k] <= gp.UPPER[k]))
             for k in theta)
    th = {k: torch.clamp(v, gp.LOWER[k], gp.UPPER[k])
          for k, v in theta.items()}
    K_tilde, K, Kvec = gp.grams(th, x, xtilde, n_px, shared=False,
                                window=window)
    Kb = st.B.T @ (K_tilde @ st.B)
    Kb = 0.5 * (Kb + Kb.T)
    pad = torch.diag((~keep).to(Kb.dtype))
    ok = ok and schulz_guard((Kb + pad).detach(), kinv + pad.diagonal(),
                             schulz_steps)
    L, info = torch.linalg.cholesky_ex(Kb[keep][:, keep])
    inv = torch.cholesky_inverse(L)
    K_b = (K @ st.B)[:, keep]
    a = K_b @ inv
    m, V = st.m_b[keep], st.V_b[keep][:, keep]
    lam_m = a @ m
    lam_var = Kvec + torch.sum(-K_b * a + a * (a @ V), dim=1)
    e = gp.ell(st.f["logA"], st.f["lambda0"], r, lam_m, lam_var)
    kl = (torch.sum(torch.log(torch.diagonal(L))) + 0.5 * (m @ (inv @ m))
          + 0.5 * torch.sum(V * inv))
    loss = -(e - kl)
    if not ok or int(info) != 0 or not bool(torch.isfinite(loss)):
        return torch.where(torch.zeros_like(loss, dtype=torch.bool), loss,
                           math.inf)
    return loss


def mstep(st: gp.State, x, xtilde, r, n_px: int, n_mstep: int, trials: int,
          window, kinv, schulz_steps: int, record: list = None):
    """The M-step from ``st``'s theta: the Armijo search (``n_mstep``
    steps) on ``mstep_loss``, theta flattened in sorted-key order
    (``KEYS``), its calls into ``record`` (``armijo_minimize``).  Returns
    (theta after, its value, the value and the gradient at the start, and
    ``loss(theta)``: the objective at a theta of floats, or at a flat theta
    in ``KEYS`` order of any dtype)."""
    def fn(p):
        return mstep_loss({k: p[i] for i, k in enumerate(KEYS)}, st, x,
                          xtilde, r, n_px, window, kinv, schulz_steps)
    value, vg = _flat_vg(fn)

    def loss(theta) -> float:
        if isinstance(theta, dict):
            theta = torch.tensor([float(theta[k]) for k in KEYS],
                                 dtype=torch.float64)
        return float(value(theta.to(dtype=x.dtype, device=x.device)))
    x0 = torch.stack([st.theta[k] for k in KEYS])
    v0, g0 = vg(x0)
    best, f_best = armijo_minimize(value, vg, x0, n_mstep, trials, record)
    return ({k: best[i] for i, k in enumerate(KEYS)}, f_best, v0,
            {k: g0[i] for i, k in enumerate(KEYS)}, loss)


def _kl(st: gp.State, k, kinv) -> torch.Tensor:
    """The KL term of the recorded loss (``gp.log_marginal``'s)."""
    keep = st.keep
    Vk = st.V_b[keep][:, keep]
    return (-0.5 * torch.linalg.slogdet(0.5 * (Vk + Vk.T))[1]
            + 0.5 * torch.sum(torch.log(k[keep]))
            + 0.5 * torch.sum(st.m_b * kinv * st.m_b)
            + 0.5 * torch.sum(torch.diagonal(st.V_b) * kinv))


def fit_lane(x, r, xtilde, theta0: Dict, f_params0: Dict, window,
             fit: Dict, n_px: int) -> Dict:
    """One lane's whole fit (the module docstring) from its start theta
    and f-params (floats), on its ``window`` (i0, j0, w) or the whole frame
    (None), at the configuration's knobs ``fit`` (maxiter, n_estep, n_mstep,
    n_fparamstep, armijo_trials, schulz_steps).  Returns the final theta
    and f-params (floats), m_b, V_b, B, keep, the recorded losses
    (``track``, 0 past a rollback) and ``failed_at`` (-1: none)."""
    with gp.precision(False):
        return _fit_lane(x, r, xtilde, theta0, f_params0, window, fit, n_px)


def _fit_lane(x, r, xtilde, theta0, f_params0, window, fit, n_px):
    dtype, device = x.dtype, x.device
    maxiter, trials = fit["maxiter"], fit.get("armijo_trials", 6)
    steps = fit.get("schulz_steps", 12)

    def kernel(theta):
        K_tilde, K, Kvec = gp.grams(theta, x, xtilde, n_px, shared=False,
                                    window=window)
        B, keep, _ = eigenspace(K_tilde)
        return K_tilde, K, Kvec, B, keep

    theta = dict(theta0)
    K_tilde, K, Kvec, B, keep = kernel(theta)
    m = torch.zeros(len(keep), dtype=dtype, device=device)
    st = gp.State(theta, f_params0, m, torch.zeros_like(K_tilde), B, keep,
                  dtype, device)
    k, kinv = gp.basis_terms(st, K_tilde)
    st.V_b = torch.diag(k)
    lam_m, lam_var, _ = gp.moments(st, K, Kvec, kinv, False)
    ell = gp.ell(st.f["logA"], st.f["lambda0"], r, lam_m, lam_var)
    track = [float(ell - _kl(st, k, kinv))] + [0.0] * (maxiter - 1)
    f_params, failed_at = dict(f_params0), -1
    for i in range(1, maxiter):
        if fit["n_mstep"] > 0:
            K_tilde, K, Kvec, B_new, keep = kernel(theta)
            m_b, V_b = gp.reproject(B_new, st.B, st.m_b, st.V_b)
        else:
            B_new, m_b, V_b = st.B, st.m_b, st.V_b
        logA = torch.as_tensor(f_params["logA"], dtype=dtype, device=device)
        cur = gp.State(theta, {"logA": logA, "lambda0": 0.0}, m_b, V_b,
                       B_new, keep, dtype, device)
        m_b, V_b, logA, lam0 = estep(cur, K_tilde, K, Kvec, r,
                                     fit["n_estep"], fit["n_fparamstep"],
                                     trials)
        after = gp.State(theta, {"logA": logA, "lambda0": lam0}, m_b, V_b,
                         B_new, keep, dtype, device)
        k, kinv = gp.basis_terms(after, K_tilde)
        lam_m, lam_var, _ = gp.moments(after, K, Kvec, kinv, False)
        loss = gp.ell(logA, lam0, r, lam_m, lam_var) - _kl(after, k, kinv)
        new_theta = theta
        if fit["n_mstep"] > 0 and i < maxiter - 1:
            t, _, _, _, _ = mstep(after, x, xtilde, r, n_px, fit["n_mstep"],
                                  trials, window, kinv, steps)
            new_theta = {kk: float(v) for kk, v in t.items()}
        finite = (bool(torch.isfinite(loss))
                  and bool(torch.all(torch.isfinite(m_b)))
                  and bool(torch.all(torch.isfinite(V_b)))
                  and all(math.isfinite(v) for v in new_theta.values()))
        if not finite:
            failed_at = i
            break
        track[i] = float(loss)
        st, theta = after, new_theta
        f_params = {"logA": float(logA), "lambda0": float(lam0)}
    V = 0.5 * (st.V_b + st.V_b.T)
    keepf = st.keep.to(dtype)
    low = torch.linalg.eigvalsh(V + torch.diag(1.0 - keepf)).min()
    if bool(low <= 0):
        V = V + EIGVAL_TOL * torch.diag(keepf) * keepf[:, None] \
            * keepf[None, :]
    return dict(theta=theta, f_params=f_params, m_b=st.m_b, V_b=V, B=st.B,
                keep=st.keep, track=track, failed_at=failed_at)
