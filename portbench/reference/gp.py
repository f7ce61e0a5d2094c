"""The plain reference of both configurations: the sparse-variational
Poisson GP of a retinal receptive field (the reference's ``varGP``,
Spatial_GP_repo/utils.py), in plain PyTorch: the Grams, the
log-marginal, prediction and r^2, and one EM iteration (the E-step's
Newton updates with the f-param optimum, the M-step's L-BFGS on theta).

It imports nothing of the program.  Every function computes in the dtype
of its inputs: the checks run it in float64; the control runs it in
float32 with TF32 products on (``precision``).  From the program it takes
only the states it judges: the final one (theta, the f-params, the
variational state m_b, V_b in the basis B with its keep mask), and the
one a checked EM iteration started from with the basis it rebuilt; every
Gram, moment, projection, loss, step and gradient is worked out again
here from the inputs.

The formulas (the reference's, utils.py:861-1459 and 1794-2125):

* envelope alpha(p) = exp(-e^{-2log2beta} |p - eps_0|^2), zero where
  alpha < ``ALPHA_THRESHOLD``; the separable smoothness prior S (x) S with
  S[a, b] = exp(-e^{-log2rho2} (lin_a - lin_b)^2); q(x1, x2) = Amp
  (alpha x1)^T (S (x) S) (alpha x2);
* the order-1 arc-cosine kernel K = X1 X2 J(c), X = sqrt(q(x, x) +
  sigma_0^2), c = clip((q12 + sigma_0^2) / (X1 X2 + 1e-7), -1, 1),
  J(c) = (sqrt(1 - c^2) + (pi - acos c) c) / pi;
* in the basis B: k = diag(B^T K_tilde B), a = K B / k (a = B when the
  inducing set is the training set), lambda_m = a m_b, lambda_var = Kvec
  + sum(-(K B) . a + a . (a V_b));
* <f> = exp(A lambda_m + A^2 lambda_var / 2 + lambda0), A = e^logA;
  ELL = A r.lambda_m + lambda0 sum r - sum <f>; KL = -log|V_b|/2 +
  sum log k / 2 + m_b.(m_b / k) / 2 + tr(V_b) / k / 2 over kept
  coordinates; the log-marginal ELL - KL.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch

from portbench.reference import lbfgs

ALPHA_THRESHOLD = 1.0e-3
COSDELTA_JITTER = 1.0e-7


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls in TF32 (``tf32``) or in full float32, restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _scalars(theta: Dict, dtype, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=dtype, device=device).reshape(())
            for k, v in theta.items()}


def crop_window(theta: Dict, n_px: int, margin: float, bucket: int = 16):
    """The fit's crop window at theta, (i0, j0, w), or None for the whole
    frame: the square of side w (``margin`` times the radius of {alpha >=
    ALPHA_THRESHOLD}, rounded up to a multiple of ``bucket``) around the
    centre's pixel, kept inside the frame.  The configuration's EM
    iteration computes its Grams on the window taken at the theta it
    starts from, its M-step's trials too."""
    lb, ex, ey = (float(theta[k]) for k in ("-2log2beta", "eps_0x",
                                             "eps_0y"))
    radius = math.sqrt(max(math.log(1.0 / ALPHA_THRESHOLD)
                           / max(math.exp(lb), 1e-12), 0.0)) * margin
    half_px = radius * (n_px - 1) / 2.0
    w = int(2 * half_px) + 2
    w = min(((w + bucket - 1) // bucket) * bucket, n_px)
    if w >= n_px:
        return None
    i0 = int(round((ey + 1.0) * (n_px - 1) / 2.0)) - w // 2
    j0 = int(round((ex + 1.0) * (n_px - 1) / 2.0)) - w // 2
    return (max(0, min(i0, n_px - w)), max(0, min(j0, n_px - w)), w)


def envelope_and_smoothing(theta: Dict, n_px: int, dtype, device,
                           window=None):
    """(alpha (nx,), S (n_px, n_px)) at theta; alpha is 0 outside the crop
    ``window`` when one is given."""
    th = _scalars(theta, dtype, device)
    lin = torch.linspace(-1.0, 1.0, n_px, dtype=torch.float64,
                         device=device).to(dtype)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    d2 = (xx - th["eps_0x"]) ** 2 + (yy - th["eps_0y"]) ** 2
    alpha = torch.exp(-torch.exp(th["-2log2beta"]) * d2)
    if window is not None:
        i0, j0, w = window
        inside = torch.zeros(n_px, n_px, dtype=torch.bool, device=device)
        inside[i0:i0 + w, j0:j0 + w] = True
        alpha = torch.where(inside, alpha, 0.0)
    alpha = alpha.reshape(-1)
    alpha = torch.where(alpha >= ALPHA_THRESHOLD, alpha,
                        torch.zeros_like(alpha))
    S = torch.exp(-torch.exp(th["-log2rho2"])
                  * (lin[:, None] - lin[None, :]) ** 2)
    return alpha, S


def _forms(x: torch.Tensor, alpha, S, n_px: int, block: int = 1024):
    """(u, s) = (alpha x, (S (x) S)(alpha x)) row by row in blocks."""
    u = x * alpha
    s = torch.empty_like(u)
    for i in range(0, u.shape[0], block):
        img = u[i:i + block].reshape(-1, n_px, n_px)
        s[i:i + block] = (S @ img @ S).reshape(img.shape[0], -1)
    return u, s


def _acos(q12, q11, q22, s02):
    X1X2 = torch.sqrt(q11 + s02)[:, None] * torch.sqrt(q22 + s02)[None, :]
    c = torch.clamp((q12 + s02) / (X1X2 + COSDELTA_JITTER), -1.0, 1.0)
    J = (torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
         + (math.pi - torch.acos(c)) * c) / math.pi
    return X1X2 * J


def grams(theta: Dict, x: torch.Tensor, xtilde: torch.Tensor, n_px: int,
          shared: bool, window=None):
    """(K_tilde, K, Kvec) at theta in x's dtype (K is K_tilde when
    ``shared``), on the full frame or on the crop ``window``."""
    dtype, device = x.dtype, x.device
    th = _scalars(theta, dtype, device)
    alpha, S = envelope_and_smoothing(theta, n_px, dtype, device, window)
    s02 = th["sigma_0"] ** 2
    ut, st = _forms(xtilde, alpha, S, n_px)
    qtt = th["Amp"] * (ut * st).sum(1)
    K_tilde = _acos(th["Amp"] * (ut @ st.T), qtt, qtt, s02)
    K_tilde = 0.5 * (K_tilde + K_tilde.T)
    if shared:
        return K_tilde, K_tilde, qtt + s02
    u, s = _forms(x, alpha, S, n_px)
    q = th["Amp"] * (u * s).sum(1)
    del s
    K = _acos(th["Amp"] * (u @ st.T), q, qtt, s02)
    return K_tilde, K, q + s02


def cross_gram(theta: Dict, xstar: torch.Tensor, xtilde: torch.Tensor,
               n_px: int):
    """(K* (nstar, ntilde), Kvec* (nstar,)) at theta."""
    _, K, Kvec = grams(theta, xstar, xtilde, n_px, shared=False)
    return K, Kvec


class State:
    """The final state a fit handed back, in the reference's dtype: theta,
    the f-params, m_b, V_b, the basis B and its keep mask."""

    def __init__(self, theta, f_params, m_b, V_b, B, keep, dtype, device):
        self.theta = _scalars(theta, dtype, device)
        self.f = _scalars(f_params, dtype, device)
        cast = dict(dtype=dtype, device=device)
        self.m_b, self.V_b, self.B = (t.to(**cast) for t in (m_b, V_b, B))
        self.keep = keep.to(device=device, dtype=torch.bool)


def basis_terms(state: State, K_tilde: torch.Tensor):
    """(k, kinv): diag(B^T K_tilde B) on kept coordinates and its inverse
    (0 where dropped)."""
    B = state.B
    k = torch.sum(B * (K_tilde @ B), dim=0)
    keepf = state.keep.to(k.dtype)
    kinv = keepf / torch.where(state.keep, k, torch.ones_like(k))
    return k * keepf, kinv


def moments(state: State, K, Kvec, kinv, shared: bool):
    """(lambda_m, lambda_var) at the training (or test) points."""
    K_b = K @ state.B
    a = state.B if shared else K_b * kinv[None, :]
    lam_m = a @ state.m_b
    lam_var = Kvec + torch.sum(-K_b * a + a * (a @ state.V_b), dim=1)
    return lam_m, lam_var, a


def lambda0_given_logA(logA, r, lam_m, lam_var):
    A = torch.exp(logA)
    z = A * lam_m + 0.5 * A * A * lam_var
    return torch.log(torch.sum(r)) - torch.logsumexp(z, dim=0)


def ell(logA, lam0, r, lam_m, lam_var):
    """The expected Poisson log-likelihood (log r! dropped)."""
    A = torch.exp(logA)
    f = torch.exp(A * lam_m + 0.5 * A * A * lam_var + lam0)
    return A * (r @ lam_m) + lam0 * torch.sum(r) - torch.sum(f)


def log_marginal(state: State, K_tilde, K, Kvec, r, shared: bool):
    """ELL - KL at the state, with the reference's Grams; also returns the
    moments and basis terms it used."""
    k, kinv = basis_terms(state, K_tilde)
    lam_m, lam_var, a = moments(state, K, Kvec, kinv, shared)
    e = ell(state.f["logA"], state.f["lambda0"], r, lam_m, lam_var)
    keep = state.keep
    Vk = state.V_b[keep][:, keep]
    Vk = 0.5 * (Vk + Vk.T)
    logdet_V = torch.linalg.slogdet(Vk)[1]
    m = state.m_b
    kl = (-0.5 * logdet_V + 0.5 * torch.sum(torch.log(k[keep]))
          + 0.5 * torch.sum(m * kinv * m)
          + 0.5 * torch.sum(torch.diagonal(state.V_b) * kinv))
    return e - kl, dict(k=k, kinv=kinv, lam_m=lam_m, lam_var=lam_var, a=a)


def best_logA(logA0, r, lam_m, lam_var, steps: int = 30):
    """The minimiser of the profiled negative ELL over logA (lambda0 at its
    closed form), by Newton's method from ``logA0``."""
    x = logA0.detach().clone()
    for _ in range(steps):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = -ell(x, lambda0_given_logA(x, r, lam_m, lam_var), r, lam_m,
                     lam_var)
            g, = torch.autograd.grad(v, x, create_graph=True)
            h, = torch.autograd.grad(g, x)
        step = g / h if h > 0 else g
        x = x - step
        if abs(float(step.detach())) < 1e-14:
            break
    return x.detach()


def predict(state: State, K_star, Kvec_star, k, kinv):
    """The posterior predictive rates exp(A mu + A^2 var / 2 + lambda0) at
    test stimuli and the log-rate moments (mu, var)."""
    K_star_b = K_star @ state.B
    a = K_star_b * kinv[None, :]
    mu = a @ state.m_b
    var = Kvec_star + torch.sum((a @ (state.V_b - torch.diag(k))) * a, dim=1)
    A = torch.exp(state.f["logA"])
    return torch.exp(A * mu + 0.5 * A * A * var + state.f["lambda0"]), mu, var


def _corr(u, v):
    uc = u - u.mean(-1, keepdim=True)
    vc = v - v.mean(-1, keepdim=True)
    return (uc * vc).sum(-1) / torch.sqrt((uc * uc).sum(-1)
                                          * (vc * vc).sum(-1))


def explained_variance(r_test, rates, perms):
    """Noise-corrected r^2 (utils.py:1502-1541): the mean over the repeat
    permutations ``perms`` (nbootstrap, nrep) of the split-half
    correlations over the reliability."""
    rates = rates.to(r_test.dtype)
    even = r_test[perms[:, 0::2]].mean(1)
    odd = r_test[perms[:, 1::2]].mean(1)
    rel = torch.abs(_corr(even, odd))
    return (0.5 * (_corr(rates, odd) + _corr(rates, even)) / rel).mean()


def bootstrap_perms(nrep: int, nbootstrap: int, seed: int) -> torch.Tensor:
    """The repeat permutations ``evaluate(nbootstrap=, seed=)`` draws: one
    ``randperm`` a draw from a CPU generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(nrep, generator=gen)
                        for _ in range(nbootstrap)])


# ---- one EM iteration (utils.py:1794-2125) ----------------------------------

# The box on theta (utils.py:854-855): a trial outside it has an infinite
# loss, and the loss is taken at the clipped theta.
LOWER = {"sigma_0": 0.0, "eps_0x": -1.0, "eps_0y": -1.0,
         "-2log2beta": -math.inf, "-log2rho2": -math.inf, "Amp": 0.0}
UPPER = {"sigma_0": math.inf, "eps_0x": 1.0, "eps_0y": 1.0,
         "-2log2beta": math.inf, "-log2rho2": math.inf, "Amp": math.inf}


def basis_error(B, keep, K_tilde) -> torch.Tensor:
    """How far B is from diagonalizing K_tilde on its kept columns (the
    premise of the E-step and of the moments): the largest off-diagonal
    entry of B^T K_tilde B over its largest diagonal one."""
    Kb = B.T @ (K_tilde @ B)
    kk = keep[:, None] & keep[None, :]
    off = torch.where(kk & ~torch.eye(len(keep), dtype=torch.bool,
                                      device=keep.device), Kb, 0.0)
    return torch.max(torch.abs(off)) / torch.max(torch.diagonal(Kb)[keep])


def reproject(B_new, B_old, m_b, V_b):
    """The variational state carried into a new basis (utils.py:1833-1841):
    R m_b and R V_b R^T with R = B_new^T B_old."""
    R = B_new.T @ B_old
    return R @ m_b, R @ V_b @ R.T


def estep(st: State, K_tilde, K, Kvec, r, n_estep: int):
    """The E-step from ``st`` (its m_b, V_b in its basis B, its logA):
    ``n_estep`` Newton updates of (m_b, V_b), V = S (I + S G S)^-1 S and
    m = V (G m + g) with S^2 = diag(B^T K_tilde B), g = A a^T (r - f), G =
    A^2 a^T (a . f), each followed by logA at its optimum and lambda0 at
    its closed form (utils.py:1402-1459, 1859-1943).  Returns (m_b, V_b,
    logA)."""
    k, kinv = basis_terms(st, K_tilde)
    K_b = K @ st.B
    a = K_b * kinv[None, :]
    s = torch.sqrt(k)
    eye = torch.eye(len(k), dtype=k.dtype, device=k.device)
    m, V, logA = st.m_b, st.V_b, st.f["logA"]

    def lam(m, V):
        return a @ m, Kvec + torch.sum(-K_b * a + a * (a @ V), dim=1)
    lam_m, lam_var = lam(m, V)
    lam0 = lambda0_given_logA(logA, r, lam_m, lam_var)
    for _ in range(n_estep):
        A = torch.exp(logA)
        f = torch.exp(A * lam_m + 0.5 * A * A * lam_var + lam0)
        g = A * (a.T @ (r - f))
        G = A * A * (a.T @ (a * f[:, None]))
        M = eye + s[:, None] * G * s[None, :]
        V = torch.cholesky_inverse(torch.linalg.cholesky(M)) \
            * s[:, None] * s[None, :]
        m = V @ (G @ m + g)
        V = 0.5 * (V + V.T)
        lam_m, lam_var = lam(m, V)
        logA = best_logA(logA, r, lam_m, lam_var)
        lam0 = lambda0_given_logA(logA, r, lam_m, lam_var)
    return m, V, logA


def mstep_loss(theta: Dict[str, torch.Tensor], st: State, x, xtilde, r,
               n_px: int, window=None) -> torch.Tensor:
    """The M-step's objective, -(ELL - KL) with log|V| left out (constant
    in theta), as a function of theta with the basis B, m_b, V_b and the
    f-params of ``st`` fixed: the Grams at theta, K_tilde_b = B^T K_tilde
    B inverted and its log-determinant taken on the kept block by
    Cholesky (utils.py:1999-2112), on the iteration's crop ``window``.
    +inf outside the box or where the factorization fails."""
    ok = all(bool((theta[k] >= LOWER[k]) & (theta[k] <= UPPER[k]))
             for k in theta)
    th = {k: torch.clamp(v, LOWER[k], UPPER[k]) for k, v in theta.items()}
    K_tilde, K, Kvec = grams(th, x, xtilde, n_px, shared=False,
                             window=window)
    keep = st.keep
    Kb = st.B.T @ (K_tilde @ st.B)
    Kb = 0.5 * (Kb + Kb.T)
    L, info = torch.linalg.cholesky_ex(Kb[keep][:, keep])
    inv = torch.cholesky_inverse(L)
    K_b = (K @ st.B)[:, keep]
    a = K_b @ inv
    m, V = st.m_b[keep], st.V_b[keep][:, keep]
    lam_m = a @ m
    lam_var = Kvec + torch.sum(-K_b * a + a * (a @ V), dim=1)
    e = ell(st.f["logA"], st.f["lambda0"], r, lam_m, lam_var)
    kl = (torch.sum(torch.log(torch.diagonal(L))) + 0.5 * (m @ (inv @ m))
          + 0.5 * torch.sum(V * inv))
    loss = -(e - kl)
    if not ok or int(info) != 0:
        return loss + math.inf
    return loss


def mstep(st: State, x, xtilde, r, n_px: int, n_mstep: int,
          max_linesearch_steps: int, window=None):
    """The M-step from ``st``'s theta: ``n_mstep`` L-BFGS steps on
    ``mstep_loss`` (``reference/lbfgs.py``, theta flattened in sorted-key
    order), gradients by autograd.  Returns (theta after, its value, the
    value and the gradient at the start, and ``loss(theta)``: the
    objective at a theta of floats)."""
    keys = sorted(st.theta)

    def vg(flat):
        p = flat.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = mstep_loss({k: p[i] for i, k in enumerate(keys)}, st, x,
                           xtilde, r, n_px, window)
            g, = torch.autograd.grad(v, p)
        return v.detach(), g
    def loss(theta: Dict[str, float]) -> float:
        return float(mstep_loss(_scalars(theta, x.dtype, x.device), st, x,
                                xtilde, r, n_px, window))
    x0 = torch.stack([st.theta[k] for k in keys])
    v0, g0 = vg(x0)
    best, f_best = lbfgs.minimize(vg, x0, n_mstep, max_linesearch_steps)
    return ({k: best[i] for i, k in enumerate(keys)}, f_best, v0,
            {k: g0[i] for i, k in enumerate(keys)}, loss)
