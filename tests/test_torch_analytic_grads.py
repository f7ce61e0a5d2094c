"""The port's hand-derived gradients (ops/analytic_grads.py) against the JAX
package's, float64 on the CPU, on tests/test_gradients.py's problem (N 14,
NT 18, NTILDE 10, default_rng(7)) carried across as numpy: dense C and its
five derivatives, the arc-cosine K and dK in its cross, same and diagonal
forms, the lambda-moment, ELL and KL chains, and the composed M-step
gradient, which must equal JAX's analytic chain and the port's own autograd
gradient of ``models/fit._mstep_objective`` -- on the full frame and, at a
narrower receptive field, with the objective on the crop window the fit
uses and the analytic chain on the full grid.

Tolerances: rtol 1e-12 on C, dC, K and dK (the same formulas, summed in
other orders); 1e-10 on the chains and the composed gradient (a masked
Cholesky inverse against JAX's LU inverse of a K_tilde_b whose kept
eigenvalues span 1e4); rtol 2e-6 with atol 1e-9 for autograd against the
analytic chain, JAX's own bound (tests/test_gradients.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.ops import analytic_grads as jag
from gaussian_processes_tpu.ops.stabilize import compute_eigenspace
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig
from gaussian_processes_tpu_torch.models.fit import _mstep_objective
from gaussian_processes_tpu_torch.ops import analytic_grads as tag
from gaussian_processes_tpu_torch.ops import stabilize as ts
from gaussian_processes_tpu_torch.ops.kernels import (
    crop_images, crop_window_for_theta, gram_matrices)
from gaussian_processes_tpu_torch.params import THETA_KEYS, theta_bounds

from test_gradients import N, NT, NTILDE, analytic_mstep_grad, setup
from test_torch_linalg import tes_from

torch.set_num_threads(1)

RTOL = 1e-12
CHAIN_RTOL = 1e-10
AUTOGRAD_RTOL, AUTOGRAD_ATOL = 2e-6, 1e-9


def close(t, j, rtol=RTOL, atol=1e-14, err_msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def to_t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def prob():
    """setup()'s JAX inputs and the same values as the port's tensors."""
    x, xtilde, r, theta, f_params = setup()
    return dict(x=x, xtilde=xtilde, r=r, theta=theta, f_params=f_params,
                tx=to_t(x), txt=to_t(xtilde), tr=to_t(r),
                ttheta=convert.theta_from_numpy(
                    {k: np.asarray(v) for k, v in theta.items()}),
                tfp=convert.f_params_from_numpy(
                    {k: np.asarray(v) for k, v in f_params.items()}))


@pytest.mark.parametrize("beta", [None, 0.1])
def test_localker_with_grads_matches_jax(prob, beta):
    """setup()'s theta (no pixel masked) and a receptive field of beta 0.1,
    whose mask zeroes C and dC on the grid's rim."""
    theta, jtheta = prob["ttheta"], prob["theta"]
    if beta is not None:
        lb = -2 * np.log(2 * beta)
        theta = dict(theta, **{"-2log2beta": torch.tensor(lb)})
        jtheta = dict(jtheta, **{"-2log2beta": jnp.float64(lb)})
    C, mask, dC = tag.localker_with_grads(theta, N)
    jC, jmask, jdC = jag.localker_with_grads(jtheta, N)
    close(C, jC)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(mask.sum()) == N * N if beta is None else (
        0 < int(mask.sum()) < N * N)
    assert sorted(dC) == sorted(jdC)
    for key in jdC:
        close(dC[key], jdC[key], err_msg=key)


@pytest.mark.parametrize("form", ["cross", "same", "diag"])
def test_acosker_with_grads_matches_jax(prob, form):
    C, _, dC = tag.localker_with_grads(prob["ttheta"], N)
    jC, _, jdC = jag.localker_with_grads(prob["theta"], N)
    x2, jx2 = ((prob["txt"], prob["xtilde"]) if form == "cross"
               else (None, None))
    K, dK = tag.acosker_with_grads(prob["ttheta"], prob["tx"], x2, C, dC,
                                   diag=form == "diag")
    jK, jdK = jag.acosker_with_grads(prob["theta"], prob["x"], jx2, jC, jdC,
                                     diag=form == "diag")
    assert tuple(K.shape) == jK.shape
    close(K, jK)
    if form == "same":
        assert torch.equal(K, K.T)
    assert sorted(dK) == sorted(tag.GRAD_KEYS) == sorted(jdK)
    for key in jdK:
        close(dK[key], jdK[key], err_msg=key)


@pytest.fixture(scope="module")
def chain_inputs():
    """Seeded inputs of the three chain functions: a, K_b, m_b, V_b (SPD),
    K_tilde_inv_b (SPD), r, f_mean, logA, and per key dK_b, dK_tilde_b
    (symmetric), dKvec, dlambda_m and dlambda_var."""
    rng = np.random.default_rng(11)
    nt, n = NT, NTILDE
    W = rng.standard_normal((n, n))
    P = rng.standard_normal((n, n))
    d = {"a": rng.standard_normal((nt, n)),
         "K_b": rng.standard_normal((nt, n)),
         "m_b": rng.standard_normal(n),
         "V_b": W @ W.T / n + np.eye(n),
         "K_tilde_inv_b": P @ P.T / n + 0.5 * np.eye(n),
         "r": rng.poisson(2.0, nt).astype(float),
         "f_mean": rng.uniform(0.5, 3.0, nt),
         "logA": np.float64(np.log(0.3))}
    for name, shape in (("dK_b", (nt, n)), ("dK_tilde_b", (n, n)),
                        ("dKvec", (nt,)), ("dlambda_m", (nt,)),
                        ("dlambda_var", (nt,))):
        g = {k: rng.standard_normal(shape) for k in tag.GRAD_KEYS}
        if name == "dK_tilde_b":
            g = {k: 0.5 * (v + v.T) for k, v in g.items()}
        d[name] = g
    return d


def _both(d, names):
    def conv(v, f):
        return {k: f(u) for k, u in v.items()} if isinstance(v, dict) else f(v)
    return ([conv(d[n], to_t) for n in names],
            [conv(d[n], jnp.asarray) for n in names])


def test_lambda_moment_grads_matches_jax(chain_inputs):
    names = ("a", "K_b", "m_b", "V_b", "dK_b", "dK_tilde_b", "dKvec",
             "K_tilde_inv_b")
    t_args, j_args = _both(chain_inputs, names)
    dlm, dlv = tag.lambda_moment_grads(*t_args)
    jdlm, jdlv = jag.lambda_moment_grads(*j_args)
    for key in tag.GRAD_KEYS:
        close(dlm[key], jdlm[key], rtol=CHAIN_RTOL, err_msg=key)
        close(dlv[key], jdlv[key], rtol=CHAIN_RTOL, err_msg=key)


def test_ell_grads_theta_matches_jax(chain_inputs):
    names = ("r", "f_mean", "logA", "dlambda_m", "dlambda_var")
    t_args, j_args = _both(chain_inputs, names)
    out = tag.ell_grads_theta(*t_args)
    jout = jag.ell_grads_theta(*j_args)
    for key in tag.GRAD_KEYS:
        close(out[key], jout[key], rtol=CHAIN_RTOL, err_msg=key)


def test_kl_grads_theta_matches_jax(chain_inputs):
    names = ("m_b", "V_b", "K_tilde_inv_b", "dK_tilde_b")
    t_args, j_args = _both(chain_inputs, names)
    out = tag.kl_grads_theta(*t_args)
    jout = jag.kl_grads_theta(*j_args)
    for key in tag.GRAD_KEYS:
        close(out[key], jout[key], rtol=CHAIN_RTOL, err_msg=key)


def _variational_state(keep, seed=3):
    """tests/test_gradients.py's generic kept-subspace state."""
    rng = np.random.default_rng(seed)
    n = keep.shape[0]
    W = rng.standard_normal((n, n)) * 0.05
    V_b = (W @ W.T + np.eye(n)) * np.outer(keep, keep)
    m_b = rng.standard_normal(n) * keep
    return m_b, V_b


def test_analytic_mstep_grad_matches_jax_chain(prob):
    from gaussian_processes_tpu.ops.kernels import gram_matrices as jgram
    K_tilde, _, _ = jgram(prob["theta"], prob["x"], prob["xtilde"], N,
                          shared=False)
    jes = compute_eigenspace(K_tilde)
    m_b, V_b = _variational_state(np.asarray(jes.keep))
    want = analytic_mstep_grad(prob["theta"], prob["x"], prob["xtilde"],
                               prob["r"], jes, jnp.asarray(m_b),
                               jnp.asarray(V_b), prob["f_params"])
    got = tag.analytic_mstep_grad(prob["ttheta"], prob["tx"], prob["txt"],
                                  prob["tr"], tes_from(jes), to_t(m_b),
                                  to_t(V_b), prob["tfp"], N)
    assert tuple(got) == THETA_KEYS
    for k in THETA_KEYS:
        close(got[k], want[k], rtol=CHAIN_RTOL, err_msg=k)


# the crop case: a receptive field narrow enough that the fit's window
# (crop_bucket 4) is smaller than the 24 px grid
CROP_N, CROP_BETA = 24, 0.1


@pytest.mark.parametrize("frame", ["full", "crop"])
def test_analytic_mstep_grad_matches_autograd(prob, frame):
    theta, x, xtilde, n_px = prob["ttheta"], prob["tx"], prob["txt"], N
    cfg = FitConfig(ntilde=NTILDE, n_px_side=N)
    if frame == "crop":
        n_px = CROP_N
        rng = np.random.default_rng(7)
        x = torch.as_tensor(rng.standard_normal((NT, n_px * n_px)))
        xtilde = x[:NTILDE]
        theta = dict(theta, **{"-2log2beta": torch.tensor(
            -2 * np.log(2 * CROP_BETA), dtype=torch.float64)})
        cfg = FitConfig(ntilde=NTILDE, n_px_side=n_px, crop_bucket=4)
    K_tilde, _, _ = gram_matrices(theta, x, xtilde, n_px, shared=False)
    es = ts.compute_eigenspace(K_tilde)
    m_b, V_b = map(to_t, _variational_state(es.keep.numpy()))
    win, xcrop = None, None
    if frame == "crop":
        win = crop_window_for_theta(theta, n_px, cfg.alpha_threshold,
                                    cfg.crop_margin, cfg.crop_bucket)
        assert win[2] < n_px
        xcrop = tuple(crop_images(v, *win, n_px) for v in (x, xtilde))
    leaf = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    lower, upper = theta_bounds()
    loss = _mstep_objective(leaf, x, xtilde, prob["tr"], es, m_b, V_b,
                            prob["tfp"], False, cfg, lower, upper, win=win,
                            xcrop=xcrop)
    g_auto = torch.autograd.grad(loss, [leaf[k] for k in THETA_KEYS])
    g_an = tag.analytic_mstep_grad(theta, x, xtilde, prob["tr"], es, m_b,
                                   V_b, prob["tfp"], n_px)
    for k, g in zip(THETA_KEYS, g_auto):
        close(g, g_an[k], rtol=AUTOGRAD_RTOL, atol=AUTOGRAD_ATOL, err_msg=k)
