"""The updates and helpers that no fit calls, the port against the JAX
package, float64 on the CPU, on the same numpy inputs: the damped E-step
(alpha 0.5 and 1) and the explicit V^-1 inverse on a small seeded problem
sliced to its kept coordinates (as tests/test_reference_parity.py slices
it), both at alpha 1 against the port's Newton E-step; the legacy f-param
Newton update on tests/test_gradients.py's data, stop rule included; the
hand-derived ELL gradient in (logA, lambda0); ``linker``; and
``theta_from_samuele``.

Tolerances: rtol 1e-10 for values against JAX (the same arithmetic; LU
solves and inverses of systems whose condition numbers stay below 1e4);
the alpha-1 identity relative to the norm of the result, 1e-10 for the
damped form and 1e-8 for the explicit inverse (the reference calls it the
less stable form); the Newton update's iterates rtol 1e-12.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu import params as jp
from gaussian_processes_tpu.models import estep as je
from gaussian_processes_tpu.models import moments as jm
from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu.ops import stabilize as js
from gaussian_processes_tpu_torch import params as tp
from gaussian_processes_tpu_torch.models import estep as te
from gaussian_processes_tpu_torch.models import moments as tm
from gaussian_processes_tpu_torch.ops import kernels as tk
from gaussian_processes_tpu_torch.utils.tracing import decisions

torch.set_num_threads(1)

RTOL = 1e-10
NEWTON_RTOL = 1e-12
DAMPED_ID_RTOL, V_INV_ID_RTOL = 1e-10, 1e-8

N, NT, NTILDE = 12, 40, 16
THETA = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
         "-2log2beta": -2 * np.log(2 * 0.3),
         "-log2rho2": -np.log(2 * 0.2 ** 2), "Amp": 1.3}


def close(t, j, rtol=RTOL, atol=1e-13, err_msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def T(a):
    return torch.as_tensor(np.array(a))


def ttheta(vals=THETA):
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in vals.items()}


def jtheta(vals=THETA):
    return {k: jnp.float64(v) for k, v in vals.items()}


@pytest.fixture(scope="module")
def kept():
    """A seeded problem with two inducing points repeated (two eigenvalues
    of K_tilde fall below the keep threshold), in the full basis and
    sliced to the kept coordinates: a, K_b, k_tilde diagonals, m_b, a
    generic V_b (positive definite on the kept block), f_mean, r, f-params
    and a weight that masks the last five training points."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((NT, N * N))
    xtilde = x[list(range(NTILDE - 2)) + [0, 1]]
    K_tilde, K, Kvec = jk.gram_matrices(jtheta(), jnp.asarray(x),
                                        jnp.asarray(xtilde), N, shared=False)
    es = js.compute_eigenspace(K_tilde)
    keep = np.asarray(es.keep)
    assert 0 < keep.sum() < NTILDE
    a = np.asarray(js.project_gram(es, K, shared=False))
    K_b = np.asarray(K) @ np.asarray(es.B)
    W = rng.standard_normal((NTILDE, NTILDE)) * 0.2
    V_b = (W @ W.T + np.diag(np.asarray(es.k_tilde_b_diag))) * np.outer(
        keep, keep)
    m_b = rng.standard_normal(NTILDE) * 0.3 * keep
    fp = {"logA": np.log(0.05), "lambda0": 0.4}
    lm, lv = jm.lambda_moments(jnp.asarray(a), jnp.asarray(K_b), Kvec,
                               jnp.asarray(m_b), jnp.asarray(V_b))
    f_mean = np.asarray(jm.mean_f_given_lambda_moments(
        {k: jnp.float64(v) for k, v in fp.items()}, lm, lv))
    full = dict(a=a, m_b=m_b, V_b=V_b, kdiag=np.asarray(es.k_tilde_b_diag),
                kinv=np.asarray(es.k_tilde_inv_diag))
    sliced = dict(a=a[:, keep], m_b=m_b[keep], V_b=V_b[np.ix_(keep, keep)],
                  kdiag=full["kdiag"][keep], kinv=full["kinv"][keep])
    r = rng.poisson(1.5, NT).astype(float)
    weight = (np.arange(NT) < NT - 5).astype(float)
    return dict(full=full, sliced=sliced, keep=keep, f_mean=f_mean, r=r,
                fp=fp, weight=weight)


def _variant(mod, name, arr, p, alpha, weight, conv, fp):
    if name == "damped":
        return mod.estep_update_damped(
            conv(p["r"]), conv(arr["a"]), conv(arr["m_b"]), conv(arr["V_b"]),
            conv(p["f_mean"]), conv(arr["kdiag"]), fp, alpha=alpha,
            weight=weight)
    return mod.estep_update_V_inv(
        conv(p["r"]), conv(arr["a"]), conv(arr["m_b"]), conv(p["f_mean"]),
        conv(arr["kinv"]), fp, weight=weight)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name, alpha", [("damped", 0.5), ("damped", 1.0),
                                         ("V_inv", None)])
def test_estep_variants_match_jax(kept, name, alpha, weighted):
    s = kept["sliced"]
    tw = T(kept["weight"]) if weighted else None
    jw = jnp.asarray(kept["weight"]) if weighted else None
    tfp = {k: torch.tensor(v, dtype=torch.float64)
           for k, v in kept["fp"].items()}
    jfp = {k: jnp.float64(v) for k, v in kept["fp"].items()}
    got = _variant(te, name, s, kept, alpha, tw, T, tfp)
    want = _variant(je, name, s, kept, alpha, jw, jnp.asarray, jfp)
    for g, w, what in zip(got, want, ("m_new", "V_new")):
        close(g, w, err_msg=what)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("weighted", [False, True])
def test_alpha_one_variants_equal_the_newton_estep(kept, weighted):
    """At alpha 1 the damped form and the explicit inverse are the Newton
    update V = (I + K G)^-1 K, m = V (G m + g) of ``estep_update``."""
    f, s, keep = kept["full"], kept["sliced"], kept["keep"]
    w = T(kept["weight"]) if weighted else None
    fp = {k: torch.tensor(v, dtype=torch.float64)
          for k, v in kept["fp"].items()}
    m_ref, V_ref = te.estep_update(T(kept["r"]), T(f["a"]), T(f["m_b"]),
                                   T(kept["f_mean"]), T(f["kdiag"]), fp,
                                   weight=w)
    # the dropped coordinates stay exactly zero; compare the kept block
    k = T(keep)
    assert torch.all(m_ref[~k] == 0) and torch.all(V_ref[~k] == 0)
    m_ref, V_ref = m_ref[k], V_ref[k][:, k]
    for name, bound in (("damped", DAMPED_ID_RTOL), ("V_inv", V_INV_ID_RTOL)):
        m, V = _variant(te, name, s, kept, 1.0, w, T, fp)
        assert _rel(m, m_ref) <= bound, name
        assert _rel(V, V_ref) <= bound, name


@pytest.fixture(scope="module")
def newton_data():
    """tests/test_gradients.py:147-153's moments, responses and start."""
    rng = np.random.default_rng(0)
    lam_m = rng.standard_normal(60) * 0.8
    lam_v = rng.uniform(0.05, 0.2, 60)
    r = rng.poisson(np.exp(0.9 * lam_m + 0.4)).astype(float)
    fp0 = {"logA": np.log(0.5), "lambda0": 0.2}
    return lam_m, lam_v, r, fp0


def _newton_port(data, **kw):
    lam_m, lam_v, r, fp0 = data
    decisions.clear()
    out = te.update_f_params_newton(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in fp0.items()},
        T(r), T(lam_m), T(lam_v), **kw)
    return out, (decisions["fparams_newton.stop"],
                 decisions["fparams_newton.step"])


# (nit, tol) -> (met tol, iterations): to convergence; a tol that the
# fifth iterate's start meets (||R||_1 26.9 < 30 after 92.5, 66.7, 48.9
# and 36.2), whose step is still applied; and nit cutting the loop short
@pytest.mark.parametrize("nit, tol, stops, iters", [
    (2000, 1e-6, 1, 65), (2000, 30.0, 1, 5), (3, 1e-6, 0, 3)])
def test_newton_update_takes_jax_iterates(newton_data, nit, tol, stops,
                                          iters):
    lam_m, lam_v, r, fp0 = newton_data
    (out, ell, f_mean), counts = _newton_port(newton_data, nit=nit,
                                              eta=0.25, tol=tol)
    jout, jell, jf = je.update_f_params_newton(
        {k: jnp.float64(v) for k, v in fp0.items()}, jnp.asarray(r),
        jnp.asarray(lam_m), jnp.asarray(lam_v), nit=nit, eta=0.25, tol=tol)
    for k in ("logA", "lambda0"):
        close(out[k], jout[k], rtol=NEWTON_RTOL, err_msg=k)
    close(ell, jell, rtol=NEWTON_RTOL)
    close(f_mean, jf, rtol=NEWTON_RTOL)
    # one host read per iteration: stop once if tol was met
    assert counts == (stops, iters - stops)
    if stops and iters < 10:
        # the step of the iteration that met tol was applied: stopping one
        # iteration earlier lands elsewhere
        (early, _, _), _ = _newton_port(newton_data, nit=iters - 1,
                                        eta=0.25, tol=tol)
        assert abs(float(early["logA"] - out["logA"])) > 1e-3


def test_newton_update_reaches_stationarity(newton_data):
    """tests/test_gradients.py's claim on the port: the ELL gradient at the
    result is below 1e-3 and the ELL improved on the start."""
    lam_m, lam_v, r, fp0 = newton_data
    (out, ell, f_mean), _ = _newton_port(newton_data, nit=2000)
    g = tm.ell_grad_f_params(T(r), f_mean, T(lam_m), T(lam_v), out)
    assert abs(float(g["logA"])) < 1e-3 and abs(float(g["lambda0"])) < 1e-3
    fp = {k: torch.tensor(v, dtype=torch.float64) for k, v in fp0.items()}
    f0 = tm.mean_f_given_lambda_moments(fp, T(lam_m), T(lam_v))
    assert float(ell) > float(tm.poisson_ell(T(r), f0, T(lam_m), fp))


def test_ell_grad_f_params_matches_jax_and_autograd(newton_data):
    lam_m, lam_v, r, _ = newton_data
    fp = {"logA": np.log(0.3), "lambda0": -0.1}
    leaf = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
            for k, v in fp.items()}
    f_mean = tm.mean_f_given_lambda_moments(leaf, T(lam_m), T(lam_v))
    nll = -tm.poisson_ell(T(r), f_mean, T(lam_m), leaf)
    g_auto = torch.autograd.grad(nll, [leaf["logA"], leaf["lambda0"]])
    g = tm.ell_grad_f_params(T(r), f_mean.detach(), T(lam_m), T(lam_v),
                             {k: v.detach() for k, v in leaf.items()})
    jfp = {k: jnp.float64(v) for k, v in fp.items()}
    jf = jm.mean_f_given_lambda_moments(jfp, jnp.asarray(lam_m),
                                        jnp.asarray(lam_v))
    jg = jm.ell_grad_f_params(jnp.asarray(r), jf, jnp.asarray(lam_m),
                              jnp.asarray(lam_v), jfp)
    for k, ga in zip(("logA", "lambda0"), g_auto):
        close(g[k], jg[k], err_msg=k)
        close(g[k], -ga, err_msg=k)


@pytest.mark.parametrize("form", ["diag", "same", "same_by_identity",
                                  "cross"])
def test_linker_matches_jax(form):
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal((9, N * N))
    x2 = rng.standard_normal((6, N * N))
    t1, j1 = T(x1), jnp.asarray(x1)
    kw = dict(n_px_side=N, diag=form == "diag")
    if form == "cross":
        got = tk.linker(ttheta(), t1, T(x2), **kw)
        want = jk.linker(jtheta(), j1, jnp.asarray(x2), **kw)
    elif form == "same_by_identity":
        got = tk.linker(ttheta(), t1, t1, **kw)
        want = jk.linker(jtheta(), j1, j1, **kw)
    else:
        got = tk.linker(ttheta(), t1, **kw)
        want = jk.linker(jtheta(), j1, **kw)
    assert tuple(got.shape) == want.shape
    close(got, want)
    if form.startswith("same"):
        assert torch.equal(got, got.T)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_theta_from_samuele_matches_jax(dtype):
    args = (math.log(0.7), 1.3, 0.12, -0.3, 2.2)
    got = tp.theta_from_samuele(*args, Amp=1.4, dtype=getattr(torch, dtype))
    want = jp.theta_from_samuele(*args, Amp=1.4, dtype=getattr(jnp, dtype))
    assert sorted(got) == sorted(tp.THETA_KEYS) == sorted(want)
    for k, v in got.items():
        assert v.dtype == getattr(torch, dtype) and v.dim() == 0
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert tp.theta_from_samuele(*args)["Amp"].dtype == torch.float32
