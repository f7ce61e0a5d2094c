"""The whole slice -- fit, prediction, r^2 and state conversion -- of the
port against the JAX package at a small shape, float64, on the same inputs
(the same xtilde rows, theta and f-params).

The JAX side runs its per-iteration fit with the exact-semantics knobs the
port implements.  Its crop window lags one iteration behind the port's
(both cover the RF, so the Grams agree up to rounding).  Tolerances: the
loss trajectory, theta, f-params and B m_b rtol 1e-6 (the parity gate of
__graft_entry__.py); the point r^2 rtol 1e-6; predictions from a converted
JAX state rtol 1e-10 (the same arrays through the same math).
"""

import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.models import inference as ji
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.models import inference as ti

torch.set_num_threads(1)

N, NT, NTILDE = 24, 256, 64
THETA0 = {"sigma_0": 1.0, "eps_0x": 0.0001, "eps_0y": 0.0001,
          "-2log2beta": -2 * np.log(2 * 0.1),
          "-log2rho2": -np.log(2 * 0.1 ** 2), "Amp": 1.0}
FP0 = {"logA": np.log(0.01), "lambda0": 1.0}
# crop_bucket 4: at 24 px the start window is 20 px, so the windowed Gram
# and the hoisted M-step crop are on the path
STEPS = dict(maxiter=3, n_estep=3, n_mstep=3, n_fparamstep=3, n_px_side=N,
             crop_bucket=4)
JAX_EXACT = dict(jit_whole_fit=False, static_schedule=False,
                 eigensolver="eigh", eigh_impl="eigh", reduced_rank=False,
                 estep_solver="chol", mstep_inverse="exact",
                 mstep_logdet="chol", mstep_gram="exact",
                 mstep_precision="highest", track_variational=True)


def planted(n_px, n, seed, gain=0.6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n_px * n_px))
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2)).ravel()
    return x, np.exp(gain * x @ (w / np.linalg.norm(w))), rng


@pytest.fixture(scope="module")
def problem():
    x, lam, rng = planted(N, NT, 0)
    r = rng.poisson(lam).astype(float)
    idx = rng.permutation(NT)[:NTILDE]
    xs, lam_s, rng_s = planted(N, 20, 1)
    R_test = rng_s.poisson(np.broadcast_to(lam_s, (10, 20))).astype(float)
    return dict(x=x, r=r, idx=idx, x_test=xs, R_test=R_test)


@pytest.fixture(scope="module")
def jax_fit(problem):
    p = problem
    return jf.fit(jnp.asarray(p["x"]), jnp.asarray(p["r"]),
                  JCfg(ntilde=NTILDE, **STEPS, **JAX_EXACT),
                  xtilde=jnp.asarray(p["x"][p["idx"]]),
                  theta={k: jnp.float64(v) for k, v in THETA0.items()},
                  f_params={k: jnp.float64(v) for k, v in FP0.items()})


@pytest.fixture(scope="module", params=["torch", "cuda"])
def port_fit(problem, request):
    p = problem
    x = torch.as_tensor(p["x"])
    return tf.fit(x, torch.as_tensor(p["r"]), TCfg(ntilde=NTILDE, **STEPS),
                  xtilde=x[torch.as_tensor(p["idx"])], theta=THETA0,
                  f_params=FP0, backend=request.param)


def close(t, j, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


def test_loss_trajectory_matches_jax(jax_fit, port_fit):
    assert not port_fit.failed and not jax_fit.failed
    for name in ("logmarginal", "loglikelihood", "KL"):
        close(getattr(port_fit.track, name), getattr(jax_fit.track, name))
    np.testing.assert_array_equal(port_fit.track.n_eigen.numpy(),
                                  np.asarray(jax_fit.track.n_eigen))
    loss = port_fit.track.logmarginal.numpy()
    assert loss[-1] > loss[0]


def test_final_theta_fparams_and_posterior_match_jax(jax_fit, port_fit):
    for k in THETA0:
        close(port_fit.theta[k], jax_fit.theta[k], atol=1e-9)
    for k in FP0:
        close(port_fit.f_params[k], jax_fit.f_params[k])
    jBm = np.asarray(jax_fit.B @ jax_fit.m_b)
    close(port_fit.B @ port_fit.m_b, jBm, atol=1e-6 * np.abs(jBm).max())
    jBVB = np.asarray(jax_fit.B @ jax_fit.V_b @ jax_fit.B.T)
    close(port_fit.B @ port_fit.V_b @ port_fit.B.T, jBVB,
          atol=1e-6 * np.abs(jBVB).max())
    tv = port_fit.values_track()
    assert tv["variation_par_track"]["V_b"].shape == (3, NTILDE, NTILDE)


def test_point_r2_matches_jax(problem, jax_fit, port_fit):
    p = problem
    j_rates, _, _ = ji.predict(jax_fit, jnp.asarray(p["x_test"]))
    j_r2, _ = ji.explained_variance(jnp.asarray(p["R_test"]), j_rates,
                                    sigma=False)
    t_rates, _, _ = ti.predict(port_fit, torch.as_tensor(p["x_test"]))
    t_r2, _ = ti.explained_variance(torch.as_tensor(p["R_test"]), t_rates,
                                    sigma=False)
    close(t_rates, j_rates)
    close(t_r2, j_r2)
    assert np.isfinite(float(t_r2))
    _, rates, r2, s2 = ti.evaluate(port_fit, torch.as_tensor(p["x_test"]),
                                   torch.as_tensor(p["R_test"]),
                                   nbootstrap=50)
    assert rates.shape == (20,) and np.isfinite(float(r2)) and float(s2) > 0


def test_bootstrap_uses_the_given_permutations():
    rng = np.random.default_rng(4)
    R = rng.poisson(2.0, (10, 15)).astype(float)
    f = rng.random(15) + 1.0
    perms = np.stack([rng.permutation(10) for _ in range(7)])

    def corr(u, v):
        return np.corrcoef(u, v)[0, 1]

    r2s = []
    for p in perms:
        ev, od = R[p[0::2]].mean(0), R[p[1::2]].mean(0)
        r2s.append(0.5 * (corr(f, od) + corr(f, ev)) / abs(corr(ev, od)))
    mean, std = ti.explained_variance(torch.as_tensor(R), torch.as_tensor(f),
                                      perms=torch.as_tensor(perms))
    np.testing.assert_allclose(float(mean), np.mean(r2s), rtol=1e-12)
    np.testing.assert_allclose(float(std), np.std(r2s), rtol=1e-10)


def test_converted_jax_state_predicts_like_jax(problem, jax_fit):
    p = problem
    j_rates, j_mu, j_var = ji.predict(jax_fit, jnp.asarray(p["x_test"]))
    st = convert.state_from_numpy(jax_fit)
    th = convert.theta_from_numpy({k: np.asarray(v)
                                   for k, v in jax_fit.theta.items()})
    fp = convert.f_params_from_numpy({k: np.asarray(v)
                                      for k, v in jax_fit.f_params.items()})
    t_out = ti.predict_rates(torch.as_tensor(p["x_test"]), st.xtilde, th, fp,
                             st.m_b, st.V_b, st.B, st.k_tilde_b_diag,
                             st.k_tilde_inv_diag, n_px_side=N)
    for t, j in zip(t_out, (j_rates, j_mu, j_var)):
        close(t, j, rtol=1e-10)


def test_port_theta_predicts_through_jax(problem, port_fit):
    """Fit with the port, predict with the JAX package."""
    p = problem
    th = {k: jnp.asarray(v) for k, v in
          convert.theta_to_numpy(port_fit.theta).items()}
    fp = {k: jnp.asarray(v.numpy()) for k, v in port_fit.f_params.items()}
    arr = {k: jnp.asarray(getattr(port_fit, k).numpy()) for k in
           ("xtilde", "m_b", "V_b", "B", "k_tilde_b_diag",
            "k_tilde_inv_diag")}
    j_rates, _, _ = ji.predict_rates(
        jnp.asarray(p["x_test"]), arr["xtilde"], th, fp, arr["m_b"],
        arr["V_b"], arr["B"], arr["k_tilde_b_diag"], arr["k_tilde_inv_diag"],
        n_px_side=N)
    t_rates, _, _ = ti.predict(port_fit, torch.as_tensor(p["x_test"]))
    close(t_rates, j_rates, rtol=1e-10)


def test_shared_inducing_set_matches_jax():
    """xtilde = x (the shared K = K_tilde path), full frame."""
    x, lam, rng = planted(16, 40, 2, gain=0.5)
    r = rng.poisson(lam).astype(float)
    theta0 = dict(THETA0, **{"-2log2beta": -2 * np.log(2 * 0.3),
                             "-log2rho2": -np.log(2 * 0.15 ** 2)})
    steps = dict(STEPS, n_px_side=16, crop_window=False)
    jr = jf.fit(jnp.asarray(x), jnp.asarray(r),
                JCfg(ntilde=40, **steps, **JAX_EXACT), xtilde=jnp.asarray(x),
                theta={k: jnp.float64(v) for k, v in theta0.items()},
                f_params={k: jnp.float64(v) for k, v in FP0.items()})
    tx = torch.as_tensor(x)
    tr = tf.fit(tx, torch.as_tensor(r), TCfg(ntilde=40, **steps), xtilde=tx,
                theta=theta0, f_params=FP0)
    assert tr.K is tr.K_tilde
    close(tr.track.logmarginal, jr.track.logmarginal)
    for k in theta0:
        close(tr.theta[k], jr.theta[k], atol=1e-9)


def test_failure_rolls_back_and_freezes(problem):
    p = problem
    r = p["r"].copy()
    r[3] = np.nan
    x = torch.as_tensor(p["x"])
    res = tf.fit(x, torch.as_tensor(r), TCfg(ntilde=NTILDE, **STEPS),
                 xtilde=x[torch.as_tensor(p["idx"])], theta=THETA0,
                 f_params=FP0)
    assert res.failed and res.failed_at == 1
    for k in THETA0:
        assert float(res.theta[k]) == pytest.approx(THETA0[k])
    assert torch.all(res.track.logmarginal[1:] == 0)


def test_window_that_stops_covering_reruns_grown(problem, port_fit):
    """A crop margin too small for the RF: the fit notices after the first
    iteration and re-runs with the margin doubled (0.3 -> 0.6 -> 1.2) until
    the window covers; the result is the fit at the grown margin."""
    p = problem
    x = torch.as_tensor(p["x"])

    def run(margin):
        return tf.fit(x, torch.as_tensor(p["r"]),
                      TCfg(ntilde=NTILDE, **dict(STEPS, crop_margin=margin)),
                      xtilde=x[torch.as_tensor(p["idx"])], theta=THETA0,
                      f_params=FP0)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = run(0.3)
    assert sum("no longer covers" in str(w.message) for w in caught) == 2
    assert res.config.crop_margin == pytest.approx(1.2)
    assert not res.failed
    close(res.track.logmarginal, run(1.2).track.logmarginal, rtol=1e-12)
    close(res.track.logmarginal, port_fit.track.logmarginal, rtol=1e-3)


@pytest.mark.parametrize("variant", ["estep_only", "warm_start"])
def test_fit_variants_match_jax(problem, variant):
    """n_mstep = 0 (no kernel rebuild, theta fixed: the reference's one-cell
    config) and a warm start from given (m, V)."""
    p = problem
    steps = dict(STEPS, maxiter=2)
    kw_t, kw_j = {}, {}
    if variant == "estep_only":
        steps["n_mstep"] = 0
    else:
        rng = np.random.default_rng(7)
        m0 = rng.standard_normal(NTILDE) * 0.1
        A = rng.standard_normal((NTILDE, NTILDE)) * 0.05
        V0 = A @ A.T + 0.5 * np.eye(NTILDE)
        kw_t = dict(m=torch.as_tensor(m0), V=torch.as_tensor(V0))
        kw_j = dict(m=jnp.asarray(m0), V=jnp.asarray(V0))
    jr = jf.fit(jnp.asarray(p["x"]), jnp.asarray(p["r"]),
                JCfg(ntilde=NTILDE, **steps, **JAX_EXACT),
                xtilde=jnp.asarray(p["x"][p["idx"]]),
                theta={k: jnp.float64(v) for k, v in THETA0.items()},
                f_params={k: jnp.float64(v) for k, v in FP0.items()}, **kw_j)
    x = torch.as_tensor(p["x"])
    tr = tf.fit(x, torch.as_tensor(p["r"]), TCfg(ntilde=NTILDE, **steps),
                xtilde=x[torch.as_tensor(p["idx"])], theta=THETA0,
                f_params=FP0, **kw_t)
    close(tr.track.logmarginal, jr.track.logmarginal)
    for k in THETA0:
        close(tr.theta[k], jr.theta[k], atol=1e-9)
    if variant == "estep_only":
        for k, v in THETA0.items():
            assert float(tr.theta[k]) == pytest.approx(v)


def test_inducing_rows_drawn_from_a_generator(problem):
    p = problem
    x = torch.as_tensor(p["x"])
    cfg = TCfg(ntilde=NTILDE, **dict(STEPS, maxiter=1))

    def run(seed):
        return tf.fit(x, torch.as_tensor(p["r"]), cfg, theta=THETA0,
                      f_params=FP0,
                      generator=torch.Generator().manual_seed(seed))

    a, b = run(5), run(5)
    assert a.xtilde.shape == (NTILDE, N * N)
    assert torch.equal(a.xtilde, b.xtilde)
    rows = {tuple(row.tolist()) for row in x}
    assert all(tuple(row.tolist()) in rows for row in a.xtilde)
