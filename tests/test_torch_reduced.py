"""The reduced-rank single-cell fit and ``state_at_iteration`` of the port
against the JAX package, float64, on the same inputs.

The JAX side runs its per-iteration fit with the exact knobs and
``reduced_rank=True`` (``eigensolver="eigh"``: a full eigh each iteration,
then the top-rank slice).  Its rank schedule reads the carry of one
iteration earlier than the port's, so the two budgets may differ by an
iteration; the values agree wherever both budgets cover the kept rank, and
are compared with the kept rank, never the budgets.  Eigenvectors are
unique only up to sign, so bases are compared through B m_b, B V_b B^T and
projectors.  Tolerances: the eigenspace 1e-12; slicing and padding
exactly; the fits' log-marginal and rates 1e-8 against JAX, 1e-9 against
the port's own full-rank fit.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.models import inference as ji
from gaussian_processes_tpu.ops import stabilize as js
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.models import inference as ti
from gaussian_processes_tpu_torch.ops import stabilize as ts

from test_torch_fit import FP0, JAX_EXACT, THETA0, planted

torch.set_num_threads(1)

N, NT, NTILDE = 24, 256, 128
# The issue's setup: at THETA0 every eigenvalue is kept, so the budget is
# ntilde.  "budget": a smoother prior (rho 0.3) keeps 53-56 of 128, and a
# bucket of 4 moves the budget (84 -> 88) during the fit.
CASES = {
    "setup": dict(theta={}, steps=dict(maxiter=3, rank_bucket=16)),
    "budget": dict(theta={"-log2rho2": -np.log(2 * 0.3 ** 2)},
                   steps=dict(maxiter=5, rank_bucket=4)),
}
COMMON = dict(n_estep=3, n_mstep=3, n_fparamstep=3, n_px_side=N,
              crop_window=False)


def close(t, j, rtol=1e-8, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    x, lam, rng = planted(N, NT, 0)
    r = rng.poisson(lam).astype(float)
    idx = rng.permutation(NT)[:NTILDE]
    xs, _, _ = planted(N, 20, 1)
    return dict(x=x, r=r, idx=idx, x_test=xs)


def jax_fit(d, case, **extra):
    c = CASES[case]
    return jf.fit(jnp.asarray(d["x"]), jnp.asarray(d["r"]),
                  JCfg(ntilde=NTILDE, **COMMON, **c["steps"],
                       **dict(JAX_EXACT, reduced_rank=True), **extra),
                  xtilde=jnp.asarray(d["x"][d["idx"]]),
                  theta={k: jnp.float64(v)
                         for k, v in dict(THETA0, **c["theta"]).items()},
                  f_params={k: jnp.float64(v) for k, v in FP0.items()})


def port_fit(d, case, **extra):
    c = CASES[case]
    x = torch.as_tensor(d["x"])
    return tf.fit(x, torch.as_tensor(d["r"]),
                  TCfg(ntilde=NTILDE, **COMMON, **c["steps"], **extra),
                  xtilde=x[torch.as_tensor(d["idx"])],
                  theta=dict(THETA0, **c["theta"]), f_params=FP0,
                  profile=True)


@pytest.fixture(scope="module")
def fits(data):
    """JAX and port reduced fits of both cases (the budget case with the
    basis tracked) and the port's full-rank fits."""
    out = {}
    for case in CASES:
        extra = dict(track_basis=True) if case == "budget" else {}
        out[case] = dict(
            jax=jax_fit(data, case, **extra),
            port=port_fit(data, case, reduced_rank=True, **extra),
            full=port_fit(data, case, **extra))
    return out


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def gram_like(n=40, seed=0, decay=0.3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * (10.0 * np.exp(-decay * np.arange(n)))) @ Q.T
    return 0.5 * (M + M.T)


@pytest.mark.parametrize("rank", [5, 17, 30, 40, None])
def test_eigenspace_at_rank_matches_jax(rank):
    M = gram_like()
    jes = js.compute_eigenspace(jnp.asarray(M), rank=rank)
    tes = ts.compute_eigenspace(torch.as_tensor(M), rank=rank)
    width = 40 if rank is None else rank
    assert tes.B.shape == (40, width) and tes.eigvals.shape == (width,)
    np.testing.assert_array_equal(tes.keep.numpy(), np.asarray(jes.keep))
    for name in ("eigvals", "k_tilde_b_diag", "k_tilde_inv_diag"):
        close(getattr(tes, name), getattr(jes, name), rtol=1e-12,
              atol=1e-12)
    jB = np.asarray(jes.B)
    for diag in ("k_tilde_b_diag", "k_tilde_inv_diag"):
        jd, td = np.asarray(getattr(jes, diag)), getattr(tes, diag)
        close((tes.B * td) @ tes.B.T, (jB * jd) @ jB.T, rtol=1e-12,
              atol=1e-12 * np.abs(jd).max())
    # the top of the ascending eigh: the same columns as the full basis's
    full = ts.compute_eigenspace(torch.as_tensor(M))
    assert torch.equal(tes.eigvals, full.eigvals[40 - width:])


def test_eigenspace_at_rank_keeps_the_nan_poison():
    M = gram_like()
    M[3, 5] = np.nan
    tes = ts.compute_eigenspace(torch.as_tensor(M), rank=10)
    for name in ("eigvals", "B", "k_tilde_b_diag", "k_tilde_inv_diag"):
        assert torch.all(torch.isnan(getattr(tes, name))), name
    assert tes.B.shape == (40, 10) and not bool(tes.keep.any())


def test_rank_bucket_equals_jax_on_a_grid():
    for slack, pad, bucket in [(1.25, 16, 64), (1.0, 0, 1), (1.5, 3, 16),
                               (2.0, 7, 5), (1.1, 16, 4)]:
        for ntilde in (64, 100, 2100):
            jc = JCfg(rank_slack=slack, rank_pad=pad, rank_bucket=bucket)
            tc = TCfg(rank_slack=slack, rank_pad=pad, rank_bucket=bucket)
            for n_eigen in list(range(0, 120)) + [400, 1679, 2100]:
                assert (tf._rank_bucket(n_eigen, tc, ntilde)
                        == jf._rank_bucket(n_eigen, jc, ntilde))


def test_rank_knobs_are_validated():
    with pytest.raises(ValueError):
        TCfg(rank_bucket=0)
    assert not TCfg().reduced_rank and TCfg().rank_bucket == 64


def _port_carry(jc):
    """A JAX carry's arrays as the port's Carry (float64, CPU)."""
    def t(a):
        return torch.as_tensor(np.array(a))
    es = ts.Eigenspace(*(t(a) for a in jc.kern.es))
    kern = tf.KernelState(t(jc.kern.K_tilde), t(jc.kern.K), t(jc.kern.Kvec),
                          es, t(jc.kern.K_b), t(jc.kern.a))
    return tf.Carry({k: t(v) for k, v in jc.theta.items()},
                    {k: t(v) for k, v in jc.f_params.items()}, t(jc.m_b),
                    t(jc.V_b), kern, t(jc.lambda_m), t(jc.lambda_var), None,
                    False, -1)


@pytest.mark.parametrize("shared", [False, True])
def test_slice_carry_shrink_and_grow_match_jax(data, shared):
    x = jnp.asarray(data["x"][:96])
    xtilde = x if shared else jnp.asarray(data["x"][data["idx"][:40]])
    theta = {k: jnp.float64(v) for k, v in dict(
        THETA0, **CASES["budget"]["theta"]).items()}
    fp = {k: jnp.float64(v) for k, v in FP0.items()}
    n = xtilde.shape[0]
    cfg = JCfg(ntilde=n, **COMMON, **dict(JAX_EXACT, maxiter=2))
    jc = jf._fit_init(x, jnp.asarray(data["r"][:96]), xtilde, theta, fp,
                      jnp.zeros(n), jnp.zeros((n, n)), False, shared, cfg)
    tc = _port_carry(jc)
    for rank in (24, 31, n):        # shrink, then grow from the shrunk one
        jc = jf._slice_carry(jc, rank, shared)
        tc = tf._slice_carry(tc, rank, shared)
        assert tc.m_b.shape == (rank,) and tc.kern.es.B.shape == (n, rank)
        pairs = [(tc.m_b, jc.m_b), (tc.V_b, jc.V_b), (tc.kern.K_b, jc.kern.K_b),
                 (tc.kern.a, jc.kern.a)] + list(zip(tc.kern.es, jc.kern.es))
        for t_, j_ in pairs:
            np.testing.assert_array_equal(t_.numpy(), np.asarray(j_))
        if shared:
            assert tc.kern.a is tc.kern.es.B


def test_moments_estep_and_mstep_run_at_rank_r(data):
    """The algebra downstream of the eigenspace, at a rank-r carry (r = 20
    of 40): the M-step objective (exact inverse, Cholesky logdet), the
    moments, the KL (keep mask of length r), the Cholesky E-step and the
    final repair against JAX's on the same arrays."""
    from gaussian_processes_tpu.models import estep as je
    from gaussian_processes_tpu.models import moments as jm
    from gaussian_processes_tpu_torch.models import estep as te
    from gaussian_processes_tpu_torch.models import moments as tm
    from gaussian_processes_tpu_torch.params import theta_bounds

    x = jnp.asarray(data["x"][:96])
    xtilde = jnp.asarray(data["x"][data["idx"][:40]])
    theta = {k: jnp.float64(v) for k, v in dict(
        THETA0, **CASES["budget"]["theta"]).items()}
    fp = {k: jnp.float64(v) for k, v in FP0.items()}
    r = jnp.asarray(data["r"][:96])
    cfg = JCfg(ntilde=40, **COMMON, **dict(JAX_EXACT, maxiter=2))
    jc = jf._slice_carry(
        jf._fit_init(x, r, xtilde, theta, fp, jnp.zeros(40),
                     jnp.zeros((40, 40)), False, False, cfg), 20, False)
    tc = _port_carry(jc)
    tr, tx, txt = (torch.as_tensor(np.array(a)) for a in (r, x, xtilde))
    tfp = {k: torch.as_tensor(np.array(v)) for k, v in fp.items()}
    assert tc.kern.es.B.shape == (40, 20)
    lower, upper = theta_bounds()
    trial = {k: v + 0.05 for k, v in theta.items()}
    jl = jf._mstep_objective(trial, x, xtilde, r, jc.kern.es, jc.m_b, jc.V_b,
                             fp, False, cfg, lower, upper)
    tl = tf._mstep_objective({k: torch.as_tensor(np.array(v))
                              for k, v in trial.items()}, tx, txt, tr,
                             tc.kern.es, tc.m_b, tc.V_b, tfp, False,
                             TCfg(ntilde=40, **COMMON, maxiter=2), lower,
                             upper)
    close(tl, jl, rtol=1e-10)
    a, K_b, Kvec = (tc.kern.a, tc.kern.K_b, tc.kern.Kvec)
    tlm, tlv = tm.lambda_moments(a, K_b, Kvec, tc.m_b, tc.V_b)
    jlm, jlv = jm.lambda_moments(jc.kern.a, jc.kern.K_b, jc.kern.Kvec,
                                 jc.m_b, jc.V_b)
    close(tlm, jlm, rtol=1e-10, atol=1e-12)
    close(tlv, jlv, rtol=1e-10)
    close(tm.kl_divergence(tc.m_b, tc.V_b, tc.kern.es),
          jm.kl_divergence(jc.m_b, jc.V_b, jc.kern.es), rtol=1e-10)
    jfm = jm.mean_f_given_lambda_moments(fp, jlm, jlv)
    tout = te.estep_update(tr, a, tc.m_b, torch.as_tensor(np.array(jfm)),
                           tc.kern.es.k_tilde_b_diag, tfp)
    jout = je.estep_update(r, jc.kern.a, jc.m_b, jfm,
                           jc.kern.es.k_tilde_b_diag, fp)
    for t_, j_ in zip(tout, jout):
        assert t_.shape[-1] == 20
        close(t_, j_, rtol=1e-9, atol=1e-11)
    jfin = jf._fit_finalize(jc._replace(V_b=jout[1]), cfg)
    tfin = tf._fit_finalize(tc._replace(V_b=tout[1]), TCfg())
    close(tfin.V_b, jfin.V_b, rtol=1e-9, atol=1e-11)


# ---------------------------------------------------------------------------
# The reduced-rank fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_reduced_fit_matches_jax(data, fits, case):
    f = fits[case]
    jr, tr = f["jax"], f["port"]
    assert not tr.failed and not jr.failed
    close(tr.track.logmarginal, jr.track.logmarginal)
    np.testing.assert_array_equal(tr.track.n_eigen.numpy(),
                                  np.asarray(jr.track.n_eigen))
    for k in THETA0:
        close(tr.theta[k], jr.theta[k], atol=1e-10)
    xs = data["x_test"]
    close(ti.predict(tr, torch.as_tensor(xs))[0],
          ji.predict(jr, jnp.asarray(xs))[0])
    budgets = tr.timing["rank"]
    kept = tr.track.n_eigen.numpy()[1:]
    # a budget below ntilde never saturates
    assert all(k < b or b == NTILDE for k, b in zip(kept, budgets))
    if case == "setup":
        assert budgets == [NTILDE] * 2 and (kept == NTILDE).all()
    else:
        # below ntilde, and moved during the fit
        assert max(budgets) < NTILDE and len(set(budgets)) > 1
        assert tr.B.shape == (NTILDE, budgets[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_fit_matches_the_full_rank_fit(data, fits, case):
    f = fits[case]
    tr, full = f["port"], f["full"]
    close(tr.track.logmarginal, full.track.logmarginal, rtol=1e-9)
    np.testing.assert_array_equal(tr.track.n_eigen.numpy(),
                                  full.track.n_eigen.numpy())
    xs = torch.as_tensor(data["x_test"])
    close(ti.predict(tr, xs)[0], ti.predict(full, xs)[0].numpy(), rtol=1e-9)
    # tracked coordinates align with the full ascending eigh
    close(tr.track.m_b, full.track.m_b.numpy(), rtol=1e-6,
          atol=1e-9 * float(full.track.m_b.abs().max()))
    assert full.timing["rank"] == [NTILDE] * (full.config.maxiter - 1)


def test_reduced_fit_resumes_from_its_kernel_state(data, fits):
    """init_kernel at the reduced rank (a FitResult's kernel_state): the
    carry is born at that rank."""
    tr = fits["budget"]["port"]
    x = torch.as_tensor(data["x"])
    again = tf.fit(x, torch.as_tensor(data["r"]),
                   TCfg(ntilde=NTILDE, **COMMON, maxiter=2, rank_bucket=4,
                        reduced_rank=True),
                   xtilde=tr.xtilde, theta=tr.theta, f_params=tr.f_params,
                   init_kernel=tr.kernel_state, profile=True)
    assert not again.failed and again.m_b.shape[0] < NTILDE
    assert torch.isfinite(again.track.logmarginal).all()


# ---------------------------------------------------------------------------
# state_at_iteration and evaluate(at_iteration=)
# ---------------------------------------------------------------------------

def _without_basis(res, empty):
    return dataclasses.replace(res, track=res.track._replace(B=empty))


@pytest.mark.parametrize("route", ["tracked", "eigh"])
@pytest.mark.parametrize("it", [1, 4])
def test_state_at_iteration_matches_jax(data, fits, route, it):
    jr, tr = fits["budget"]["jax"], fits["budget"]["port"]
    if route == "eigh":
        jr = _without_basis(jr, jnp.zeros((5, NTILDE, 0)))
        tr = _without_basis(tr, torch.zeros((5, NTILDE, 0),
                                            dtype=torch.float64))
    jth, jfp, jm, jV, jes = ji.state_at_iteration(jr, it)
    tth, tfp, tm, tV, tes = ti.state_at_iteration(tr, it)
    for k in THETA0:
        close(tth[k], jth[k], atol=1e-12)
    np.testing.assert_array_equal(tes.keep.numpy(), np.asarray(jes.keep))
    close(tes.k_tilde_b_diag[tes.keep], np.asarray(jes.k_tilde_b_diag)[
        np.asarray(jes.keep)], rtol=1e-9)
    jB = np.asarray(jes.B)
    Bm = np.asarray(jB @ jm)
    close(tes.B @ tm, Bm, atol=1e-8 * np.abs(Bm).max())
    BVB = jB @ np.asarray(jV) @ jB.T
    close(tes.B @ tV @ tes.B.T, BVB, atol=1e-8 * np.abs(BVB).max())
    xs = data["x_test"]
    R = np.random.default_rng(3).poisson(2.0, (6, xs.shape[0])).astype(float)
    _, j_rates, _, _ = ji.evaluate(jr, jnp.asarray(xs), jnp.asarray(R),
                                   at_iteration=it, nbootstrap=10)
    _, t_rates, t_r2, _ = ti.evaluate(tr, torch.as_tensor(xs),
                                      torch.as_tensor(R), at_iteration=it,
                                      nbootstrap=10)
    close(t_rates, j_rates)
    assert np.isfinite(float(t_r2))


def test_final_iteration_reconstructs_the_prediction(data, fits):
    tr = fits["budget"]["port"]
    xs = torch.as_tensor(data["x_test"])
    R = torch.ones((4, xs.shape[0]), dtype=torch.float64)
    _, rates, _, _ = ti.evaluate(tr, xs, R, at_iteration=4, nbootstrap=5)
    close(rates, ti.predict(tr, xs)[0].numpy(), rtol=1e-9)


def test_state_at_iteration_refuses_what_it_cannot_reconstruct(fits):
    tr = fits["setup"]["port"]
    warm = dataclasses.replace(tr, used_warm_basis=True)
    with pytest.raises(ValueError, match="warm-started"):
        ti.state_at_iteration(warm, 1)
    untracked = dataclasses.replace(tr, track=tr.track._replace(
        m_b=torch.zeros((3, 0)), V_b=torch.zeros((3, 0, 0))))
    with pytest.raises(ValueError, match="track_variational"):
        ti.state_at_iteration(untracked, 1)


def test_converted_jax_reduced_result_predicts_like_jax(data, fits):
    jr = fits["budget"]["jax"]
    tr = convert.fit_result_from_numpy(jr, device="cpu")
    assert tr.B.shape == tuple(jr.B.shape) and tr.config.reduced_rank
    assert tr.track.B.shape == tuple(jr.track.B.shape)
    xs = data["x_test"]
    want = ji.predict(jr, jnp.asarray(xs))[0]
    close(ti.predict(tr, torch.as_tensor(xs))[0], want, rtol=1e-10)
    close(ti.state_at_iteration(tr, 2)[2],
          ji.state_at_iteration(jr, 2)[2], rtol=1e-12)
    # the eight arrays a prediction needs, at rank r
    st = convert.state_from_numpy(jr)
    assert st.m_b.shape[0] == jr.m_b.shape[0] < NTILDE
    th = convert.theta_from_numpy({k: np.asarray(v)
                                   for k, v in jr.theta.items()})
    fp = convert.f_params_from_numpy({k: np.asarray(v)
                                      for k, v in jr.f_params.items()})
    rates = ti.predict_rates(torch.as_tensor(xs), st.xtilde, th, fp, st.m_b,
                             st.V_b, st.B, st.k_tilde_b_diag,
                             st.k_tilde_inv_diag, n_px_side=N)[0]
    close(rates, want, rtol=1e-10)
