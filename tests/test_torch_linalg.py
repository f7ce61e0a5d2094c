"""The port's stabilization (ops/stabilize.py), moments (models/moments.py)
and E-step (models/estep.py) against the JAX package, float64, on the same
numpy inputs.

Eigenvectors are unique only up to sign (and rotation inside degenerate
eigenspaces), so the eigenspace is compared through basis-independent
quantities: B diag(k) B^T, B diag(1/k) B^T, the kept count and the
eigenvalues.  Functions downstream of the eigenspace get the JAX
eigenspace's arrays, so their outputs compare element-wise.  Tolerance
rtol 1e-9 (float64, LAPACK routines and summation orders differ).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.models import estep as je
from gaussian_processes_tpu.models import moments as jm
from gaussian_processes_tpu.ops import stabilize as js
from gaussian_processes_tpu_torch.models import estep as te
from gaussian_processes_tpu_torch.models import moments as tm
from gaussian_processes_tpu_torch.ops import stabilize as ts

torch.set_num_threads(1)

RTOL = 1e-9


def close(t, j, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


def gram_like(n=24, seed=0, decay=0.5):
    """A symmetric PSD matrix with a spectrum spanning many orders, like a
    kernel Gram (so the keep mask drops a tail)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = 10.0 * np.exp(-decay * np.arange(n))
    M = (Q * ev) @ Q.T
    return 0.5 * (M + M.T)


def both_eigenspaces(M):
    return js.compute_eigenspace(jnp.asarray(M)), \
        ts.compute_eigenspace(torch.as_tensor(M))


def tes_from(jes):
    """The JAX eigenspace's arrays as the port's Eigenspace."""
    return ts.Eigenspace(*(torch.as_tensor(np.array(a)) for a in jes))


@pytest.mark.parametrize("decay", [0.1, 0.5, 1.0])
def test_eigenspace_basis_independent_quantities(decay):
    M = gram_like(decay=decay)
    jes, tes = both_eigenspaces(M)
    assert int(tes.keep.sum()) == int(np.asarray(jes.keep).sum())
    assert 0 < int(tes.keep.sum()) < M.shape[0] or decay == 0.1
    close(tes.eigvals, jes.eigvals, atol=1e-12)
    for diag in ("k_tilde_b_diag", "k_tilde_inv_diag"):
        jB, tB = np.asarray(jes.B), tes.B
        jd, td = np.asarray(getattr(jes, diag)), getattr(tes, diag)
        close((tB * td) @ tB.T, (jB * jd) @ jB.T, atol=1e-10)
    np.testing.assert_array_equal(tes.keep.numpy(), np.asarray(jes.keep))


def test_eigenspace_nan_poison():
    M = gram_like()
    M[3, 5] = np.nan
    jes, tes = both_eigenspaces(M)
    for name in ("eigvals", "B", "k_tilde_b_diag", "k_tilde_inv_diag"):
        assert torch.all(torch.isnan(getattr(tes, name))), name
        assert np.all(np.isnan(np.asarray(getattr(jes, name)))), name
    assert not bool(tes.keep.any())


def test_project_gram_and_reproject_match_jax():
    rng = np.random.default_rng(1)
    jes = js.compute_eigenspace(jnp.asarray(gram_like()))
    jes2 = js.compute_eigenspace(jnp.asarray(gram_like(seed=2)))
    tes, tes2 = tes_from(jes), tes_from(jes2)
    K = rng.standard_normal((30, 24))
    for shared in (False, True):
        close(ts.project_gram(tes, torch.as_tensor(K), shared),
              js.project_gram(jes, jnp.asarray(K), shared))
    m = rng.standard_normal(24)
    V = gram_like(seed=3)
    for t, j in zip(ts.reproject(tes2, tes, torch.as_tensor(m),
                                 torch.as_tensor(V)),
                    js.reproject(jes2, jes, jnp.asarray(m), jnp.asarray(V))):
        close(t, j)


@pytest.mark.parametrize("case", ["posdef", "indefinite"])
def test_logdets_and_inverse_match_jax(case):
    jes = js.compute_eigenspace(jnp.asarray(gram_like()))
    keep = np.array(jes.keep)
    B = np.asarray(jes.B)
    M = B.T @ gram_like(seed=4) @ B       # dense, zero on dropped rows/cols
    if case == "indefinite":
        kept = np.flatnonzero(keep)
        M[kept[0], kept[0]] = -5.0
    tk_, jk_ = torch.as_tensor(keep), jnp.asarray(keep)
    tM, jM = torch.as_tensor(M), jnp.asarray(M)
    ld_t, ld_j = ts.masked_logdet_chol(tM, tk_), js.masked_logdet_chol(jM, jk_)
    if case == "posdef":
        close(ld_t, ld_j)
    else:
        assert torch.isnan(ld_t) and np.isnan(float(ld_j))
    close(ts.masked_logdet_eigh(tM, tk_), js.masked_logdet_eigh(jM, jk_))
    close(ts.logdet_with_fallback(tM, tk_), js.logdet_with_fallback(jM, jk_))
    if case == "posdef":
        close(ts.masked_inverse_spd(tM, tk_), js.masked_inverse(jM, jk_),
              atol=1e-10)
    else:
        assert torch.all(torch.isnan(ts.masked_inverse_spd(tM, tk_)))


@pytest.mark.parametrize("batched", [False, True])
def test_spd_inverse_matches_jax_and_poisons_the_indefinite(batched):
    """The M-step's Cholesky-route inverse against JAX's LU masked_inverse
    on positive definite kept blocks (one matrix, or a stack with an
    indefinite item, which alone turns NaN)."""
    jes = js.compute_eigenspace(jnp.asarray(gram_like()))
    keep = np.array(jes.keep)
    B = np.asarray(jes.B)
    Ms = [B.T @ gram_like(seed=s) @ B for s in (4, 7, 8)]
    kept = np.flatnonzero(keep)
    Ms[1][kept[0], kept[0]] = -5.0
    want = [js.masked_inverse(jnp.asarray(M), jnp.asarray(keep)) for M in Ms]
    tk_ = torch.as_tensor(keep)
    if not batched:
        close(ts.masked_inverse_spd(torch.as_tensor(Ms[0]), tk_), want[0],
              atol=1e-10)
        assert torch.all(torch.isnan(ts.masked_inverse_spd(
            torch.as_tensor(Ms[1]), tk_)))
        return
    got = ts.masked_inverse_spd(torch.as_tensor(np.stack(Ms)),
                                tk_.expand(3, -1))
    for i in (0, 2):
        close(got[i], want[i], atol=1e-10)
    assert torch.all(torch.isnan(got[1]))


def test_linalg_nan_poison():
    M = gram_like()
    keep = torch.ones(M.shape[0], dtype=torch.bool)
    bad = torch.as_tensor(M).clone()
    bad[0, 0] = float("nan")
    assert torch.isnan(ts.masked_logdet_chol(bad, keep))
    assert torch.isnan(ts.masked_logdet_eigh(bad, keep))
    assert torch.isnan(ts.logdet_with_fallback(bad, keep))
    assert torch.all(torch.isnan(ts.masked_inverse_spd(bad, keep)))
    singular = torch.zeros_like(bad)
    assert torch.all(torch.isnan(ts.masked_inverse_spd(singular, keep)))


# ---------------------------------------------------------------------------
# Moments, KL and the E-step
# ---------------------------------------------------------------------------

def problem(nt=40, n=24, seed=5):
    rng = np.random.default_rng(seed)
    jes = js.compute_eigenspace(jnp.asarray(gram_like(n)))
    B = np.asarray(jes.B)
    K = rng.standard_normal((nt, n)) * 0.5
    K_b = K @ B
    a = K_b * np.asarray(jes.k_tilde_inv_diag)[None, :]
    Kvec = 2.0 + rng.random(nt)
    m_b = (B.T @ rng.standard_normal(n)) * 0.3
    V_b = B.T @ gram_like(n, seed=6) @ B * 0.05
    r = rng.poisson(1.5, nt).astype(float)
    fp = {"logA": np.log(0.3), "lambda0": 0.2}
    return dict(jes=jes, a=a, K_b=K_b, Kvec=Kvec, m_b=m_b, V_b=V_b, r=r,
                fp=fp)


def as_t(p):
    return {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


def as_j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_moments_match_jax():
    p = problem()
    T = {k: torch.as_tensor(v) for k, v in p.items()
         if k not in ("jes", "fp")}
    J = {k: jnp.asarray(v) for k, v in p.items() if k not in ("jes", "fp")}
    tfp, jfp = as_t(p["fp"]), as_j(p["fp"])
    tlm, tlv = tm.lambda_moments(T["a"], T["K_b"], T["Kvec"], T["m_b"],
                                 T["V_b"])
    jlm, jlv = jm.lambda_moments(J["a"], J["K_b"], J["Kvec"], J["m_b"],
                                 J["V_b"])
    close(tlm, jlm)
    close(tlv, jlv)
    tf = tm.mean_f_given_lambda_moments(tfp, tlm, tlv)
    jf = jm.mean_f_given_lambda_moments(jfp, jlm, jlv)
    close(tf, jf)
    close(tm.lambda0_given_logA(tfp["logA"], T["r"], tlm, tlv),
          jm.lambda0_given_logA(jfp["logA"], J["r"], jlm, jlv))
    close(tm.poisson_ell(T["r"], tf, tlm, tfp),
          jm.poisson_ell(J["r"], jf, jlm, jfp))
    # test-point moments
    close_pair = zip(
        tm.lambda_moments_star(T["a"], T["K_b"], T["Kvec"], T["m_b"],
                               T["V_b"],
                               torch.as_tensor(np.array(
                                   p["jes"].k_tilde_b_diag))),
        jm.lambda_moments_star(J["a"], J["K_b"], J["Kvec"], J["m_b"],
                               J["V_b"], p["jes"].k_tilde_b_diag))
    for t, j in close_pair:
        close(t, j)


def test_kl_divergence_matches_jax():
    p = problem()
    jes = p["jes"]
    tes = tes_from(jes)
    tmb, tVb = torch.as_tensor(p["m_b"]), torch.as_tensor(p["V_b"])
    jmb, jVb = jnp.asarray(p["m_b"]), jnp.asarray(p["V_b"])
    V_full = torch.as_tensor(np.array(jes.B).T @ gram_like(seed=6)
                             @ np.asarray(jes.B))
    # diagonal (E-step basis) case, with and without log|V|
    close(tm.kl_divergence(tmb, tVb, tes), jm.kl_divergence(jmb, jVb, jes))
    close(tm.kl_divergence(tmb, tVb, tes, skip_logdet_V=True),
          jm.kl_divergence(jmb, jVb, jes, skip_logdet_V=True))
    # dense M-step case
    Kb = V_full.numpy() + np.diag(np.asarray(jes.k_tilde_b_diag))
    Kb = Kb * np.outer(np.asarray(jes.keep), np.asarray(jes.keep))
    jKi = js.masked_inverse(jnp.asarray(Kb), jes.keep)
    tKi = ts.masked_inverse_spd(torch.as_tensor(Kb), tes.keep)
    for chol_only in (False, True):
        close(tm.kl_divergence(tmb, tVb, tes, K_tilde_b=torch.as_tensor(Kb),
                               K_tilde_inv_b=tKi, skip_logdet_V=True,
                               chol_only=chol_only),
              jm.kl_divergence(jmb, jVb, jes, K_tilde_b=jnp.asarray(Kb),
                               K_tilde_inv_b=jKi, skip_logdet_V=True,
                               chol_only=chol_only))


def test_estep_update_matches_jax():
    p = problem()
    jes = p["jes"]
    tfp, jfp = as_t(p["fp"]), as_j(p["fp"])
    jlm, jlv = jm.lambda_moments(jnp.asarray(p["a"]), jnp.asarray(p["K_b"]),
                                 jnp.asarray(p["Kvec"]), jnp.asarray(p["m_b"]),
                                 jnp.asarray(p["V_b"]))
    jf = jm.mean_f_given_lambda_moments(jfp, jlm, jlv)
    jout = je.estep_update(jnp.asarray(p["r"]), jnp.asarray(p["a"]),
                           jnp.asarray(p["m_b"]), jf, jes.k_tilde_b_diag, jfp)
    tout = te.estep_update(torch.as_tensor(p["r"]), torch.as_tensor(p["a"]),
                           torch.as_tensor(p["m_b"]),
                           torch.as_tensor(np.array(jf)),
                           torch.as_tensor(np.array(jes.k_tilde_b_diag)),
                           tfp)
    for t, j in zip(tout, jout):
        close(t, j, atol=1e-11)


def test_estep_nan_poison():
    p = problem()
    f = np.full(p["r"].shape, np.nan)
    m, V = te.estep_update(torch.as_tensor(p["r"]), torch.as_tensor(p["a"]),
                           torch.as_tensor(p["m_b"]), torch.as_tensor(f),
                           torch.as_tensor(np.array(
                               p["jes"].k_tilde_b_diag)), as_t(p["fp"]))
    assert torch.all(torch.isnan(m)) and torch.all(torch.isnan(V))
