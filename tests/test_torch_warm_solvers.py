"""The port's warm solvers against the JAX package's, float64, on the same
numpy inputs: CholQR, the warm-started subspace eigensolver, Newton-Schulz
(2-D and batched), the warm-seeded M-step inverse with both fallbacks and
its hand-written backward, the trace-series log-determinant, the E-step
update with a carried inverse, and the KL with a supplied log-determinant.

JAX decides its fallbacks in the graph (``lax.cond``, ``while_loop``); the
port decides the eigensolver's and the E-step's on the host, once per call,
and the M-step's two (the inverse and the series) on the device, counting
them there (``decisions.fold`` brings the counts to the host); it runs
Newton-Schulz for its fixed step count: after acceptance the iterate sits
at the rounding floor, so the two agree to rounding.  Eigenvectors are compared as projectors.
Tolerances: rtol 1e-10 on values, 1e-8 on gradients.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.models import estep as je
from gaussian_processes_tpu.models import moments as jm
from gaussian_processes_tpu.ops import stabilize as js
from gaussian_processes_tpu_torch.models import estep as te
from gaussian_processes_tpu_torch.models import moments as tm
from gaussian_processes_tpu_torch.ops import stabilize as ts
from gaussian_processes_tpu_torch.utils.tracing import decisions

from test_torch_linalg import as_j, as_t, gram_like, problem, tes_from

torch.set_num_threads(1)

RTOL = 1e-10
GRAD_RTOL = 1e-8


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


def sym(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return 0.5 * (A + A.T)


def kept_block(n=24, seed=0, eps=0.005, scale=1.0, drop=4):
    """A K_tilde_b-like matrix: ``scale`` diag(eigenvalues) plus a
    symmetric perturbation of relative size ``eps``, exactly zero on the
    ``drop`` dropped rows and columns; with its keep mask and the diagonal
    inverse seed of the unscaled, unperturbed matrix (the M-step's
    ``k_tilde_inv_diag``).  ``scale`` 3 puts the seed out of Newton-Schulz's
    reach (||I - M X0|| = 2) with M still positive definite."""
    ev = 10.0 * np.exp(-0.3 * np.arange(n))[::-1].copy()
    keep = np.arange(n) >= drop
    s = np.sqrt(ev)
    M = scale * np.diag(ev) + eps * (s[:, None] * sym(n, seed) * s[None, :])
    M = M * np.outer(keep, keep)
    inv_diag = np.where(keep, 1.0 / ev, 0.0)
    return M, keep, inv_diag


FAR = dict(scale=3.0)


# ---------------------------------------------------------------------------
# CholQR and Newton-Schulz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 2])
def test_cholqr_matches_jax(iters):
    Y = np.random.default_rng(0).standard_normal((40, 8))
    Y[:, 3] *= 1e3
    got = ts._cholqr(torch.as_tensor(Y), iters=iters)
    close(got, js._cholqr(jnp.asarray(Y), iters=iters), atol=1e-12)
    close(got.T @ got, np.eye(8), atol=1e-10)
    # a rank-deficient Y gives NaN in both
    Y[:, 5] = 0.0
    assert not bool(torch.isfinite(ts._cholqr(torch.as_tensor(Y))).all())
    assert not np.all(np.isfinite(np.asarray(js._cholqr(jnp.asarray(Y)))))


def _schulz_case(seed, eps):
    """An SPD matrix and the inverse of a matrix ``eps`` away from it."""
    M = gram_like(20, seed=seed, decay=0.1)
    near = M + eps * sym(20, seed + 100)
    return M, np.linalg.inv(near)


@pytest.mark.parametrize("eps", [1e-3, 0.5])
def test_schulz_iterations_matches_jax(eps):
    M, X0 = _schulz_case(1, eps)
    X, resid = ts.schulz_iterations(torch.as_tensor(M), torch.as_tensor(X0))
    jX, jres = js.schulz_iterations(jnp.asarray(M), jnp.asarray(X0))
    accepted = bool(resid < 1e-3)
    assert accepted == bool(jres < 1e-3) == (eps < 0.1)
    if accepted:
        close(X, jX, atol=1e-12)
        close(X, np.linalg.inv(M), atol=1e-12)
    assert bool(torch.isfinite(resid))


def test_schulz_iterations_batched_matches_per_item_jax():
    cases = [_schulz_case(s, e) for s, e in ((1, 1e-3), (2, 0.5), (3, 1e-2))]
    M = np.stack([c[0] for c in cases])
    X0 = np.stack([c[1] for c in cases])
    X, resid = ts.schulz_iterations(torch.as_tensor(M), torch.as_tensor(X0))
    assert resid.shape == (3,)
    for i, (Mi, X0i) in enumerate(cases):
        jX, jres = js.schulz_iterations(jnp.asarray(Mi), jnp.asarray(X0i))
        assert bool(resid[i] < 1e-3) == bool(jres < 1e-3)
        if bool(jres < 1e-3):
            close(X[i], jX, atol=1e-12)
        # the item alone gives the batch's result
        Xi, ri = ts.schulz_iterations(torch.as_tensor(Mi),
                                      torch.as_tensor(X0i))
        close(X[i], Xi.numpy())
    np.testing.assert_array_equal((resid < 1e-3).numpy(),
                                  [True, False, True])


# ---------------------------------------------------------------------------
# The warm-seeded M-step inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fallback", ["exact", "poison"])
@pytest.mark.parametrize("seed_dist", ["near", "far"])
def test_masked_inverse_warm_matches_jax(seed_dist, fallback):
    M, keep, inv_diag = kept_block(**({} if seed_dist == "near" else FAR))
    decisions.clear()
    got = ts.masked_inverse_warm(torch.as_tensor(M), torch.as_tensor(keep),
                                 torch.as_tensor(inv_diag), fallback=fallback)
    want = js.masked_inverse_warm(jnp.asarray(M), jnp.asarray(keep),
                                  jnp.asarray(inv_diag), fallback=fallback)
    # the guard is counted on the device: fold its count into the host's
    decisions.fold()
    if seed_dist == "far" and fallback == "poison":
        assert bool(torch.isnan(got).all()) and np.all(np.isnan(want))
        assert not decisions          # no guard counted under "poison"
        return
    scale = np.abs(np.asarray(want)).max()
    close(got, want, atol=1e-12 * scale)
    close(got, ts.masked_inverse_spd(torch.as_tensor(M),
                                     torch.as_tensor(keep)).numpy(),
          atol=1e-12 * scale)
    if fallback == "exact":
        route = "mstep.schulz" if seed_dist == "near" else "mstep.exact"
        assert dict(decisions) == {route: 1,
                                   ({"mstep.schulz", "mstep.exact"}
                                    - {route}).pop(): 0}


def test_masked_inverse_warm_validates_its_fallback():
    M, keep, inv_diag = kept_block()
    with pytest.raises(ValueError, match="fallback must be"):
        ts.masked_inverse_warm(torch.as_tensor(M), torch.as_tensor(keep),
                               torch.as_tensor(inv_diag), fallback="lu")


@pytest.mark.parametrize("fallback", ["exact", "poison"])
def test_masked_inverse_warm_gradient_matches_jax(fallback):
    """The hand-written backward (-X^T g X^T) against jax.grad through the
    JAX package's custom_vjp, on a weighted sum of the inverse."""
    M, keep, inv_diag = kept_block(seed=3)
    W = sym(M.shape[0], 7) + 0.3 * np.random.default_rng(8).standard_normal(
        M.shape)

    def jloss(Mj):
        inv = js.masked_inverse_warm(Mj, jnp.asarray(keep),
                                     jnp.asarray(inv_diag), fallback=fallback)
        return jnp.sum(jnp.asarray(W) * inv)

    tM = torch.as_tensor(M).requires_grad_(True)
    inv = ts.masked_inverse_warm(tM, torch.as_tensor(keep),
                                 torch.as_tensor(inv_diag), fallback=fallback)
    (g,) = torch.autograd.grad(torch.sum(torch.as_tensor(W) * inv), tM)
    jg = jax.grad(jloss)(jnp.asarray(M))
    close(g, jg, rtol=GRAD_RTOL, atol=1e-12 * np.abs(np.asarray(jg)).max())


def test_poisoned_trial_has_a_finite_gradient():
    """A trial too far from the seed under "poison": the inverse is NaN,
    its gradient finite (zero), as in the JAX package."""
    M, keep, inv_diag = kept_block(**FAR)
    tM = torch.as_tensor(M).requires_grad_(True)
    inv = ts.masked_inverse_warm(tM, torch.as_tensor(keep),
                                 torch.as_tensor(inv_diag), fallback="poison")
    assert bool(torch.isnan(inv).all())
    (g,) = torch.autograd.grad(inv.sum(), tM)
    assert bool(torch.isfinite(g).all())
    jg = jax.grad(lambda Mj: jnp.sum(js.masked_inverse_warm(
        Mj, jnp.asarray(keep), jnp.asarray(inv_diag), fallback="poison")))(
            jnp.asarray(M))
    close(g, jg)


def test_masked_inverse_warm_batched_mixes_both_routes():
    """A stack with one item near its seed and one far: under "exact" each
    item is the Cholesky inverse to rounding, decided on the device;
    under "poison" only the far item is NaN."""
    (M0, keep, d0), (M1, _, d1) = kept_block(), kept_block(**FAR)
    M = torch.as_tensor(np.stack([M0, M1]))
    k = torch.as_tensor(keep).expand(2, -1)
    d = torch.as_tensor(np.stack([d0, d1]))
    decisions.clear()
    got = ts.masked_inverse_warm(M, k, d)
    decisions.fold()
    assert dict(decisions) == {"mstep.schulz": 1, "mstep.exact": 1}
    want = ts.masked_inverse_spd(M, k)
    close(got, want.numpy(), atol=1e-12 * float(want.abs().max()))
    pois = ts.masked_inverse_warm(M, k, d, fallback="poison")
    assert bool(torch.isfinite(pois[0]).all()) and bool(
        torch.isnan(pois[1]).all())


# ---------------------------------------------------------------------------
# The trace-series log-determinant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("far,route", [(False, "mstep.series"),
                                       (True, "mstep.chol")])
def test_masked_logdet_series_matches_jax(far, route):
    M, keep, inv_diag = kept_block(**(FAR if far else {}))
    decisions.clear()
    tM = torch.as_tensor(M).requires_grad_(True)
    got = ts.masked_logdet_series(tM, torch.as_tensor(keep),
                                  torch.as_tensor(inv_diag))
    decisions.fold()
    assert decisions[route] == 1 and sum(decisions.values()) == 1

    def jld(Mj):
        return js.masked_logdet_series(Mj, jnp.asarray(keep),
                                       jnp.asarray(inv_diag))
    close(got, jld(jnp.asarray(M)))
    (g,) = torch.autograd.grad(got, tM)
    jg = jax.grad(jld)(jnp.asarray(M))
    close(g, jg, rtol=GRAD_RTOL, atol=1e-12 * np.abs(np.asarray(jg)).max())
    # the series is the Cholesky log-determinant to its truncation error
    chol = float(ts.masked_logdet_chol(torch.as_tensor(M),
                                       torch.as_tensor(keep)))
    assert abs(float(got.detach()) - chol) <= (1e-6 if route == "mstep.series"
                                      else 1e-12 * abs(chol))


def test_masked_logdet_series_batched_keeps_gradients_finite():
    """A stack with one item in the series regime and one indefinite item
    (the Cholesky route, NaN): the first item's value and gradient are the
    single call's, with no NaN from the other route."""
    M0, keep, d0 = kept_block()
    M1, _, d1 = kept_block(**FAR)
    M1[-1, -1] = -5.0
    tM = torch.as_tensor(np.stack([M0, M1])).requires_grad_(True)
    k = torch.as_tensor(keep).expand(2, -1)
    ld = ts.masked_logdet_series(tM, k, torch.as_tensor(np.stack([d0, d1])))
    assert bool(torch.isfinite(ld[0])) and bool(torch.isnan(ld[1]))
    (g,) = torch.autograd.grad(ld[0], tM)
    assert bool(torch.isfinite(g).all()) and not bool(g[1].any())
    want = jax.grad(lambda Mj: js.masked_logdet_series(
        Mj, jnp.asarray(keep), jnp.asarray(d0)))(jnp.asarray(M0))
    close(ld[0], js.masked_logdet_series(jnp.asarray(M0), jnp.asarray(keep),
                                         jnp.asarray(d0)))
    close(g[0], want, rtol=GRAD_RTOL,
          atol=1e-12 * np.abs(np.asarray(want)).max())


# ---------------------------------------------------------------------------
# The warm-started subspace eigensolver
# ---------------------------------------------------------------------------

def _warm_basis(n=40, rank=16, dead=(0, 1, 5)):
    """K_tilde at one theta and the top-``rank`` basis of a nearby one,
    with the ``dead`` columns zeroed (dropped directions, or the padding of
    a grown budget)."""
    K = gram_like(n, seed=0, decay=0.3)
    K_prev = K + 1e-3 * sym(n, 11)
    B = np.array(js.compute_eigenspace(jnp.asarray(K_prev), rank=rank).B)
    B[:, list(dead)] = 0.0
    return K, B


@pytest.mark.parametrize("dead", [(), (0, 1, 5)])
def test_subspace_eigenspace_matches_jax(dead):
    K, B = _warm_basis(dead=dead)
    tes, tok = ts.subspace_eigenspace(torch.as_tensor(K), torch.as_tensor(B))
    jes, jok = js.subspace_eigenspace(jnp.asarray(K), jnp.asarray(B))
    assert bool(tok) and bool(jok)
    np.testing.assert_array_equal(tes.keep.numpy(), np.asarray(jes.keep))
    for name in ("eigvals", "k_tilde_b_diag", "k_tilde_inv_diag"):
        close(getattr(tes, name), getattr(jes, name), atol=1e-12)
    jB = np.asarray(jes.B)
    close(tes.B @ tes.B.T, jB @ jB.T, atol=1e-10)
    close((tes.B * tes.k_tilde_b_diag) @ tes.B.T,
          (jB * np.asarray(jes.k_tilde_b_diag)) @ jB.T, atol=1e-10)
    # the top eigenvalues are the full eigh's (the bottom of a subspace
    # that grew from fillers converges more slowly)
    full = np.linalg.eigvalsh(K)[-B.shape[1]:]
    close(tes.eigvals[-8:], full[-8:], rtol=1e-8)


def test_subspace_eigenspace_holds_in_float32_past_the_kept_rank():
    """A float32 K_tilde and a budget of 40 whose last columns lie below
    the kept threshold (1e-4 lambda_max): float32 CholQR would fail on them
    every time; the port iterates in float64, so the warm solve holds, and
    its eigenspace (cast back to float32) is the float64 one's to float32
    rounding of K_tilde."""
    K = gram_like(60, seed=0, decay=0.3)
    K_prev = K + 1e-4 * sym(60, 11)
    B = ts.compute_eigenspace(torch.as_tensor(K_prev), rank=40).B
    want, ok64 = ts.subspace_eigenspace(torch.as_tensor(K), B)
    got, ok32 = ts.subspace_eigenspace(torch.as_tensor(K).float(), B.float())
    assert bool(ok64) and bool(ok32) and got.eigvals.dtype == torch.float32
    np.testing.assert_array_equal(got.keep.numpy(), want.keep.numpy())
    kept = want.keep
    close(got.eigvals[kept], want.eigvals[kept].numpy(), rtol=1e-4)
    assert int(kept.sum()) < 40
    # the JAX package iterates in the input's dtype: in float32 its CholQR
    # fails here, and its fit would take the full eigh every iteration
    _, jok = js.subspace_eigenspace(jnp.asarray(K, jnp.float32),
                                    jnp.asarray(B.numpy(), jnp.float32))
    assert not bool(jok)


def test_subspace_eigenspace_rank_deficient_warm_basis_fails_in_both():
    K, B = _warm_basis(dead=())
    B[:, 7] = B[:, 9]
    tes, tok = ts.subspace_eigenspace(torch.as_tensor(K), torch.as_tensor(B))
    _, jok = js.subspace_eigenspace(jnp.asarray(K), jnp.asarray(B))
    assert not bool(tok) and not bool(jok)
    assert not bool(tes.B.any())


# ---------------------------------------------------------------------------
# The E-step with a carried inverse, and the KL with a given log|K|
# ---------------------------------------------------------------------------

def _estep_inputs(scale=1.0):
    """test_torch_linalg's problem with f_mean positive (its moments give
    a negative variance there), scaled by ``scale``."""
    p = problem()
    f = 1.5 * np.exp(0.2 * np.random.default_rng(9).standard_normal(
        p["r"].shape)) * scale
    return [p["r"], p["a"], p["m_b"], f,
            np.array(p["jes"].k_tilde_b_diag)], p["fp"]


@pytest.mark.parametrize("seed_dist", ["near", "far"])
def test_estep_update_with_warm_inverse_matches_jax(seed_dist):
    """The previous Newton step's inverse (at f scaled by 1.02, or by 0.05
    for a seed too far to converge) seeds the next: m_b, V_b and the
    inverse against JAX's, and against the Cholesky route."""
    prev, fp = _estep_inputs(1.02 if seed_dist == "near" else 0.05)
    args, _ = _estep_inputs()
    _, _, jMinv0 = je.estep_update(*(jnp.asarray(a) for a in prev),
                                   as_j(fp), return_minv=True)
    jout = je.estep_update(*(jnp.asarray(a) for a in args), as_j(fp),
                           Minv_warm=jMinv0, use_warm=jnp.asarray(True),
                           return_minv=True)
    decisions.clear()
    tout = te.estep_update(*(torch.as_tensor(a) for a in args), as_t(fp),
                           Minv_warm=torch.as_tensor(np.array(jMinv0)),
                           use_warm=True, return_minv=True)
    route = "estep.schulz" if seed_dist == "near" else "estep.exact"
    assert decisions[route] == 1 and sum(decisions.values()) == 1
    for t, j in zip(tout, jout):
        close(t, j, atol=1e-11)
    exact = te.estep_update(*(torch.as_tensor(a) for a in args), as_t(fp),
                            return_minv=True)
    for t, e in zip(tout, exact):
        close(t, e.numpy(), atol=1e-11)
    # without use_warm the seed is ignored: the Cholesky route
    cold = te.estep_update(*(torch.as_tensor(a) for a in args), as_t(fp),
                           Minv_warm=torch.as_tensor(np.array(jMinv0)))
    for t, e in zip(cold, exact):
        assert torch.equal(t, e)


def test_kl_divergence_with_logdet_K_matches_jax():
    p = problem()
    jes = p["jes"]
    tes = tes_from(jes)
    keep = np.asarray(jes.keep)
    Kb = (np.diag(np.asarray(jes.k_tilde_b_diag))
          + 0.01 * sym(keep.size, 4) * np.outer(keep, keep))
    ld = js.masked_logdet_series(jnp.asarray(Kb), jes.keep,
                                 jes.k_tilde_inv_diag)
    jKi = js.masked_inverse(jnp.asarray(Kb), jes.keep)
    want = jm.kl_divergence(jnp.asarray(p["m_b"]), jnp.asarray(p["V_b"]), jes,
                            K_tilde_b=jnp.asarray(Kb), K_tilde_inv_b=jKi,
                            skip_logdet_V=True, chol_only=True, logdet_K=ld)
    got = tm.kl_divergence(torch.as_tensor(p["m_b"]), torch.as_tensor(p["V_b"]),
                           tes, K_tilde_b=torch.as_tensor(Kb),
                           K_tilde_inv_b=torch.as_tensor(np.array(jKi)),
                           skip_logdet_V=True, chol_only=True,
                           logdet_K=torch.as_tensor(np.array(ld)))
    close(got, want)
    # a supplied log|K| replaces the Cholesky one
    chol = tm.kl_divergence(torch.as_tensor(p["m_b"]),
                            torch.as_tensor(p["V_b"]), tes,
                            K_tilde_b=torch.as_tensor(Kb),
                            K_tilde_inv_b=torch.as_tensor(np.array(jKi)),
                            skip_logdet_V=True, chol_only=True)
    shift = tm.kl_divergence(torch.as_tensor(p["m_b"]),
                             torch.as_tensor(p["V_b"]), tes,
                             K_tilde_b=torch.as_tensor(Kb),
                             K_tilde_inv_b=torch.as_tensor(np.array(jKi)),
                             skip_logdet_V=True, chol_only=True,
                             logdet_K=torch.tensor(0.0, dtype=torch.float64))
    close(chol - shift, 0.5 * float(ts.masked_logdet_chol(
        torch.as_tensor(Kb), tes.keep)))
