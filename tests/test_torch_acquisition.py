"""Lambert-W, the batched mutual-information utility and the pool scorer of
the port against the JAX package, on the same numpy inputs.

Tolerances: float64 rtol 1e-12 (Lambert-W), 1e-10 (the nd_* functions and
utility) and 1e-8 (the scorer, whose Grams sum in another order).  float32:
Lambert-W rtol 1e-6; the nd_* functions rtol 1e-5 plus an absolute 1e-5 of
the output's largest magnitude, because XLA's float32 lgamma is off by up to
5e-7 absolute (lgamma(1) = 4.8e-7) and the utility is a difference of O(1)
entropies, so small entries carry the terms' rounding, not their own.  The
overflow masks (z = sigma2 exp(r sigma2 + mu) not finite) are compared
exactly in both dtypes: float32 masks far more entries than float64, and
both sides must mask the same ones.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy.special import lambertw as scipy_w

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import acquisition as ja
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.ops.lambertw import lambertw as j_lambertw
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.models import acquisition as ta
from gaussian_processes_tpu_torch.ops.kernels import crop_window_from_scalars
from gaussian_processes_tpu_torch.ops.lambertw import lambertw

from test_torch_fit import FP0, JAX_EXACT, THETA0, planted

torch.set_num_threads(1)

# the grid of tests/test_acquisition.py, extended to 1e300 (float64) and to
# float32's largest finite value
Z_SMALL = np.concatenate([[0.0], np.logspace(-12, -1, 40),
                          np.linspace(0.0, 5.0, 101)])
Z64 = np.concatenate([Z_SMALL, np.logspace(1, 300, 120), [1e300]])
Z32 = np.concatenate([Z_SMALL, np.logspace(1, 38, 120),
                      [np.finfo(np.float32).max]]).astype(np.float32)
DTYPES = [(np.float64, 1e-12), (np.float32, 1e-6)]


def _z(dtype):
    return Z64 if dtype == np.float64 else Z32


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_lambertw_matches_jax(dtype, rtol):
    z = _z(dtype)
    got = lambertw(torch.as_tensor(z))
    assert got.dtype == torch.as_tensor(z).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(j_lambertw(
        jnp.asarray(z))), rtol=rtol, atol=0.0)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_lambertw_matches_scipy(dtype, rtol):
    """Against SciPy in float64; float32 up to 1e37, since the last
    iterates overflow w e^w just below float32's largest value (the JAX
    function does the same there, see the test above)."""
    z = _z(dtype)
    if dtype == np.float32:
        z = z[z <= 1e37]
    ref = np.real(scipy_w(z.astype(np.float64), k=0))
    np.testing.assert_allclose(lambertw(torch.as_tensor(z)).numpy(), ref,
                               rtol=rtol, atol=1e-15)


@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_lambertw_initial_guess_and_iterates_match_jax(iterations):
    """The same initial guess (tiny floor, the e threshold) and the same
    Halley iterates, step by step."""
    z = Z64
    np.testing.assert_allclose(
        lambertw(torch.as_tensor(z), iterations=iterations).numpy(),
        np.asarray(j_lambertw(jnp.asarray(z), iterations=iterations)),
        rtol=1e-13, atol=0.0)


def _moments(dtype, ns=64, seed=0):
    """log-f moments whose z overflows for large r: in float32 from
    sigma2 ~ 0.9, in float64 from sigma2 ~ 7.2."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-3.0, 2.0, ns)
    s2 = np.concatenate([rng.uniform(0.01, 1.5, ns - 6),
                         [2.0, 3.0, 5.0, 7.5, 8.0, 0.9]])
    return s2.astype(dtype), mu.astype(dtype)


def _close(t, j, dtype, rtol64=1e-10):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    if j.dtype == bool:
        np.testing.assert_array_equal(t, j)
        return
    if dtype == np.float64:
        np.testing.assert_allclose(t, j, rtol=rtol64, atol=0.0)
    else:
        scale = np.nanmax(np.abs(j[np.isfinite(j)]))
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["nd_lambda_r_mean", "nd_p_r_given_xD",
                                  "nd_mean_noise_entropy", "nd_utility",
                                  "utility"])
def test_acquisition_functions_match_jax(name, dtype):
    s2, mu = _moments(dtype)
    r = np.arange(100, dtype=dtype)
    T = {k: torch.as_tensor(v) for k, v in (("r", r), ("s2", s2), ("mu", mu))}
    J = {k: jnp.asarray(v) for k, v in (("r", r), ("s2", s2), ("mu", mu))}
    if name in ("nd_lambda_r_mean", "nd_p_r_given_xD"):
        t_out = getattr(ta, name)(T["r"], T["s2"], T["mu"])
        j_out = getattr(ja, name)(J["r"], J["s2"], J["mu"])
    elif name == "nd_mean_noise_entropy":
        tp = ta.nd_p_r_given_xD(T["r"], T["s2"], T["mu"])
        jp = ja.nd_p_r_given_xD(J["r"], J["s2"], J["mu"])
        t_out = [ta.nd_mean_noise_entropy(tp[0], tp[3], T["s2"], T["mu"])]
        j_out = [ja.nd_mean_noise_entropy(jp[0], jp[3], J["s2"], J["mu"])]
    elif name == "nd_utility":
        t_out = [ta.nd_utility(T["s2"], T["mu"])]
        j_out = [ja.nd_utility(J["s2"], J["mu"])]
    else:
        t_out = [torch.stack([ta.utility(T["s2"][i], T["mu"][i])
                              for i in (0, 5, 60, 63)])]
        j_out = [jnp.stack([ja.utility(J["s2"][i], J["mu"][i])
                            for i in (0, 5, 60, 63)])]
    for t, j in zip(t_out, j_out):
        assert t.dtype == T["s2"].dtype or t.dtype == torch.bool
        _close(t, j, dtype)


def test_float32_masks_more_than_float64():
    """The overflow mask is a property of the dtype: both sides mask the
    same (r, candidate) terms, and float32 masks many more."""
    masked = {}
    for dtype in (np.float64, np.float32):
        s2, mu = _moments(dtype)
        r = np.arange(100, dtype=dtype)
        _, t_mask = ta.nd_lambda_r_mean(torch.as_tensor(r),
                                        torch.as_tensor(s2),
                                        torch.as_tensor(mu))
        _, j_mask = ja.nd_lambda_r_mean(jnp.asarray(r), jnp.asarray(s2),
                                        jnp.asarray(mu))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
        masked[dtype] = int((~t_mask).sum())
    assert 0 < masked[np.float64] < masked[np.float32]


N, NT, NTILDE, NPOOL = 24, 96, 32, 40


@pytest.fixture(scope="module")
def fitted():
    """A JAX fit (non-shared inducing set) and a pool to score."""
    x, lam, rng = planted(N, NT, 3)
    r = rng.poisson(lam).astype(float)
    idx = rng.permutation(NT)[:NTILDE]
    pool, _, _ = planted(N, NPOOL, 4)
    res = jf.fit(jnp.asarray(x), jnp.asarray(r),
                 JCfg(ntilde=NTILDE, maxiter=2, n_estep=3, n_mstep=2,
                      n_fparamstep=3, n_px_side=N, crop_bucket=4,
                      **JAX_EXACT),
                 xtilde=jnp.asarray(x[idx]),
                 theta={k: jnp.float64(v) for k, v in THETA0.items()},
                 f_params={k: jnp.float64(v) for k, v in FP0.items()})
    assert not res.failed
    return res, pool


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("windowed", [False, True])
def test_score_candidates_matches_jax(fitted, backend, windowed):
    """The port's scorer on a converted JAX fit state, full frame and on
    the crop window of the fitted theta; backend "cuda" on a CPU tensor runs
    the kernel wrapper's plain forward through AcosGram."""
    res, pool = fitted
    st = convert.state_from_numpy(res)
    th = convert.theta_from_numpy({k: np.asarray(v)
                                   for k, v in res.theta.items()})
    fp = convert.f_params_from_numpy({k: np.asarray(v)
                                      for k, v in res.f_params.items()})
    win_t, win_j = {}, {}
    if windowed:
        i0, j0, w = crop_window_from_scalars(
            *(float(res.theta[k]) for k in ("-2log2beta", "eps_0x",
                                            "eps_0y")), N, bucket=4)
        assert w < N
        win_t = dict(win_i0=i0, win_j0=j0, win_w=w)
        win_j = dict(win_i0=jnp.asarray(i0, jnp.int32),
                     win_j0=jnp.asarray(j0, jnp.int32), win_w=w)
    j_u, j_best = ja.score_candidates(
        jnp.asarray(pool), res.xtilde, res.theta, res.f_params, res.m_b,
        res.V_b, res.B, res.k_tilde_inv_diag, n_px_side=N, **win_j)
    t_u, t_best = ta.score_candidates(
        torch.as_tensor(pool), st.xtilde, th, fp, st.m_b, st.V_b, st.B,
        st.k_tilde_inv_diag, n_px_side=N, backend=backend, **win_t)
    assert t_u.shape == (NPOOL,) and bool(torch.all(torch.isfinite(t_u)))
    np.testing.assert_allclose(t_u.numpy(), np.asarray(j_u), rtol=1e-8)
    assert int(t_best) == int(j_best)
