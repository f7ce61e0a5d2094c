"""The JAX package's regression tests, ported: the reference's documented
failure regimes (Spatial_GP_repo/ToDo.md:14-29; ``tests/test_robustness.py``)
and their fast-gate representatives with the checkpoint round trip and
the M-step gradient against finite differences
(``tests/test_fast_regressions.py``), each through the port's entry
points at the JAX test's shapes, float64 on the CPU.

Where the JAX test compares values (the unsorted inducing rows against
the sorted ones; the M-step gradient against finite differences) the JAX
package's own fit or objective stands beside the port's, under the same
solver knobs (the port's defaults are JAX's exact forms: ``JAX_EXACT``):
the trajectories within 1e-6 relative (two summation orders through five
EM iterations), the objective's value 1e-10 and gradient 1e-8.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu.ops import stabilize as js
from gaussian_processes_tpu.params import theta_bounds as jbounds
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.models.inference import evaluate
from gaussian_processes_tpu_torch.ops.stabilize import Eigenspace
from gaussian_processes_tpu_torch.params import THETA_KEYS, theta_bounds
from gaussian_processes_tpu_torch.utils.io import load_model, save_model

from test_torch_fit import JAX_EXACT

torch.set_num_threads(1)

FP0 = {"logA": np.log(0.01), "lambda0": 1.0}
TRACK_RTOL = 1e-6
RTOL = 1e-10
GRAD_RTOL = 1e-8


def _theta(beta=0.3, rho=0.15, eps=(0.0, 0.0)):
    return {"sigma_0": 1.0, "eps_0x": eps[0], "eps_0y": eps[1],
            "-2log2beta": -2 * np.log(2 * beta),
            "-log2rho2": -np.log(2 * rho ** 2), "Amp": 1.0}


def _planted(n_px, nt, seed=3, gain=0.7, center=(0.1, -0.2), width=0.3):
    """The JAX tests' data: white-noise images and Poisson counts of a
    planted Gaussian RF (``_data`` in both JAX files)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nt, n_px * n_px))
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - center[0]) ** 2 + (yy - center[1]) ** 2)
               / (2 * width ** 2)).ravel()
    w = w / np.linalg.norm(w)
    r = rng.poisson(np.exp(gain * x @ w)).astype(float)
    return x, r, rng


def _fit(x, r, cfg, xtilde, theta=None, f_params=FP0):
    tx = torch.as_tensor(x)
    return tf.fit(tx, torch.as_tensor(r), cfg,
                  xtilde=tx if xtilde is x else torch.as_tensor(xtilde),
                  theta=theta, f_params=f_params)


def _assert_clean(res):
    """A fit is clean when it completed with a finite trajectory or failed
    through the rollback (failed, with a finite last good state up to
    failed_at): a silent NaN in the returned state is the bug."""
    loss = res.track.logmarginal.numpy()
    if res.failed:
        assert res.failed_at >= 0
        assert np.all(np.isfinite(loss[:max(res.failed_at, 1)]))
    else:
        assert np.all(np.isfinite(loss)), "clean fit tracked NaN loss"
    for k, v in res.theta.items():
        assert np.isfinite(float(v)), f"returned theta[{k}] is non-finite"
    assert bool(torch.isfinite(res.m_b).all())
    assert bool(torch.isfinite(res.V_b).all())


def _in_bounds(res):
    for k in ("eps_0x", "eps_0y"):
        v = float(res.theta[k])
        assert res.theta_lower[k] <= v <= res.theta_upper[k], (
            f"{k}={v} escaped its bounds")
        tr = res.track.theta[k].numpy()
        assert np.all(tr >= res.theta_lower[k] - 1e-12)
        assert np.all(tr <= res.theta_upper[k] + 1e-12)


# ---------------------------------------------------------------------------
# tests/test_robustness.py: 16 px, nt 120, five EM iterations
# ---------------------------------------------------------------------------

N = 16
STEPS = dict(maxiter=5, n_estep=4, n_mstep=3, n_fparamstep=4, n_px_side=N)


def test_unsorted_xtilde_indices_stable():
    """ToDo.md:14: unsorted inducing indices NaN'd the reference's f-param
    update.  The fit is clean, its trajectory the sorted set's (the
    posterior does not depend on the inducing rows' order), and JAX's fit
    on the unsorted rows."""
    x, r, rng = _planted(N, 120)
    perm = rng.permutation(x.shape[0])[:64]
    assert not np.all(np.diff(perm) > 0)
    cfg = TCfg(ntilde=64, **STEPS)
    unsorted = _fit(x, r, cfg, x[perm], _theta())
    _assert_clean(unsorted)
    assert not unsorted.failed
    ordered = _fit(x, r, cfg, x[np.sort(perm)], _theta())
    np.testing.assert_allclose(unsorted.track.logmarginal.numpy(),
                               ordered.track.logmarginal.numpy(), rtol=1e-8)
    jres = jf.fit(jnp.asarray(x), jnp.asarray(r),
                  JCfg(ntilde=64, **STEPS, **JAX_EXACT),
                  xtilde=jnp.asarray(x[perm]),
                  theta={k: jnp.float64(v) for k, v in _theta().items()},
                  f_params={k: jnp.float64(v) for k, v in FP0.items()})
    np.testing.assert_allclose(unsorted.track.logmarginal.numpy(),
                               np.asarray(jres.track.logmarginal),
                               rtol=TRACK_RTOL)


def test_duplicated_xtilde_rows_stable():
    """Duplicated inducing rows make K_tilde exactly singular: the
    eigenvalue truncation drops the collapsed directions (the reference
    adds 1e-15 jitter instead, utils.py:705-711)."""
    x, r, _ = _planted(N, 120)
    idx = np.concatenate([np.arange(48), np.arange(16)])
    res = _fit(x, r, TCfg(ntilde=64, **STEPS), x[idx], _theta())
    _assert_clean(res)
    assert not res.failed
    assert int(res.track.n_eigen[-1]) <= 48


def test_weak_rf_cell_no_nan_r2():
    """ToDo.md:20: NaN r2 on weakly driven cells.  Spikes independent of
    the stimulus fit cleanly from the STA start and give a finite r2."""
    rng = np.random.default_rng(7)
    nt = 120
    x = rng.standard_normal((nt, N * N))
    r = rng.poisson(1.0, nt).astype(float)
    res = _fit(x, r, TCfg(ntilde=nt, **STEPS), x, f_params=None)
    _assert_clean(res)
    xt = rng.standard_normal((12, N * N))
    R_test = rng.poisson(1.0, (20, 12)).astype(float)
    _, rates, r2, s2 = evaluate(res, torch.as_tensor(xt),
                                torch.as_tensor(R_test), nbootstrap=100)
    assert bool(torch.isfinite(rates).all())
    assert np.isfinite(float(r2)) and np.isfinite(float(s2))


def test_rf_at_border_bounds_enforced():
    """ToDo.md:29: an RF drifting to the border destabilized the
    reference's M-step until its inf-loss-at-bounds rule.  Starting at the
    corner of the eps box with the planted RF at the border, the fit stays
    clean and every tracked iterate stays inside the bounds."""
    x, r, _ = _planted(N, 120, center=(0.95, 0.95), width=0.25, gain=0.8)
    res = _fit(x, r, TCfg(ntilde=x.shape[0], **STEPS), x,
               _theta(eps=(0.93, 0.93)))
    _assert_clean(res)
    assert not res.failed
    _in_bounds(res)


# ---------------------------------------------------------------------------
# tests/test_fast_regressions.py: 10 px, nt 40, ntilde 32
# ---------------------------------------------------------------------------

FAST = TCfg(ntilde=32, maxiter=3, n_estep=2, n_mstep=3, n_fparamstep=2,
            n_px_side=10)


def test_duplicated_xtilde_rows_stable_fast():
    x, r, _ = _planted(10, 40)
    idx = np.concatenate([np.arange(24), np.arange(8)])
    res = _fit(x, r, FAST, x[idx], _theta())
    _assert_clean(res)
    assert not res.failed
    assert int(res.track.n_eigen[-1]) <= 24


def test_rf_at_border_bounds_enforced_fast(tmp_path):
    """The border regime at the fast shape, and the checkpoint round trip
    of the fitted model."""
    x, r, _ = _planted(10, 40, center=(0.9, 0.9), width=0.3, gain=0.8)
    res = _fit(x, r, FAST, x[:32], _theta(eps=(0.9, 0.9)))
    _assert_clean(res)
    assert not res.failed
    _in_bounds(res)
    d = str(tmp_path / "model_dir")
    save_model(res, d, additional_description="fast roundtrip")
    loaded = load_model(d, device="cpu")
    np.testing.assert_allclose(loaded.m_b.numpy(), res.m_b.numpy())
    for k in THETA_KEYS:
        assert float(loaded.theta[k]) == pytest.approx(float(res.theta[k]))


def test_mstep_objective_finite_difference_fast():
    """Central finite differences referee the M-step objective's autograd
    gradient (rtol 5e-5, atol 1e-7, as the JAX test), and the JAX
    package's objective and ``jax.grad`` stand beside it at the same
    point."""
    rng = np.random.default_rng(7)
    nt, ntilde, n = 10, 6, 8
    x = rng.standard_normal((nt, n * n))
    r = rng.poisson(2.0, nt).astype(float)
    theta = {"sigma_0": 1.1, "eps_0x": 0.15, "eps_0y": -0.1,
             "-2log2beta": -2 * np.log(2 * 0.4),
             "-log2rho2": -np.log(2 * 0.18 ** 2), "Amp": 0.9}
    f_params = {"logA": np.log(0.05), "lambda0": 0.3}
    jx = jnp.asarray(x)
    jtheta = {k: jnp.float64(v) for k, v in theta.items()}
    K_tilde, _, _ = jk.gram_matrices(jtheta, jx, jx[:ntilde], n,
                                     shared=False)
    jes = js.compute_eigenspace(K_tilde)
    keep = np.asarray(jes.keep)
    m_b = np.linspace(-0.5, 0.5, ntilde) * keep
    V_b = np.diag(np.asarray(jes.k_tilde_b_diag)) * 0.9

    tx = torch.as_tensor(x)
    es = Eigenspace(*(torch.as_tensor(np.array(a)) for a in jes))
    cfg = TCfg(ntilde=ntilde, n_px_side=n)
    lower, upper = theta_bounds()

    def obj(th):
        return tf._mstep_objective(
            th, tx, tx[:ntilde], torch.as_tensor(r), es, torch.as_tensor(m_b),
            torch.as_tensor(V_b),
            {k: torch.tensor(v, dtype=torch.float64)
             for k, v in f_params.items()}, False, cfg, lower, upper)

    def at(th):
        return {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
                for k, v in th.items()}
    leaf = at(theta)
    value = obj(leaf)
    grads = torch.autograd.grad(value, [leaf[k] for k in THETA_KEYS])
    eps_fd = 1e-6
    with torch.no_grad():
        for k, g in zip(THETA_KEYS, grads):
            fd = (float(obj(at(dict(theta, **{k: theta[k] + eps_fd}))))
                  - float(obj(at(dict(theta, **{k: theta[k] - eps_fd}))))
                  ) / (2 * eps_fd)
            np.testing.assert_allclose(float(g), fd, rtol=5e-5, atol=1e-7,
                                       err_msg=k)

    jcfg = JCfg(ntilde=ntilde, n_px_side=n, **JAX_EXACT)
    jlower, jupper = jbounds()

    @jax.jit
    def jobj(th):
        return jf._mstep_objective(
            th, jx, jx[:ntilde], jnp.asarray(r), jes, jnp.asarray(m_b),
            jnp.asarray(V_b), {k: jnp.float64(v) for k, v in f_params.items()},
            False, jcfg, jlower, jupper)
    np.testing.assert_allclose(float(value.detach()), float(jobj(jtheta)),
                               rtol=RTOL)
    jg = jax.jit(jax.grad(jobj))(jtheta)
    want = np.array([float(jg[k]) for k in THETA_KEYS])
    np.testing.assert_allclose([float(g) for g in grads], want,
                               rtol=GRAD_RTOL,
                               atol=1e-12 * np.abs(want).max())
