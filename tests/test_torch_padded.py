"""Pad-and-mask fits and the init_kernel warm start of the port, against the
JAX package and against the port's own unpadded fit, float64, on the same
numpy inputs (tests/test_active.py's pool).

Tolerances: the loss trajectory rtol 1e-6 (the fit's parity gate), the kept
rank exactly; the padded-vs-unpadded theta rtol 1e-4 / atol 1e-6 as in the
JAX package's own test_padded_fit_matches_unpadded.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf

from test_active import FP0, N, THETA0, make_pool
from test_torch_fit import JAX_EXACT

torch.set_num_threads(1)

STEPS = dict(maxiter=4, n_estep=3, n_mstep=3, n_fparamstep=4, n_px_side=N)
NA, CAP = 25, 40


def jcfg(ntilde, **kw):
    return JCfg(ntilde=ntilde, **{**JAX_EXACT, **STEPS, **kw})


def tcfg(ntilde, **kw):
    return TCfg(ntilde=ntilde, **{**STEPS, **kw})


def jstart():
    return dict(theta={k: jnp.float64(v) for k, v in THETA0.items()},
                f_params={k: jnp.float64(v) for k, v in FP0.items()})


def tstart():
    return dict(theta=THETA0, f_params=FP0)


def close(t, j, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol)


@pytest.fixture(scope="module")
def buffers():
    X, R, _, _ = make_pool()
    x_buf = np.zeros((CAP, N * N))
    x_buf[:NA] = X[:NA]
    r_buf = np.zeros(CAP)
    r_buf[:NA] = R[:NA]
    mask = (np.arange(CAP) < NA).astype(float)
    return X, R, x_buf, r_buf, mask


@pytest.fixture(scope="module")
def port_padded(buffers):
    _, _, x_buf, r_buf, mask = buffers
    xb = torch.as_tensor(x_buf)
    return tf.fit(xb, torch.as_tensor(r_buf), tcfg(CAP), xtilde=xb,
                  sample_weight=torch.as_tensor(mask), **tstart())


@pytest.mark.parametrize("window", [False, True])
def test_padded_fit_matches_jax(buffers, port_padded, window):
    """Shared inducing set at a fixed capacity: one mask for both.  The
    window case starts from a narrow RF (beta 0.1) with a crop bucket of 4,
    so the Grams and the M-step's pre-cropped Grams run on a 12 px window."""
    _, _, x_buf, r_buf, mask = buffers
    xb = jnp.asarray(x_buf)
    kw, theta = {}, dict(THETA0)
    if window:
        kw = dict(crop_bucket=4)
        theta["-2log2beta"] = -2 * np.log(2 * 0.1)
    jr = jf.fit(xb, jnp.asarray(r_buf), jcfg(CAP, **kw), xtilde=xb,
                sample_weight=jnp.asarray(mask),
                theta={k: jnp.float64(v) for k, v in theta.items()},
                f_params={k: jnp.float64(v) for k, v in FP0.items()})
    tr = port_padded
    if window:
        xt = torch.as_tensor(x_buf)
        tr = tf.fit(xt, torch.as_tensor(r_buf), tcfg(CAP, **kw), xtilde=xt,
                    sample_weight=torch.as_tensor(mask), theta=theta,
                    f_params=FP0)
    assert not tr.failed and not jr.failed
    assert tr.K is tr.K_tilde
    for name in ("logmarginal", "loglikelihood", "KL"):
        close(getattr(tr.track, name), getattr(jr.track, name))
    np.testing.assert_array_equal(tr.track.n_eigen.numpy(),
                                  np.asarray(jr.track.n_eigen))
    for k in THETA0:
        np.testing.assert_allclose(float(tr.theta[k]), float(jr.theta[k]),
                                   rtol=1e-6, atol=1e-9)


def test_padded_fit_matches_unpadded(buffers, port_padded):
    """The JAX package's test_padded_fit_matches_unpadded on the port: the
    fit on NA active points inside a capacity-CAP buffer gives the fit on
    the NA points alone."""
    X, R, _, _, _ = buffers
    xa = torch.as_tensor(X[:NA])
    ta = tf.fit(xa, torch.as_tensor(R[:NA]), tcfg(NA), xtilde=xa,
                **tstart())
    tb = port_padded
    assert not ta.failed and not tb.failed
    assert int(ta.keep.sum()) == int(tb.keep.sum())
    np.testing.assert_array_equal(ta.track.n_eigen.numpy(),
                                  tb.track.n_eigen.numpy())
    close(tb.track.logmarginal, ta.track.logmarginal)
    for k in THETA0:
        np.testing.assert_allclose(float(tb.theta[k]), float(ta.theta[k]),
                                   rtol=1e-4, atol=1e-6)


def test_inducing_weight_on_a_separate_set_matches_jax(buffers):
    """A non-shared inducing buffer with padded rows: inducing_weight masks
    them out of K_tilde and K, every training point stays in."""
    X, R, _, _, _ = buffers
    nt, ni, cap_i = 40, 12, 16
    xt_buf = np.zeros((cap_i, N * N))
    xt_buf[:ni] = X[nt:nt + ni]
    wi = (np.arange(cap_i) < ni).astype(float)
    jr = jf.fit(jnp.asarray(X[:nt]), jnp.asarray(R[:nt]), jcfg(cap_i),
                xtilde=jnp.asarray(xt_buf), inducing_weight=jnp.asarray(wi),
                **jstart())
    tr = tf.fit(torch.as_tensor(X[:nt]), torch.as_tensor(R[:nt]),
                tcfg(cap_i), xtilde=torch.as_tensor(xt_buf),
                inducing_weight=torch.as_tensor(wi), **tstart())
    assert not tr.failed and not jr.failed
    assert tr.K is not tr.K_tilde
    assert bool(torch.all(tr.K_tilde[ni:] == 0))
    assert bool(torch.all(tr.K[:, ni:] == 0))
    close(tr.track.logmarginal, jr.track.logmarginal)
    np.testing.assert_array_equal(tr.track.n_eigen.numpy(),
                                  np.asarray(jr.track.n_eigen))
    assert int(tr.keep.sum()) <= ni


def test_init_kernel_matches_jax(buffers, port_padded):
    """A second padded fit warm-started from the first one's theta,
    f-params, posterior and kernel state (init_kernel skips the initial
    Gram + eigh), on both sides; and init_kernel at the theta it was built
    at changes nothing."""
    _, _, x_buf, r_buf, mask = buffers
    xb = jnp.asarray(x_buf)
    j1 = jf.fit(xb, jnp.asarray(r_buf), jcfg(CAP), xtilde=xb,
                sample_weight=jnp.asarray(mask), **jstart())
    j2 = jf.fit(xb, jnp.asarray(r_buf), jcfg(CAP, maxiter=3), xtilde=xb,
                theta=j1.theta, f_params=j1.f_params,
                sample_weight=jnp.asarray(mask), init_kernel=j1.kernel_state)
    t1 = port_padded
    xt = torch.as_tensor(x_buf)
    kw = dict(xtilde=xt, theta=t1.theta, f_params=t1.f_params,
              sample_weight=torch.as_tensor(mask))
    t2 = tf.fit(xt, torch.as_tensor(r_buf), tcfg(CAP, maxiter=3),
                init_kernel=t1.kernel_state, **kw)
    assert not t2.failed and not j2.failed
    close(t2.track.logmarginal, j2.track.logmarginal)
    for k in THETA0:
        np.testing.assert_allclose(float(t2.theta[k]), float(j2.theta[k]),
                                   rtol=1e-6, atol=1e-9)
    cold = tf.fit(xt, torch.as_tensor(r_buf), tcfg(CAP, maxiter=3), **kw)
    close(t2.track.logmarginal, cold.track.logmarginal, rtol=1e-10)
