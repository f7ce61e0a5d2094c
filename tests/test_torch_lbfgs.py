"""The port's L-BFGS (optim/lbfgs.py, a transcription of optax's lbfgs with
the zoom line search) against the JAX package's ``lbfgs_minimize``, which
drives optax itself.  float64; iterates and values rtol 1e-8.

"Step by step": the best iterate after k steps is compared for a range of k.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.optim.lbfgs import lbfgs_minimize as j_lbfgs
from gaussian_processes_tpu_torch.optim.lbfgs import lbfgs_minimize as t_lbfgs

torch.set_num_threads(1)

X0 = np.array([-1.2, 1.0, -0.5, 0.8])


def rosen(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def compare(t_fun, j_fun, x0, steps, rtol=1e-8, **kw):
    xj, fj = j_lbfgs(j_fun, jnp.asarray(x0), steps, **kw)
    xt, ft = t_lbfgs(t_fun, torch.as_tensor(x0), steps, **kw)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=rtol,
                               atol=1e-12)
    # the value near a minimum is a difference of nearly equal terms:
    # an absolute floor as well
    np.testing.assert_allclose(float(ft), float(fj), rtol=rtol, atol=1e-12)
    return xt, ft


@pytest.mark.parametrize("steps", [1, 2, 3, 5, 8, 13, 21, 30])
def test_rosenbrock_iterates_match_optax(steps):
    compare(lambda x: rosen(x, torch), lambda x: rosen(x, jnp), X0, steps)


@pytest.mark.parametrize("gate", [{"gtol": 1e-2}, {"ftol": 1e-3},
                                  {"ftol_rel": 1e-3}])
def test_early_termination_gates_match(gate):
    compare(lambda x: rosen(x, torch), lambda x: rosen(x, jnp), X0, 40,
            **gate)


def _bounded(x, lib, upper=1.0):
    """Minimum at x = 3 outside the box x <= 1: +inf beyond the bound, the
    loss itself on the clipped point (the M-step's convention)."""
    xc = lib.minimum(x, lib.ones_like(x) * upper)
    loss = lib.sum((xc - 3.0) ** 2) + 0.1 * xc[0] * xc[1]
    return lib.where(lib.all(x <= upper), loss, float("inf"))


@pytest.mark.parametrize("steps", [1, 3, 6])
def test_plus_inf_bound_matches(steps):
    x0 = np.array([0.0, -0.5, 0.3])
    xt, ft = compare(lambda x: _bounded(x, torch), lambda x: _bounded(x, jnp),
                     x0, steps)
    assert torch.all(xt <= 1.0) and torch.isfinite(ft)


def _nan_beyond(x, lib):
    """Rosenbrock, NaN once x[0] passes -0.6: the iterate must freeze."""
    return lib.where(x[0] < -0.6, rosen(x, lib), float("nan"))


def test_nan_objective_freezes_like_jax():
    compare(lambda x: _nan_beyond(x, torch), lambda x: _nan_beyond(x, jnp),
            X0, 6)


def test_theta_mstep_objective_matches():
    """The 6-dim theta M-step objective at a small shape (JAX fit init
    state, handed to both packages), 3 L-BFGS steps of budget 15."""
    from gaussian_processes_tpu.config import FitConfig as JCfg
    from gaussian_processes_tpu.models import fit as jf
    from gaussian_processes_tpu.params import theta_bounds
    from gaussian_processes_tpu_torch.config import FitConfig as TCfg
    from gaussian_processes_tpu_torch.models import fit as tf
    from gaussian_processes_tpu_torch.ops.stabilize import Eigenspace

    N, nt, nti = 16, 48, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((nt, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.3 ** 2)).ravel()
    r = rng.poisson(np.exp(0.5 * x @ w / np.linalg.norm(w))).astype(float)
    xt = x[:nti]
    theta0 = {"sigma_0": 1.0, "eps_0x": 0.0, "eps_0y": 0.0,
              "-2log2beta": -2 * np.log(2 * 0.3),
              "-log2rho2": -np.log(2 * 0.15 ** 2), "Amp": 1.0}
    fp0 = {"logA": np.log(0.01), "lambda0": 1.0}
    jcfg = JCfg(ntilde=nti, maxiter=2, n_px_side=N, jit_whole_fit=False,
                reduced_rank=False, eigensolver="eigh", mstep_inverse="exact",
                mstep_logdet="chol", mstep_precision="highest")
    jth = {k: jnp.float64(v) for k, v in theta0.items()}
    carry = jf._fit_init(jnp.asarray(x), jnp.asarray(r), jnp.asarray(xt), jth,
                         {k: jnp.float64(v) for k, v in fp0.items()},
                         jnp.zeros(nti), jnp.zeros((nti, nti)), False, False,
                         jcfg)
    lower, upper = theta_bounds()
    j_obj = functools.partial(
        jf._mstep_objective, x=jnp.asarray(x), xtilde=jnp.asarray(xt),
        r=jnp.asarray(r), es=carry.kern.es, m_b=carry.m_b, V_b=carry.V_b,
        f_params=carry.f_params, shared=False, cfg=jcfg, lower=lower,
        upper=upper)
    xj, fj = j_lbfgs(j_obj, jth, 3, max_linesearch_steps=15)

    def t_(a):
        return torch.as_tensor(np.array(a))

    t_obj = functools.partial(
        tf._mstep_objective, x=t_(x), xtilde=t_(xt), r=t_(r),
        es=Eigenspace(*(t_(a) for a in carry.kern.es)), m_b=t_(carry.m_b),
        V_b=t_(carry.V_b),
        f_params={k: t_(v) for k, v in carry.f_params.items()}, shared=False,
        cfg=TCfg(ntilde=nti, n_px_side=N), lower=lower, upper=upper)
    xt_, ft = t_lbfgs(t_obj, {k: torch.tensor(v, dtype=torch.float64)
                              for k, v in theta0.items()}, 3,
                      max_linesearch_steps=15)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    for k in theta0:
        np.testing.assert_allclose(float(xt_[k]), float(xj[k]), rtol=1e-8,
                                   atol=1e-10, err_msg=k)
    assert float(ft) < float(j_obj(jth))
