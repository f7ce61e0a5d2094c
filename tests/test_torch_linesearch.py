"""The port's other inner line searches (optim/lbfgs.py: the speculative
search with its carried memory, zoom_carry and backtracking) against the
JAX package's, float64 on the same numpy inputs.

Optimizers: iterates and values rtol 1e-8 on Rosenbrock, a +inf bound, a
NaN freeze and the 6-dim theta M-step objective.  Fits: the single-cell
fit under each search against JAX's per-iteration fit with
test_torch_fit.py's exact knobs, the loss trajectory, theta, f-params and
B m_b rtol 1e-6.  Four EM iterations where the M-step's memory is carried,
so that two M-steps share it; a 16-rung speculative ladder, since from
this start the unscaled steepest-descent step and its first six halvings
all fail Armijo (as at the bench shape on the card, PERF.md).  The JAX fits are module-scoped (each compiles for
about 10 s).
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.optim import lbfgs as jl
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.optim import lbfgs as tl

from test_torch_fit import FP0, JAX_EXACT, STEPS, THETA0, planted
from test_torch_lbfgs import X0, _bounded, _nan_beyond

torch.set_num_threads(1)

SEARCHES = ("speculative", "zoom_carry", "backtracking")


def rosen(x, lib):
    """Rosenbrock over the last axis (a batch of points gives a batch of
    values)."""
    return lib.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                   + (1 - x[..., :-1]) ** 2, axis=-1)


def as_lib(x0, lib):
    """x0 (an array, or a dict of scalars) in lib's float64 arrays."""
    if isinstance(x0, dict):
        return {k: as_lib(v, lib) for k, v in x0.items()}
    if lib is jnp:
        return jnp.asarray(x0, dtype=jnp.float64)
    return torch.as_tensor(x0, dtype=torch.float64)


def run(search, lib, fun, x0, steps, **kw):
    """(x_best, f_best) of one search in one package (zoom_carry from a
    fresh state)."""
    mod = jl if lib is jnp else tl
    x0 = as_lib(x0, lib)
    if search == "speculative":
        return mod.lbfgs_minimize_speculative(fun, x0, steps, **kw)[:2]
    if search == "zoom_carry":
        return mod.lbfgs_minimize_zoom_carry(fun, x0, steps,
                                             mod.zoom_carry_init(x0),
                                             **kw)[:2]
    return mod.lbfgs_minimize_backtracking(fun, x0, steps, **kw)


def close(t, j, rtol=1e-8):
    # an absolute floor as well: a value near a minimum is a difference of
    # nearly equal terms
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-12)


def compare(search, t_fun, j_fun, x0, steps, **kw):
    xj, fj = run(search, jnp, j_fun, x0, steps, **kw)
    xt, ft = run(search, torch, t_fun, x0, steps, **kw)
    close(xt.numpy(), xj)
    close(float(ft), float(fj))
    return xt, ft


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("steps", [1, 3, 8, 20])
def test_rosenbrock_iterates_match_jax(search, steps):
    compare(search, lambda x: rosen(x, torch), lambda x: rosen(x, jnp), X0,
            steps)


@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("steps", [1, 3, 6])
def test_plus_inf_bound_matches(search, steps):
    x0 = np.array([0.0, -0.5, 0.3])
    xt, ft = compare(search, lambda x: _bounded(x, torch),
                     lambda x: _bounded(x, jnp), x0, steps)
    assert torch.all(xt <= 1.0) and torch.isfinite(ft)


@pytest.mark.parametrize("search", SEARCHES)
def test_nan_objective_freezes_like_jax(search):
    compare(search, lambda x: _nan_beyond(x, torch),
            lambda x: _nan_beyond(x, jnp), X0, 6)


def test_speculative_ladder_runs_and_memory_round_trips():
    """From X0 the unit step along -g overshoots, so the rejection ladder
    runs (one batched call, counted); the memory of a first call carries
    into a second, and both calls' iterates and memories equal JAX's.  The
    per-point loop (no ladder_fun) gives the same iterates."""
    calls = []

    def ladder(xs):
        calls.append(xs.shape[0])
        return rosen(xs, torch)

    t_fun, j_fun = (lambda x: rosen(x, torch)), (lambda x: rosen(x, jnp))
    xj, fj, mj = jl.lbfgs_minimize_speculative(j_fun, jnp.asarray(X0), 4)
    xt, ft, mt = tl.lbfgs_minimize_speculative(t_fun, torch.as_tensor(X0), 4,
                                               ladder_fun=ladder)
    assert calls and all(n == 10 for n in calls)
    close(xt.numpy(), xj)
    close(float(ft), float(fj))
    for a, b in zip(mt, mj):
        close(a.numpy(), b)
    assert int(mt[3].max()) >= 1
    xj2, fj2, mj2 = jl.lbfgs_minimize_speculative(j_fun, xj, 5, memory=mj)
    xt2, ft2, mt2 = tl.lbfgs_minimize_speculative(t_fun, xt, 5, memory=mt,
                                                  ladder_fun=ladder)
    close(xt2.numpy(), xj2)
    close(float(ft2), float(fj2))
    for a, b in zip(mt2, mj2):
        close(a.numpy(), b)
    # the caller's memory is not written into
    for a, b in zip(mt, mj):
        close(a.numpy(), b)
    xl, fl, ml = tl.lbfgs_minimize_speculative(t_fun, xt, 5, memory=mt)
    assert torch.equal(xl, xt2) and torch.equal(fl, ft2)


def test_zoom_carry_chained_calls_with_gates():
    """Two calls chained through the carried state, each with a gate on:
    the second starts from the first's memory (and the poisoned value)."""
    t_fun, j_fun = (lambda x: rosen(x, torch)), (lambda x: rosen(x, jnp))
    sj = jl.zoom_carry_init(jnp.asarray(X0))
    st = tl.zoom_carry_init(torch.as_tensor(X0))
    xj, fj, sj = jl.lbfgs_minimize_zoom_carry(j_fun, jnp.asarray(X0), 8, sj,
                                              ftol_rel=1e-3)
    xt, ft, st = tl.lbfgs_minimize_zoom_carry(t_fun, torch.as_tensor(X0), 8,
                                              st, ftol_rel=1e-3)
    close(xt.numpy(), xj)
    close(float(ft), float(fj))
    assert st.count == int(sj[0].count) > 0
    xj, fj, sj = jl.lbfgs_minimize_zoom_carry(j_fun, xj, 25, sj, gtol=1e-3)
    xt, ft, st = tl.lbfgs_minimize_zoom_carry(t_fun, xt, 25, st, gtol=1e-3)
    close(xt.numpy(), xj)
    close(float(ft), float(fj))
    assert st.count == int(sj[0].count)
    close(st.diff_params.numpy(), sj[0].diff_params_memory)


@pytest.fixture(scope="module")
def mstep_objective():
    """The 6-dim theta M-step objective of both packages at a small shape
    (JAX fit-init state handed to both), and its start theta."""
    from gaussian_processes_tpu.params import theta_bounds
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
    jcfg = JCfg(ntilde=nti, maxiter=2, n_px_side=N, **JAX_EXACT)
    jth = {k: jnp.float64(v) for k, v in theta0.items()}
    carry = jf._fit_init(jnp.asarray(x), jnp.asarray(r), jnp.asarray(xt), jth,
                         {k: jnp.float64(v) for k, v in FP0.items()},
                         jnp.zeros(nti), jnp.zeros((nti, nti)), False, False,
                         jcfg)
    lower, upper = theta_bounds()
    j_obj = functools.partial(
        jf._mstep_objective, x=jnp.asarray(x), xtilde=jnp.asarray(xt),
        r=jnp.asarray(r), es=carry.kern.es, m_b=carry.m_b, V_b=carry.V_b,
        f_params=carry.f_params, shared=False, cfg=jcfg, lower=lower,
        upper=upper)

    def t_(a):
        return torch.as_tensor(np.array(a))

    t_obj = functools.partial(
        tf._mstep_objective, x=t_(x), xtilde=t_(xt), r=t_(r),
        es=Eigenspace(*(t_(a) for a in carry.kern.es)), m_b=t_(carry.m_b),
        V_b=t_(carry.V_b),
        f_params={k: t_(v) for k, v in carry.f_params.items()}, shared=False,
        cfg=TCfg(ntilde=nti, n_px_side=N), lower=lower, upper=upper)
    return t_obj, j_obj, theta0


@pytest.mark.parametrize("search", SEARCHES)
def test_theta_mstep_objective_matches(mstep_objective, search):
    """3 steps on the M-step objective (the speculative search's first
    step is rejected there, and its ladder finds a rung)."""
    t_obj, j_obj, theta0 = mstep_objective
    xj, fj = run(search, jnp, j_obj, theta0, 3)
    xt, ft = run(search, torch, t_obj, theta0, 3)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    for k in theta0:
        np.testing.assert_allclose(float(xt[k]), float(xj[k]), rtol=1e-8,
                                   atol=1e-10, err_msg=k)
    assert float(ft) < float(j_obj(as_lib(theta0, jnp)))


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

N, NT, NTILDE = 24, 256, 64
SPEC = dict(linesearch="speculative", armijo_trials=16, maxiter=4)
# the reduced-rank case of test_torch_reduced.py whose budget moves (a
# smooth prior keeps about 55 of 128, rank bucket 4)
REDUCED = dict(ntilde=128, theta={"-log2rho2": -np.log(2 * 0.3 ** 2)},
               steps=dict(SPEC, maxiter=5, rank_bucket=4, crop_window=False,
                          reduced_rank=True))
FITS = {
    "speculative": dict(steps=SPEC),
    "speculative_no_memory": dict(steps=dict(SPEC, mstep_memory=False)),
    "zoom_carry": dict(steps=dict(linesearch="zoom_carry", maxiter=4)),
    "backtracking": dict(steps=dict(linesearch="backtracking")),
    "speculative_reduced": REDUCED,
}


@pytest.fixture(scope="module")
def problem():
    x, lam, rng = planted(N, NT, 0)
    r = rng.poisson(lam).astype(float)
    return dict(x=x, r=r, idx=rng.permutation(NT)[:128])


@pytest.fixture(scope="module")
def fits(problem):
    """Each case's JAX and port fits, run once; the port's M-step ladder
    calls and their items are counted."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        c = FITS[case]
        nti = c.get("ntilde", NTILDE)
        steps = dict(STEPS, **c["steps"])
        theta = dict(THETA0, **c.get("theta", {}))
        x, r, idx = problem["x"], problem["r"], problem["idx"][:nti]
        jr = jf.fit(jnp.asarray(x), jnp.asarray(r),
                    JCfg(ntilde=nti, **dict(JAX_EXACT, **steps)),
                    xtilde=jnp.asarray(x[idx]),
                    theta={k: jnp.float64(v) for k, v in theta.items()},
                    f_params={k: jnp.float64(v) for k, v in FP0.items()})
        ladders = []
        real = tf._mstep_objective_cells

        def counted(theta, *args, **kwargs):
            ladders.append(theta["Amp"].numel())
            return real(theta, *args, **kwargs)

        tf._mstep_objective_cells = counted
        try:
            xt = torch.as_tensor(x)
            tr = tf.fit(xt, torch.as_tensor(r), TCfg(ntilde=nti, **steps),
                        xtilde=xt[torch.as_tensor(idx)], theta=theta,
                        f_params=FP0)
        finally:
            tf._mstep_objective_cells = real
        cache[case] = (jr, tr, ladders)
        return cache[case]
    return get


def close6(t, j, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=1e-6, atol=atol)


@pytest.mark.parametrize("case", list(FITS))
def test_fit_matches_jax(fits, case):
    jr, tr, ladders = fits(case)
    assert not tr.failed and not jr.failed
    for name in ("logmarginal", "loglikelihood", "KL"):
        close6(getattr(tr.track, name), getattr(jr.track, name))
    np.testing.assert_array_equal(tr.track.n_eigen.numpy(),
                                  np.asarray(jr.track.n_eigen))
    for k in THETA0:
        close6(tr.theta[k], jr.theta[k], atol=1e-9)
    for k in FP0:
        close6(tr.f_params[k], jr.f_params[k])
    jBm = np.asarray(jr.B @ jr.m_b)
    close6(tr.B @ tr.m_b, jBm, atol=1e-6 * np.abs(jBm).max())
    loss = tr.track.logmarginal.numpy()
    assert loss[-1] > loss[0]
    if FITS[case]["steps"].get("linesearch") == "speculative":
        # the ladder ran, as one call over its 16 trials
        assert ladders and set(ladders) == {16}
    else:
        assert not ladders


def test_carried_memory_changes_the_speculative_fit(fits):
    """With the memory carried, the second M-step starts from the first's
    curvature and takes another path than a cold start."""
    _, mem, _ = fits("speculative")
    _, cold, _ = fits("speculative_no_memory")
    a, b = mem.track.logmarginal.numpy(), cold.track.logmarginal.numpy()
    np.testing.assert_array_equal(a[:3], b[:3])
    assert abs(a[3] - b[3]) > 1e-6 * abs(b[3])


def test_reduced_speculative_fit_runs_below_ntilde(fits):
    """The reduced case slices the carry to its budgets with the memory in
    it (``_slice_carry`` leaves ``mem`` alone)."""
    _, tr, _ = fits("speculative_reduced")
    assert max(tr.track.n_eigen.tolist()) < 128
    assert tr.m_b.shape[0] < 128
