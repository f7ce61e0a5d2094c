"""The fit under the JAX package's warm solvers and the projected M-step
Gram, against the JAX package's per-iteration fit with the same knobs,
float64, on test_torch_fit.py's problem (24 px, nt 256, ntilde 64) with a
smooth prior (rho 0.5), whose kept rank (30) leaves the reduced budget
(48) below ntilde; and the population under them, lane by lane.

The cases: (a) the subspace eigensolver at the reduced budget with a
refresh every second iteration, Newton-Schulz for the E-step's and the
M-step's inverses and the trace-series log-determinant (the JAX defaults);
(b) (a) with the projected Gram at a pinned rank; (c) the projected Gram
alone, its rank sized from the start theta.  JAX decides its fallbacks in
the graph and the port on the host, and the port's Newton-Schulz runs its
fixed steps; both land on the same iterates to rounding.  Tolerances: the
log-marginal trajectory rtol 1e-6, theta atol 1e-9, kept ranks equal; the
population's tracks rtol 1e-8 (test_torch_population.py's).

Also here: the new knobs' defaults, validation messages and conversion,
``_vmap_safe_config``, ``used_warm_basis`` and ``state_at_iteration``'s
guard.  The JAX fits are module-scoped (each compiles for ~10 s).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.parallel import population as jpop
from gaussian_processes_tpu.utils import io as jio
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.models import inference as ti
from gaussian_processes_tpu_torch.parallel import population as tpop
from gaussian_processes_tpu_torch.utils import io as tio
from gaussian_processes_tpu_torch.utils.tracing import decisions

from test_torch_fit import FP0, JAX_EXACT, THETA0, planted
from test_torch_population import STEPS_W, windowed_problem

torch.set_num_threads(1)

N, NT, NTILDE = 24, 256, 64
THETA = dict(THETA0, **{"-log2rho2": -np.log(2 * 0.5 ** 2)})
STEPS = dict(maxiter=4, n_estep=3, n_mstep=3, n_fparamstep=3, n_px_side=N,
             crop_bucket=4)
WARM = dict(reduced_rank=True, eigensolver="subspace", eigh_refresh_every=2,
            estep_solver="schulz", mstep_inverse="schulz",
            mstep_logdet="series", rank_bucket=8, rank_pad=4)
CASES = {
    "warm": WARM,
    "warm_projected": dict(WARM, mstep_gram="projected", mstep_proj_rank=16),
    "projected": dict(mstep_gram="projected"),
}

# FitConfig() at the parent of this slice: every field keeps its value
PREVIOUS_DEFAULTS = {
    "ntilde": None, "maxiter": 50, "n_estep": 50, "n_mstep": 20,
    "n_fparamstep": 10, "n_px_side": 108, "cellid": 0, "eigval_tol": 1e-4,
    "alpha_threshold": 1e-3, "track_variational": True, "track_basis": False,
    "reduced_rank": False, "rank_slack": 1.25, "rank_pad": 16,
    "rank_bucket": 64, "crop_window": True, "crop_margin": 1.25,
    "crop_bucket": 16, "max_linesearch_steps": 15, "linesearch": "zoom",
    "mstep_memory": True, "armijo_trials": 6, "mstep_gtol": 0.0,
    "mstep_ftol": 0.0, "mstep_ftol_rel": 0.0, "estep_tol": 0.0}
SOLVER_KNOBS = ("eigensolver", "subspace_power_steps", "eigh_refresh_every",
                "estep_solver", "mstep_inverse", "schulz_steps",
                "schulz_fallback", "mstep_logdet", "mstep_gram",
                "mstep_proj_rank", "mstep_proj_tol", "mstep_proj_fallback")


@pytest.fixture(scope="module")
def data():
    x, lam, rng = planted(N, NT, 0)
    r = rng.poisson(lam).astype(float)
    idx = rng.permutation(NT)[:NTILDE]
    return dict(x=x, r=r, idx=idx)


def port_fit(d, **knobs):
    x = torch.as_tensor(d["x"])
    return tf.fit(x, torch.as_tensor(d["r"]),
                  TCfg(ntilde=NTILDE, **STEPS, **knobs),
                  xtilde=x[torch.as_tensor(d["idx"])], theta=THETA,
                  f_params=FP0, profile=True)


def jax_fit(d, **knobs):
    return jf.fit(jnp.asarray(d["x"]), jnp.asarray(d["r"]),
                  JCfg(ntilde=NTILDE, **STEPS, **dict(JAX_EXACT, **knobs)),
                  xtilde=jnp.asarray(d["x"][d["idx"]]),
                  theta={k: jnp.float64(v) for k, v in THETA.items()},
                  f_params={k: jnp.float64(v) for k, v in FP0.items()})


@pytest.fixture(scope="module")
def fits(data):
    """Each case's JAX and port fits, run once; the port's with its host
    decisions counted."""
    cache = {}

    def get(case):
        if case not in cache:
            decisions.clear()
            port = port_fit(data, **CASES[case])
            cache[case] = (jax_fit(data, **CASES[case]), port,
                           dict(decisions))
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax(fits, case):
    jr, tr, _ = fits(case)
    assert not jr.failed and not tr.failed
    np.testing.assert_allclose(tr.track.logmarginal.numpy(),
                               np.asarray(jr.track.logmarginal), rtol=1e-6)
    np.testing.assert_array_equal(tr.track.n_eigen.numpy(),
                                  np.asarray(jr.track.n_eigen))
    for k in THETA:
        np.testing.assert_allclose(float(tr.theta[k]), float(jr.theta[k]),
                                   rtol=0, atol=1e-9, err_msg=k)
    assert tr.m_b.shape == jr.m_b.shape


def test_warm_fit_runs_the_warm_route_and_its_refresh(fits):
    """The budget (48) sits below ntilde from iteration 1, so every
    iteration's kernel rebuild is warm except the refresh at i = 2; the
    warm solvers decided on the host, and no warm solve failed."""
    jr, tr, dec = fits("warm")
    assert tr.timing["rank"] == [48, 48, 48]
    assert tr.timing["eigensolver"] == ["warm", "refresh", "warm"]
    assert dec["eigensolver.warm"] == 2 and dec["eigensolver.refresh"] == 1
    assert dec["eigensolver.fallback"] == 0
    assert dec["estep.schulz"] > 0 and dec["mstep.schulz"] > 0
    assert dec["mstep.series"] > 0
    assert tr.used_warm_basis and jr.used_warm_basis


def test_projected_fit_sizes_its_rank_and_passes_its_guard(fits):
    jr, tr, dec = fits("projected")
    assert tr.config.mstep_proj_rank == jr.config.mstep_proj_rank
    assert dec["mstep.projected"] > 0 and not tr.used_warm_basis
    _, tr_pinned, dec_pinned = fits("warm_projected")
    assert tr_pinned.config.mstep_proj_rank == 16
    assert dec_pinned["mstep.projected"] > 0


def test_state_at_iteration_needs_the_tracked_basis_after_a_warm_fit(fits,
                                                                     data):
    _, tr, _ = fits("warm")
    with pytest.raises(ValueError, match="track_basis"):
        ti.state_at_iteration(tr, 1)
    tracked = port_fit(data, **WARM, track_basis=True)
    assert tracked.used_warm_basis
    np.testing.assert_array_equal(tracked.track.logmarginal.numpy(),
                                  tr.track.logmarginal.numpy())
    theta, _, m_b, _, es = ti.state_at_iteration(tracked, 1)
    assert bool(torch.isfinite(m_b).all()) and int(es.keep.sum()) > 0


@pytest.mark.parametrize("rank,fallback", [(12, "exact"), (4, "exact"),
                                           (4, "poison")])
def test_projected_mstep_ladder_equals_the_loop(data, rank, fallback):
    """The single-cell ladder (the speculative and Armijo searches' batched
    evaluator) under the projected Gram, the warm inverse and the series,
    against the M-step objective trial by trial on the start window: rank
    12 projects within tolerance, rank 4 falls back to the exact Gram or
    poisons every in-bounds trial (+inf) in both."""
    from gaussian_processes_tpu_torch.ops.kernels import (
        crop_window_for_theta, smooth_projection_basis)
    from gaussian_processes_tpu_torch.params import theta_bounds
    x = torch.as_tensor(data["x"])
    xtilde = x[torch.as_tensor(data["idx"])]
    r = torch.as_tensor(data["r"])
    cfg = TCfg(ntilde=NTILDE, **STEPS, mstep_gram="projected",
               mstep_proj_rank=rank, mstep_proj_fallback=fallback,
               mstep_inverse="schulz", mstep_logdet="series")
    theta = {k: torch.tensor(v, dtype=torch.float64) for k, v in THETA.items()}
    fp = {k: torch.tensor(v, dtype=torch.float64) for k, v in FP0.items()}
    win = crop_window_for_theta(theta, N, cfg.alpha_threshold,
                                cfg.crop_margin, cfg.crop_bucket)
    assert win[2] < N
    c = tf._fit_init(x, r, xtilde, theta, fp,
                     torch.zeros(NTILDE, dtype=torch.float64), None, False,
                     False, cfg, win)
    xc = tf.crop_images(x, *win, N)
    xtc = tf.crop_images(xtilde, *win, N)
    E = smooth_projection_basis(theta, win[2], N, rank, dtype=torch.float64)
    lower, upper = theta_bounds()
    args = dict(x=x, xtilde=xtilde, r=r, es=c.kern.es, m_b=c.m_b, V_b=c.V_b,
                f_params=c.f_params, shared=False, cfg=cfg, lower=lower,
                upper=upper, win=win, xcrop=(xc, xtc),
                proj=(E, xc, xtc, win[0], win[1]))
    rng = np.random.default_rng(0)
    th = {k: torch.as_tensor(v + 0.02 * rng.standard_normal(5))
          for k, v in THETA.items()}
    th["sigma_0"][-1] = -1.0                  # out of bounds: +inf
    with torch.no_grad():
        got = tf._mstep_ladder(**args)(th)
        want = torch.stack([tf._mstep_objective(
            {k: v[t] for k, v in th.items()}, **args) for t in range(5)])
    assert bool(torch.isinf(got[-1])) and bool(torch.isinf(want[-1]))
    if fallback == "poison":
        assert bool(torch.isinf(got).all()) and bool(torch.isinf(want).all())
        return
    assert bool(torch.isfinite(got[:-1]).all())
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1].numpy(),
                               rtol=1e-10)


# ---------------------------------------------------------------------------
# The population under the warm solvers and the projected Gram
# ---------------------------------------------------------------------------

def test_population_under_the_warm_knobs_matches_jax():
    """fit_population with the Schulz E-step and M-step inverse, the series
    log-determinant and the projected Gram (rank sized from the sharpest
    cell): both packages' _vmap_safe_config turn them into the Cholesky
    E-step and log-determinant and the poisoning fallbacks; lane by lane
    against JAX's."""
    X, R, thetas = windowed_problem()
    xt = X[:16]
    knobs = dict(estep_solver="schulz", mstep_inverse="schulz",
                 mstep_logdet="series", mstep_gram="projected")
    jc, _ = jpop.fit_population(
        jnp.asarray(X), jnp.asarray(R),
        JCfg(ntilde=16, n_px_side=N, **STEPS_W, **dict(JAX_EXACT, **knobs)),
        xtilde=jnp.asarray(xt),
        thetas={k: jnp.asarray(v) for k, v in thetas.items()},
        f_params={k: jnp.float64(v) for k, v in FP0.items()})
    tc, _ = tpop.fit_population(
        X, R, TCfg(ntilde=16, n_px_side=N, **STEPS_W, **knobs), xtilde=xt,
        thetas=thetas, f_params=FP0, device="cpu")
    assert not np.any(np.asarray(jc.failed)) and not torch.any(tc.failed)
    for name in ("logmarginal", "loglikelihood", "KL"):
        np.testing.assert_allclose(getattr(tc.track, name).numpy(),
                                   np.asarray(getattr(jc.track, name)),
                                   rtol=1e-8)
    for k in THETA:
        np.testing.assert_allclose(tc.theta[k].numpy(),
                                   np.asarray(jc.theta[k]), rtol=1e-8,
                                   atol=1e-12, err_msg=k)


@pytest.mark.parametrize("knobs", [
    dict(mstep_inverse="schulz"),
    dict(mstep_inverse="schulz", schulz_fallback="poison"),
    dict(mstep_gram="projected"),
    dict(mstep_gram="projected", mstep_proj_fallback="poison"),
    dict(estep_solver="schulz", mstep_logdet="series"),
    dict(estep_solver="schulz", mstep_inverse="schulz",
         mstep_logdet="series", mstep_gram="projected", mstep_gtol=1e-3),
])
def test_vmap_safe_config_matches_jax(knobs):
    jc = jpop._vmap_safe_config(JCfg(**dict(JAX_EXACT, **knobs)))
    tc = tpop._vmap_safe_config(TCfg(**knobs))
    for name in SOLVER_KNOBS + ("mstep_gtol", "estep_tol"):
        assert getattr(tc, name) == getattr(jc, name), name


# ---------------------------------------------------------------------------
# The knobs: defaults, validation, conversion
# ---------------------------------------------------------------------------

def test_defaults_compute_what_they_did():
    """Every field FitConfig() had keeps its value, and every new knob
    defaults to its exact form (JAX defaults to the warm ones)."""
    cfg = dataclasses.asdict(TCfg())
    assert {k: cfg[k] for k in PREVIOUS_DEFAULTS} == PREVIOUS_DEFAULTS
    assert {k: cfg[k] for k in SOLVER_KNOBS} == {
        "eigensolver": "eigh", "subspace_power_steps": 2,
        "eigh_refresh_every": 8, "estep_solver": "chol",
        "mstep_inverse": "exact", "schulz_steps": 12,
        "schulz_fallback": "exact", "mstep_logdet": "chol",
        "mstep_gram": "exact", "mstep_proj_rank": None,
        "mstep_proj_tol": 3e-6, "mstep_proj_fallback": "exact"}
    assert set(cfg) == set(PREVIOUS_DEFAULTS) | set(SOLVER_KNOBS)
    j = JCfg()
    for name in ("subspace_power_steps", "eigh_refresh_every",
                 "schulz_steps", "mstep_proj_rank", "mstep_proj_tol",
                 "mstep_gram"):
        assert cfg[name] == getattr(j, name), name


@pytest.mark.parametrize("name", ["eigensolver", "estep_solver",
                                  "mstep_inverse", "mstep_logdet",
                                  "mstep_gram", "mstep_proj_fallback",
                                  "schulz_fallback"])
def test_validation_messages_equal_jax(name):
    with pytest.raises(ValueError) as jerr:
        JCfg(**{name: "bogus"})
    with pytest.raises(ValueError) as terr:
        TCfg(**{name: "bogus"})
    assert str(terr.value) == str(jerr.value)


def test_a_jax_config_arrives_with_its_warm_solvers():
    cfg = convert.config_from_any(JCfg())
    j = JCfg()
    assert (cfg.eigensolver, cfg.estep_solver, cfg.mstep_inverse,
            cfg.mstep_logdet, cfg.reduced_rank) == (
        "subspace", "schulz", "schulz", "series", True)
    for name in SOLVER_KNOBS:
        assert getattr(cfg, name) == getattr(j, name), name


def test_a_jax_checkpoint_loads_with_its_solvers(fits, tmp_path):
    jr, _, _ = fits("warm_projected")
    d = str(tmp_path / "jax_model")
    jio.save_model(jr, d)
    res = tio.load_model(d, device="cpu")
    for name in SOLVER_KNOBS + ("reduced_rank", "rank_bucket"):
        assert getattr(res.config, name) == getattr(jr.config, name), name
    assert res.used_warm_basis
