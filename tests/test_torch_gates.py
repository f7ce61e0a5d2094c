"""The port's convergence gates (``FitConfig.mstep_gtol``, ``mstep_ftol``,
``mstep_ftol_rel``, ``estep_tol``) against the JAX package, and the knobs
around the line searches: the config's validation, ``config_from_any``,
the population's ``_vmap_safe_config`` and the batched ladder evaluators.

Fits: the single-cell fit with each gate against JAX's per-iteration fit
with test_torch_fit.py's exact knobs, float64 on the same numpy inputs;
the loss trajectory, theta, f-params and B m_b rtol 1e-6, and the gate's
effect (Newton steps run, M-step evaluations) counted on the port's side.
Four EM iterations, so that three E-steps and two M-steps meet the gates.
The JAX fits are module-scoped (each compiles for about 10 s).  The
ladder evaluators against a loop over their trials, rtol 1e-12.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.parallel import population as jpop
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.params import theta_bounds
from gaussian_processes_tpu_torch.parallel import population as tpop

from test_torch_fit import FP0, JAX_EXACT, STEPS, THETA0, planted

torch.set_num_threads(1)

N, NT, NTILDE = 24, 256, 64
# the full frame: over four iterations the port's crop window, which
# follows the theta each iteration starts from, and JAX's, one iteration
# behind, part the fits by ~5e-6 (ROADMAP queue 3)
GATED = dict(STEPS, maxiter=4, n_mstep=6, crop_window=False)
GATES = ("mstep_gtol", "mstep_ftol", "mstep_ftol_rel", "estep_tol")
# estep_tol 0.1 stops the second and third E-steps after their first
# Newton step, 1e-3 and 1e-12 never stop one at this depth; mstep_ftol_rel
# 1e-3 stops both M-steps early, the reference's gtol 1e-7 and ftol 1e-9
# neither.
CASES = {
    "estep_tol_1e-3": dict(estep_tol=1e-3),
    "estep_tol_1e-12": dict(estep_tol=1e-12),
    "estep_tol_0.1": dict(estep_tol=0.1),
    "mstep_ftol_rel": dict(mstep_ftol_rel=1e-3),
    "mstep_gtol_ftol": dict(mstep_gtol=1e-7, mstep_ftol=1e-9),
}


@pytest.fixture(scope="module")
def problem():
    x, lam, rng = planted(N, NT, 0)
    r = rng.poisson(lam).astype(float)
    return dict(x=x, r=r, idx=rng.permutation(NT)[:NTILDE])


def port_fit(problem, **gates):
    """The port's fit with ``gates``, and its Newton steps and M-step
    objective evaluations."""
    counts = {"newton": 0, "mstep": 0}
    real = tf.estep_update, tf._mstep_objective

    def newton(*args, **kwargs):
        counts["newton"] += 1
        return real[0](*args, **kwargs)

    def mstep(*args, **kwargs):
        counts["mstep"] += 1
        return real[1](*args, **kwargs)

    tf.estep_update, tf._mstep_objective = newton, mstep
    try:
        x = torch.as_tensor(problem["x"])
        res = tf.fit(x, torch.as_tensor(problem["r"]),
                     TCfg(ntilde=NTILDE, **GATED, **gates),
                     xtilde=x[torch.as_tensor(problem["idx"])], theta=THETA0,
                     f_params=FP0)
    finally:
        tf.estep_update, tf._mstep_objective = real
    return res, counts


@pytest.fixture(scope="module")
def fits(problem):
    """Each case's JAX and port fits (with the port's counts), and the
    port's ungated fit, run once."""
    cache = {}

    def get(case):
        if case not in cache:
            if case == "ungated":
                cache[case] = (None, *port_fit(problem))
            else:
                p = problem
                jr = jf.fit(jnp.asarray(p["x"]), jnp.asarray(p["r"]),
                            JCfg(ntilde=NTILDE, **GATED, **JAX_EXACT,
                                 **CASES[case]),
                            xtilde=jnp.asarray(p["x"][p["idx"]]),
                            theta={k: jnp.float64(v)
                                   for k, v in THETA0.items()},
                            f_params={k: jnp.float64(v)
                                      for k, v in FP0.items()})
                cache[case] = (jr, *port_fit(problem, **CASES[case]))
        return cache[case]
    return get


def close(t, j, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=1e-6, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_gated_fit_matches_jax(fits, case):
    jr, tr, _ = fits(case)
    assert not tr.failed and not jr.failed
    for name in ("logmarginal", "loglikelihood", "KL"):
        close(getattr(tr.track, name), getattr(jr.track, name))
    for k in THETA0:
        close(tr.theta[k], jr.theta[k], atol=1e-9)
    for k in FP0:
        close(tr.f_params[k], jr.f_params[k])
    jBm = np.asarray(jr.B @ jr.m_b)
    close(tr.B @ tr.m_b, jBm, atol=1e-6 * np.abs(jBm).max())
    loss = tr.track.logmarginal.numpy()
    assert loss[-1] > loss[0]


@pytest.mark.parametrize("case,newton,mstep", [
    ("estep_tol_1e-3", 9, 26), ("estep_tol_1e-12", 9, 26),
    ("estep_tol_0.1", 6, 25), ("mstep_ftol_rel", 9, 14),
    ("mstep_gtol_ftol", 9, 26)])
def test_gates_skip_what_they_should(fits, case, newton, mstep):
    """Against the ungated fit's 9 Newton steps and 26 M-step evaluations;
    a gate that never fires leaves the fit bit for bit."""
    _, tr, counts = fits(case)
    _, ungated, base = fits("ungated")
    assert base == {"newton": 9, "mstep": 26}
    assert counts == {"newton": newton, "mstep": mstep}
    if counts == base:
        assert torch.equal(tr.track.logmarginal, ungated.track.logmarginal)


def test_estep_gate_is_refused_on_the_cell_axis():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="estep_tol"):
        tf._estep_block(x, None, None, None, None, None, None,
                        TCfg(estep_tol=1e-3), lanes=True)


# ---------------------------------------------------------------------------
# Config, conversion, the population's knobs
# ---------------------------------------------------------------------------

def test_config_defaults_and_validation_match_jax():
    names = ("linesearch", "mstep_memory", "armijo_trials",
             "max_linesearch_steps") + GATES
    for name in names:
        assert getattr(TCfg(), name) == getattr(JCfg(), name), name
    for search in ("zoom", "zoom_carry", "speculative", "backtracking",
                   "armijo"):
        assert TCfg(linesearch=search).linesearch == search
    messages = []
    for cls in (TCfg, JCfg):
        with pytest.raises(ValueError) as err:
            cls(linesearch="lbfgs")
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_config_from_any_keeps_the_new_fields():
    knobs = dict(linesearch="speculative", mstep_memory=False,
                 armijo_trials=9, mstep_gtol=1e-7, mstep_ftol=1e-9,
                 mstep_ftol_rel=1e-4, estep_tol=1e-3)
    got = convert.config_from_any(JCfg(**knobs))
    assert {k: getattr(got, k) for k in knobs} == knobs
    got = convert.config_from_any(dict(knobs, linesearch="zoom_carry"))
    assert got.linesearch == "zoom_carry" and got.estep_tol == 1e-3


@pytest.mark.parametrize("search", ["zoom", "armijo"])
def test_vmap_safe_config_zeroes_the_gates_like_jax(search):
    gates = dict(mstep_gtol=1e-7, mstep_ftol=1e-2, mstep_ftol_rel=1e-4,
                 estep_tol=1e-3)
    t = tpop._vmap_safe_config(TCfg(linesearch=search, **gates))
    j = jpop._vmap_safe_config(JCfg(linesearch=search, **gates))
    assert {g: getattr(t, g) for g in GATES} == {g: getattr(j, g)
                                                for g in GATES}
    assert all(getattr(t, g) == 0.0 for g in GATES)
    assert t.linesearch == "armijo"


@pytest.mark.parametrize("search", ["speculative", "backtracking",
                                    "zoom_carry"])
def test_population_refuses_single_lane_searches(search):
    X, R = np.zeros((8, 16)), np.ones((2, 8))
    with pytest.raises(ValueError, match="fit_cells_sequential"):
        tpop.fit_population(X, R, TCfg(linesearch=search, n_px_side=4),
                            device="cpu")


# ---------------------------------------------------------------------------
# The batched ladder evaluators against a loop over their trials
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mstep_state(problem):
    """A port fit's start state: kernels, eigenspace, (m_b, V_b) and
    f-params at THETA0, with the start window (the crop window's default
    knobs)."""
    p = problem
    x = torch.as_tensor(p["x"])
    xtilde = x[torch.as_tensor(p["idx"])]
    r = torch.as_tensor(p["r"])
    cfg = TCfg(ntilde=NTILDE, **STEPS)
    theta = {k: torch.tensor(v, dtype=torch.float64)
             for k, v in THETA0.items()}
    fp = {k: torch.tensor(v, dtype=torch.float64) for k, v in FP0.items()}
    from gaussian_processes_tpu_torch.ops.kernels import crop_window_for_theta
    win = crop_window_for_theta(theta, N, cfg.alpha_threshold,
                                cfg.crop_margin, cfg.crop_bucket)
    assert win[2] < N
    c = tf._fit_init(x, r, xtilde, theta, fp,
                     torch.zeros(NTILDE, dtype=torch.float64), None, False,
                     False, cfg, win)
    return dict(x=x, xtilde=xtilde, r=r, cfg=cfg, carry=c, win=win)


def trial_thetas(T, seed=0):
    """T trial points around THETA0, the last one out of bounds (+inf)."""
    rng = np.random.default_rng(seed)
    th = {k: torch.as_tensor(v + 0.05 * rng.standard_normal(T))
          for k, v in THETA0.items()}
    th["sigma_0"][-1] = -1.0
    return th


@pytest.mark.parametrize("where", ["window", "full frame", "pad weights"])
def test_mstep_ladder_equals_the_loop(mstep_state, where):
    s = mstep_state
    c, cfg = s["carry"], s["cfg"]
    lower, upper = theta_bounds()
    win = None if where == "full frame" else s["win"]
    kw = {}
    if where == "pad weights":
        wt = torch.ones(NT, dtype=torch.float64)
        wt[-20:] = 0.0
        wi = torch.ones(NTILDE, dtype=torch.float64)
        wi[-5:] = 0.0
        kw = dict(wt=wt, wi=wi)
    args = dict(x=s["x"], xtilde=s["xtilde"], r=s["r"], es=c.kern.es,
                m_b=c.m_b, V_b=c.V_b, f_params=c.f_params, shared=False,
                cfg=cfg, lower=lower, upper=upper, win=win, **kw)
    th = trial_thetas(7)
    with torch.no_grad():
        got = tf._mstep_ladder(**args)(th)
        want = torch.stack([tf._mstep_objective(
            {k: v[t] for k, v in th.items()}, **args) for t in range(7)])
    assert got.shape == (7,) and torch.isinf(got[-1]) and torch.isinf(want[-1])
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1].numpy(),
                               rtol=1e-12)


def test_mstep_ladder_chunks_change_nothing(mstep_state, monkeypatch):
    """Chunks of 2 items (as a card with little free memory sizes them)."""
    s = mstep_state
    c = s["carry"]
    lower, upper = theta_bounds()
    args = (s["x"], s["xtilde"], s["r"], c.kern.es, c.m_b, c.V_b,
            c.f_params, False, s["cfg"], lower, upper, s["win"])
    th = trial_thetas(5, seed=1)
    with torch.no_grad():
        one = tf._mstep_ladder(*args)(th)
        monkeypatch.setattr(tpop, "ladder_items", lambda *a: 2)
        chunked = tf._mstep_ladder(*args)(th)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-14)


def test_fparam_ladder_equals_the_loop(mstep_state):
    """The f-param objective at T logA trials against (1, nt) moments, as
    ``_estep_block`` hands it to the searches."""
    c = mstep_state["carry"]
    r = mstep_state["r"]
    logA = torch.log(torch.tensor([0.005, 0.01, 0.02, 0.05],
                                  dtype=torch.float64))
    wt = torch.ones(NT, dtype=torch.float64)
    wt[:10] = 0.0
    for w in (None, wt):
        got = tf._fparam_objective(logA, r[None], c.lambda_m[None],
                                   c.lambda_var[None], wt=w)
        want = torch.stack([tf._fparam_objective(a, r, c.lambda_m,
                                                 c.lambda_var, wt=w)
                            for a in logA])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_single_cell_armijo_runs_the_batched_ladder(problem):
    """The single-cell Armijo search evaluates each ladder as one call
    (its trials as one cell's items), not trial by trial."""
    calls = []
    real = tf._mstep_objective_cells

    def counted(theta, *args, **kwargs):
        calls.append(tuple(theta["Amp"].shape))
        return real(theta, *args, **kwargs)

    tf._mstep_objective_cells = counted
    try:
        x = torch.as_tensor(problem["x"])
        cfg = TCfg(ntilde=NTILDE, **dict(STEPS, linesearch="armijo"))
        res = tf.fit(x, torch.as_tensor(problem["r"]), cfg,
                     xtilde=x[torch.as_tensor(problem["idx"])], theta=THETA0,
                     f_params=FP0)
    finally:
        tf._mstep_objective_cells = real
    assert not res.failed
    # one M-step: value and gradient at the start (1, 1), then per step
    # the ladder (1, 6) and the accepted point's value and gradient
    assert calls == [(1, 1)] + [(1, 6), (1, 1)] * 3
