"""The M-step's trial evaluation as JAX's compiled EM iteration runs it:
the two warm-solver guards decided on the device, and the evaluation
served by ``optim/graphed`` (one CUDA graph replay a trial on the card).

On the CPU the graph's eager twin (the same static buffers and body, no
capture) stands in for the graph, and the JAX package's ``lax.cond`` forms
referee the branch-free guards.  Float64 throughout: values rtol 1e-10 and
gradients 1e-8 against JAX (Newton-Schulz runs the port's fixed step count
where JAX's loop exits early, so the inverses agree to rounding); the twin
against the eager route and the twin's fit against the eager fit bit for
bit (the same operations on the same values).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu.ops import stabilize as js
from gaussian_processes_tpu.params import theta_bounds
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import estep as te
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.ops import kernels as tk
from gaussian_processes_tpu_torch.ops import stabilize as ts
from gaussian_processes_tpu_torch.optim import graphed, lbfgs
from gaussian_processes_tpu_torch.optim.graphed import GraphedValueAndGrad
from gaussian_processes_tpu_torch.utils import tracing
from gaussian_processes_tpu_torch.utils.tracing import (decisions,
                                                        objective_counts)

from test_torch_fit import FP0, JAX_EXACT, THETA0, planted
from test_torch_linalg import tes_from
from test_torch_warm_solvers import FAR, kept_block

torch.set_num_threads(1)

RTOL = 1e-10
GRAD_RTOL = 1e-8


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach()), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture
def read_guards(monkeypatch):
    """Counts the calls of ``read_guard`` (the host-read guard) from every
    module that holds it while the test runs."""
    calls = []
    real = tracing.read_guard

    def counted(*args, **kwargs):
        calls.append(args[1:])
        return real(*args, **kwargs)
    for mod in (tracing, tf, te):
        monkeypatch.setattr(mod, "read_guard", counted)
    return calls


# ---------------------------------------------------------------------------
# The branch-free guards against JAX's lax.cond forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("outcome", ["pass", "fail"])
def test_logdet_series_guard_on_the_device_matches_lax_cond(outcome,
                                                            read_guards):
    """``masked_logdet_series`` with its guard forced each way: the value
    and gradient of JAX's ``lax.cond`` (the series, or the Cholesky
    log-determinant), no host read, and the outcome counted on the
    device."""
    M, keep, inv_diag = kept_block(**({} if outcome == "pass" else FAR))
    decisions.clear()
    tM = torch.as_tensor(M).requires_grad_(True)
    got = ts.masked_logdet_series(tM, torch.as_tensor(keep),
                                  torch.as_tensor(inv_diag))
    (g,) = torch.autograd.grad(got, tM)
    assert read_guards == [] and not decisions
    decisions.fold()
    route = "mstep.series" if outcome == "pass" else "mstep.chol"
    assert decisions[route] == 1 and sum(decisions.values()) == 1

    def jld(Mj):
        return js.masked_logdet_series(Mj, jnp.asarray(keep),
                                       jnp.asarray(inv_diag))
    close(got, jld(jnp.asarray(M)))
    jg = jax.grad(jld)(jnp.asarray(M))
    close(g, jg, rtol=GRAD_RTOL, atol=1e-12 * np.abs(np.asarray(jg)).max())
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("outcome", ["pass", "fail"])
def test_inverse_guard_on_the_device_matches_lax_cond(outcome, read_guards):
    """``masked_inverse_warm`` (fallback "exact") with its guard forced each
    way: JAX's ``lax.cond`` between Newton-Schulz and the exact inverse,
    value and gradient, no host read, the outcome counted on the device."""
    M, keep, inv_diag = kept_block(seed=3, **({} if outcome == "pass"
                                              else FAR))
    W = np.random.default_rng(8).standard_normal(M.shape)
    decisions.clear()
    tM = torch.as_tensor(M).requires_grad_(True)
    inv = ts.masked_inverse_warm(tM, torch.as_tensor(keep),
                                 torch.as_tensor(inv_diag))
    (g,) = torch.autograd.grad(torch.sum(torch.as_tensor(W) * inv), tM)
    assert read_guards == [] and not decisions
    decisions.fold()
    route = "mstep.schulz" if outcome == "pass" else "mstep.exact"
    assert decisions[route] == 1 and sum(decisions.values()) == 1

    def jinv(Mj):
        return js.masked_inverse_warm(Mj, jnp.asarray(keep),
                                      jnp.asarray(inv_diag))
    want = jinv(jnp.asarray(M))
    close(inv, want, atol=1e-12 * float(np.abs(np.asarray(want)).max()))
    jg = jax.grad(lambda Mj: jnp.sum(jnp.asarray(W) * jinv(Mj)))(
        jnp.asarray(M))
    close(g, jg, rtol=GRAD_RTOL, atol=1e-12 * np.abs(np.asarray(jg)).max())


# ---------------------------------------------------------------------------
# One M-step evaluation: the graph's eager twin, the eager route and JAX
# ---------------------------------------------------------------------------

N, NT, NTILDE = 24, 80, 24
BETA = 0.1       # a narrow RF: the window (crop_bucket 4) is below 24 px
FORMS = {"exact": {}, "warm": dict(mstep_inverse="schulz",
                                   mstep_logdet="series")}
# the trial theta: the state's own (both warm guards pass) or Amp x 3
# (K_tilde_b three times the seed's inverse: both fall back)
TRIALS = {"near": 1.0, "far": 3.0}


@pytest.fixture(scope="module")
def mstep_problem():
    """A crop-window M-step state: the eigenspace of K_tilde at theta (from
    JAX, converted), a kept-subspace variational state, the window and its
    crops."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((NT, N * N))
    r = rng.poisson(1.5, NT).astype(float)
    theta = dict(THETA0, **{"-2log2beta": -2 * np.log(2 * BETA),
                            "eps_0x": 0.15, "eps_0y": -0.1})
    jtheta = {k: jnp.float64(v) for k, v in theta.items()}
    K_tilde, _, _ = jk.gram_matrices(jtheta, jnp.asarray(x),
                                     jnp.asarray(x[:NTILDE]), N, shared=False)
    jes = js.compute_eigenspace(K_tilde)
    keep = np.asarray(jes.keep)
    W = rng.standard_normal((NTILDE, NTILDE)) * 0.05
    V_b = (W @ W.T + np.eye(NTILDE)) * np.outer(keep, keep)
    m_b = rng.standard_normal(NTILDE) * keep
    tx = torch.as_tensor(x)
    ttheta = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in theta.items()}
    win = tk.crop_window_for_theta(ttheta, N, 1e-3, 1.25, 4)
    assert win[2] < N
    return dict(x=x, r=r, theta=theta, jes=jes, m_b=m_b, V_b=V_b, win=win,
                tx=tx, txt=tx[:NTILDE], tr=torch.as_tensor(r),
                ttheta=ttheta, tes=tes_from(jes))


def _port_twin(p, cfg, monkeypatch):
    """The fit's graphed evaluator as its eager twin, bound to the
    problem's state; and the eager route's ``vg`` on the same state."""
    monkeypatch.setattr(tf, "_mstep_graph_route", lambda x, cfg, rows: True)
    monkeypatch.setattr(tf, "GraphedValueAndGrad",
                        functools.partial(GraphedValueAndGrad, graph=False))
    bounds = theta_bounds()
    fp = {k: torch.tensor(v, dtype=torch.float64) for k, v in FP0.items()}
    xcrop = tuple(tk.crop_images(v, *p["win"], N) for v in (p["tx"],
                                                            p["txt"]))
    twin = tf._mstep_graph(p["tx"], p["txt"], p["tr"], p["ttheta"], False,
                           cfg, bounds)
    vg = twin.bind(tf._mstep_state(p["tes"], torch.as_tensor(p["m_b"]),
                                   torch.as_tensor(p["V_b"]), fp, p["win"],
                                   xcrop))
    eager = functools.partial(
        tf._mstep_objective, x=p["tx"], xtilde=p["txt"], r=p["tr"],
        es=p["tes"], m_b=torch.as_tensor(p["m_b"]),
        V_b=torch.as_tensor(p["V_b"]), f_params=fp, shared=False, cfg=cfg,
        lower=bounds[0], upper=bounds[1], win=p["win"], xcrop=xcrop)
    _, unflatten, device = lbfgs._flatten(p["ttheta"])
    return twin, vg, lbfgs._value_and_grad_fn(eager, unflatten, device,
                                              torch.float64)


def _trial(p, trial):
    return dict(p["theta"], Amp=p["theta"]["Amp"] * TRIALS[trial])


@pytest.mark.parametrize("form,trial", [("exact", "near"), ("warm", "near"),
                                        ("warm", "far")])
def test_graph_twin_is_the_eager_route_and_jax(mstep_problem, form, trial,
                                               monkeypatch, read_guards):
    """At a crop-window state: the twin's value and gradient equal the
    eager route's bit for bit, with no host read of a guard, and JAX's
    ``_mstep_objective`` (value and ``jax.grad``) within the stated
    tolerance; the warm forms' guards forced to pass (near) and fail
    (far)."""
    p = mstep_problem
    cfg = TCfg(ntilde=NTILDE, n_px_side=N, crop_bucket=4, **FORMS[form])
    twin, vg, eager = _port_twin(p, cfg, monkeypatch)
    theta = _trial(p, trial)
    flat = torch.tensor([theta[k] for k in sorted(theta)],
                        dtype=torch.float64)
    decisions.clear()
    with twin:
        v, g = vg(flat)
    v_e, g_e = eager(flat)
    assert read_guards == []
    assert torch.equal(v, v_e) and torch.equal(g, g_e)
    decisions.fold()
    if form == "warm":
        route = ("mstep.schulz", "mstep.series") if trial == "near" else (
            "mstep.exact", "mstep.chol")
        assert {k for k, n in decisions.items() if n} == set(route)

    jcfg = JCfg(ntilde=NTILDE, n_px_side=N, crop_bucket=4,
                **dict(JAX_EXACT, **FORMS[form]))
    jx = jnp.asarray(p["x"])
    jxt = jx[:NTILDE]
    win = p["win"]
    jcrop = (jk.crop_images(jx, *win, N), jk.crop_images(jxt, *win, N))
    lower, upper = theta_bounds()

    def jobj(th):
        return jf._mstep_objective(
            th, jx, jxt, jnp.asarray(p["r"]), p["jes"],
            jnp.asarray(p["m_b"]), jnp.asarray(p["V_b"]),
            {k: jnp.float64(val) for k, val in FP0.items()}, False, jcfg,
            lower, upper, win=win, xcrop=jcrop)
    jtheta = {k: jnp.float64(val) for k, val in theta.items()}
    close(v, jobj(jtheta))
    jg = jax.grad(jobj)(jtheta)
    jflat = np.array([float(jg[k]) for k in sorted(theta)])
    close(g, jflat, rtol=GRAD_RTOL, atol=1e-12 * np.abs(jflat).max())


def test_graph_twin_out_of_bounds_and_rebinding(mstep_problem, monkeypatch):
    """An out-of-bounds trial is +inf with a finite gradient on both
    routes, bit for bit; binding a state of another window width makes new
    buffers and gives the eager route's values there too."""
    p = mstep_problem
    cfg = TCfg(ntilde=NTILDE, n_px_side=N, crop_bucket=4, **FORMS["warm"])
    twin, vg, eager = _port_twin(p, cfg, monkeypatch)
    keys = sorted(p["theta"])
    flat = torch.tensor([p["theta"][k] for k in keys], dtype=torch.float64)
    out = flat.clone()
    out[keys.index("eps_0x")] = 5.0
    v, g = vg(out)
    assert torch.equal(v, eager(out)[0]) and torch.equal(g, eager(out)[1])
    assert torch.isinf(v) and bool(torch.isfinite(g).all())
    # the full frame: no window, no crops
    fp = {k: torch.tensor(val, dtype=torch.float64) for k, val in FP0.items()}
    vg_full = twin.bind(tf._mstep_state(p["tes"], torch.as_tensor(p["m_b"]),
                                        torch.as_tensor(p["V_b"]), fp, None,
                                        None))
    bounds = theta_bounds()
    _, unflatten, device = lbfgs._flatten(p["ttheta"])
    full = lbfgs._value_and_grad_fn(functools.partial(
        tf._mstep_objective, x=p["tx"], xtilde=p["txt"], r=p["tr"],
        es=p["tes"], m_b=torch.as_tensor(p["m_b"]),
        V_b=torch.as_tensor(p["V_b"]), f_params=fp, shared=False, cfg=cfg,
        lower=bounds[0], upper=bounds[1]), unflatten, device, torch.float64)
    v_f, g_f = vg_full(flat)
    assert torch.equal(v_f, full(flat)[0]) and torch.equal(g_f, full(flat)[1])
    twin.close()


# ---------------------------------------------------------------------------
# The graphed module's own contract
# ---------------------------------------------------------------------------

def test_graphed_state_trees_and_errors():
    """The state tree through the buffers (named tuples, dicts, tuples,
    lists, constants), buffers copied at each bind, a CUDA graph refused on
    CPU parameters, and vg refused before a bind."""
    es = ts.Eigenspace(*(torch.arange(3.0) + i for i in range(5)))
    tree = {"es": es, "pair": (torch.ones(2), 4), "lst": [None, 1.5],
            "t": torch.zeros(2, 2)}
    seen = []

    def record(params, state):
        seen.append(state)
        return params["x"] * state["t"].sum()
    x0 = {"x": torch.tensor(1.0)}
    holder = GraphedValueAndGrad(record, x0, graph=False)
    holder.bind(tree)(torch.ones(1))
    back = seen[0]
    assert isinstance(back["es"], ts.Eigenspace)
    assert back["pair"][1] == 4 and back["lst"] == [None, 1.5]
    assert all(torch.equal(a, b) and a is not b
               for a, b in zip(back["es"], es))
    holder.bind(dict(tree, t=torch.ones(2, 2)))(torch.ones(1))
    assert seen[1] is back          # the same key: the same buffers
    holder.bind(dict(tree, pair=(torch.ones(2), 5)))(torch.ones(1))
    assert seen[2] is not back and seen[2]["pair"][1] == 5   # a new key
    holder.close()

    def fun(params, state):
        return (state["a"] * params["x"] ** 2).sum() + state["b"] * params["y"]
    x0 = {"x": torch.tensor(1.0, dtype=torch.float64),
          "y": torch.tensor(2.0, dtype=torch.float64)}
    with pytest.raises(ValueError, match="CUDA"):
        GraphedValueAndGrad(fun, x0)
    twin = GraphedValueAndGrad(fun, x0, graph=False)
    with pytest.raises(RuntimeError, match="bind"):
        twin._vg(torch.zeros(2, dtype=torch.float64))
    a = torch.tensor([1.0, 2.0], dtype=torch.float64)
    vg = twin.bind({"a": a, "b": torch.tensor(3.0, dtype=torch.float64)})
    a += 1.0              # the bind copied it
    v, g = vg(torch.tensor([1.0, 2.0], dtype=torch.float64))
    assert float(v) == 9.0 and g.tolist() == [6.0, 3.0]
    vg = twin.bind({"a": a, "b": torch.tensor(3.0, dtype=torch.float64)})
    assert float(vg(torch.tensor([1.0, 2.0], dtype=torch.float64))[0]) == 11.0
    twin.close()


@pytest.mark.parametrize("module,name,bump", [
    ("gram_cuda", "bwd_launches", 2),
    ("gram_cuda", "product_shapes", {"1x8x8 k16": 3}),
    ("fparam_search", "launches", 1)])
def test_capture_launches_are_held_out_and_credited_at_replay(module, name,
                                                              bump):
    """What the wrappers count inside ``launches_held_out`` (a capture,
    which launches nothing) is taken off the counters and kept; each
    ``credit_launches`` (a replay) adds it back; a block that raises is
    held out all the same."""
    from gaussian_processes_tpu_torch.ops import fparam_search, gram_cuda
    mod = {"gram_cuda": gram_cuda, "fparam_search": fparam_search}[module]
    tracing.reset_launch_counts()
    before = tracing.read_launch_counts()

    def count():
        if isinstance(bump, dict):
            getattr(mod, name).update(bump)
        else:
            setattr(mod, name, getattr(mod, name) + bump)
    with tracing.launches_held_out() as held:
        count()
    assert tracing.read_launch_counts() == before
    assert held == {(mod, name): bump}
    for _ in range(2):
        tracing.credit_launches(held)
    after = tracing.read_launch_counts()
    with pytest.raises(RuntimeError):
        with tracing.launches_held_out() as failed:
            count()
            raise RuntimeError("a capture that fails")
    assert tracing.read_launch_counts() == after and failed == held
    tracing.credit_launches(held, -2)
    assert tracing.read_launch_counts() == before
    tracing.credit_launches(held, 2)
    assert tracing.read_launch_counts() == after != before
    tracing.reset_launch_counts()


class _Replayed:
    """A stand-in for a captured CUDA graph: a replay launches nothing
    that the wrappers see, as a real one does."""

    def replay(self):
        pass


@pytest.mark.parametrize("plan", [
    ("replay", "replay", "replay", "read", "close"),
    ("replay", "read", "replay", "read", "replay", "close", "read"),
    ("replay", "replay", "rebind", "read", "close"),
    ("replay", "reset", "replay", "replay", "close", "read"),
    ("read", "close")])
def test_replays_are_credited_at_each_replay(plan, monkeypatch):
    """A graph's launches are credited at each replay: the counts read at
    every point, through replays, a reset of the counters, a rebind to
    another key and the close, are the held counts times the replays since
    the capture or the last reset."""
    from gaussian_processes_tpu_torch.ops import gram_cuda
    tracing.reset_launch_counts()
    monkeypatch.setattr(graphed, "_parked", {})   # where close parks it

    def fun(params, state):
        return (state["a"] * params["x"] ** 2).sum()
    x0 = {"x": torch.tensor(1.0, dtype=torch.float64)}
    twin = GraphedValueAndGrad(fun, x0, graph=False)
    vg = twin.bind({"a": torch.ones(2, dtype=torch.float64)})
    point = torch.ones(1, dtype=torch.float64)
    vg(point)                                   # the key's warm-up
    # the capture, held out: a graph replays 2 backward and 1 product
    # launches a call
    with tracing.launches_held_out() as held:
        gram_cuda.bwd_launches += 2
        gram_cuda.product_launches += 1
        gram_cuda.product_shapes.update({"1x8x8 k16": 1})
    twin.graph, twin._graph, twin._launches = True, _Replayed(), held
    zero = tracing.read_launch_counts()
    replayed, seen, want = 0, [], []
    for step in plan:
        if step == "replay":
            vg(point)
            replayed += 1
        elif step == "reset":
            tracing.reset_launch_counts()
            replayed = 0
        elif step == "rebind":
            vg = twin.bind({"a": torch.ones(3, dtype=torch.float64)})
        elif step == "close":
            twin.close()
        if step in ("read", "close"):
            seen.append(tracing.read_launch_counts())
            want.append(dict(zero, bwd=zero["bwd"] + 2 * replayed,
                             product=zero["product"] + replayed,
                             product_shapes=(
                                 {"1x8x8 k16": replayed} if replayed
                                 else {})))
    assert seen == want
    assert gram_cuda.bwd_launches == 2 * replayed
    tracing.reset_launch_counts()


# ---------------------------------------------------------------------------
# Whole fits: the graph route's twin against the eager route
# ---------------------------------------------------------------------------

FIT_N, FIT_NT, FIT_NTILDE = 24, 200, 48
WARM = dict(reduced_rank=True, eigensolver="subspace", eigh_refresh_every=2,
            estep_solver="schulz", mstep_inverse="schulz",
            mstep_logdet="series", rank_bucket=8, rank_pad=4)
FIT_STEPS = dict(maxiter=4, n_estep=3, n_mstep=3, n_fparamstep=3,
                 n_px_side=FIT_N, crop_bucket=4)


@pytest.fixture(scope="module")
def fit_data():
    x, lam, rng = planted(FIT_N, FIT_NT, 0)
    r = rng.poisson(lam).astype(float)
    return dict(x=x, r=r, idx=rng.permutation(FIT_NT)[:FIT_NTILDE])


def _fit(d, cfg):
    x = torch.as_tensor(d["x"])
    decisions.clear()
    with objective_counts() as evals:
        res = tf.fit(x, torch.as_tensor(d["r"]), cfg,
                     xtilde=x[torch.as_tensor(d["idx"])], theta=THETA0,
                     f_params=FP0)
    return res, dict(decisions), dict(evals)


@pytest.mark.parametrize("search", ["zoom", "zoom_carry"])
def test_fit_through_the_graph_twin_is_the_eager_fit(fit_data, search,
                                                     monkeypatch):
    """The fit under JAX's warm solvers through the graph route (its eager
    twin) and through the eager route: the same track, theta, decisions
    and objective evaluations, bit for bit; the twin evaluated every M-step
    trial."""
    cfg = TCfg(ntilde=FIT_NTILDE, linesearch=search, **FIT_STEPS, **WARM)
    eager, dec_e, ev_e = _fit(fit_data, cfg)
    monkeypatch.setattr(tf, "_mstep_graph_route", lambda x, cfg, rows: True)
    served = []

    class Counted(GraphedValueAndGrad):
        def _body(self):
            served.append(1)
            super()._body()
    monkeypatch.setattr(tf, "GraphedValueAndGrad",
                        functools.partial(Counted, graph=False))
    twin, dec_t, ev_t = _fit(fit_data, cfg)
    assert torch.equal(twin.track.logmarginal, eager.track.logmarginal)
    assert all(torch.equal(twin.theta[k], eager.theta[k])
               for k in eager.theta)
    assert dec_t == dec_e and dec_e["mstep.series"] > 0
    assert ev_t == ev_e and len(served) == ev_e["mstep"] > 0


def test_fit_decisions_equal_the_host_read_routes(fit_data, monkeypatch):
    """A small fit's decisions counted on the device and folded when it
    ends equal the same fit's with every M-step guard read on the host
    (``read_guard``, the route before the guards moved to the device)."""
    cfg = TCfg(ntilde=FIT_NTILDE, **FIT_STEPS, **WARM)
    device_res, on_device, _ = _fit(fit_data, cfg)
    monkeypatch.setattr(decisions, "count_on_device", tracing.read_guard)
    host_res, on_host, _ = _fit(fit_data, cfg)
    assert on_device == on_host
    assert on_device["mstep.schulz"] + on_device["mstep.exact"] > 0
    assert torch.equal(device_res.track.logmarginal,
                       host_res.track.logmarginal)


def test_graph_route_is_taken_where_it_should_be():
    """The graph route: CUDA tensors, no mesh, the exact Gram, a zoom
    search, M-steps to run."""
    x = torch.zeros(2, 2)
    cfg = TCfg()
    assert not tf._mstep_graph_route(x, cfg, None)      # a CPU tensor
    assert isinstance(tf._mstep_graph(x, x, x[:, 0], THETA0, False, cfg,
                                      theta_bounds()),
                      type(tf.contextlib.nullcontext()))

    class OnCuda:
        is_cuda = True
    for knobs, want in ((dict(), True), (dict(linesearch="zoom_carry"), True),
                        (dict(linesearch="speculative"), False),
                        (dict(linesearch="backtracking"), False),
                        (dict(mstep_gram="projected"), False),
                        (dict(n_mstep=0), False)):
        assert tf._mstep_graph_route(OnCuda, TCfg(**knobs), None) == want
    assert not tf._mstep_graph_route(OnCuda, cfg, rows=object())
