"""Population requests back to back: the lab's fit of a whole recording
(one_cell_fit.ipynb cell4: many cells' responses to one stimulus set),
every cell fitted at once through the port's population program, then
each cell tested.

A request is the STA init of every cell (``bench.sta_init``),
``parallel.population.fit_population`` on the recording with its
``ntilde`` inducing rows (one draw a recording, from the seed),
``population_results``, and ``models.inference.evaluate`` of every lane on
the test images and their repeats, timed on the host from its start to
its end, closed by a device synchronize.  The window closes after the
request that takes it past ``seconds``; ``fit_s`` is the window's seconds
over its requests.  Making each request's data, and moving what the check
reads to the host, fall between requests and outside the window.
``attempted`` and ``failed`` count lanes: a lane whose fit failed or whose
loss or r^2 is not finite is a failed operation.

With ``trace`` the first request runs under the profiler (the device
metrics, with the launch counts of its ``fit_population`` call), the
others inside ``collect_spans`` (the chunk counters).

The check holds every lane of every request against the plain reference
(``portbench/reference/population.py`` on ``gp.py``) in float64: the
final state's Grams, loss and rates and r^2 on the population's window,
and its full-rank basis; and, for one lane a request drawn from the seed,
the first EM iteration stage by stage (``em_probe``): the E-step from the
state it started from in the basis it rebuilt, the M-step (the
reference's Armijo search) from the program's E-step, the M-step's first
value and gradient, and every call of the M-step's search, its ladders'
rungs and its value-and-gradient calls, with one more ladder inside
theta's box made after the request (``pulled_ladder``,
``search_numbers``).  The other numbers are ``fit_requests``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from contextlib import nullcontext

import numpy as np
import torch

from gaussian_processes_tpu_torch.bench import sta_init
from gaussian_processes_tpu_torch.config import FitConfig
from gaussian_processes_tpu_torch.models import fit as fit_module
from gaussian_processes_tpu_torch.models.inference import evaluate
from gaussian_processes_tpu_torch.parallel.population import (
    fit_population, population_results)
from gaussian_processes_tpu_torch.utils.tracing import (
    collect_spans, read_launch_counts, reset_launch_counts)

from ..reference import gp as ref
from ..reference import population as pop_ref
from ..trace import Tracer
from .common import clock, generator, rel_err, worst
from . import fit_requests
from .fit_requests import STEP_NUMBERS, program_step

SEARCH_NUMBERS = ("ladder", "rungs0", "ladder0")
PULL = 2.0 ** -20

WARMUP_INDEX = -1
CHECKED_ITERATION = 1
INDUCING_STREAM = 4
LANE_STREAM = 6


@dataclasses.dataclass
class Session:
    config: dict
    params: dict
    seed: int
    device: torch.device
    cfg: FitConfig
    gen: object


def inputs(s: Session, index: int, params: dict = None) -> dict:
    """Request ``index``'s recording and its inducing rows."""
    params = params or s.params
    rec = s.gen.make_recording(params, s.seed, index, s.device)
    key = s.gen.cell_key(params, s.seed, index)
    g = torch.Generator().manual_seed(s.gen.stream_seed(*key,
                                                        INDUCING_STREAM))
    idx = torch.randperm(rec["x"].shape[0], generator=g)[:s.config["ntilde"]]
    rec["xtilde_idx"] = idx.to(s.device)
    return rec


def checked_lane(s: Session, index: int) -> int:
    """The lane whose first EM iteration request ``index`` checks."""
    rng = np.random.default_rng(s.gen.stream_seed(s.seed, index, LANE_STREAM))
    return int(rng.integers(s.params["n_cells"]))


def serve(s: Session, rec: dict, cfg: FitConfig = None, marks: dict = None):
    """One request (the program's calls): the start thetas, the
    population's results and each lane's (rates, r^2).  ``marks`` gets the
    launch counts at the end of ``fit_population``."""
    cfg = cfg or s.cfg
    x, rs = rec["x"], rec["rs"]
    starts = [sta_init(x, r, s.config["n_px_side"]) for r in rs]
    thetas = {k: torch.stack([t[k] for t, _ in starts]) for k in starts[0][0]}
    xtilde = x[rec["xtilde_idx"]]
    carry, (lower, upper) = fit_population(x, rs, cfg, xtilde=xtilde,
                                           thetas=thetas,
                                           f_params=starts[0][1])
    if marks is not None:
        marks["launches"] = read_launch_counts()
    results = population_results(carry, cfg, xtilde, lower, upper)
    tests = []
    for c, res in enumerate(results):
        _, rates, r2, _ = evaluate(res, rec["x_test"], rec["r_test"][c],
                                   nbootstrap=s.config["nbootstrap"],
                                   seed=s.config["bootstrap_seed"])
        tests.append((rates, r2))
    return thetas, results, tests


def _lane(c, lane: int) -> dict:
    """A copy of lane ``lane`` of a cell-stacked carry, what the check
    reads of an EM iteration."""
    es = c.kern.es
    return dict(theta={k: v[lane].clone() for k, v in c.theta.items()},
                f_params={k: v[lane].clone() for k, v in c.f_params.items()},
                m_b=c.m_b[lane].clone(), V_b=c.V_b[lane].clone(),
                B=es.B[lane].clone(), keep=es.keep[lane].clone())


@contextlib.contextmanager
def em_probe(lane: int):
    """Keeps, for the check, lane ``lane``'s state entering and leaving the
    program's first EM iteration (``models.fit._fit_iteration_cells``),
    the value and gradient of its first M-step evaluation (the batched
    Armijo search's first value-and-gradient call, at the iteration's
    start theta), and every call of that search (``calls``: the lane's
    points, theta in sorted-key order, and their values, a ladder's rungs
    or a value-and-gradient call's one point).  It also keeps what
    ``pulled_ladder`` needs after the request: the search's objective, its
    start and its first ladder's rungs, every lane's.  Yields the dict it
    fills; without "out" the lane failed in the iteration."""
    real_iteration, real_minimize = (fit_module._fit_iteration_cells,
                                     fit_module._minimize)
    rec: dict = {}

    def iteration(i, c, *args, **kwargs):
        if i != CHECKED_ITERATION:
            return real_iteration(i, c, *args, **kwargs)
        rec.clear()
        rec["in"], rec["armed"], rec["calls"] = _lane(c, lane), True, []
        try:
            out = real_iteration(i, c, *args, **kwargs)
        finally:
            rec["armed"] = False
        if not bool(out.failed[lane]):
            rec["out"] = _lane(out, lane)
        return out

    def minimize(cfg, fun, x0, *args, **kwargs):
        if not (rec.get("armed") and isinstance(x0, dict)):
            return real_minimize(cfg, fun, x0, *args, **kwargs)

        def first(theta):
            v = fun(theta)
            keys = sorted(theta)
            if ("x0" if v.requires_grad else "rungs") not in rec:
                held = {k: t.detach().clone() for k, t in theta.items()}
                if v.requires_grad:
                    rec["x0"] = held
                else:
                    rec["objective"], rec["rungs"] = fun, held
            rec["calls"].append(dict(
                points=torch.stack([theta[k][lane].detach() for k in keys],
                                   -1),
                values=v[lane].detach().clone()))
            if "grad0" not in rec and v.requires_grad:
                g = torch.autograd.grad(v[lane].sum(),
                                        [theta[k] for k in keys],
                                        retain_graph=True)
                rec["value0"] = v[lane, 0].detach().clone()
                rec["grad0"] = torch.stack([d[lane, 0] for d in g])
                rec["keys"] = keys
            return v
        return real_minimize(cfg, first, x0, *args, **kwargs)

    fit_module._fit_iteration_cells, fit_module._minimize = (iteration,
                                                             minimize)
    try:
        yield rec
    finally:
        fit_module._fit_iteration_cells, fit_module._minimize = (
            real_iteration, real_minimize)


def pulled_ladder(probe: dict, lane: int) -> None:
    """One more value-only call of the checked iteration's M-step
    objective, at the first ladder's shape, made after the request (so
    outside the window, the trace and the counters): every lane's rungs
    pulled toward its start by ``PULL``, which keeps them inside theta's
    box, where the objective has a finite value to compute.  On the cell
    every rung of the search itself leaves the box and reads +inf on both
    sides, so this call is what holds the ladder's computation.  Puts the
    checked lane's points and values under "ladder0"."""
    objective = probe.pop("objective", None)
    x0, rungs = probe.pop("x0", None), probe.pop("rungs", None)
    if objective is None or x0 is None or "out" not in probe:
        return
    keys = sorted(rungs)
    with torch.no_grad():
        points = {k: x0[k] + PULL * (rungs[k] - x0[k]) for k in keys}
        values = objective(points)
    probe["ladder0"] = dict(
        points=torch.stack([points[k][lane] for k in keys], -1),
        values=values[lane].clone())


def _to(tree, device):
    """A copy of the tensors of a tree of dicts on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree


def _host(t):
    return _to(t, "cpu")


def kept(thetas, results, tests, probe: dict) -> dict:
    """What the check reads of a request, on the host: the start thetas,
    each lane's final state and outputs, the probed iteration."""
    lanes = []
    for res, (rates, r2) in zip(results, tests):
        loss = float(res.track.logmarginal[-1])
        lanes.append(dict(
            theta={k: float(v) for k, v in res.theta.items()},
            f_params={k: float(v) for k, v in res.f_params.items()},
            m_b=_host(res.m_b), V_b=_host(res.V_b), B=_host(res.B),
            keep=_host(res.keep), K_tilde=_host(res.K_tilde),
            K=_host(res.K), loss=loss, rates=_host(rates), r2=float(r2),
            failed=bool(res.failed) or not math.isfinite(loss)
            or not math.isfinite(float(r2))))
    step = None
    if "out" in probe and "grad0" in probe:
        step = _host(probe)
    return dict(starts=[{k: float(v[c]) for k, v in thetas.items()}
                        for c in range(len(lanes))],
                lanes=lanes, step=step)


def setup(config: dict, traffic: dict, seed: int, device) -> Session:
    """The session, its kernels built and a population of
    ``warmup_cells`` cells fitted at ``warmup_maxiter`` EM iterations (an
    M-step included) at the cell's shapes, with its evaluations."""
    params = dict(traffic["params"])
    if (params["n_train"], params["n_px_side"], params["n_cells"]) != (
            config["nt"], config["n_px_side"], config["n_cells"]):
        raise ValueError("the traffic's recording does not have the "
                         "configuration's shape")
    cfg = FitConfig(ntilde=config["ntilde"], n_px_side=config["n_px_side"],
                    **config["fit"])
    s = Session(config, params, seed, torch.device(device), cfg,
                generator(traffic))
    warm = dict(params, n_cells=config["warmup_cells"])
    serve(s, inputs(s, WARMUP_INDEX, warm),
          dataclasses.replace(cfg, maxiter=config["warmup_maxiter"]))
    return s


def window(s: Session, seconds: float, trace: bool) -> dict:
    """Requests until their time passes ``seconds`` (and a pass over the
    mix's panel ends)."""
    done, busy, index = [], 0.0, 0
    ctx = {"requests": 0, "wall_s": 0.0, "spans": {}, "traced_launches": None,
           "traced_requests": 0}
    tracer = Tracer() if trace else None
    whole = s.gen.pass_size(s.params)
    while busy < seconds or index % whole:
        rec = inputs(s, index)
        traced = trace and index == 0
        counting = trace and not traced
        marks = {} if traced else None
        reset_launch_counts()
        if traced:
            tracer.start()
        with collect_spans() if counting else nullcontext() as spans, \
                em_probe(checked_lane(s, index)) as probe:
            t0 = clock(s.device)
            out = serve(s, rec, marks=marks)
            t1 = clock(s.device)
        if traced:
            tracer.stop()
            ctx["traced_launches"] = marks["launches"]
            ctx["traced_requests"] = 1
        elif counting:
            ctx["requests"] += 1
            ctx["wall_s"] += t1 - t0
            for k, v in spans.totals.items():
                ctx["spans"][k] = ctx["spans"].get(k, 0.0) + v
        busy += t1 - t0
        pulled_ladder(probe, checked_lane(s, index))
        done.append((index, dict(kept(*out, probe), seconds=t1 - t0)))
        del out, rec, probe
        index += 1
    lanes = [lane for _, k in done for lane in k["lanes"]]
    return {"e2e": {"fit_s": busy / len(done)}, "attempted": len(lanes),
            "failed": sum(lane["failed"] for lane in lanes), "done": done,
            "ctx": ctx, "trace": tracer.reduce() if trace else None}


def _window_of(s: Session, k: dict, lane: int):
    win = pop_ref.population_window(k["starts"], s.config["n_px_side"],
                                    s.config["fit"]["crop_margin"])
    return None if win is None else win[lane]


def reference_outputs(s: Session, rec: dict, k: dict, lane: int, dtype,
                      tf32: bool = False) -> dict:
    """The reference's outputs of one lane in ``dtype`` (the check's
    float64, or the control's float32 with TF32 products), from the
    request's inputs and the lane's final state: the Grams and the loss on
    the population's window, the test rates (their cross Gram on the whole
    frame, as ``evaluate`` takes it), r^2, and how far the final basis is
    from diagonalizing K_tilde."""
    n_px, got = s.config["n_px_side"], k["lanes"][lane]
    device = rec["x"].device
    with ref.precision(tf32):
        x = rec["x"].to(dtype)
        xt = x[rec["xtilde_idx"]]
        r = rec["rs"][lane].to(dtype)
        st = ref.State(got["theta"], got["f_params"], got["m_b"], got["V_b"],
                       got["B"], got["keep"], dtype, device)
        K_tilde, K, Kvec = ref.grams(st.theta, x, xt, n_px, shared=False,
                                     window=_window_of(s, k, lane))
        loss, terms = ref.log_marginal(st, K_tilde, K, Kvec, r, False)
        K_star, Kvec_star = ref.cross_gram(st.theta, rec["x_test"].to(dtype),
                                           xt, n_px)
        rates, _, _ = ref.predict(st, K_star, Kvec_star, terms["k"],
                                  terms["kinv"])
        r_test = rec["r_test"][lane]
        perms = ref.bootstrap_perms(r_test.shape[0], s.config["nbootstrap"],
                                    s.config["bootstrap_seed"]).to(device)
        r2 = ref.explained_variance(r_test.to(dtype), rates, perms)
        basis = ref.basis_error(st.B, st.keep, K_tilde)
    return dict(K_tilde=K_tilde, K=K, loss=float(loss), rates=rates,
                r2=float(r2), spikes=float(r.sum()), basis=float(basis))


def reference_step(s: Session, rec: dict, k: dict, lane: int, dtype,
                   tf32: bool = False) -> dict:
    """The reference's first EM iteration of lane ``lane`` in ``dtype``,
    stage by stage from the program's states (``em_probe``): the state the
    iteration started from, carried into the basis the iteration rebuilt;
    the E-step from there; the M-step (the Armijo search, its calls in
    ``calls``) from the program's E-step; the Grams on the lane's
    population window."""
    n_px, fit = s.config["n_px_side"], s.config["fit"]
    p = k["step"]
    start, end = p["in"], p["out"]
    device = rec["x"].device
    f64 = dict(dtype=torch.float64)
    trials = fit["armijo_trials"]
    with ref.precision(tf32):
        x = rec["x"].to(dtype)
        xt = x[rec["xtilde_idx"]]
        r = rec["rs"][lane].to(dtype)
        window = _window_of(s, k, lane)
        K_tilde, K, Kvec = ref.grams(start["theta"], x, xt, n_px,
                                     shared=False, window=window)
        B_in, B = start["B"].to(dtype), end["B"].to(dtype)
        m0, V0 = ref.reproject(B, B_in, start["m_b"].to(dtype),
                               start["V_b"].to(dtype))
        st = ref.State(start["theta"], start["f_params"], m0, V0, B,
                       end["keep"], dtype, device)
        m, V, logA, _ = pop_ref.estep(st, K_tilde, K, Kvec, r,
                                      fit["n_estep"], fit["n_fparamstep"],
                                      trials)
        after_e = ref.State(start["theta"], end["f_params"], end["m_b"],
                            end["V_b"], B, end["keep"], dtype, device)
        _, kinv = ref.basis_terms(after_e, K_tilde)
        calls: list = []
        theta, value, value0, grad0, loss = pop_ref.mstep(
            after_e, x, xt, r, n_px, fit["n_mstep"], trials, window, kinv,
            fit["schulz_steps"], calls)
        bases = [(B_in, start["keep"]), (B, end["keep"])]
        if tf32:
            _, vecs = torch.linalg.eigh(K_tilde)
            bases = [(vecs, keep) for _, keep in bases]
    return dict(m0=m0.to(**f64), V0=V0.to(**f64), m=m.to(**f64),
                V=V.to(**f64), logA=float(logA),
                theta={kk: float(v) for kk, v in theta.items()},
                value=float(value), value0=float(value0), loss=loss,
                grad0={kk: float(v) for kk, v in grad0.items()}, bases=bases,
                K_tilde=K_tilde, calls=calls)


def _moved_gap(got, want) -> float:
    """``fit_requests``' gap of norms of a change, | |got| - |want| | over
    |want|, and 0 where neither side moved."""
    g, w = fit_requests._norm(got), fit_requests._norm(want)
    if w == 0.0:
        return 0.0 if g == 0.0 else math.inf
    return abs(g - w) / w


def step_numbers(got: dict, want: dict, spikes: float, K_tilde) -> dict:
    """``fit_requests.step_numbers``, where a search that accepts no step
    is the program's semantics: the batched Armijo ladder's unscaled first
    step can leave every trial out of the box or uphill, so logA or theta
    may not move in an iteration on either side.  A leaf of the E-step's
    change, and the M-step's change of theta, read 0 where neither side
    moved and inf where only one did; ``mstep`` then reads as
    ``mstep_theta``."""
    out = fit_requests.step_numbers(got, want, spikes, K_tilde)
    logA0, theta0 = want["logA0"], want["theta0"]
    out["estep"] = max(
        _moved_gap(got["m"] - want["m0"], want["m"] - want["m0"]),
        _moved_gap(got["V"] - want["V0"], want["V"] - want["V0"]),
        _moved_gap(got["logA"] - logA0, want["logA"] - logA0))
    if all(want["theta"][k] == v for k, v in theta0.items()):
        out["mstep"] = out["mstep_theta"] = _moved_gap(
            [got["theta"][k] - v for k, v in theta0.items()], [0.0])
    return out


def _value_gap(got: float, want: float, spikes: float) -> float:
    """A value's gap in nats a spike: 0 where both are +inf (a trial out of
    the box or poisoned), inf where only one is finite or either is NaN."""
    if got == want == math.inf:
        return 0.0
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / spikes


def _rung_gap(got, want, start) -> float:
    """A rung's distance from the reference's over the reference's rung's
    distance from the step's start (0 where both sit at the start)."""
    far = float(torch.linalg.vector_norm(want - start))
    off = float(torch.linalg.vector_norm(got.to(want) - want))
    if far == 0.0:
        return 0.0 if off == 0.0 else math.inf
    return off / far


def search_numbers(got: list, want: list, loss, spikes: float,
                   pulled: dict = None) -> dict:
    """The M-step's search call by call: ``got`` the calls ``em_probe``
    kept (or the control's), ``want`` the float64 reference's
    (``armijo_minimize``'s record), ``loss`` the reference's objective.
    ``ladder``: the worst gap, in nats a spike, of a value the search got
    against the reference's objective at the same theta, over every rung
    of every ladder and every value-and-gradient call; ``rungs0``: the
    worst ``_rung_gap`` of the first ladder's rungs against the
    reference's (later ladders follow each side's own curvature pairs, so
    only their values are held).  All three inf where the calls or their
    rungs do not come in the reference's number and order (a call skipped,
    a rung left out).  ``ladder0``: ``ladder``'s gap over the rungs of
    ``pulled_ladder`` (``pulled``: its points and the values got there),
    inf without them."""
    if [len(c["values"]) for c in got] != [len(c["values"]) for c in want]:
        return dict.fromkeys(SEARCH_NUMBERS, math.inf)
    at: dict = {}

    def gap(calls) -> float:
        out = 0.0
        for c in calls:
            for point, v in zip(c["points"], c["values"]):
                key = tuple(point.tolist())
                if key not in at:
                    at[key] = loss(point.to(torch.float64))
                out = max(out, _value_gap(float(v), at[key], spikes))
        return out
    ladder = gap(got)
    ladder0 = math.inf if pulled is None else gap([pulled])
    first = next((i for i, w in enumerate(want) if "start" in w), None)
    rungs0 = 0.0 if first is None else max(
        _rung_gap(p, q, want[first]["start"])
        for p, q in zip(got[first]["points"], want[first]["points"]))
    return dict(ladder=ladder, rungs0=rungs0, ladder0=ladder0)


def numbers(got: dict, want: dict) -> dict:
    """A lane's final numbers: ``fit_requests.numbers``, and the basis's
    ``basis_error`` against the reference's K_tilde."""
    return dict(fit_requests.numbers(got, want), basis=want["basis"])


def check(s: Session, win: dict, control: bool = False) -> dict:
    """The worst of each number over the window's lanes and requests;
    ``control`` puts the reference in float32 with TF32 products in the
    program's place.  A request whose checked lane failed in its first EM
    iteration reads inf on the iteration's numbers."""
    out: dict = {}
    for index, k in win["done"]:
        rec = inputs(s, index)
        device = rec["x"].device
        spikes = []
        for lane, got in enumerate(k["lanes"]):
            want = reference_outputs(s, rec, k, lane, torch.float64)
            got = _to(got, device)
            if control:
                c = reference_outputs(s, rec, k, lane, torch.float32,
                                      tf32=True)
                got = dict(got, K_tilde=c["K_tilde"], K=c["K"],
                           loss=c["loss"], rates=c["rates"], r2=c["r2"])
                _, vecs = torch.linalg.eigh(c["K_tilde"])
                want = dict(want, basis=float(ref.basis_error(
                    vecs.to(torch.float64), got["keep"], want["K_tilde"])))
            worst(out, numbers(got, want))
            spikes.append(want["spikes"])
            del want, got
        lane, p = checked_lane(s, index), k["step"]
        if p is None:
            worst(out, dict.fromkeys(STEP_NUMBERS + SEARCH_NUMBERS,
                                     math.inf))
            continue
        k = dict(k, step=_to(p, device))
        p = k["step"]
        want_step = reference_step(s, rec, k, lane, torch.float64)
        want_step.update(
            logA0=float(p["in"]["f_params"]["logA"]),
            theta0={kk: float(v) for kk, v in p["in"]["theta"].items()})
        got_step = (reference_step(s, rec, k, lane, torch.float32, tf32=True)
                    if control else dict(program_step(p), calls=p["calls"]))
        worst(out, step_numbers(got_step, want_step, spikes[lane],
                                want_step["K_tilde"]))
        pulled = p.get("ladder0")
        if control and pulled is not None:
            with ref.precision(True):
                pulled = dict(pulled, values=[got_step["loss"](q)
                                              for q in pulled["points"]])
        worst(out, search_numbers(got_step["calls"], want_step["calls"],
                                  want_step["loss"], spikes[lane], pulled))
        del rec, want_step, got_step
    return out
