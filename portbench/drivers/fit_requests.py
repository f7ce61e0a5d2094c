"""Fit requests back to back: the lab's fit-then-test of one recorded cell
(one_cell_fit.ipynb:cell8), each request a new cell from the traffic's
generator.

A request is the STA init (``bench.sta_init``), ``models.fit.fit`` at the
configuration's knobs with ``ntilde`` inducing rows drawn from the seed,
and ``models.inference.evaluate`` on the test images and repeats, timed on
the host from its start to its end, closed by a device synchronize.  The
window is the sum of the requests' times; it closes after the request
that takes it past ``seconds``, so no request is cut, and with a panel of
cells in the mix only at the end of a pass over it, so every run does
the same work.  Making each
request's data, and keeping what the check reads, fall between requests
and outside the window.  ``fit_s`` is the window over the requests.

With ``trace`` the first request of the window runs under the profiler
(the device metrics), the others inside ``collect_spans``,
``objective_counts`` and the launch counters (the host metrics and the
FLOPs), whose own costs only a traced run pays.

The check holds every request of the window against the plain reference
(``portbench/reference/gp.py``) in float64, from the request's inputs:
the final state the fit returned (its Grams, loss, rates and r^2), and
the fit's first EM iteration, which the reference runs again from the
state that iteration started from (``em_probe`` keeps it, with the basis
the iteration rebuilt, what the iteration returned, and the M-step's
first value and gradient), stage by stage: its E-step from that state,
its M-step from the program's E-step (``numbers``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
from contextlib import nullcontext

import torch

from gaussian_processes_tpu_torch.bench import sta_init
from gaussian_processes_tpu_torch.config import FitConfig
from gaussian_processes_tpu_torch.models import fit as fit_module
from gaussian_processes_tpu_torch.models.fit import fit
from gaussian_processes_tpu_torch.models.inference import evaluate
from gaussian_processes_tpu_torch.optim import lbfgs as program_lbfgs
from gaussian_processes_tpu_torch.utils.tracing import (
    collect_spans, objective_counts, read_launch_counts, reset_launch_counts)

from ..reference import gp as ref
from ..trace import Tracer
from .common import clock, generator, rel_err, worst

WARMUP_INDEX = -1
CHECKED_ITERATION = 1


@dataclasses.dataclass
class Session:
    config: dict
    params: dict
    seed: int
    device: torch.device
    cfg: FitConfig
    gen: object


def inputs(s: Session, index: int) -> dict:
    """Request ``index``'s data and inducing rows."""
    cell = s.gen.make_cell(s.params, s.seed, index, s.device)
    g = torch.Generator().manual_seed(
        s.gen.stream_seed(*s.gen.cell_key(s.params, s.seed, index), 3))
    nt = cell["x"].shape[0]
    cell["xtilde_idx"] = torch.randperm(nt, generator=g)[:s.config["ntilde"]]
    return cell


def serve(s: Session, cell: dict, cfg: FitConfig = None):
    """One request: the fit and its evaluation (the program's calls)."""
    x, r = cell["x"], cell["r"]
    theta, f_params = sta_init(x, r, s.config["n_px_side"])
    res = fit(x, r, cfg or s.cfg, xtilde=x[cell["xtilde_idx"].to(x.device)],
              theta=theta, f_params=f_params)
    _, rates, r2, _ = evaluate(res, cell["x_test"], cell["r_test"],
                               nbootstrap=s.config["nbootstrap"],
                               seed=s.config["bootstrap_seed"])
    return res, rates, r2


def _snapshot(c) -> dict:
    """A copy of what an EM iteration's carry holds for the check."""
    es = c.kern.es
    return dict(theta={k: v.detach().clone() for k, v in c.theta.items()},
                f_params={k: v.detach().clone()
                          for k, v in c.f_params.items()},
                m_b=c.m_b.clone(), V_b=c.V_b.clone(), B=es.B.clone(),
                keep=es.keep.clone())


@contextlib.contextmanager
def em_probe():
    """Keeps, for the check, the state the fit's first EM iteration
    started from and the state it returned (the carry of
    ``models.fit._fit_iteration``, copied on the device), and the first
    value and gradient the M-step's L-BFGS got (its ``vg``: the graphed
    evaluation on the card).  A re-run of the fit with a wider crop window
    replaces what an earlier run kept.  Yields the dict it fills."""
    real_iteration, real_minimize = (fit_module._fit_iteration,
                                     fit_module._minimize)
    rec: dict = {}

    def iteration(i, c, *args, **kwargs):
        if i != CHECKED_ITERATION or c.failed:
            return real_iteration(i, c, *args, **kwargs)
        rec.clear()
        rec["in"], rec["armed"] = _snapshot(c), True
        try:
            out = real_iteration(i, c, *args, **kwargs)
        finally:
            rec["armed"] = False
        if not out.failed:
            rec["out"] = _snapshot(out)
        return out

    def minimize(cfg, fun, x0, *args, vg=None, **kwargs):
        if rec.get("armed") and isinstance(x0, dict) and "grad0" not in rec:
            if vg is None:
                flat0, unflatten, device = program_lbfgs._flatten(x0)
                vg = program_lbfgs._value_and_grad_fn(fun, unflatten, device,
                                                      flat0.dtype)
            inner = vg

            def vg(flat):
                v, g = inner(flat)
                if "grad0" not in rec:
                    rec["value0"], rec["grad0"] = v.clone(), g.clone()
                    rec["keys"] = sorted(x0)
                return v, g
        return real_minimize(cfg, fun, x0, *args, vg=vg, **kwargs)

    fit_module._fit_iteration, fit_module._minimize = iteration, minimize
    try:
        yield rec
    finally:
        fit_module._fit_iteration, fit_module._minimize = (real_iteration,
                                                           real_minimize)


def kept(res, rates, r2, probe: dict) -> dict:
    """What the check reads of a request: the final state and the outputs
    it judges."""
    loss = float(res.track.logmarginal[-1])
    return dict(
        theta={k: float(v) for k, v in res.theta.items()},
        f_params={k: float(v) for k, v in res.f_params.items()},
        m_b=res.m_b, V_b=res.V_b, B=res.B, keep=res.keep,
        K_tilde=res.K_tilde, K=res.K, loss=loss, rates=rates, r2=float(r2),
        step=dict(probe) if "out" in probe and "grad0" in probe else None,
        failed=bool(res.failed) or not math.isfinite(loss)
        or not math.isfinite(float(r2)))


def setup(config: dict, traffic: dict, seed: int, device) -> Session:
    """The session, its kernels built and a fit of ``warmup_maxiter`` EM
    iterations at the cell's shapes run (with its evaluation)."""
    params = dict(traffic["params"])
    if params["n_train"] != config["nt"] or \
            params["n_px_side"] != config["n_px_side"]:
        raise ValueError("the traffic's images do not have the "
                         "configuration's shape")
    cfg = FitConfig(ntilde=config["ntilde"], n_px_side=config["n_px_side"],
                    **config["fit"])
    s = Session(config, params, seed, torch.device(device), cfg,
                generator(traffic))
    warm = dataclasses.replace(cfg, maxiter=config["warmup_maxiter"])
    serve(s, inputs(s, WARMUP_INDEX), warm)
    return s


def window(s: Session, seconds: float, trace: bool) -> dict:
    """Requests until their time passes ``seconds`` and a pass over the
    mix's panel ends."""
    done, busy, index = [], 0.0, 0
    ctx = {"requests": 0, "wall_s": 0.0, "spans": {}, "evals": {},
           "launches": None, "traced_evals": None, "traced_launches": None,
           "traced_requests": 0}
    tracer = Tracer() if trace else None
    whole = s.gen.pass_size(s.params)
    while busy < seconds or index % whole:
        cell = inputs(s, index)
        traced = trace and index == 0
        counting = trace and not traced
        reset_launch_counts()
        if traced:
            tracer.start()
        with objective_counts() if trace else nullcontext() as evals, \
                collect_spans() if counting else nullcontext() as spans, \
                em_probe() as probe:
            t0 = clock(s.device)
            res, rates, r2 = serve(s, cell)
            t1 = clock(s.device)
        if traced:
            tracer.stop()
            ctx["traced_evals"] = dict(evals)
            ctx["traced_launches"] = read_launch_counts()
            ctx["traced_requests"] = 1
        elif counting:
            ctx["requests"] += 1
            ctx["wall_s"] += t1 - t0
            _add(ctx["evals"], evals)
            for k, v in spans.totals.items():
                ctx["spans"][k] = ctx["spans"].get(k, 0.0) + v
            ctx["launches"] = _add_launches(ctx["launches"],
                                            read_launch_counts())
        busy += t1 - t0
        done.append((index, dict(kept(res, rates, r2, probe),
                                 seconds=t1 - t0)))
        del res, rates, cell
        index += 1
    return {"e2e": {"fit_s": busy / len(done)}, "attempted": len(done),
            "failed": sum(k["failed"] for _, k in done), "done": done,
            "ctx": ctx, "trace": tracer.reduce() if trace else None}


def _add(acc: dict, counts: dict) -> None:
    for k, v in counts.items():
        acc[k] = acc.get(k, 0) + v


def _add_launches(acc, new: dict) -> dict:
    if acc is None:
        return new
    for key in ("shapes", "product_shapes", "bwd_shapes"):
        for shape, c in new[key].items():
            acc[key][shape] = acc[key].get(shape, 0) + c
    return acc


def reference_outputs(s: Session, cell: dict, k: dict, dtype, tf32=False):
    """The reference's outputs of one request in ``dtype`` (the check's
    float64, or the control's float32 with TF32 products), from its
    inputs and the fit's final state."""
    n_px = s.config["n_px_side"]
    with ref.precision(tf32):
        x = cell["x"].to(dtype)
        xt = x[cell["xtilde_idx"].to(x.device)]
        r = cell["r"].to(dtype)
        st = ref.State(k["theta"], k["f_params"], k["m_b"], k["V_b"], k["B"],
                       k["keep"], dtype, x.device)
        K_tilde, K, Kvec = ref.grams(st.theta, x, xt, n_px, shared=False)
        loss, terms = ref.log_marginal(st, K_tilde, K, Kvec, r, False)
        K_star, Kvec_star = ref.cross_gram(st.theta, cell["x_test"].to(dtype),
                                           xt, n_px)
        rates, _, _ = ref.predict(st, K_star, Kvec_star, terms["k"],
                                  terms["kinv"])
        perms = ref.bootstrap_perms(cell["r_test"].shape[0],
                                    s.config["nbootstrap"],
                                    s.config["bootstrap_seed"]).to(x.device)
        r2 = ref.explained_variance(cell["r_test"].to(dtype), rates, perms)
    return dict(K_tilde=K_tilde, K=K, loss=float(loss), rates=rates,
                r2=float(r2), spikes=float(r.sum()))


def reference_step(s: Session, cell: dict, p: dict, dtype, tf32=False):
    """The reference's first EM iteration of one request in ``dtype``,
    stage by stage from the program's states in ``p`` (``em_probe``): the
    state the iteration started from, carried into the basis the
    iteration rebuilt; the E-step from there; the M-step from the
    program's E-step; the Grams on the crop window the configuration
    takes at the iteration's start.  Also how far each basis is from diagonalizing
    K_tilde: the program's two (``p``), or, for the control, the top
    eigenvectors of its own K_tilde at the same rank."""
    n_px, fit_cfg = s.config["n_px_side"], s.config["fit"]
    start, end = p["in"], p["out"]
    f64 = dict(dtype=torch.float64)
    with ref.precision(tf32):
        x = cell["x"].to(dtype)
        xt = x[cell["xtilde_idx"].to(x.device)]
        r = cell["r"].to(dtype)
        window = (ref.crop_window(start["theta"], n_px,
                                  fit_cfg["crop_margin"])
                  if fit_cfg.get("crop_window", True) else None)
        K_tilde, K, Kvec = ref.grams(start["theta"], x, xt, n_px,
                                     shared=False, window=window)
        B_in, B = start["B"].to(dtype), end["B"].to(dtype)
        m0, V0 = ref.reproject(B, B_in, start["m_b"].to(dtype),
                               start["V_b"].to(dtype))
        st = ref.State(start["theta"], start["f_params"], m0, V0, B,
                       end["keep"], dtype, x.device)
        m, V, logA = ref.estep(st, K_tilde, K, Kvec, r, fit_cfg["n_estep"])
        after_e = ref.State(start["theta"], end["f_params"], end["m_b"],
                            end["V_b"], B, end["keep"], dtype, x.device)
        theta, value, value0, grad0, loss = ref.mstep(
            after_e, x, xt, r, n_px, fit_cfg["n_mstep"],
            fit_cfg["max_linesearch_steps"], window)
        bases = [(B_in, start["keep"]), (B, end["keep"])]
        if tf32:
            _, vecs = torch.linalg.eigh(K_tilde)
            bases = [(vecs[:, -b.shape[1]:], keep) for b, keep in bases]
    return dict(m0=m0.to(**f64), V0=V0.to(**f64), m=m.to(**f64),
                V=V.to(**f64), logA=float(logA),
                theta={k: float(v) for k, v in theta.items()},
                value=float(value), value0=float(value0), loss=loss,
                grad0={k: float(v) for k, v in grad0.items()}, bases=bases,
                K_tilde=K_tilde)


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(t,
                                                          dtype=torch.float64)))


def _gap(got: dict, want: dict) -> float:
    """The worst leaf's gap of norms: | |got| - |want| | over the larger of
    the reference's norm of that leaf and of the median leaf."""
    norms = {k: _norm(v) for k, v in want.items()}
    floor = statistics.median(norms.values())
    return max(abs(_norm(got[k]) - n) / max(n, floor) if max(n, floor) > 0
               else math.inf for k, n in norms.items())


def step_numbers(got: dict, want: dict, spikes: float, K_tilde) -> dict:
    """The first EM iteration's numbers: the E-step's change of m_b, V_b
    and logA by the worst leaf's gap of norms (its own norm the floor of
    each leaf); the M-step's loss, as the share of the reference's
    decrease that the reference's objective at the M-step's theta falls
    short of (or goes past) its own; the M-step's first gradient by the
    worst leaf's gap of norms (the median leaf's the floor) and its first
    value's gap in nats a spike; the largest ``basis_error`` of the bases
    against the float64 K_tilde at the iteration's theta.  Also, read and
    not compared (PERF.md section 2), the M-step's change of theta by the
    worst leaf's gap of norms (``mstep_theta``)."""
    def change(side, base):
        return {"m_b": side["m"] - want["m0"], "V_b": side["V"] - want["V0"],
                "logA": side["logA"] - base}
    logA0 = want["logA0"]
    estep = max(_gap({k: v}, {k: w}) for (k, v), w in zip(
        change(got, logA0).items(), change(want, logA0).values()))
    theta0 = want["theta0"]
    return {
        "estep": estep,
        "mstep": _shortfall(want["loss"](got["theta"]), want["value"],
                            want["value0"]),
        "mstep_theta": _gap(
            {k: got["theta"][k] - theta0[k] for k in theta0},
            {k: want["theta"][k] - theta0[k] for k in theta0}),
        "grad0": _gap(got["grad0"], want["grad0"]),
        "value0": abs(got["value0"] - want["value0"]) / spikes,
        "basis": max(float(ref.basis_error(b.to(K_tilde.dtype),
                                           keep.to(K_tilde.device),
                                           K_tilde))
                     for b, keep in got["bases"])}


def _shortfall(got: float, want: float, start: float) -> float:
    """|got - want| over the decrease start - want (inf without one)."""
    drop = start - want
    return abs(got - want) / drop if drop > 0 else math.inf


def program_step(p: dict) -> dict:
    """The program's side of ``step_numbers`` from what ``em_probe`` kept."""
    end = p["out"]
    f64 = dict(dtype=torch.float64)
    return dict(m=end["m_b"].to(**f64), V=end["V_b"].to(**f64),
                logA=float(end["f_params"]["logA"]),
                theta={k: float(v) for k, v in end["theta"].items()},
                value0=float(p["value0"]),
                grad0={k: float(v) for k, v in zip(p["keys"], p["grad0"])},
                bases=[(p["in"]["B"], p["in"]["keep"]),
                       (end["B"], end["keep"])])


def numbers(got: dict, want: dict) -> dict:
    """The final state's numbers: the Grams' and the test rates' relative
    error, the final loss's gap in nats a spike (a relative gap swings
    with a loss near 0), the gap of r^2."""
    return {"gram": max(rel_err(got["K_tilde"], want["K_tilde"]),
                        rel_err(got["K"], want["K"])),
            "rates": rel_err(got["rates"], want["rates"]),
            "loss": abs(got["loss"] - want["loss"]) / want["spikes"],
            "r2": abs(got["r2"] - want["r2"])}


STEP_NUMBERS = ("estep", "mstep", "grad0", "value0", "basis",
                "mstep_theta")


def check(s: Session, win: dict, control: bool = False) -> dict:
    """The worst of each number over the window's requests; ``control``
    puts the reference in float32 with TF32 products in the program's
    place.  A request whose first EM iteration was not kept (the fit
    failed in it) reads inf on the iteration's numbers."""
    out: dict = {}
    for index, k in win["done"]:
        cell = inputs(s, index)
        want = reference_outputs(s, cell, k, torch.float64)
        got = k
        if control:
            c = reference_outputs(s, cell, k, torch.float32, tf32=True)
            got = dict(k, K_tilde=c["K_tilde"], K=c["K"], loss=c["loss"],
                       rates=c["rates"], r2=c["r2"])
        worst(out, numbers(got, want))
        p = k["step"]
        if p is None:
            worst(out, dict.fromkeys(STEP_NUMBERS, math.inf))
            continue
        want_step = reference_step(s, cell, p, torch.float64)
        want_step.update(
            logA0=float(p["in"]["f_params"]["logA"]),
            theta0={kk: float(v) for kk, v in p["in"]["theta"].items()})
        got_step = (reference_step(s, cell, p, torch.float32, tf32=True)
                    if control else program_step(p))
        worst(out, step_numbers(got_step, want_step, want["spikes"],
                                want_step["K_tilde"]))
        del cell, want, want_step, got_step
    return out
