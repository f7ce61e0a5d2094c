"""The port's tracing inside the fit (``utils/tracing``): the graphed
M-step's spans (``fit.mstep.eval``, ``fit.mstep.warmup``,
``fit.mstep.capture`` under ``fit.mstep``), the counters ``collect_spans``
gathers beside them (the E-step's ``host_reads.<site>``), nothing
counted outside it, the population program's spans and chunk counters
(``grams.chunks``, ``grams.items``), and the benchmark's readers of them
(``portbench/metrics``).

On the CPU the graph's eager twin (``graph=False``) stands in for the
graph: it takes the graph's path and spans.  The device time of a replay
is a card test (``tests/test_torch_cuda.py``).  Imports torch, numpy and
the port only.
"""

import functools
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_processes_tpu_torch.config import FitConfig
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.optim.graphed import GraphedValueAndGrad
from gaussian_processes_tpu_torch.utils import tracing
from portbench.run import load_module

torch.set_num_threads(1)

N, NT, NTILDE = 24, 200, 48
THETA0 = {"sigma_0": 1.0, "eps_0x": 0.0001, "eps_0y": 0.0001,
          "-2log2beta": -2 * np.log(2 * 0.1),
          "-log2rho2": -np.log(2 * 0.1 ** 2), "Amp": 1.0}
FP0 = {"logA": np.log(0.01), "lambda0": 1.0}
# JAX's warm solvers: the E-step's Newton-Schulz guard is read on the host
WARM = dict(reduced_rank=True, eigensolver="subspace", eigh_refresh_every=2,
            estep_solver="schulz", mstep_inverse="schulz",
            mstep_logdet="series", rank_bucket=8, rank_pad=4,
            n_fparamstep=3, n_px_side=N, crop_bucket=4)
MSTEP_SPANS = ("fit.mstep.eval", "fit.mstep.warmup", "fit.mstep.capture")
METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((NT, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2)).ravel()
    r = rng.poisson(np.exp(0.6 * x @ (w / np.linalg.norm(w)))).astype(float)
    return dict(x=torch.as_tensor(x), r=torch.as_tensor(r),
                idx=torch.as_tensor(rng.permutation(NT)[:NTILDE]))


@pytest.fixture
def twin(monkeypatch):
    """The fit's M-step on the graph route, served by the graph's eager
    twin."""
    monkeypatch.setattr(tf, "_mstep_graph_route", lambda x, cfg, rows: True)
    monkeypatch.setattr(tf, "GraphedValueAndGrad",
                        functools.partial(GraphedValueAndGrad, graph=False))


def _fit(d, **knobs):
    cfg = FitConfig(ntilde=NTILDE, **dict(WARM, **knobs))
    return tf.fit(d["x"], d["r"], cfg, xtilde=d["x"][d["idx"]], theta=THETA0,
                  f_params=FP0)


@pytest.mark.parametrize("knobs", [
    dict(maxiter=4, n_estep=3, n_mstep=3),
    dict(maxiter=3, n_estep=5, n_mstep=2),
    dict(maxiter=4, n_estep=4, n_mstep=3, estep_tol=0.5)])
def test_host_reads_are_counted_at_each_site(data, twin, knobs):
    """Every E-step host read of a small schulz fit under its site: the
    Newton-Schulz guard at each Newton step after an E-step's first,
    (n_estep - 1) x (maxiter - 1) without the early stop (iteration 0 is
    the init, which runs no E-step), and the early stop's read at every
    Newton step with it (0 without it); no other site is counted."""
    tracing.decisions.clear()
    with tracing.objective_counts() as evals, \
            tracing.collect_spans() as spans:
        res = _fit(data, **knobs)
    assert not res.failed
    reads = {k[len("host_reads."):]: v for k, v in spans.totals.items()
             if k.startswith("host_reads.")}
    iters, steps = knobs["maxiter"] - 1, evals["newton"]
    if knobs.get("estep_tol"):
        assert steps < iters * knobs["n_estep"]       # it stopped early
        assert reads == {"estep.schulz": steps - iters,
                         "estep.early_stop": steps}
    else:
        assert steps == iters * knobs["n_estep"]
        assert reads == {"estep.schulz": iters * (knobs["n_estep"] - 1),
                         "estep.early_stop": 0}
    decided = tracing.decisions["estep.schulz"] + \
        tracing.decisions["estep.exact"]
    assert reads["estep.schulz"] == decided


def test_mstep_spans_nest_under_fit_mstep(data, twin):
    """In a ``collect_spans`` timer and in a profiler trace: every
    evaluation the twin serves is a ``fit.mstep.eval`` span, every key's
    first call a ``fit.mstep.warmup`` span and a ``fit.mstep.capture`` span
    after it, each directly inside a ``fit.mstep`` span; the warm-up and
    the capture are siblings."""
    with tracing.objective_counts() as evals, \
            tracing.collect_spans() as spans:
        _fit(data, maxiter=4, n_estep=2, n_mstep=3)
    c, t = spans.counts, spans.totals
    assert c["fit.mstep.eval"] + c["fit.mstep.warmup"] == evals["mstep"]
    assert c["fit.mstep.capture"] == c["fit.mstep.warmup"] >= 1
    assert t["fit.mstep"] >= sum(t[k] for k in MSTEP_SPANS)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(data, maxiter=4, n_estep=2, n_mstep=3)
    events = [e for e in prof.events() if e.name.startswith("fit.mstep")]
    by_name = {name: [e for e in events if e.name == name]
               for name in ("fit.mstep",) + MSTEP_SPANS}
    assert [len(by_name[k]) for k in ("fit.mstep",) + MSTEP_SPANS] == \
        [c["fit.mstep"]] + [c[k] for k in MSTEP_SPANS]
    for name in MSTEP_SPANS:
        for e in by_name[name]:
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == "fit.mstep", name
    for warm, cap in zip(by_name["fit.mstep.warmup"],
                         by_name["fit.mstep.capture"]):
        assert warm.cpu_parent is cap.cpu_parent
        assert warm.time_range.end <= cap.time_range.start


def test_nothing_is_counted_outside_collect_spans(data, twin, monkeypatch):
    """Outside ``collect_spans`` no timer is handed a span or a counter,
    and no CUDA event is made."""
    added = []
    monkeypatch.setattr(tracing.PhaseTimer, "add",
                        lambda self, name, amount=1: added.append(name))

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event outside collect_spans")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with tracing.objective_counts() as evals:
        _fit(data, maxiter=3, n_estep=3, n_mstep=2)
    assert evals["mstep"] > 0 and added == []
    tracing.host_read("estep.schulz")
    with tracing.trace_annotation("fit.mstep.eval"):
        pass
    assert added == []
    with tracing.collect_spans():
        tracing.host_read("estep.schulz")
    # the host-read sites and the population's counters start at 0 inside
    # collect_spans
    assert added == ["host_reads." + site for site in tracing.HOST_READ_SITES
                     ] + ["grams.chunks", "grams.items",
                          "host_reads.estep.schulz"]


def test_phase_timer_adds_counters_beside_spans():
    """Counters sit in ``totals`` beside the spans' seconds, each host-read
    site from 0; ``counts`` and ``summary`` hold the spans alone."""
    timer = tracing.PhaseTimer()
    with tracing.collect_spans(timer):
        with tracing.trace_annotation("fit.estep"):
            tracing.host_read("estep.schulz")
            tracing.host_read("estep.schulz")
        timer.add("mstep.replay_device", 0.25)
    assert timer.totals["host_reads.estep.schulz"] == 2
    assert timer.totals["host_reads.estep.early_stop"] == 0
    assert timer.totals["mstep.replay_device"] == 0.25
    assert timer.counts == {"fit.estep": 1} and timer.totals["fit.estep"] >= 0
    lines = timer.summary().splitlines()
    assert len(lines) == 1 and "fit.estep" in lines[0]
    assert "1 calls" in lines[0]
    assert tracing.span_timer() is None


def _ctx(**spans):
    return {"requests": 4, "evals": {"mstep": 400}, "spans": spans}


FULL = {"fit.mstep": 8.0, "fit.mstep.eval": 4.8, "fit.mstep.warmup": 0.4,
        "fit.mstep.capture": 0.8, "mstep.replay_device": 3.0,
        "mstep.replays": 300.0, "host_reads.estep.schulz": 1044.0,
        "host_reads.estep.early_stop": 8.0}


@pytest.mark.parametrize("metric,want,needs", [
    ("mstep.replay_device_ms", 10.0, ("mstep.replays",
                                      "mstep.replay_device")),
    ("mstep.optimizer_host_ms", 5.0, ("fit.mstep", "fit.mstep.eval",
                                      "fit.mstep.warmup",
                                      "fit.mstep.capture")),
    ("mstep.capture_s_per_fit", 0.3, ("fit.mstep.warmup",
                                      "fit.mstep.capture")),
    ("estep.host_reads_per_fit", 263.0, ("host_reads.estep.",))])
def test_readers_of_the_new_spans_and_counters(metric, want, needs):
    """Each reader from a synthetic ``ctx`` of 4 counted requests, and
    None without what it reads (the parent program's ``ctx``, or a run
    without ``--trace 1``)."""
    read = load_module(METRICS / f"{metric}.py").read
    assert read(_ctx(**FULL)) == pytest.approx(want, rel=1e-12)
    for key in needs:
        assert read(_ctx(**{k: v for k, v in FULL.items()
                            if not k.startswith(key)})) is None, key
    assert read({}) is None


def test_host_reads_per_fit_reads_zero_where_the_estep_reads_nothing(
        data):
    """A program that counts host reads and reads nothing in the E-step
    (the Cholesky E-step) reads 0, not nothing: ``collect_spans`` starts
    each site at 0."""
    with tracing.collect_spans() as spans:
        res = _fit(data, maxiter=3, n_estep=3, n_mstep=2,
                   estep_solver="chol")
    assert not res.failed
    read = load_module(METRICS / "estep.host_reads_per_fit.py").read
    assert read(_ctx(**spans.totals)) == 0.0


POP_SPANS = ("fit.init", "fit.iteration", "fit.kernel_state", "fit.estep",
             "fit.estep.newton", "fit.estep.fparams", "fit.mstep",
             "fit.mstep.ladder", "fit.mstep.grad", "fit.finalize")


def test_population_spans_and_chunk_counters(monkeypatch):
    """``collect_spans`` around a small population fit sees every span of
    the population program, each as often as the program enters it, and
    counts its chunks of Grams as ``max_items`` (here 2) cuts them: the
    kernel states of every cell (init and each iteration), each ladder of
    cells x trials items, each value-and-gradient call in chunks of
    ``max_items // GRAD_CHUNK_DIVISOR``.  Outside it nothing is counted; a
    profiler trace holds the same spans."""
    from gaussian_processes_tpu_torch.parallel import population as tpop
    rng = np.random.default_rng(2)
    n, nt, ncells = 12, 40, 3
    x = torch.as_tensor(rng.standard_normal((nt, n * n)))
    rs = torch.as_tensor(rng.poisson(1.0, (ncells, nt)).astype(float))
    steps = dict(maxiter=3, n_estep=2, n_mstep=3, n_fparamstep=2)
    cfg = FitConfig(ntilde=16, n_px_side=n, linesearch="armijo",
                    armijo_trials=4, **steps)
    monkeypatch.setattr(tpop, "ladder_items", lambda *args: 2)

    def fit():
        return tpop.fit_population(x, rs, cfg, xtilde=x[:16], thetas=THETA0,
                                   f_params=FP0, device="cpu")
    with tracing.collect_spans() as spans:
        fit()
    iters, msteps = steps["maxiter"] - 1, steps["maxiter"] - 2
    want = {"fit.init": 1, "fit.iteration": iters,
            "fit.kernel_state": steps["maxiter"], "fit.estep": iters,
            "fit.estep.newton": steps["n_estep"] * iters,
            "fit.estep.fparams": steps["n_estep"] * iters,
            "fit.mstep": msteps,
            "fit.mstep.ladder": steps["n_mstep"] * msteps,
            "fit.mstep.grad": (steps["n_mstep"] + 1) * msteps,
            "fit.finalize": 1}
    assert {k: spans.counts[k] for k in POP_SPANS} == want
    grad_items = 2 // tf.GRAD_CHUNK_DIVISOR
    states = steps["maxiter"] * math.ceil(ncells / 2)
    ladders = steps["n_mstep"] * msteps * math.ceil(ncells * 4 / 2)
    grads = want["fit.mstep.grad"] * math.ceil(ncells / grad_items)
    assert spans.totals["grams.chunks"] == states + ladders + grads
    assert spans.totals["grams.items"] == ncells * (
        steps["maxiter"] + want["fit.mstep.grad"]
        + 4 * want["fit.mstep.ladder"])

    added = []
    monkeypatch.setattr(tracing.PhaseTimer, "add",
                        lambda self, name, amount=1: added.append(name))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fit()
    assert added == []
    names = {e.name for e in prof.events()}
    assert set(POP_SPANS) <= names
