"""Tracing and profiling: phase timers, spans and counters
(counterpart of ``gaussian_processes_tpu/utils/tracing.py``).

The reference instruments varGP with ``time.time()`` accumulators per phase
(E-step / f-params / M-step / kernels / loss) printed at the end
(Spatial_GP_repo/utils.py:1760-1766, 2252-2261).  Here:

* ``PhaseTimer``: host wall-clock per named phase; ``sync=`` synchronizes
  the CUDA device of the given tensors before the clock stops (PyTorch
  returns before the card has finished); ``add`` accumulates a counter
  into the same ``totals`` (so ``totals`` mixes seconds and counts;
  ``counts`` and ``summary`` hold the timed phases alone);
* ``fit(..., profile=True)``: per-iteration seconds and rank budgets in
  ``FitResult.timing``;
* ``trace_annotation``: a named span in ``torch.profiler`` traces
  (``torch.profiler.record_function``); the fit marks its layers with
  them (``fit.init``, ``fit.iteration``, ``fit.kernel_state``,
  ``fit.estep`` with ``fit.estep.newton`` and ``fit.estep.fparams``,
  ``fit.mstep``, ``fit.finalize``; the population's program the same).
  Each call of the cell-batched M-step objective (``models/fit.
  _mstep_objective_cells``: the population's Armijo search, the
  single-cell ladder) is a ``fit.mstep.grad`` span under autograd, else a
  ``fit.mstep.ladder`` span.  Inside the single-cell fit's
  ``fit.mstep`` the graphed
  evaluator (``optim/graphed``) marks each evaluation it serves
  (``fit.mstep.eval``: the copy in, the replay or its eager twin, the
  wait, the copy out) and, at the first call of a key, the eager warm-up
  (``fit.mstep.warmup``) and the CUDA graph capture
  (``fit.mstep.capture``), two siblings; what is left of ``fit.mstep``
  is the L-BFGS's own host code (``optim/lbfgs``);
* ``collect_spans``: the same spans' host wall-clock into a
  ``PhaseTimer`` without a profiler, for the code run inside it, and the
  counters added there: ``mstep.replays`` and ``mstep.replay_device``
  (seconds between a CUDA event pair around each graph replay, read after
  the replay's own wait), and ``host_reads.<site>``, one for each time
  the E-step reads a value of the fit on the host (``host_read``; on the
  card a read waits for the device's queue to drain) at the sites of
  ``HOST_READ_SITES``: the Newton-Schulz guard (``estep.schulz``,
  ``models/estep``) and the early stop under ``estep_tol``
  (``estep.early_stop``, ``models/fit``).  The fit's other host reads are
  not counted.  The population's program (``models/fit.
  fit_cells_program``) counts its chunks of Grams (``grams.chunks``) and
  the items in them (``grams.items``).  Outside ``collect_spans`` nothing
  is counted and no CUDA event is recorded;
* ``objective_counts``: the evaluations of the fit's two inner objectives
  (the E-step's f-param L-BFGS and the M-step's, CUDA graph replays
  included) and its Newton steps while a block runs;
* ``reset_launch_counts`` / ``read_launch_counts``: every hand-written
  kernel's launch counts at once; ``launches_held_out`` /
  ``credit_launches``: what a CUDA graph capture counted (and did not
  launch) taken off them, and added back at each replay
  (``optim/graphed``);
* ``decisions``: the decisions of the warm solvers and the projected
  Gram, counted where the host already reads their guard (no added
  synchronization): ``eigensolver.warm`` / ``.refresh`` / ``.fallback``
  per reduced-rank kernel rebuild, ``estep.schulz`` / ``.exact`` per
  warm-started Newton step (items of a batch), ``mstep.projected`` /
  ``.exact_gram`` per projected Gram under ``mstep_proj_fallback="exact"``
  (items), and the legacy f-param Newton update's stop test,
  ``fparams_newton.stop`` / ``.step`` per iteration
  (``models/estep.update_f_params_newton``).  The M-step's two guards are
  decided on the device, with no host read (``mstep.schulz`` / ``.exact``
  per M-step inverse under ``schulz_fallback="exact"``, ``mstep.series`` /
  ``.chol`` per series log-determinant): ``decisions.count_on_device``
  adds them to a counter on the guard's device, and ``decisions.fold()``
  adds those counters to the host counts with one read a device (the fits
  fold when they end).  ``decisions.clear()`` sets both to 0.

The fit's phase split comes from its spans (``collect_spans``, or a
profiler trace), from one fit.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import contextvars
import time
from typing import Dict, Optional, Tuple

import torch

class Decisions(collections.Counter):
    """The solvers' decisions by name (see the module docstring), with the
    counts of the guards decided on the device kept there until
    ``fold``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # (device, passed, failed) -> int64 (2,): items passed, failed
        self._on_device: Dict[Tuple[torch.device, str, str],
                              torch.Tensor] = {}

    def count_on_device(self, ok: torch.Tensor, passed: str,
                        failed: str) -> None:
        """Count the items of the bool tensor ``ok`` that hold under
        ``passed`` and the rest under ``failed``, on ok's device: queued
        work, no host read.  A CUDA graph that captures this call counts at
        each replay; its first call for a device and name pair must come
        before the capture (the counter is allocated then)."""
        key = (ok.device, passed, failed)
        counts = self._on_device.get(key)
        if counts is None:
            counts = torch.zeros(2, dtype=torch.int64, device=ok.device)
            self._on_device[key] = counts
        n_ok = ok.sum()
        counts.add_(torch.stack([n_ok, ok.numel() - n_ok]))

    def fold(self) -> None:
        """Add the device counters to the host counts and set them to 0:
        one host read for each device that holds counters."""
        by_device: Dict[torch.device, list] = {}
        for (device, passed, failed), counts in self._on_device.items():
            by_device.setdefault(device, []).append((passed, failed, counts))
        for entries in by_device.values():
            values = torch.stack([c for _, _, c in entries]).tolist()
            for (passed, failed, counts), (n_ok, n_fail) in zip(entries,
                                                                values):
                if n_ok + n_fail:
                    self[passed] += n_ok
                    self[failed] += n_fail
                    counts.zero_()

    def clear(self) -> None:
        """Set every count to 0, on the host and on the devices."""
        super().clear()
        for counts in self._on_device.values():
            counts.zero_()


# the decisions of the warm solvers and the projected Gram since import (or
# since the caller cleared it), by name (see the module docstring)
decisions = Decisions()


def read_guard(ok: torch.Tensor, passed: str, failed: str) -> int:
    """How many items of the bool tensor ``ok`` (0-d, or one per item of a
    batch) hold, read on the host -- one synchronization -- and counted in
    ``decisions`` under ``passed`` and, for the rest, ``failed``."""
    n_ok = int(ok.sum())
    decisions[passed] += n_ok
    decisions[failed] += ok.numel() - n_ok
    return n_ok


def _synchronize(sync) -> None:
    """Wait for the CUDA devices of ``sync`` (a tensor or a sequence of
    them) to finish their queued work; CPU tensors need no wait."""
    tensors = [sync] if isinstance(sync, torch.Tensor) else list(sync)
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name.  ``totals``
    also holds the counters that ``add`` accumulates beside the phases'
    seconds; ``counts`` (calls) and ``summary`` hold the phases alone."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, name: str, amount: float = 1) -> None:
        """Add ``amount`` to the counter ``name`` in ``totals`` (beside
        the phases' seconds; not a phase, so not in ``counts``)."""
        self.totals[name] = self.totals.get(name, 0.0) + amount

    def summary(self) -> str:
        """The phases (not the counters), largest total first."""
        lines = []
        for name, n in sorted(self.counts.items(),
                              key=lambda kv: -self.totals[kv[0]]):
            total = self.totals[name]
            lines.append(f"  {name:<24} {total:8.3f}s  "
                         f"({n} calls, {total / n * 1000:8.2f} ms/call)")
        return "\n".join(lines)

    def print_summary(self, header: str = "Phase timing:"):
        print(header)
        print(self.summary())


# the PhaseTimer that ``collect_spans`` installed for this context, if any
_span_timer: contextvars.ContextVar = contextvars.ContextVar(
    "span_timer", default=None)


def span_timer() -> Optional[PhaseTimer]:
    """The ``PhaseTimer`` that ``collect_spans`` installed for this
    context, or None outside it."""
    return _span_timer.get()


# the host reads that ``host_read`` counts: the E-step's (the module
# docstring)
HOST_READ_SITES = ("estep.schulz", "estep.early_stop")
# the counters that start at 0 in a ``collect_spans`` timer, so that a fit
# that counts none of them reads 0: the host reads and the population's
# chunks of Grams
ZERO_COUNTERS = tuple("host_reads." + site for site in HOST_READ_SITES) + (
    "grams.chunks", "grams.items")


def count(name: str, amount: float = 1) -> None:
    """Inside ``collect_spans``, add ``amount`` to the counter ``name``;
    outside it, nothing."""
    timer = _span_timer.get()
    if timer is not None:
        timer.add(name, amount)


def host_read(site: str) -> None:
    """Inside ``collect_spans``, count one host read of a value of the fit
    at ``site``, one of ``HOST_READ_SITES`` (``host_reads.<site>``);
    outside it, nothing."""
    count("host_reads." + site)


@contextlib.contextmanager
def trace_annotation(name: str):
    """Label a region in ``torch.profiler`` traces; inside
    ``collect_spans`` also add its host wall-clock to that timer."""
    timer = _span_timer.get()
    with torch.profiler.record_function(name):
        if timer is None:
            yield
        else:
            with timer.phase(name):
                yield


@contextlib.contextmanager
def collect_spans(timer: Optional[PhaseTimer] = None):
    """Time every ``trace_annotation`` span entered inside the block on
    the host clock (no device synchronize: a span that queues device work
    without waiting for it hands that time to a later one) and yield the
    ``PhaseTimer`` that holds the totals, with the counters added inside
    the block (the module docstring)."""
    timer = PhaseTimer() if timer is None else timer
    for name in ZERO_COUNTERS:
        timer.add(name, 0)
    token = _span_timer.set(timer)
    try:
        yield timer
    finally:
        _span_timer.reset(token)


def reset_launch_counts() -> None:
    """Set every kernel's launch counts to 0: the Gram's
    (``ops/gram_cuda``) and the f-param search's (``ops/fparam_search``)."""
    from ..ops import fparam_search, gram_cuda
    gram_cuda.reset_counts()
    fparam_search.reset_counts()


def read_launch_counts() -> dict:
    """``gram_cuda.read_counts()`` with the f-param search kernel's
    launches under "fparam"."""
    from ..ops import fparam_search, gram_cuda
    return dict(gram_cuda.read_counts(), fparam=fparam_search.launches)


def _launch_counters() -> Dict[tuple, object]:
    """Every launch counter of the kernels' wrappers by (module, name), a
    copy of its value."""
    from ..ops import fparam_search, gram_cuda
    names = {gram_cuda: ("launches", "batched_launches", "items",
                         "split_launches", "bwd_launches", "split_t_launches",
                         "product_launches", "plain_bwd_cuda",
                         "shape_launches", "bwd_shapes", "split_t_shapes",
                         "product_shapes"),
             fparam_search: ("launches",)}
    return {(mod, name): copy.copy(getattr(mod, name))
            for mod, counters in names.items() for name in counters}


def credit_launches(held: dict, times: int = 1) -> None:
    """Add ``times`` x the counts ``held`` (``launches_held_out``'s) to
    the kernels' launch counters."""
    for (mod, name), delta in held.items():
        value = getattr(mod, name)
        if isinstance(value, collections.Counter):
            for key, n in delta.items():
                value[key] += times * n
                if not value[key]:
                    del value[key]
        else:
            setattr(mod, name, value + times * delta)


@contextlib.contextmanager
def launches_held_out():
    """Yields a dict that holds, when the block ends, the launch counts its
    kernels' wrappers added, which are taken off the counters: a CUDA graph
    capture calls the wrappers and launches nothing.  Each replay of the
    graph launches them all, and ``credit_launches`` adds them then."""
    before = _launch_counters()
    held: dict = {}
    try:
        yield held
    finally:
        for key, now in _launch_counters().items():
            delta = now - before[key]
            if delta:
                held[key] = delta
        credit_launches(held, -1)


@contextlib.contextmanager
def objective_counts(ladders: Optional[list] = None):
    """Evaluations of the fit's two inner objectives (the E-step's f-param
    L-BFGS and the M-step's) while the block runs: the host-bound work.
    The batched ladder calls of the speculative and Armijo searches are
    counted apart, with the trials they held ("*_ladder", "*_items"), and
    so are the E-step's Newton steps.  Each M-step ladder's trial thetas
    go to the list ``ladders`` when one is given.  The counters wrap the
    functions in ``models/fit`` for the block's duration.  The f-param
    searches that ran as kernels on the card (``ops/fparam_search``) count
    their evaluations on the device: those are read once, at the block's
    exit, and added to "fparam".  An M-step evaluation replayed from a CUDA
    graph (``optim/graphed``) calls no function: the replays are added to
    "mstep", and the captures, which call the objective without
    evaluating it, are taken off."""
    from ..models import fit as fit_module
    from ..ops import fparam_search
    from ..optim import graphed

    counts = {"fparam": 0, "mstep": 0, "fparam_ladder": 0, "fparam_items": 0,
              "mstep_ladder": 0, "mstep_items": 0, "newton": 0}
    names = ("_fparam_objective", "_mstep_objective",
             "_mstep_objective_cells", "estep_update")
    real = {name: getattr(fit_module, name) for name in names}

    def fparam(logA, *args, **kwargs):
        if logA.dim() > 0:              # a ladder: (T,) trials of logA
            counts["fparam_ladder"] += 1
            counts["fparam_items"] += logA.numel()
        else:
            counts["fparam"] += 1
        return real["_fparam_objective"](logA, *args, **kwargs)

    def mstep(*args, **kwargs):
        counts["mstep"] += 1
        return real["_mstep_objective"](*args, **kwargs)

    def mstep_ladder(theta, *args, **kwargs):
        counts["mstep_ladder"] += 1
        counts["mstep_items"] += theta["Amp"].numel()
        if ladders is not None:
            ladders.append({k: v.detach().cpu() for k, v in theta.items()})
        return real["_mstep_objective_cells"](theta, *args, **kwargs)

    def newton(*args, **kwargs):
        counts["newton"] += 1
        return real["estep_update"](*args, **kwargs)

    for name, fn in zip(names, (fparam, mstep, mstep_ladder, newton)):
        setattr(fit_module, name, fn)
    on_card = fparam_search.evaluation_counters()
    graphs = graphed.read_counts()
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(fit_module, name, fn)
        counts["fparam"] += fparam_search.evaluations_since(on_card)
        now = graphed.read_counts()
        counts["mstep"] += ((now["replays"] - graphs["replays"])
                            - (now["captures"] - graphs["captures"]))
