"""Active against random stimulus selection on the hard data: the
reference's scientific capstone, learning curves from identical starting
models (counterpart of ``benchmarks/ab_active_vs_random_hard.py``;
reference: one_cell_active_training.ipynb:cell19/cell23).

    python -m gaussian_processes_tpu_torch.benchmarks.ab_active_vs_random_hard \\
        [--device cpu]

Per seed: ``synthetic_retina_hard(n_cells=1, seed=seed)`` (3,160 pool
images of 108 x 108 px, 30 test images x 30 repeats), the start set
``default_rng(seed).permutation(3160)[:n_start]``, and both arms through
``models/active.active_loop`` from it, ``select="utility"`` and
``"random"``, adding ``n_add`` images with a refit every round and the
held-out r^2 (``nbootstrap=100``) after every refit.  The refit is the
script's: 10 EM iterations of 5/5/5 steps, ``mstep_ftol_rel=1e-4``,
``estep_tol=1e-3`` and the JAX ``FitConfig`` defaults it relies on
(``common.JAX_DEFAULTS``) at full rank.

One record per (seed, arm) with the script's keys (``seed``, ``arm``,
``n_start``, ``n_add``, ``wallclock_s``, ``r2_start``, ``r2_final``,
``r2_history``, ``r2_sigma_history``) and the picks, then a summary: the
active-minus-random r^2 gap at rounds 25, 50, 75, 100 and 150 (those within
``n_add``) and at the last round, its mean over the seeds and its standard
error
``std(ddof=1) / sqrt(n)`` (``null`` for one seed; the script divided by
sqrt(n - 1) and printed NaN for one seed).  Non-finite numbers print as
``null``, so the lines are strict JSON.  ``ok``: every refit finite and
not failed, and every r^2 finite.

Environment, read when ``run`` is called: ``GPTPU_AB_SEEDS`` (default
"0,1,2"), ``GPTPU_AB_NSTART`` (50) and ``GPTPU_AB_NADD`` (150).

Not ported, being TPU matters: ``jit_whole_fit`` (the script's refits ran
one whole-fit program at a rank budget; the port's loop refits per
iteration at full rank, ``models/active.py``), ``GPTPU_GRAD_PRECISION``
and the ``.jax_cache`` compilation cache.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import bench
from ..config import FitConfig, resolve_device
from ..models.active import active_loop
from ..ops import fparam_search, gram_cuda
from . import common

STEPS = dict(maxiter=10, n_estep=5, n_mstep=5, n_fparamstep=5)
CHECKPOINTS = (25, 50, 75, 100, 150)
ARMS = (("active", "utility"), ("random", "random"))
NBOOTSTRAP = 100


def make_config(n_px: int = bench.N_PX, **steps) -> FitConfig:
    """The script's refit configuration (ab_active_vs_random_hard.py:72-75)
    without ``jit_whole_fit``, at full rank."""
    return FitConfig(n_px_side=n_px, track_variational=False,
                     **{**STEPS, **steps},
                     **dict(common.JAX_DEFAULTS, reduced_rank=False),
                     mstep_ftol_rel=1e-4, estep_tol=1e-3)


def _number(v):
    """``v`` as a float, or None when it is not finite."""
    v = float(v)
    return v if math.isfinite(v) else None


def summarize(seeds, n_add: int, curves: dict) -> dict:
    """The summary record of the r^2 curves (``curves[arm]``: one history
    per seed, ``n_add + 1`` rounds each)."""
    act = np.asarray(curves["active"], dtype=float)
    rnd = np.asarray(curves["random"], dtype=float)
    gap = act - rnd
    n = len(seeds)

    def sem(c):
        return _number(gap[:, c].std(ddof=1) / math.sqrt(n)) if n > 1 else None

    checkpoints = [c for c in CHECKPOINTS if c <= n_add]
    return {
        "metric": "active_vs_random_hard",
        "seeds": list(seeds),
        "r2_gap_mean_at_round": {str(c): _number(gap[:, c].mean())
                                 for c in checkpoints},
        "r2_gap_sem_at_round": {str(c): sem(c) for c in checkpoints},
        "r2_gap_mean_final": _number(gap[:, -1].mean()),
        "r2_gap_sem_final": sem(-1),
        "active_final_mean": _number(act[:, -1].mean()),
        "random_final_mean": _number(rnd[:, -1].mean()),
    }


def run(seeds=None, n_start=None, n_add=None, hard_kwargs=None, emit=None,
        device=None, dtype=torch.float32, **steps):
    """Both arms for each seed (see the module docstring); ``steps``
    (``maxiter``, ``n_estep``, ``n_mstep``, ``n_fparamstep``) override the
    refit's depth, ``hard_kwargs`` (to ``synthetic_retina_hard``) the
    shape.  ``emit`` receives each (seed,
    arm) record as it is made.  Returns ``(record, values)``: the summary
    with every (seed, arm) record under ``arms``, and the loops' results by
    (seed, arm)."""
    device = resolve_device(None, device)
    env = os.environ
    if seeds is None:
        seeds = [int(s) for s in env.get("GPTPU_AB_SEEDS", "0,1,2").split(",")]
    n_start = int(env.get("GPTPU_AB_NSTART", "50")) if n_start is None \
        else n_start
    n_add = int(env.get("GPTPU_AB_NADD", "150")) if n_add is None else n_add
    if device.type == "cuda":
        gram_cuda.load_library()         # the builds stay off the clock
        fparam_search.load_library()

    curves = {"active": [], "random": []}
    records, values, ok = [], {}, True
    for seed in seeds:
        X, R, Xte, Rte = bench.make_hard_problem(seed, **(hard_kwargs or {}))
        cfg = make_config(math.isqrt(X.shape[1]), **steps)
        pool = [torch.as_tensor(a, dtype=dtype, device=device)
                for a in (X, R, Xte, Rte)]
        start_idx = np.random.default_rng(seed).permutation(
            X.shape[0])[:n_start]
        for arm, select in ARMS:
            refits = []
            t0 = time.perf_counter()
            res = active_loop(pool[0], pool[1], start_idx=start_idx,
                              n_add=n_add, cfg=cfg, select=select,
                              X_test=pool[2], R_test=pool[3],
                              nbootstrap=NBOOTSTRAP, seed=seed, refits=refits)
            common.sync(device)
            wall = time.perf_counter() - t0
            curves[arm].append(res.r2_history)
            good = (all(not failed and math.isfinite(loss)
                        for failed, loss in refits)
                    and len(refits) == n_add + 1
                    and all(math.isfinite(v) for v in
                            res.r2_history + res.r2_sigma_history))
            ok = ok and good
            rec = {"seed": seed, "arm": arm, "n_start": n_start,
                   "n_add": n_add, "wallclock_s": wall,
                   "r2_start": _number(res.r2_history[0]),
                   "r2_final": _number(res.r2_history[-1]),
                   "r2_history": [_number(v) for v in res.r2_history],
                   "r2_sigma_history": [_number(v)
                                        for v in res.r2_sigma_history],
                   "picks": res.selected_idx,
                   "start_idx": start_idx.tolist(),
                   "refit_final_loss": [_number(-loss)
                                        for _, loss in refits],
                   "refits_failed": sum(failed for failed, _ in refits),
                   "ok": good}
            records.append(rec)
            values[(seed, arm)] = res
            if emit is not None:
                emit(rec)

    record = summarize(seeds, n_add, curves)
    record.update(n_start=n_start, n_add=n_add, arms=records,
                  device=bench.card_info(device), ok=ok)
    return record, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gaussian_processes_tpu_torch.benchmarks."
             "ab_active_vs_random_hard",
        description="active against random selection on the hard data: one "
                    "JSON line per (seed, arm), then the summary")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    record, _ = run(device=args.device, emit=lambda rec: print(
        json.dumps(rec, allow_nan=False), flush=True))
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
