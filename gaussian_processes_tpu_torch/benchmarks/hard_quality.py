"""The gate ladder on the hard data: each convergence gate and trial budget
of the fit priced on r^2 and seconds (counterpart of
``benchmarks/bench_hard_quality.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.hard_quality \\
        [ladder | RUNG ...] [--device cpu]

The easy planted-RF data saturate r^2 near 1, so they cannot rank fits;
``data.synthetic_retina_hard`` (model-mismatched, correlated stimuli, low
rates) can.  One hard cell at the bench's shape (``bench.make_hard_problem``:
3,160 train images of 108 x 108 px, 30 test images x 30 repeats), the JAX
bench's inducing rows (``bench.load_draws``) and the STA init
(``bench.sta_init``); each rung is ``dataclasses.replace(bench.make_config(),
**LADDER[name])``.  A rung's fit is timed on the host clock, closed by a
device synchronize, after one untimed fit when ``warm`` (the kernel library
is loaded before the first clock starts); its r^2 bootstraps
over the JAX package's 200 repeat permutations (``bench._r2``), as the
script's ``evaluate(nbootstrap=200)`` does.  One record per rung with the
script's keys (``name``, the rung's knobs, ``wallclock_s``, ``final_loss``,
``init_loss``, ``r2``, ``r2_sigma``, ``failed``), unrounded; then a summary
record with the oracle's r^2 (the true test rates as the predictor), and
``ok``: no rung failed or went non-finite.

Environment, read when ``run`` is called (the script read
``GPTPU_HARD_WARM`` at import): ``GPTPU_HARD_SEED`` (default 0),
``GPTPU_HARD_WARM`` (1: an untimed fit before each timed one) and
``GPTPU_HARD_ORACLE`` (1: the oracle's r^2).

Not ported, being TPU matters: ``static_schedule`` (the rungs' schedule
knob; "exact" and "exact_dyn" are then the same configuration, both kept so
that each record maps onto one of the script's), ``GPTPU_GRAD_PRECISION``
and the ``.jax_cache`` compilation cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from .. import bench
from ..config import resolve_device
from ..data import synthetic_retina_hard
from ..models.fit import fit
from ..models.inference import explained_variance
from ..ops import fparam_search, gram_cuda
from . import common

# benchmarks/bench_hard_quality.py:40-70 without static_schedule
LADDER = {
    "exact":      dict(mstep_ftol=0.0, estep_tol=0.0, max_linesearch_steps=15),
    "ftol_only":  dict(mstep_ftol=1.0, estep_tol=0.0, max_linesearch_steps=15),
    "mid":        dict(mstep_ftol=0.3, estep_tol=1e-3, max_linesearch_steps=8),
    "gated":      dict(mstep_ftol=1.0, estep_tol=1e-3, max_linesearch_steps=4),
    "gated_ls8":  dict(mstep_ftol=1.0, estep_tol=1e-3, max_linesearch_steps=8),
    "exact_dyn":  dict(mstep_ftol=0.0, estep_tol=0.0, max_linesearch_steps=15),
    "ls4_only":   dict(mstep_ftol=0.0, estep_tol=0.0, max_linesearch_steps=4),
    "ls8_only":   dict(mstep_ftol=0.0, estep_tol=0.0, max_linesearch_steps=8),
    "rel_only":   dict(mstep_ftol=0.0, mstep_ftol_rel=1e-4, estep_tol=0.0,
                       max_linesearch_steps=4),
    "estep_only": dict(mstep_ftol=0.0, estep_tol=1e-3,
                       max_linesearch_steps=15),
    "rel_1e-4":   dict(mstep_ftol=0.0, mstep_ftol_rel=1e-4, estep_tol=1e-3,
                       max_linesearch_steps=4),
    "rel_3e-4":   dict(mstep_ftol=0.0, mstep_ftol_rel=3e-4, estep_tol=1e-3,
                       max_linesearch_steps=4),
    "rel_1e-3":   dict(mstep_ftol=0.0, mstep_ftol_rel=1e-3, estep_tol=1e-3,
                       max_linesearch_steps=4),
}


def _env_flag(name: str) -> bool:
    return bool(int(os.environ.get(name, "1")))


def run(names=None, seed=None, maxiter=None, warm=None, oracle=None,
        ntilde: int = bench.NTILDE, xtilde_idx=None, hard_kwargs=None,
        emit=None, device=None, dtype=torch.float32, **steps):
    """Run the rungs ``names`` (default: the whole ladder, in order) on the
    hard cell of ``seed`` (see the module docstring).  ``maxiter`` and
    ``steps`` (``n_estep``, ``n_mstep``, ``n_fparamstep``) cut the depth;
    ``ntilde``, ``xtilde_idx`` (default: the JAX draw, for 3,160 images)
    and ``hard_kwargs`` (to ``synthetic_retina_hard``) the shape.
    ``emit`` receives each rung's record as it is made.  Returns ``(record,
    values)``: the summary with every rung's record under ``ladder``, and
    per rung its result, configuration and loss per iteration."""
    device = resolve_device(None, device)
    env = os.environ
    seed = int(env.get("GPTPU_HARD_SEED", "0")) if seed is None else seed
    warm = _env_flag("GPTPU_HARD_WARM") if warm is None else warm
    oracle = _env_flag("GPTPU_HARD_ORACLE") if oracle is None else oracle
    names = list(LADDER) if names is None else list(names)
    unknown = [n for n in names if n not in LADDER]
    if unknown:
        raise ValueError(f"unknown rungs {unknown}; the ladder: "
                         f"{list(LADDER)}")

    ds = synthetic_retina_hard(n_cells=1, seed=seed, **(hard_kwargs or {}))
    X, R, Xte, Rte = bench.hard_arrays(ds)
    n_px = ds.images_train.shape[1]
    idx_jax, perms = bench.load_draws()
    idx = idx_jax[:ntilde] if xtilde_idx is None else np.array(xtilde_idx)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x, r, x_test, r_test = tensor(X), tensor(R), tensor(Xte), tensor(Rte)
    perms = torch.as_tensor(perms, device=device)
    xtilde = x[torch.as_tensor(idx, device=device)]
    theta, f_params = bench.sta_init(x, r, n_px)
    lam = ds.ground_truth_rates_test[:, 0]
    print(f"[hard] seed {seed}: mean train rate {R.mean():.2f} spk/img; "
          f"test rate mean {lam.mean():.2f}", file=sys.stderr)
    summary = {"metric": "hard_quality_ladder", "seed": seed,
               "rungs": names, "warm": warm,
               "mean_train_rate": float(R.mean()),
               "test_rate_mean": float(lam.mean())}
    if oracle:
        r2o, s2o = explained_variance(r_test, tensor(lam), perms=perms)
        summary.update(oracle_r2=float(r2o), oracle_r2_sigma=float(s2o))
        print(f"[hard] oracle (true-rate) r2 = {float(r2o):.3f} "
              f"+/- {float(s2o):.3f}", file=sys.stderr)

    base = bench.make_config(maxiter, ntilde, n_px, **steps)
    if device.type == "cuda":
        gram_cuda.load_library()         # the builds stay off the clock
        fparam_search.load_library()
    records, values = [], {}
    for name in names:
        cfg = dataclasses.replace(base, **LADDER[name])

        def go():
            res = fit(x, r, cfg, xtilde=xtilde, theta=theta,
                      f_params=f_params)
            common.sync(device)
            return res

        if warm:
            go()
        t0 = time.perf_counter()
        res = go()
        elapsed = time.perf_counter() - t0
        loss = -res.track.logmarginal.double().cpu().numpy()
        r2, s2 = bench._r2(res, x_test, r_test, perms)
        rec = {"name": name, **LADDER[name], "seed": seed,
               "wallclock_s": elapsed, "final_loss": float(loss[-1]),
               "init_loss": float(loss[0]), "r2": r2, "r2_sigma": s2,
               "failed": bool(res.failed)}
        records.append(rec)
        values[name] = {"result": res, "config": cfg, "loss": loss}
        if emit is not None:
            emit(rec)

    summary["ladder"] = records
    summary["device"] = bench.card_info(device)
    summary["ok"] = all(
        not rec["failed"] and all(math.isfinite(rec[k]) for k in (
            "final_loss", "init_loss", "r2", "r2_sigma"))
        and bool(np.all(np.isfinite(values[rec["name"]]["loss"])))
        for rec in records)
    return summary, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gaussian_processes_tpu_torch.benchmarks.hard_quality",
        description="the gate ladder on the hard data: one JSON line per "
                    "rung, then the summary")
    ap.add_argument("names", nargs="*", default=["ladder"],
                    help=f"rungs, or 'ladder' for all: {list(LADDER)}")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    names = None if args.names in ([], ["ladder"]) else args.names
    record, _ = run(names=names, device=args.device,
                    emit=lambda rec: print(json.dumps(rec), flush=True))
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
