"""The active loop's refit: one warm-startable fit of a 300-image
pad-and-mask buffer with 250 images in use, 108 x 108 px (counterpart of
``benchmarks/bench_active_refit.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.active_refit

Reference baseline: 1.0-1.3 s per warm-started refit at ntilde 50-300,
maxiter 10, on the lab GPU (one_cell_active_training.ipynb:cell9/cell17);
``vs_baseline`` takes the midpoint, 1.15 s.  The fit is the script's: the
buffer is its own inducing set, a 0/1 ``sample_weight`` masks the last 50
rows out, 10 EM iterations of 5 E-, 5 M- and 5 f-param steps, the JAX
FitConfig defaults the script relies on (``common.JAX_DEFAULTS``) at full
rank, and the convergence gates ``GPTPU_REFIT_MSTEP_FTOL`` and
``GPTPU_REFIT_ESTEP_TOL`` (default 0, off; the bench sets 0.3 and 1e-3),
read when ``run`` is called.  The buffers go to the device before the
timed loop.  Two untimed fits, then the median of 6 on the host clock,
each closed by a synchronize (``value``).

The reduced arm: the JAX script times its whole-fit program at the static
rank ``_rank_bucket(n_eigen + 1)`` of the full fit's last kept rank, when
that budget is below the capacity; the port has no whole-fit program
(``models/active.py``), so under the same condition it times its own
counterpart, the per-iteration fit with ``reduced_rank=True`` and the
subspace eigensolver, the same way (``reduced_rank_s``), with the budget
of each iteration and the kept rank; ``reduced_route`` says which route
ran, or why none did.  ``main`` exits 1 when a fit fails or its
loss is not finite.

Not ported, being TPU matters: the ``.jax_cache`` compilation cache,
``jit_whole_fit`` and ``whole_fit_rank``, and the read-backs that closed
the JAX script's timed regions.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from ..bench import card_info
from ..config import FitConfig, resolve_device
from ..models.fit import _rank_bucket, fit
from . import common

BASELINE_SECONDS = 1.15      # midpoint of the lab GPU's 1.0-1.3 s
CAPACITY = 300
N_ACTIVE = 250
N_PX = 108
STEPS = dict(maxiter=10, n_estep=5, n_mstep=5, n_fparamstep=5)


def make_data(capacity: int = CAPACITY, n_active: int = N_ACTIVE,
              n_px: int = N_PX):
    """The script's buffers, float32: (x_buf, r_buf, mask)."""
    rng = np.random.default_rng(0)
    x_buf = rng.standard_normal((capacity, n_px * n_px)).astype(np.float32)
    r_buf = rng.poisson(np.exp(0.8 * x_buf @ common.planted_rf(n_px))
                        ).astype(np.float32)
    mask = (np.arange(capacity) < n_active).astype(np.float32)
    return x_buf, r_buf, mask


def make_config(capacity: int = CAPACITY, n_px: int = N_PX,
                **steps) -> FitConfig:
    """The script's full-rank refit configuration, its gates read from the
    environment now."""
    env = os.environ
    return FitConfig(
        ntilde=capacity, n_px_side=n_px, track_variational=False,
        **{**STEPS, **steps}, **dict(common.JAX_DEFAULTS, reduced_rank=False),
        mstep_ftol=float(env.get("GPTPU_REFIT_MSTEP_FTOL", "0")),
        estep_tol=float(env.get("GPTPU_REFIT_ESTEP_TOL", "0")))


def _ok(res) -> bool:
    return (not res.failed) and bool(torch.all(torch.isfinite(
        res.track.logmarginal)))


def run(capacity: int = CAPACITY, n_active: int = N_ACTIVE,
        n_px: int = N_PX, reps: int = 6, device=None, dtype=torch.float32,
        **steps):
    """Time the refit and its reduced-rank counterpart (see the module
    docstring); ``steps`` override the EM depth (``maxiter``,
    ``n_estep``, ``n_mstep``, ``n_fparamstep``).  Returns ``(record,
    values)``; ``values`` holds the last timed fits (``result``, and
    ``reduced`` or None), the full fit's loss per iteration and m_b, and
    the configuration."""
    device = resolve_device(None, device)
    xb, rb, mk = make_data(capacity, n_active, n_px)
    x, r, mask = (torch.as_tensor(a, dtype=dtype, device=device)
                  for a in (xb, rb, mk))
    theta = common.tensors(common.THETA, dtype, device)
    f_params = common.tensors(common.F_PARAMS, dtype, device)
    cfg = make_config(capacity, n_px, **steps)
    cfg_r = dataclasses.replace(cfg, reduced_rank=True)
    out = {}

    def refit(c, profile=False):
        res = fit(x, r, c, xtilde=x, theta=theta, f_params=f_params,
                  sample_weight=mask, profile=profile)
        common.sync(device)
        return res

    def timed(c, key):
        def call():
            out[key] = refit(c)
        return call

    refit(cfg)
    refit(cfg)
    elapsed, times = common.median_seconds(timed(cfg, "full"), reps, device)
    res = out["full"]
    n_eig = int(res.track.n_eigen[-1])
    budget = _rank_bucket(n_eig + 1, cfg, capacity)
    red, reduced = None, {}
    if budget < capacity:
        # the untimed reduced fits; the first records its budget per
        # iteration
        budgets = refit(cfg_r, profile=True).timing["rank"]
        refit(cfg_r)
        red_elapsed, red_times = common.median_seconds(
            timed(cfg_r, "reduced"), reps, device)
        red = out["reduced"]
        reduced = {
            "reduced_rank_s": round(red_elapsed, 3),
            "reduced_rank_times_s": red_times,
            "reduced_rank_budgets": budgets,
            "reduced_rank_kept": int(red.track.n_eigen[-1]),
            "reduced_vs_baseline": (round(BASELINE_SECONDS / red_elapsed, 2)
                                    if _ok(red) else 0.0),
            "reduced_final_loss": float(-red.track.logmarginal[-1]),
        }
    ok = _ok(res) and (red is None or _ok(red))
    record = {
        "metric": f"active_loop_refit_ntilde{capacity}",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / elapsed, 2) if ok else 0.0,
        "times_s": times,
        "final_loss": float(-res.track.logmarginal[-1]),
        "kept_rank": n_eig,
        "reduced_rank_budget": budget,
        "reduced_route": (
            "per-iteration fit, reduced_rank=True, subspace eigensolver "
            "(no whole-fit program at a static rank)" if red is not None
            else f"not run: the budget {budget} covers the {capacity}-image "
                 f"buffer (the JAX script skips it too)"),
        **reduced,
        "gates": {"mstep_ftol": cfg.mstep_ftol, "estep_tol": cfg.estep_tol},
        "baseline": "1.0-1.3 s on the lab GPU "
                    "(one_cell_active_training.ipynb:cell9/cell17)",
        "device": card_info(device),
        "ok": ok,
    }
    return record, {"result": res, "reduced": red, "config": cfg,
                    "loss": -res.track.logmarginal, "m_b": res.m_b}


def main() -> int:
    record, _ = run()
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
