"""Population throughput: the lab's multi-cell workload on one card,
batched against cell by cell (counterpart of
``benchmarks/bench_population.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.population

The reference fits one cell per notebook run in 85.2 s on the lab GPU; a
recording holds 41 cells shown the same stimuli
(one_cell_fit.ipynb:cell4).  The script's problem: 3,160 images of 108 x
108 px, cells with Gaussian RFs of width 0.1 at centres uniform in
+-0.3, ntilde ``GPTPU_POP_NTILDE`` (512), 6 EM iterations of 10/10/10 steps
under the JAX FitConfig defaults the script relies on
(``common.JAX_DEFAULTS``).  The inducing rows: the JAX script takes
``jax.random.permutation(PRNGKey(0), 3160)[:ntilde]``, whose first 2,100
are the port's bench draws (``bench.load_draws``), so up to ntilde 2,100
this takes their prefix.

Two routes, both read when ``run`` is called:

* batched: ``parallel/population.fit_population`` on the first
  ``GPTPU_POP_CELLS`` cells (16, then 8, then 4: the next only on
  ``torch.cuda.OutOfMemoryError``), one untimed run and one timed;
* sequential: ``models/fit.fit`` cell by cell with the line search
  ``GPTPU_POP_SEQ_LS`` (zoom), ``mstep_ftol`` 1.0, ``estep_tol`` 1e-3 and
  ``max_linesearch_steps`` 4 (``GPTPU_POP_MSTEP_FTOL``,
  ``GPTPU_POP_ESTEP_TOL``, ``GPTPU_POP_MAX_LS``), one untimed fit, then
  ``GPTPU_POP_SEQ`` (2) timed.

``value`` is the batched seconds per cell, ``vs_baseline`` the sequential
seconds per cell over it; each route's final log-marginals of the same
cells stand beside (and on stderr), to compare seconds at equal quality.
Every timed region closes with a synchronize.  ``main`` exits 1 when a
lane's log-marginal is not finite or a sequential fit fails.

Not ported, being TPU matters: the ``.jax_cache`` compilation cache,
``GPTPU_GRAD_PRECISION`` (bf16 gradient matmuls) and ``jit_whole_fit``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..bench import card_info, load_draws
from ..config import FitConfig, resolve_device
from ..models.fit import fit
from ..parallel.population import fit_population
from . import common

NT = 3160
N_PX = 108
STEPS = dict(maxiter=6, n_estep=10, n_mstep=10, n_fparamstep=10)


def make_data(ncells: int, nt: int = NT, n_px: int = N_PX):
    """The script's stimuli and ``ncells`` cells' responses, float32:
    (X, R (ncells, nt))."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((nt, n_px * n_px)).astype(np.float32)
    R = np.zeros((ncells, nt), np.float32)
    for c in range(ncells):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        R[c] = rng.poisson(np.exp(0.8 * X @ common.planted_rf(n_px, cx, cy)))
    return X, R


def inducing_rows(ntilde: int, nt: int = NT) -> np.ndarray:
    """The JAX script's inducing rows, permutation(PRNGKey(0), 3160)[:ntilde],
    from the bench draws (its first 2,100)."""
    idx = load_draws()[0]
    if nt != NT or ntilde > len(idx):
        raise ValueError(f"the JAX draws cover nt {NT} and ntilde up to "
                         f"{len(idx)}; got nt {nt}, ntilde {ntilde}: pass "
                         f"xtilde_idx")
    return idx[:ntilde]


def run(nt: int = NT, n_px: int = N_PX, ntilde=None, cells=None, nseq=None,
        xtilde_idx=None, device=None, dtype=torch.float32, **steps):
    """Time both routes (see the module docstring).  ``ntilde``, ``cells``
    (lane counts to try) and ``nseq`` None read the environment;
    ``xtilde_idx`` replaces the JAX draw; ``steps`` override the EM depth.
    Returns ``(record, values)``: the batched ``carry``, its per-cell
    log-marginals and configuration, the sequential fits, and the inducing
    rows."""
    device = resolve_device(None, device)
    env = os.environ
    if ntilde is None:
        ntilde = int(env.get("GPTPU_POP_NTILDE", "512"))
    if cells is None:
        cells = [int(c) for c in env.get("GPTPU_POP_CELLS",
                                         "16,8,4").split(",")]
    nseq = int(env.get("GPTPU_POP_SEQ", "2")) if nseq is None else nseq
    idx = (inducing_rows(ntilde, nt) if xtilde_idx is None
           else np.array(xtilde_idx))
    X, R = make_data(max(max(cells), nseq), nt, n_px)
    x = torch.as_tensor(X, dtype=dtype, device=device)
    rs = torch.as_tensor(R, dtype=dtype, device=device)
    xtilde = x[torch.as_tensor(idx, device=device)]
    theta = common.tensors(common.THETA, dtype, device)
    f_params = common.tensors(common.F_PARAMS, dtype, device)
    steps = {**STEPS, **steps}
    cfg = FitConfig(ntilde=ntilde, n_px_side=n_px, track_variational=False,
                    **steps, **common.JAX_DEFAULTS)

    # --- the batched fit at the largest lane count that fits ---
    t_pop = ncells = carry = None
    oom_at = []
    for nc in cells:
        error = None
        try:
            for _ in range(2):            # untimed, then timed
                common.sync(device)
                t0 = time.perf_counter()
                carry, _ = fit_population(x, rs[:nc], cfg, xtilde=xtilde,
                                          thetas=theta, f_params=f_params)
                common.sync(device)
                t_pop = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            error = f"{type(e).__name__}: {str(e)[:200]}"
        if error is None:
            ncells = nc
            break
        carry = t_pop = None
        oom_at.append(nc)
        print(f"[population] {nc} lanes failed: {error}", file=sys.stderr)
        torch.cuda.empty_cache()
    if carry is None:
        return ({"metric": "population_fit_per_cell", "value": float("inf"),
                 "unit": "s", "vs_baseline": 0.0, "oom_at": oom_at,
                 "device": card_info(device), "ok": False}, {})

    # --- the sequential per-cell fits ---
    cfg1 = FitConfig(
        ntilde=ntilde, n_px_side=n_px, track_variational=False, **steps,
        **common.JAX_DEFAULTS,
        linesearch=env.get("GPTPU_POP_SEQ_LS", "zoom"),
        mstep_ftol=float(env.get("GPTPU_POP_MSTEP_FTOL", "1.0")),
        estep_tol=float(env.get("GPTPU_POP_ESTEP_TOL", "1e-3")),
        max_linesearch_steps=int(env.get("GPTPU_POP_MAX_LS", "4")))
    fit(x, rs[0], cfg1, xtilde=xtilde, theta=theta, f_params=f_params)
    common.sync(device)
    seq = []
    t0 = time.perf_counter()
    for c in range(nseq):
        seq.append(fit(x, rs[c], cfg1, xtilde=xtilde, theta=theta,
                       f_params=f_params))
        common.sync(device)
    t_seq = (time.perf_counter() - t0) / max(nseq, 1)

    lm = carry.track.logmarginal
    lm_pop = lm[:nseq, -1].double().cpu().tolist()
    lm_seq = [float(res.track.logmarginal[-1]) for res in seq]
    ok = (bool(torch.all(torch.isfinite(lm)))
          and not any(res.failed for res in seq))
    per_cell = t_pop / ncells
    print(f"[population] {ncells} cells batched: {t_pop:.2f} s total, "
          f"{per_cell:.2f} s/cell, final log-marginal of cells 0-{nseq - 1} "
          f"{lm_pop}; sequential: {t_seq:.2f} s/cell, final log-marginal "
          f"{lm_seq}; 41-cell projection: batched {41 * per_cell:.0f} s, "
          f"sequential {41 * t_seq:.0f} s"
          + (f"; OOM at lanes {oom_at}" if oom_at else ""), file=sys.stderr)
    record = {
        "metric": f"population_fit_per_cell_{ncells}cells_ntilde{ntilde}",
        "value": round(per_cell, 3),
        "unit": "s",
        "vs_baseline": round(t_seq / per_cell, 2) if ok else 0.0,
        "batched_s": t_pop,
        "sequential_s_per_cell": t_seq,
        "ncells": ncells,
        "nseq": nseq,
        "oom_at": oom_at,
        "final_logmarginal_batched": lm_pop,
        "final_logmarginal_sequential": lm_seq,
        "sequential_linesearch": cfg1.linesearch,
        "device": card_info(device),
        "ok": ok,
    }
    return record, {"carry": carry, "logmarginal": lm, "sequential": seq,
                    "config": cfg, "xtilde_idx": idx}


def main() -> int:
    record, _ = run()
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
