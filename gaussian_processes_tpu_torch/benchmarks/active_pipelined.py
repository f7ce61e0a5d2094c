"""What acquisition adds to a closed-loop round: the pipelined loop with
the scorer against the same loop picking at random, and the host loop
(counterpart of ``benchmarks/bench_active_pipelined.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.active_pipelined

Reference baseline: a scoring pass of about 20 ms per round on the lab GPU
(one_cell_active_training.ipynb:cell13).  The script's problem: a pool of
2,400 images of 108 x 108 px with Poisson responses of a planted Gaussian
RF, the first 250 as the start set, ``GPTPU_PIPE_NADD`` acquisitions
(default 24; the bench sets 16), refits of 10 EM iterations of 5/5/5 steps
under the JAX FitConfig defaults the script relies on
(``common.JAX_DEFAULTS``) and the refit gates ``GPTPU_REFIT_MSTEP_FTOL``
(0.3) and ``GPTPU_REFIT_ESTEP_TOL`` (1e-3), read when ``run`` is called.
Three arms, each one untimed pass of one acquisition and then one timed
pass, closed by a synchronize: ``active_loop_pipelined`` with
``select="random"`` and with ``"utility"``, and ``active_loop`` with
``"utility"``.  Reported: seconds per round over the ``n_add + 1`` refits
of each arm, the acquisition cost, utility minus random, in ms
(``value``), and each timed pass's inner-objective evaluations
(``utils.tracing.objective_counts``).  The pool is put on the device
before the timed passes (the JAX script hands each pass numpy arrays).
``main`` exits 1 when the utility arm's final fit fails or a utility is
not finite.

Not ported, being TPU matters: the ``.jax_cache`` compilation cache,
``GPTPU_GRAD_PRECISION`` (bf16 gradient matmuls), ``jit_whole_fit`` with
its rank budget (the port's refits are per-iteration fits, whose reduced
rank budget the JAX defaults turn on), and the untimed pass's full length:
it compiled the JAX programs, and here one acquisition runs every path
(refit, scorer, growth) once.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..bench import card_info
from ..config import FitConfig, resolve_device
from ..models.active import active_loop, active_loop_pipelined
from ..utils.tracing import objective_counts
from . import common

BASELINE_MS = 20.0           # the lab GPU's scorer pass
N_PX = 108
NPOOL = 2400
N_START = 250
STEPS = dict(maxiter=10, n_estep=5, n_mstep=5, n_fparamstep=5)


def make_data(npool: int = NPOOL, n_px: int = N_PX):
    """The script's pool, float32: (X, R)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((npool, n_px * n_px)).astype(np.float32)
    R = rng.poisson(np.exp(0.8 * X @ common.planted_rf(n_px))
                    ).astype(np.float32)
    return X, R


def make_config(n_px: int = N_PX, **steps) -> FitConfig:
    """The script's refit configuration, its gates read from the
    environment now."""
    env = os.environ
    return FitConfig(
        n_px_side=n_px, track_variational=False, **{**STEPS, **steps},
        **common.JAX_DEFAULTS,
        mstep_ftol=float(env.get("GPTPU_REFIT_MSTEP_FTOL", "0.3")),
        estep_tol=float(env.get("GPTPU_REFIT_ESTEP_TOL", "1e-3")))


def run(npool: int = NPOOL, n_start: int = N_START, n_add=None,
        n_px: int = N_PX, pool=None, device=None, dtype=torch.float32,
        **steps):
    """Time the three arms (see the module docstring).  ``n_add`` None
    reads ``GPTPU_PIPE_NADD``; ``pool`` = (X, R) replaces the script's
    pool; ``steps`` override the refits' EM depth.  Returns ``(record,
    values)``, ``values`` the timed passes' loop results by arm
    ("random", "utility", "host_loop")."""
    device = resolve_device(None, device)
    if n_add is None:
        n_add = int(os.environ.get("GPTPU_PIPE_NADD", "24"))
    X, R = make_data(npool, n_px) if pool is None else pool
    x = torch.as_tensor(X, dtype=dtype, device=device)
    r = torch.as_tensor(R, dtype=dtype, device=device)
    kw = dict(start_idx=np.arange(n_start), n_add=n_add,
              cfg=make_config(n_px, **steps), theta=common.THETA,
              f_params=common.F_PARAMS, seed=0)
    arms = {"random": (active_loop_pipelined, "random"),
            "utility": (active_loop_pipelined, "utility"),
            "host_loop": (active_loop, "utility")}
    out, per_round, evals = {}, {}, {}
    for arm, (loop, select) in arms.items():
        loop(x, r, select=select, **dict(kw, n_add=min(n_add, 1)))
        common.sync(device)
        with objective_counts() as evals[arm]:
            t0 = time.perf_counter()
            out[arm] = loop(x, r, select=select, **kw)
            common.sync(device)
            per_round[arm] = (time.perf_counter() - t0) / (n_add + 1)

    s_util, s_rand, s_host = (per_round[a] for a in
                              ("utility", "random", "host_loop"))
    acq_ms = (s_util - s_rand) * 1000.0
    util = out["utility"]
    ok = (not util.final_fit.failed
          and bool(np.all(np.isfinite(util.utilities))))
    print(f"[pipelined] per-round: utility {s_util * 1000:.1f} ms, random "
          f"{s_rand * 1000:.1f} ms, host-loop utility {s_host * 1000:.1f} ms"
          f" -> acquisition adds {acq_ms:.1f} ms (host loop adds "
          f"{(s_host - s_rand) * 1000:.1f} ms)", file=sys.stderr)
    record = {
        "metric": "pipelined_acquisition_cost_per_round",
        "value": round(acq_ms, 2),
        "unit": "ms",
        "vs_baseline": (round(BASELINE_MS / acq_ms, 2)
                        if ok and acq_ms > 0 else 0.0),
        "round_s_utility": round(s_util, 4),
        "round_s_random": round(s_rand, 4),
        "round_s_host_loop": round(s_host, 4),
        "n_add": n_add,
        "picks": {arm: o.selected_idx for arm, o in out.items()},
        "evaluations": evals,
        "baseline": "20 ms scorer pass per round on the lab GPU "
                    "(one_cell_active_training.ipynb:cell13)",
        "device": card_info(device),
        "ok": ok,
    }
    return record, out


def main() -> int:
    record, _ = run()
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
