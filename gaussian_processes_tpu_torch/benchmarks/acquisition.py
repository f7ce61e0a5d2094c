"""Acquisition scoring: the utilities of 2,100 candidate stimuli against
300 inducing points at 108 x 108 px (counterpart of
``benchmarks/bench_acquisition.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.acquisition

Reference baseline: about 0.02 s to score about 2,100 candidates on the lab
GPU (one_cell_active_training.ipynb:cell13).  The kernel state is the
script's: K_tilde of the 300 inducing images at the start theta
(``gram_matrices``), its stabilized eigenspace, m_b = 0 and V_b =
diag(k_tilde_b_diag); the scorer crops its Gram to
``crop_window_for_theta``'s window.  ``models/acquisition.score_candidates``
builds K* through the Gram kernel on the card (``ops/kernels._gram_core``).
Two untimed calls, then the median of 10 calls on the host clock, each
closed by a synchronize (``value``), and 50 calls issued back to back timed
by CUDA events (``device_ms_amortized``, the JAX script's chain of 50
asynchronous dispatches).  ``main`` exits 1 when a utility is not finite.

Not ported, being TPU matters: the ``.jax_cache`` compilation cache and the
read-backs that closed the JAX script's timed regions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..bench import card_info
from ..config import resolve_device
from ..models.acquisition import score_candidates
from ..ops.kernels import crop_window_for_theta, gram_matrices
from ..ops.stabilize import compute_eigenspace
from . import common

BASELINE_SECONDS = 0.02      # the lab GPU's scorer pass
NSTAR = 2100
NTILDE = 300
N_PX = 108
F_PARAMS = {"logA": float(np.log(0.05)), "lambda0": 0.3}


def make_data(nstar: int = NSTAR, ntilde: int = NTILDE, n_px: int = N_PX):
    """The candidates and inducing images, float64 (the script draws them
    so and casts to float32): (xstar, xtilde)."""
    rng = np.random.default_rng(0)
    xstar = rng.standard_normal((nstar, n_px * n_px))
    xtilde = rng.standard_normal((ntilde, n_px * n_px))
    return xstar, xtilde


def run(nstar: int = NSTAR, ntilde: int = NTILDE, n_px: int = N_PX,
        reps: int = 10, chain: int = 50, device=None, dtype=torch.float32):
    """Score the candidates (see the module docstring); returns
    ``(record, values)`` with the utilities and the best index of the last
    timed call in ``values``."""
    device = resolve_device(None, device)
    xs, xt = make_data(nstar, ntilde, n_px)
    xstar = torch.as_tensor(xs, dtype=dtype, device=device)
    xtilde = torch.as_tensor(xt, dtype=dtype, device=device)
    theta = common.tensors(common.THETA, dtype, device)
    f_params = common.tensors(F_PARAMS, dtype, device)
    with torch.no_grad():
        K_tilde, _, _ = gram_matrices(theta, xtilde, xtilde, n_px,
                                      shared=True)
        es = compute_eigenspace(K_tilde)
    m_b = torch.zeros(ntilde, dtype=dtype, device=device)
    V_b = torch.diag(es.k_tilde_b_diag)
    i0, j0, w = crop_window_for_theta(theta, n_px)
    win = {} if w >= n_px else dict(win_i0=i0, win_j0=j0, win_w=w)

    def score():
        return score_candidates(xstar, xtilde, theta, f_params, m_b, V_b,
                                es.B, es.k_tilde_inv_diag, n_px_side=n_px,
                                **win)

    out = {}

    def call():
        out["u"], out["best"] = score()

    for _ in range(2):
        call()
    elapsed, times = common.median_seconds(call, reps, device)
    u, best = out["u"], int(out["best"])
    device_ms = common.chained_ms(score, chain, device)
    ok = bool(torch.all(torch.isfinite(u)))
    record = {
        "metric": f"acquisition_score_{nstar}_candidates",
        "value": round(elapsed * 1000, 3),
        "unit": "ms",
        "vs_baseline": (round(BASELINE_SECONDS / elapsed, 2) if ok
                        else 0.0),
        "device_ms_amortized": round(device_ms, 3),
        "times_ms": [round(t * 1000, 3) for t in times],
        "window": [i0, j0, w],
        "best": best,
        "baseline": "0.02 s on the lab GPU "
                    "(one_cell_active_training.ipynb:cell13)",
        "device": card_info(device),
        "ok": ok,
    }
    return record, {"utilities": u, "best": best}


def main() -> int:
    record, _ = run()
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
