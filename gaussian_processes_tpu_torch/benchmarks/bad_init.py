"""The headline fit started from a wrong theta: the crop window's coverage
check and its grown-margin re-run under stress (counterpart of
``benchmarks/bench_bad_init.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.bad_init [--device cpu]

The bench's fit (``bench.make_data``, the JAX bench's inducing rows,
``bench.make_config()``, 30 EM iterations of 10/10/10 steps) twice: from
the bench's init (``bench.THETA0``, ``F_PARAMS0``: the good arm, exactly
the headline fit) and from ``THETA_BAD``, its centre about 30 px off the
planted RF's (0.1, -0.2) and beta twice too wide.  Each fit is timed once
on the host clock, closed by a device synchronize, with no warm-up fit (the
port compiles nothing; the kernel library is loaded before the clock
starts).  The warnings each fit emits are recorded: in the port, the
coverage check's re-run (``models/fit.fit``: the window an iteration used
no longer covers the RF of its result, so the fit starts again with the
crop margin doubled, or on the full frame past a margin of 8).  The
script's other fallbacks, the static schedule's post-hoc check and its
dynamic re-run, have no counterpart: the port has no static schedule.

The record keeps the script's keys: ``value`` the bad arm's seconds,
``vs_baseline`` (0 unless the bad arm neither failed nor missed the
planted centre), ``good_init_s``, ``final_loss_bad_init``,
``final_loss_good_init``, ``recovered_center`` (both eps within 0.05 of
the planted centre) and ``fallbacks``; ``ok`` is both fits finite and not
failed (recovery is a reading, not the check).  ``GPTPU_BADINIT_MAXITER``
above the fit's depth, read when ``run`` is called, adds a longer bad arm
whose seconds, loss, eps and recovery go under keys of their own
(``recovery_*``); the script put them under the 30-iteration run's keys.

Not ported, being TPU matters: the warm-up fits (JAX compiled the new
windows' programs in them), ``static_schedule`` and its pins,
``GPTPU_GRAD_PRECISION`` and the ``.jax_cache`` compilation cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
import warnings

import numpy as np
import torch

from .. import bench
from ..config import resolve_device
from ..models.fit import fit
from ..ops import fparam_search, gram_cuda
from . import common

# bench_bad_init.py:43-51: the planted RF's centre, and the wrong start
# 30 px (of 108) off it in [-1, 1] coordinates with beta 2x too wide
PLANTED = (0.1, -0.2)
OFF = 30.0 * 2.0 / bench.N_PX
THETA_BAD = {"sigma_0": 1.0, "eps_0x": 0.1 + OFF, "eps_0y": -0.2 + OFF,
             "-2log2beta": -2 * math.log(2 * 0.2),
             "-log2rho2": -math.log(2 * 0.1 ** 2), "Amp": 1.0}
RECOVERY_TOL = 0.05


def _timed(x, r, cfg, xtilde, theta, f_params, device):
    """(result, seconds, the warnings' first 80 characters)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        res = fit(x, r, cfg, xtilde=xtilde, theta=theta, f_params=f_params)
        common.sync(device)
        seconds = time.perf_counter() - t0
    return res, seconds, [str(w.message)[:80] for w in caught]


def _reading(res):
    """(final loss, eps, recovered, finite and not failed)."""
    loss = -res.track.logmarginal.double().cpu().numpy()
    eps = [float(res.theta["eps_0x"]), float(res.theta["eps_0y"])]
    recovered = (abs(eps[0] - PLANTED[0]) < RECOVERY_TOL
                 and abs(eps[1] - PLANTED[1]) < RECOVERY_TOL)
    return (float(loss[-1]), eps, recovered,
            (not res.failed) and bool(np.all(np.isfinite(loss))))


def run(maxiter=None, nt: int = bench.NT, n_px: int = bench.N_PX,
        ntilde: int = bench.NTILDE, xtilde_idx=None, device=None,
        dtype=torch.float32, **steps):
    """Both arms (see the module docstring); ``maxiter`` and ``steps``
    (``n_estep``, ``n_mstep``, ``n_fparamstep``) cut their depth, ``nt``,
    ``n_px``, ``ntilde`` and ``xtilde_idx`` (default: the JAX draw, for
    3,160 images) the shape.  Returns ``(record, values)``: the fits by arm
    ("good", "bad", and "recovery" when it ran)."""
    device = resolve_device(None, device)
    recovery_iters = int(os.environ.get("GPTPU_BADINIT_MAXITER", "0"))
    X, R = bench.make_data(0, nt, n_px)
    idx = (bench.load_draws()[0][:ntilde] if xtilde_idx is None
           else np.array(xtilde_idx))
    x = torch.as_tensor(X, dtype=dtype, device=device)
    r = torch.as_tensor(R, dtype=dtype, device=device)
    xtilde = x[torch.as_tensor(idx, device=device)]
    cfg = bench.make_config(maxiter, ntilde, n_px, **steps)
    f_params = common.tensors(bench.F_PARAMS0, dtype, device)
    if device.type == "cuda":
        gram_cuda.load_library()         # the builds stay off the clock
        fparam_search.load_library()

    def arm(theta, c):
        return _timed(x, r, c, xtilde, common.tensors(theta, dtype, device),
                      f_params, device)

    res_g, t_good, warns_g = arm(bench.THETA0, cfg)
    res_b, t_bad, warns_b = arm(THETA_BAD, cfg)
    loss_g, _, _, ok_g = _reading(res_g)
    loss_b, eps_b, recovered, ok_b = _reading(res_b)
    values = {"good": res_g, "bad": res_b}
    record = {
        "metric": "bad_init_stress_wallclock",
        "value": t_bad,
        "unit": "s",
        "vs_baseline": (round(bench.BASELINE_SECONDS / t_bad, 2)
                        if ok_b and recovered else 0.0),
        "good_init_s": t_good,
        "final_loss_bad_init": loss_b,
        "final_loss_good_init": loss_g,
        "recovered_center": recovered,
        "fallbacks": warns_b,
        "maxiter": cfg.maxiter,
        "eps_bad_init": eps_b,
        "planted_center": list(PLANTED),
        "crop_margin_bad_init": res_b.config.crop_margin,
        "good_init_fallbacks": warns_g,
    }
    ok = ok_g and ok_b
    if recovery_iters > cfg.maxiter:
        res_l, t_long, warns_l = arm(
            THETA_BAD, dataclasses.replace(cfg, maxiter=recovery_iters))
        loss_l, eps_l, recovered_l, ok_l = _reading(res_l)
        values["recovery"] = res_l
        ok = ok and ok_l
        record.update(recovery_maxiter=recovery_iters, recovery_s=t_long,
                      recovery_final_loss=loss_l, recovery_eps=eps_l,
                      recovery_recovered_center=recovered_l,
                      recovery_fallbacks=warns_l)
    print(f"[bad-init] good: {t_good:.2f}s loss {loss_g:.1f}; bad init: "
          f"{t_bad:.2f}s loss {loss_b:.1f} eps {eps_b}; fallbacks: "
          f"{warns_b}", file=sys.stderr)
    record.update(device=bench.card_info(device), ok=ok)
    return record, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gaussian_processes_tpu_torch.benchmarks.bad_init",
        description="the headline fit from a wrong theta beside the right "
                    "one (prints one JSON line)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    record, _ = run(device=args.device)
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
