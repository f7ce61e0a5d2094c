"""Closed-loop active training: the ``one_cell_active_training.ipynb``
workflow with the active-vs-random A/B control (reference cell19/cell23;
counterpart of ``examples/active_training.py``).  Every refit is the
per-iteration fit.

    python -m gaussian_processes_tpu_torch active [--n-start 50]
        [--n-add 25] [--ab-control] [--seeds 3] [--device cpu]
"""

import argparse

import numpy as np

from ..config import FitConfig, resolve_device
from ..data import synthetic_retina
from ..models.active import active_loop


def run_one(select, X, R, start_idx, args, theta0, fp0, Xt, Rt, cfg, seed,
            device):
    return active_loop(
        X, R, start_idx=start_idx, n_add=args.n_add, cfg=cfg, theta=theta0,
        f_params=fp0, select=select, X_test=Xt, R_test=Rt, nbootstrap=200,
        seed=seed, verbose=args.verbose, device=device)


def main(argv=None):
    """Run the workflow; returns {select: [ActiveLoopResult per seed]}."""
    ap = argparse.ArgumentParser(prog="gaussian_processes_tpu_torch active")
    ap.add_argument("--cellid", type=int, default=0)
    ap.add_argument("--n-start", type=int, default=50)
    ap.add_argument("--n-add", type=int, default=25)
    ap.add_argument("--n-px", type=int, default=54)
    ap.add_argument("--npool", type=int, default=600)
    ap.add_argument("--maxiter", type=int, default=6)
    ap.add_argument("--ab-control", action="store_true",
                    help="also run random-selection baseline")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(None, args.device)
    ds = synthetic_retina(n_px_side=args.n_px, n_train=args.npool,
                          n_val=10, n_test=20, n_repeats=20,
                          n_cells=3, seed=0)
    X, R_all = ds.full_train()
    R = R_all[:, args.cellid]
    Xt = np.asarray(ds.images_test).reshape(ds.images_test.shape[0], -1)
    Rt = ds.responses_test[:, :, args.cellid]

    theta0 = {"sigma_0": 1.0, "eps_0x": 0.0001, "eps_0y": 0.0001,
              "-2log2beta": -2 * np.log(2 * 0.1),
              "-log2rho2": -np.log(2 * 0.05 ** 2), "Amp": 1.0}
    fp0 = {"logA": np.log(0.01), "lambda0": 1.0}
    cfg = FitConfig(maxiter=args.maxiter, n_estep=5, n_mstep=3,
                    n_fparamstep=5, n_px_side=args.n_px,
                    track_variational=False)

    out = {"utility": [], "random": []}
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        start_idx = rng.permutation(X.shape[0])[:args.n_start]

        res = run_one("utility", X, R, start_idx, args, theta0, fp0, Xt, Rt,
                      cfg, seed, device)
        out["utility"].append(res)
        print(f"[seed {seed}] ACTIVE  r2: "
              f"{res.r2_history[0]:.3f} -> {res.r2_history[-1]:.3f} "
              f"({len(res.selected_idx)} images added)")

        if args.ab_control:
            res_r = run_one("random", X, R, start_idx, args, theta0, fp0,
                            Xt, Rt, cfg, seed, device)
            out["random"].append(res_r)
            print(f"[seed {seed}] RANDOM  r2: "
                  f"{res_r.r2_history[0]:.3f} -> {res_r.r2_history[-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
