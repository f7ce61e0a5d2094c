"""Single-cell spatial-GP fit: the ``one_cell_fit.ipynb`` workflow
(counterpart of ``examples/one_cell_fit.py``).

Loads (or synthesizes) a dataset, fits one retinal ganglion cell with the EM
trainer under the JAX script's solver set (its per-iteration fit at the JAX
``FitConfig`` defaults: a reduced rank budget with the warm-started subspace
eigensolver, Newton-Schulz for the E-step's and the M-step's inverses and
the trace-series log-determinant, named here since the port's defaults are
the exact forms), evaluates the reliability-corrected r^2 on the repeated
test set and saves the model.

    python -m gaussian_processes_tpu_torch fit [--cellid 0] [--ntilde 200]
        [--maxiter 10] [--data path/to/dataset.pkl] [--out models/cell0]
        [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from ..config import FitConfig, resolve_device
from ..data import Dataset, synthetic_retina
from ..models.fit import fit
from ..models.inference import evaluate
from ..utils.guards import print_hyp
from ..utils.io import save_model

# the JAX package's FitConfig defaults for the solvers (its example's)
JAX_SOLVERS = dict(reduced_rank=True, eigensolver="subspace",
                   estep_solver="schulz", mstep_inverse="schulz",
                   mstep_logdet="series")


def main(argv=None):
    """Run the workflow; returns {"result", "r2", "sigma_r2", "seconds"}
    (the fit's seconds end in a device synchronize)."""
    ap = argparse.ArgumentParser(prog="gaussian_processes_tpu_torch fit")
    ap.add_argument("--cellid", type=int, default=0)
    ap.add_argument("--ntilde", type=int, default=200)
    ap.add_argument("--maxiter", type=int, default=10)
    ap.add_argument("--n-estep", type=int, default=10)
    ap.add_argument("--n-mstep", type=int, default=10)
    ap.add_argument("--n-fparamstep", type=int, default=10)
    ap.add_argument("--data", type=str, default=None,
                    help="Dataset pickle; synthetic retina if omitted")
    ap.add_argument("--n-px", type=int, default=108)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(None, args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    if args.data:
        ds = Dataset.load(args.data)
    else:
        print("No --data given; generating a synthetic retina "
              "(matching the reference dataset's shapes)")
        ds = synthetic_retina(n_px_side=args.n_px, n_train=1000, n_val=100,
                              n_test=30, n_repeats=30, seed=args.seed)

    X, R = ds.full_train()
    X = torch.as_tensor(X, dtype=dtype, device=device)
    r = torch.as_tensor(R[:, args.cellid], dtype=dtype, device=device)
    cfg = FitConfig(ntilde=min(args.ntilde, X.shape[0]),
                    maxiter=args.maxiter, n_estep=args.n_estep,
                    n_mstep=args.n_mstep, n_fparamstep=args.n_fparamstep,
                    n_px_side=ds.px_x, cellid=args.cellid, **JAX_SOLVERS)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = clock()
    res = fit(X, r, cfg, generator=torch.Generator().manual_seed(args.seed))
    elapsed = clock() - t0
    print(f"\nFit finished in {elapsed:.2f}s "
          f"(failed={res.failed} at {res.failed_at})")
    loss = -res.track.logmarginal.cpu().numpy()
    print(f"Loss: {loss[0]:.2f} -> {loss[-1]:.2f}")
    print_hyp(res.theta)

    X_test, _ = ds.test(averages=False)
    _, rates, r2, s = evaluate(
        res, torch.as_tensor(np.asarray(X_test), dtype=dtype, device=device),
        torch.as_tensor(ds.responses_test, dtype=dtype, device=device),
        cellid=args.cellid)
    r2, s = float(r2), float(s)
    print(f"\nr2 = {r2:.2f} +/- {s:.2f} "
          f"(cell {args.cellid}, maxiter={cfg.maxiter}, "
          f"nEstep={cfg.n_estep}, nMstep={cfg.n_mstep})")

    if args.out:
        save_model(res, args.out, additional_description=f"r2 = {r2:.2f}")
        print(f"Saved model to {args.out}")
    return {"result": res, "r2": r2, "sigma_r2": s, "seconds": elapsed}


if __name__ == "__main__":
    main()
