"""Beyond the reference's scale: a >= 50k-point GP posterior on one device
(counterpart of ``examples/large_scale_posterior.py``).

The arc-cosine Gram built block by block into one (n, n) buffer, its
Cholesky factor of ``K_tilde + noise_var I`` in place, the posterior-mean
weights and predictions for held-out stimuli: the conjugate
(Gaussian-likelihood) limit of the model (parallel/large.py).

    python -m gaussian_processes_tpu_torch.examples.large_scale_posterior
        [--n 50000] [--device cpu]
"""

import argparse
import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from ..parallel.large import large_posterior_mean


def main(argv=None):
    """Run the workflow; returns {"mu", "corr", "seconds"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192,
                    help="training/inducing points (50k: a 10 GB Gram)")
    ap.add_argument("--n-px", type=int, default=48,
                    help="pixels per side (48 = the production crop scale)")
    ap.add_argument("--nstar", type=int, default=64)
    ap.add_argument("--noise-var", type=float, default=1.0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(None, args.device)
    n, n_px = args.n, args.n_px
    rng = np.random.default_rng(0)

    # stream the stimuli in chunks to bound host memory
    xt = np.empty((n, n_px * n_px), np.float32)
    for i in range(0, n, 8192):
        j = min(i + 8192, n)
        xt[i:j] = rng.standard_normal((j - i, n_px * n_px)).astype(np.float32)

    # a planted smooth RF drives the (Gaussianized) responses
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.2 ** 2)).ravel()
    w = (w / np.linalg.norm(w)).astype(np.float32)
    y = xt @ w + rng.normal(0, np.sqrt(args.noise_var), n).astype(np.float32)
    xstar = rng.standard_normal((args.nstar, n_px * n_px)).astype(np.float32)
    y_star_true = xstar @ w

    theta = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
             "-2log2beta": -2 * np.log(2 * 0.25),
             "-log2rho2": -np.log(2 * 0.1 ** 2), "Amp": 1.0}

    print(f"n={n}: building Gram + factoring + solving ...", file=sys.stderr)
    t0 = time.perf_counter()
    mu, _ = large_posterior_mean(theta, torch.as_tensor(xt, device=device),
                                 y, xstar, n_px, noise_var=args.noise_var)
    mu = mu.cpu().numpy()                        # waits for the device
    elapsed = time.perf_counter() - t0

    corr = float(np.corrcoef(mu, y_star_true)[0, 1])
    print(f"n={n}: end-to-end {elapsed:.1f} s; corr(posterior mean, true "
          f"signal) = {corr:.3f} over {args.nstar} held-out stimuli")
    if not np.all(np.isfinite(mu)):
        raise RuntimeError("posterior mean has non-finite entries")
    return {"mu": mu, "corr": corr, "seconds": elapsed}


if __name__ == "__main__":
    main()
