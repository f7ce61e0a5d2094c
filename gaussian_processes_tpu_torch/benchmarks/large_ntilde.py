"""The 50k-point Gram and its Cholesky factor at 48 x 48 px (counterpart
of ``benchmarks/bench_large_ntilde.py``).

    python -m gaussian_processes_tpu_torch.benchmarks.large_ntilde

The reference cannot reach this scale.  ``parallel/large.large_gram``
builds the n x n Gram in row blocks through the Gram kernel, then
``large_cholesky(K, jitter=1.0)`` factors K + I in K's own buffer; the
sampled diagonal of each is read back inside its timed region, and the
factor's must be finite and positive (else ``RuntimeError``).  Reported:
the seconds of each, TFLOP/s as n^3 / 3 over the Cholesky's seconds, and
the peak device memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``).  The stimuli are drawn in 8,192-row chunks,
as the script draws them.

Sizes: 50,000, falling back to 40,000 and 32,768 on
``torch.cuda.OutOfMemoryError`` only (any other exception propagates);
``rows`` records every size tried.  ``GPTPU_LARGE_ONE=n`` runs that size
alone; ``GPTPU_LARGE_SWEEP=1`` runs 65,536, 50,000 and 40,000, each in its
own process, and reports the first that ran.

Not ported, being TPU matters: the ``.jax_cache`` compilation cache, the
Cholesky's block size (cuSOLVER blocks on its own) and the value read-backs
that stood for a barrier (here a synchronize closes each region).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..bench import card_info
from ..config import resolve_device
from ..parallel import large
from . import common

N_PX = 48
SIZES = (50_000, 40_000, 32_768)
SWEEP = (65_536, 50_000, 40_000)
CHUNK = 8192
JITTER = 1.0
THETA = {"sigma_0": 1.0, "eps_0x": 0.0, "eps_0y": 0.0,
         "-2log2beta": float(-2 * np.log(2 * 0.25)),
         "-log2rho2": float(-np.log(2 * 0.1 ** 2)), "Amp": 1.0}


def make_data(n: int, n_px: int = N_PX) -> np.ndarray:
    """The script's stimuli, float32, drawn in 8,192-row chunks."""
    rng = np.random.default_rng(0)
    xt = np.empty((n, n_px * n_px), np.float32)
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        xt[i:j] = rng.standard_normal((j - i, n_px * n_px)).astype(np.float32)
    return xt


def run_at(n: int, n_px: int, device: torch.device, dtype):
    """One size: (row of the record, the factor L, the stimuli)."""
    xt = torch.as_tensor(make_data(n, n_px), dtype=dtype, device=device)
    theta = common.tensors(THETA, dtype, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    step = max(n // 64, 1)
    t0 = time.perf_counter()
    K = large.large_gram(theta, xt, n_px, device=device)
    float(torch.sum(K.diagonal()[::step]))
    common.sync(device)
    t_gram = time.perf_counter() - t0

    t0 = time.perf_counter()
    L = large.large_cholesky(K, jitter=JITTER)
    d = L.diagonal()[::step].cpu()
    common.sync(device)
    t_chol = time.perf_counter() - t0
    if not bool(torch.all(torch.isfinite(d)) and torch.all(d > 0)):
        raise RuntimeError(f"large_cholesky at n={n}: a sampled diagonal "
                           f"entry is not finite and positive")
    del K
    peak = (round(torch.cuda.max_memory_allocated(device) / 2 ** 30, 2)
            if cuda else None)
    row = {"n": n, "gram_s": t_gram, "cholesky_s": t_chol,
           "cholesky_tflops": round(n ** 3 / 3.0 / t_chol / 1e12, 2),
           "peak_gib": peak}
    return row, L, xt


def _sizes():
    one = os.environ.get("GPTPU_LARGE_ONE")
    return (int(one),) if one else SIZES


def run(sizes=None, n_px: int = N_PX, device=None, dtype=torch.float32):
    """The largest size of ``sizes`` (default: ``GPTPU_LARGE_ONE``, else
    50,000, 40,000, 32,768) that fits (see the module docstring).
    Returns ``(record, values)``: ``values`` holds the factor ``L`` and the
    stimuli ``x`` of the size that ran."""
    device = resolve_device(None, device)
    rows, values = [], {}
    for n in (_sizes() if sizes is None else sizes):
        error = None
        try:
            row, L, xt = run_at(n, n_px, device, dtype)
        except torch.cuda.OutOfMemoryError as e:
            error = f"OutOfMemoryError: {str(e)[:160]}"
        if error is not None:
            # out of the handler, the failed attempt's tensors are gone
            rows.append({"n": n, "error": error})
            print(f"n={n}: {error}", file=sys.stderr)
            torch.cuda.empty_cache()
            continue
        rows.append(row)
        print(f"n={n}: gram {row['gram_s']:.3f} s, cholesky "
              f"{row['cholesky_s']:.3f} s ({row['cholesky_tflops']} "
              f"TFLOP/s), peak {row['peak_gib']} GiB", file=sys.stderr)
        values = {"L": L, "x": xt}
        break
    return _record(rows, device), values


def _record(rows, device) -> dict:
    done = [r for r in rows if "error" not in r]
    best = done[0] if done else None
    return {
        "metric": (f"large_ntilde_cholesky_n{best['n']}" if best
                   else "large_ntilde_cholesky"),
        "value": best["cholesky_tflops"] if best else 0.0,
        "unit": "TFLOP/s",
        # the reference has no such scale: the factorization's rate
        "vs_baseline": best["cholesky_tflops"] if best else 0.0,
        "detail": best,
        "rows": rows,
        "device": card_info(device),
        "ok": best is not None,
    }


def sweep(device=None) -> dict:
    """``GPTPU_LARGE_SWEEP``: each size of ``SWEEP`` in its own process
    (a size that fails leaves the next one a clean card)."""
    device = resolve_device(None, device)
    rows = []
    for n in SWEEP:
        env = dict(os.environ, GPTPU_LARGE_ONE=str(n), GPTPU_LARGE_SWEEP="0")
        try:
            out = subprocess.run(
                [sys.executable, "-m", f"{__package__}.large_ntilde"],
                capture_output=True, text=True, env=env,
                cwd=Path(__file__).resolve().parents[2], timeout=1200)
        except subprocess.TimeoutExpired:
            rows.append({"n": n, "error": "timeout after 1200 s"})
            continue
        sys.stderr.write(out.stderr[-500:])
        lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
        rows.extend(json.loads(lines[-1])["rows"] if lines
                    else [{"n": n, "error": "no JSON output"}])
    return _record(rows, device)


def main() -> int:
    if (bool(int(os.environ.get("GPTPU_LARGE_SWEEP", "0")))
            and not os.environ.get("GPTPU_LARGE_ONE")):
        return common.emit(sweep())
    record, _ = run()
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
