"""The bench's hard gate on both routes of the E-step's f-param search, or
of the Gram's backward.

    python -m gaussian_processes_tpu_torch.benchmarks.fparam_route \\
        [SEED ...] [--float64] [--gram-backward] [--device cpu]

The hard gate (``bench.run_bench``'s second gate) is the "exact_dyn" rung of
``benchmarks/hard_quality`` on seed 0: the bench's configuration, 30 EM
iterations, r^2 over the JAX package's repeat permutations.  This module fits
that rung on each seed twice, once with the f-param search on the kernel
(``ops/fparam_search``, the route the fit takes on the card) and once with the
same fit's searches on the plain host-driven route (``backend="torch"``, the
route every fit took before the kernel); the Gram and everything else are the
same.  With ``--float64`` the fits run in float64 (the Gram kernel still
takes float32 operands), where the kernel's search ends within 1e-9 of the
plain search's logA (``chip_smoke.py`` phase 6b): if the two arms then agree,
the kernel's objective and gradient are the plain route's, and a float32
difference comes from rounding along the path.  On CPU tensors both arms are the plain route.

With ``--gram-backward`` the piece on two routes is the Gram's backward
instead: the kernel arm runs the backward kernels at the forward's own q12
(the route the fit takes on the card), the plain arm the plain backward
``gram_cuda.gram_backward_torch`` at a q12 recomputed by ``torch.matmul``
(the route every fit took before the backward kernels); the f-param
search takes the kernel in both.

One record per seed and route (``seed``, ``route``, ``r2``, ``r2_sigma``,
``final_loss``, ``init_loss``, ``wallclock_s``, ``fparam_evaluations``,
``failed``), then a summary with each seed's ``dr2`` and ``dloss`` (kernel
less plain) and ``ok``: no fit failed or went non-finite.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys

import torch

from ..utils.tracing import objective_counts
from . import common, hard_quality

RUNG = "exact_dyn"
ROUTES = ("kernel", "plain")


@contextlib.contextmanager
def plain_fparam_route():
    """The fit's f-param searches take the plain host-driven route
    (``backend="torch"``) while the block runs; nothing else changes."""
    from ..models import fit as fit_module
    real = fit_module.fparam_search

    def plain(*args, **kwargs):
        return real(*args, **dict(kwargs, backend="torch"))

    fit_module.fparam_search = plain
    try:
        yield
    finally:
        fit_module.fparam_search = real


@contextlib.contextmanager
def plain_gram_backward():
    """The Gram's backward takes the plain route at a q12 recomputed by
    ``torch.matmul`` while the block runs; nothing else changes."""
    from ..ops import gram_cuda
    real = gram_cuda.gram_backward

    def plain(g, u1, s2, q11, q22, sigma0, q12, *need):
        return gram_cuda.gram_backward_torch(g, u1, s2, q11, q22, sigma0,
                                             u1 @ s2.mT, *need)

    gram_cuda.gram_backward = plain
    try:
        yield
    finally:
        gram_cuda.gram_backward = real


PLAIN = {"fparam": plain_fparam_route, "gram_backward": plain_gram_backward}


def run(seeds=(0,), emit=None, device=None, dtype=torch.float32,
        piece="fparam", **kwargs):
    """The hard gate's rung on each of ``seeds``, with ``piece`` ("fparam"
    or "gram_backward") on the kernel route then the plain route;
    ``kwargs`` go to ``hard_quality.run`` (``maxiter``, ``ntilde``,
    ``xtilde_idx``, ``hard_kwargs``, the steps).  ``emit`` receives each
    record as it is made.  Returns ``(record, values)``: the summary with
    every record under ``fits``, and per (seed, route) the rung's values
    from ``hard_quality.run``."""
    records, values = [], {}
    summary = {"metric": f"hard_gate_by_{piece}_route", "rung": RUNG,
               "seeds": list(seeds), "dtype": str(dtype).split(".")[-1]}
    for seed in seeds:
        for route in ROUTES:
            ctx = (PLAIN[piece]() if route == "plain"
                   else contextlib.nullcontext())
            with ctx, objective_counts() as ev:
                rec, vals = hard_quality.run(
                    names=[RUNG], seed=seed, warm=False, oracle=False,
                    device=device, dtype=dtype, **kwargs)
            fit_rec = rec["ladder"][0]
            out = {"seed": seed, "route": route,
                   **{k: fit_rec[k] for k in ("r2", "r2_sigma", "final_loss",
                                              "init_loss", "wallclock_s",
                                              "failed")},
                   "fparam_evaluations": ev["fparam"]}
            summary["device"] = rec["device"]
            records.append(out)
            values[(seed, route)] = vals[RUNG]
            if emit is not None:
                emit(out)
    by = {(rec["seed"], rec["route"]): rec for rec in records}
    summary["fits"] = records
    summary["dr2"] = {str(s): by[s, "kernel"]["r2"] - by[s, "plain"]["r2"]
                      for s in seeds}
    summary["dloss"] = {str(s): by[s, "kernel"]["final_loss"]
                        - by[s, "plain"]["final_loss"] for s in seeds}
    summary["ok"] = all(
        not rec["failed"] and all(math.isfinite(rec[k]) for k in (
            "r2", "r2_sigma", "final_loss", "init_loss"))
        and bool(torch.isfinite(torch.as_tensor(
            values[rec["seed"], rec["route"]]["loss"])).all())
        for rec in records)
    return summary, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gaussian_processes_tpu_torch.benchmarks.fparam_route",
        description="the bench's hard gate with the f-param search (or "
                    "the Gram's backward) on the kernel and on the plain "
                    "route: one JSON line per fit, then the summary")
    ap.add_argument("seeds", nargs="*", type=int, default=[0],
                    help="hard-data seeds (default: 0, the gate's)")
    ap.add_argument("--float64", action="store_true",
                    help="fit in float64 (default: float32, the bench's)")
    ap.add_argument("--gram-backward", action="store_true",
                    help="put the Gram's backward on two routes instead of "
                         "the f-param search")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    record, _ = run(seeds=args.seeds, device=args.device,
                    dtype=torch.float64 if args.float64 else torch.float32,
                    piece="gram_backward" if args.gram_backward else "fparam",
                    emit=lambda rec: print(json.dumps(rec), flush=True))
    return common.emit(record)


if __name__ == "__main__":
    sys.exit(main())
