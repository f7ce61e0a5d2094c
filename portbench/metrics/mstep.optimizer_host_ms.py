"""mstep.optimizer_host_ms: host milliseconds of the M-step's L-BFGS
between its evaluations (the ``fit.mstep`` span less its
``fit.mstep.eval``, ``fit.mstep.warmup`` and ``fit.mstep.capture``
spans: the two-loop recursion, the zoom search's decisions, flattening)
over the M-step's evaluations (``objective_counts``), over the untraced
requests of a traced run.  Layer: the M-step L-BFGS on the host
(``optim/lbfgs``).  Moves ``fit_s``."""

UNIT = "ms"
PARTS = ("fit.mstep.eval", "fit.mstep.warmup", "fit.mstep.capture")


def read(ctx):
    spans, n = ctx.get("spans", {}), ctx.get("evals", {}).get("mstep", 0)
    whole = spans.get("fit.mstep")
    if not n or whole is None or any(p not in spans for p in PARTS):
        return None
    return 1e3 * (whole - sum(spans[p] for p in PARTS)) / n
