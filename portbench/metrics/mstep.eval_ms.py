"""mstep.eval_ms: host milliseconds of the fit's M-step (the ``fit.mstep``
span, which ends in a host wait at every trial) over its objective's
evaluations (``objective_counts``), over the untraced requests of a
traced run.  Layer: the graphed M-step evaluation (``optim/graphed``,
``optim/lbfgs``).  Moves ``fit_s``."""

UNIT = "ms"


def read(ctx):
    n = ctx.get("evals", {}).get("mstep", 0)
    t = ctx.get("spans", {}).get("fit.mstep")
    if not n or t is None:
        return None
    return 1e3 * t / n
