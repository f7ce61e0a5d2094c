"""pop.mstep_s: device seconds of the kernels launched inside the
``fit.mstep`` span of the traced population request: the batched Armijo
search's value-only ladders (``fit.mstep.ladder``) and its
value-and-gradient calls (``fit.mstep.grad``) over every lane.  Layer:
the population's M-step (``models/fit._mstep_objective_cells``,
``optim/lbfgs.lbfgs_minimize_armijo``).  Moves ``fit_s``."""

UNIT = "s"


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_requests", 0)
    if tr is None or not n:
        return None
    t = tr.device_seconds(lambda op: tr.inside("fit.mstep", op[3]))
    return t / n if t > 0 else None
