"""mstep.rest_ms: device milliseconds of the kernels other than the
Gram's (its forward and backward kernels by name) launched inside the
``fit.mstep`` span, over the traced request's M-step evaluations.  Layer:
the M-step objective's linear algebra (``models/fit._mstep_loss``, torch
ops).  Moves ``fit_s``."""

from portbench.kernels import is_gram

UNIT = "ms"


def read(ctx):
    tr, evals = ctx.get("trace"), ctx.get("traced_evals") or {}
    if tr is None or not evals.get("mstep"):
        return None
    t = tr.device_seconds(lambda op: not is_gram(op[0])
                          and tr.inside("fit.mstep", op[3]))
    return 1e3 * t / evals["mstep"] if t > 0 else None
