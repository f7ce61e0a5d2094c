"""fparam.us_per_eval: device microseconds of the f-param search kernel
(``fparam_lbfgs``) over its objective's evaluations (the device counter
``objective_counts`` reads), in the traced request.  Layer: the f-param
search kernel (``ops/fparam_search``, ``csrc/fparam_lbfgs.cu``).  Moves
``fit_s``."""

from portbench.kernels import is_fparam

UNIT = "us"


def read(ctx):
    tr, evals = ctx.get("trace"), ctx.get("traced_evals") or {}
    if tr is None or not evals.get("fparam"):
        return None
    t = tr.device_seconds(lambda op: is_fparam(op[0]))
    return 1e6 * t / evals["fparam"] if t > 0 else None
