"""pop.estep_s: device seconds of the kernels launched inside the
``fit.estep`` spans of the traced population request: every lane's
Newton updates (Cholesky) and batched Armijo searches on logA.  Layer:
the EM iteration's E-step (``models/fit._estep_block(lanes=True)``).
Moves ``fit_s``."""

UNIT = "s"


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_requests", 0)
    if tr is None or not n:
        return None
    t = tr.device_seconds(lambda op: tr.inside("fit.estep", op[3]))
    return t / n if t > 0 else None
