"""pop.kernel_state_s: device seconds of the kernels launched inside the
``fit.kernel_state`` spans of the traced population request (the init
and every rebuild): the batched Grams of every lane, the batched eigh and
the reprojection.  Layer: the population's kernel rebuild
(``models/fit._cell_kernel_state``).  Moves ``fit_s``."""

UNIT = "s"


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_requests", 0)
    if tr is None or not n:
        return None
    t = tr.device_seconds(lambda op: tr.inside("fit.kernel_state", op[3]))
    return t / n if t > 0 else None
