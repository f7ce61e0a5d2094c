"""mstep.capture_s_per_fit: host seconds a request spends making the
M-step's CUDA graphs (the ``fit.mstep.warmup`` span, the eager evaluation
before each capture, and the ``fit.mstep.capture`` span), over the
untraced requests of a traced run.  Layer: the graphed M-step
evaluation.  Moves ``fit_s``."""

UNIT = "s"


def read(ctx):
    spans, n = ctx.get("spans", {}), ctx.get("requests", 0)
    warm, cap = spans.get("fit.mstep.warmup"), spans.get("fit.mstep.capture")
    if not n or warm is None or cap is None:
        return None
    return (warm + cap) / n
