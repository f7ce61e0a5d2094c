"""pop.gram_roofline: the share of their roofline that the Gram's forward
and backward kernels launched by the traced request's population program
reach: the least seconds those launches need by shape (the launch counts
at the end of ``fit_population``; ``portbench/counts.gram_forward_bound``
and ``gram_backward_bound``) over the device seconds of the Gram kernels
launched inside its ``fit.init`` and ``fit.iteration`` spans.  Layer: the
batched Gram kernels (``ops/gram_cuda``, ``csrc/acos_gram.cu``).  Moves
``fit_s``."""

from portbench.counts import gram_backward_bound, gram_forward_bound
from portbench.kernels import is_gram

UNIT = "%"
SPANS = ("fit.init", "fit.iteration")


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("traced_launches")
    if tr is None or not launches or not launches["shapes"]:
        return None
    t = tr.device_seconds(lambda op: is_gram(op[0]) and any(
        tr.inside(span, op[3]) for span in SPANS))
    bound = (gram_forward_bound(launches["shapes"])
             + gram_backward_bound(launches["product_shapes"],
                                   launches["bwd_shapes"]))
    return 100.0 * bound / t if t > 0 else None
