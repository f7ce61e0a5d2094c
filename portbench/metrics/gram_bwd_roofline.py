"""gram_bwd_roofline: the share of its roofline the Gram's backward
kernels (epilogue ``acos_gram_bwd``, ``tf32_split_t``, ``nt_product``)
reach in the traced request: the least seconds its products and
epilogues need by shape (``portbench/counts.gram_backward_bound``) over
their device seconds.  Layer: the Gram backward kernels.  Moves
``fit_s``."""

from portbench.counts import gram_backward_bound
from portbench.kernels import is_gram_backward

UNIT = "%"


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("traced_launches")
    if tr is None or not launches or not launches["product_shapes"]:
        return None
    t = tr.device_seconds(lambda op: is_gram_backward(op[0]))
    bound = gram_backward_bound(launches["product_shapes"],
                                launches["bwd_shapes"])
    return 100.0 * bound / t if t > 0 else None
