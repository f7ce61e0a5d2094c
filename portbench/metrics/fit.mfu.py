"""fit.mfu: the whole request's share of the card's peak: the FLOPs of
every Gram product it launched, forward and backward, counted from the
launch counters by shape (``portbench/counts.gram_products_flops``),
over the untraced requests' wall seconds at 165 TFLOP/s.  The basis
projections, factorizations and elementwise work are not counted, so the
share is a lower bound.  Layer: the whole fit.  Moves ``fit_s``."""

from portbench.counts import PEAK_FLOPS, gram_products_flops

UNIT = "%"


def read(ctx):
    launches, wall = ctx.get("launches"), ctx.get("wall_s", 0.0)
    if not launches or wall <= 0:
        return None
    flops = gram_products_flops(launches["shapes"],
                                launches["product_shapes"])
    return 100.0 * flops / (wall * PEAK_FLOPS) if flops > 0 else None
