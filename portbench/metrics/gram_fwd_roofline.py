"""gram_fwd_roofline: the share of its roofline the Gram's forward
kernels (split pass, 3xTF32 wgmma Gram, split-k reduce) reach in the
traced request: the least seconds its launches need by shape
(``portbench/counts.gram_forward_bound``) over their device seconds.
Layer: the Gram forward kernels (``ops/gram_cuda``, ``csrc/acos_gram.cu``).
Moves ``fit_s``."""

from portbench.counts import gram_forward_bound
from portbench.kernels import is_gram_forward

UNIT = "%"


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("traced_launches")
    if tr is None or not launches or not launches["shapes"]:
        return None
    t = tr.device_seconds(lambda op: is_gram_forward(op[0]))
    return 100.0 * gram_forward_bound(launches["shapes"]) / t if t > 0 \
        else None
