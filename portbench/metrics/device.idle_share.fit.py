"""device.idle_share.fit: the share of the traced request in which no
operation ran on the device (1 - the union of the device operations'
intervals over the traced window).  Layer: the device.  Moves
``fit_s``."""

UNIT = "%"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("traced_requests"):
        return None
    return 100.0 * (1.0 - tr.busy_seconds() / tr.window_s)
