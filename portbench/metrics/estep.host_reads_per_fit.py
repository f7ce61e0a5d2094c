"""estep.host_reads_per_fit: the E-step's host reads of device values a
request (the ``host_reads.estep.*`` counters that ``utils.tracing.
host_read`` adds inside ``collect_spans``: the Newton-Schulz guard, the
early stop), each a point where the device's queue drains, over the
untraced requests of a traced run.  Nothing where the program counts no
E-step read at all (``collect_spans`` starts each site at 0 where it
counts them).  Layer: the EM iteration's E-step.  Moves ``fit_s``."""

UNIT = "reads"
PREFIX = "host_reads.estep."


def read(ctx):
    spans, n = ctx.get("spans", {}), ctx.get("requests", 0)
    sites = [v for k, v in spans.items() if k.startswith(PREFIX)]
    if not n or not sites:
        return None
    return sum(sites) / n
