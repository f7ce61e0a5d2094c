"""mstep.replay_device_ms: device milliseconds of one M-step evaluation
replayed from its CUDA graph, between the CUDA event pair that
``optim/graphed`` records around each replay inside ``collect_spans``
(``mstep.replay_device`` seconds over ``mstep.replays``), over the
untraced requests of a traced run.  Layer: the graphed M-step
evaluation.  Moves ``fit_s``."""

UNIT = "ms"


def read(ctx):
    spans = ctx.get("spans", {})
    n, t = spans.get("mstep.replays"), spans.get("mstep.replay_device")
    if not n or t is None:
        return None
    return 1e3 * t / n
