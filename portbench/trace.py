"""The device trace of a traced stretch of a run, reduced to what the
per-layer readers take: each device operation with its name, its interval
and the host time of the call that launched it, and the host spans
(``record_function`` annotations, the program's ``fit.*`` among them).

``Tracer`` wraps ``torch.profiler``; ``reduce_chrome_trace`` reads the
Chrome trace it exports (the format is the profiler's stable export).  A
kernel replayed from a CUDA graph carries the correlation of the graph's
launch, so its launch time is the replay's.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Reduced:
    """Device operations ``ops`` as (name, start_us, dur_us, launch_us or
    None), host spans ``spans`` by name as sorted (start_us, end_us), and
    the traced window (start_us, end_us) of ``WINDOW_SPAN``."""

    def __init__(self, ops, spans, window):
        self.ops = ops
        self.spans = spans
        self.window = window
        self._starts = {k: [s for s, _ in v] for k, v in spans.items()}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def inside(self, span: str, t_us: Optional[float]) -> bool:
        """Whether host time ``t_us`` lies inside an instance of ``span``."""
        if t_us is None or span not in self.spans:
            return False
        i = bisect.bisect_right(self._starts[span], t_us) - 1
        return i >= 0 and self.spans[span][i][1] >= t_us

    def device_seconds(self, pred=lambda op: True) -> float:
        return sum(op[2] for op in self.ops if pred(op)) * 1e-6

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.merged()) * 1e-6

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, inside the
        window."""
        w0, w1 = self.window
        out: List[List[float]] = []
        for _, s, d, _ in sorted(self.ops, key=lambda op: op[1]):
            a, b = max(s, w0), min(s + d, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def innermost_span(self, t_us: float) -> str:
        """The shortest host span that holds ``t_us`` (the program's layer
        the host was in), or "host" outside every span but the window's."""
        best, name = None, "host"
        for span, ivs in self.spans.items():
            if span == WINDOW_SPAN:
                continue
            i = bisect.bisect_right(self._starts[span], t_us) - 1
            if i >= 0 and ivs[i][1] >= t_us:
                length = ivs[i][1] - ivs[i][0]
                if best is None or length < best:
                    best, name = length, span
        return name

    def _edges_within(self, a: float, b: float):
        """The span starts and ends strictly inside (a, b)."""
        for span, ivs in self.spans.items():
            if span == WINDOW_SPAN:
                continue
            i = bisect.bisect_left(self._starts[span], b) - 1
            while i >= 0 and ivs[i][1] > a:
                for t in ivs[i]:
                    if a < t < b:
                        yield t
                i -= 1

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        the innermost host span it fell in ("host": in none), ``top`` of
        each, in seconds."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, d, _ in self.ops:
            by_name[name] += d * 1e-6
        idle: Dict[str, float] = defaultdict(float)
        merged = self.merged()
        edges = [self.window[0]] + [t for iv in merged for t in iv] \
            + [self.window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            cuts = sorted({a, b} | {t for t in self._edges_within(a, b)})
            for c, d in zip(cuts, cuts[1:]):
                idle[self.innermost_span(0.5 * (c + d))] += (d - c) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def reduce_chrome_trace(events: list) -> Reduced:
    """``Reduced`` from the ``traceEvents`` of a Chrome trace."""
    launch: Dict[int, float] = {}
    spans: Dict[str, list] = defaultdict(list)
    device = []
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X":
            continue
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(ev["ts"])
        elif cat == "user_annotation":
            t = float(ev["ts"])
            spans[ev["name"]].append((t, t + float(ev.get("dur", 0.0))))
        elif cat in DEVICE_CATS:
            device.append(ev)
    ops = [(ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0)),
            launch.get(ev.get("args", {}).get("correlation")))
           for ev in device]
    spans = {k: sorted(v) for k, v in spans.items()}
    if WINDOW_SPAN not in spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    window = (spans[WINDOW_SPAN][0][0], spans[WINDOW_SPAN][-1][1])
    return Reduced(ops, spans, window)


class Tracer:
    """``torch.profiler`` over CPU and CUDA, started and stopped around
    the traced stretch, which the ``WINDOW_SPAN`` span marks; ``reduce()``
    exports the trace to a temporary file and reads it back."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False, profile_memory=False)
        self._span = None
        self.running = False

    def start(self):
        self.running = True
        self.prof.start()
        self._span = self.torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.running = False

    def reduce(self) -> Reduced:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return reduce_chrome_trace(events)
