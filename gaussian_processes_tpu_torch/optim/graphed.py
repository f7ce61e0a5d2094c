"""An objective's value and gradient as one CUDA graph replay a call.

The JAX package runs each EM iteration as one compiled program, the M-step's
L-BFGS with its line searches inside, so no trial evaluation waits on the
host.  The port keeps its host-driven line searches (``optim/lbfgs``), which
read each trial's value and gradient on the host, and makes the evaluation
itself one launch: ``GraphedValueAndGrad`` captures ``fun`` and
``torch.autograd.grad`` once, into a CUDA graph over static device buffers,
and serves ``vg(flat) -> (value, grad)``, the CPU contract of
``optim/lbfgs._drive_lbfgs`` and its searches.  A call writes the trial
point into a pinned host buffer and replays the graph, which copies it in,
runs the forward and the backward, and copies the value and gradient out to
a second pinned buffer; the host waits on one event.

``fun(params, state)`` returns a 0-d loss that needs a gradient.
``params`` is the optimizer's point in its structure (a dict of 0-d tensors
or one tensor, as ``optim/lbfgs``'s optimizers take it); ``state`` a pytree
(``torch.utils._pytree``: tuples, named tuples, lists, dicts) of tensors and
constants: everything else the objective reads that changes between calls
of ``bind``.  ``bind(state)`` copies the state into the buffers and returns
``vg``.  The graph is captured for a key, the tree's structure and
constants and each tensor's shape, strides and dtype: ``bind`` with another
key retires the graph, and the next call of ``vg`` captures anew.  That
first call is a real evaluation, on a side stream (PyTorch captures a whole forward and backward only after such
a warm-up, which also builds the kernels and the cuBLAS workspace the
capture reuses; one side stream a device serves every object, so one
workspace does); its value and gradient are returned.  A capture that
fails raises.  Captures on a device chain one memory pool: a capture joins
the pool of the graph it replaces, the object's last one or, for an
object's first capture, the graph of the object last closed there, which
``close`` parks for it (PyTorch's allocators want a pool in use while a
graph joins it; a pool no graph uses goes back to the device only on
``torch.cuda.empty_cache``, or on an allocation that fails outside a
capture, and one that fails inside a capture cannot be retried).  So the
process holds one evaluation's working set, the largest it has captured,
however many fits and keys it runs, and ``close`` neither frees nor
empties the allocator's cache: the next fit reuses both.  A capture empties
that cache first only when the device's free memory is below what the
warm-up allocated.  ``release()``
frees the parked graphs and hands their pools back (it runs at exit).

Under ``graph=False`` (a CPU tensor, or a CUDA one held against the graph)
``vg`` runs the same body on the same buffers, eagerly: the graph's twin.
It takes the graph's path and spans: the first call of a key is its
warm-up, on the current stream, and its capture span is empty (it has no
graph to capture).

Spans (``utils/tracing``): each call after the first of a key is a
``fit.mstep.eval`` span (the copy in, the replay or the twin's body, the
wait, the copy out); the first is a ``fit.mstep.warmup`` span (the
warm-up evaluation to its synchronize) and a ``fit.mstep.capture`` span
after it.  Inside ``utils.tracing.collect_spans``, and only there, a
replay runs between a pair of timing CUDA events, created once an object,
whose elapsed time, read after the replay's wait, goes to the timer under
``mstep.replay_device`` (seconds) beside ``mstep.replays``.

``captures``, ``capture_seconds`` and ``replays`` count the captures, their
host seconds and the replays since import (``reset_counts``,
``read_counts``).  The kernels' launch counters count each replay's
launches, and none of the capture's, which launches nothing
(``utils.tracing.launches_held_out``).
"""

from __future__ import annotations

import atexit
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..utils.tracing import (credit_launches, launches_held_out,
                             span_timer, trace_annotation)
from .lbfgs import _flatten

captures = 0
capture_seconds = 0.0
replays = 0
# the side stream of each device's warm-ups and captures
_streams: Dict[torch.device, torch.cuda.Stream] = {}
# the graph of the object last closed on each device, never replayed, kept
# until the next capture there has joined its pool
_parked: Dict[torch.device, torch.cuda.CUDAGraph] = {}


def reset_counts() -> None:
    """Set the capture and replay counts to 0."""
    global captures, capture_seconds, replays
    captures, capture_seconds, replays = 0, 0.0, 0


def read_counts() -> dict:
    """Captures, their host seconds, and replays."""
    return {"captures": captures, "capture_seconds": capture_seconds,
            "replays": replays}


def _allocated_bytes(device: torch.device) -> int:
    """The bytes the caching allocator has handed out on ``device`` since
    it started (a running total)."""
    return torch.cuda.memory_stats(device).get(
        "allocated_bytes.all.allocated", 0)


@atexit.register
def release() -> None:
    """Free the parked graphs and hand their memory pools back to the
    device."""
    if _parked:
        for graph in _parked.values():
            graph.reset()
        _parked.clear()
        torch.cuda.empty_cache()


class GraphedValueAndGrad:
    """``vg(flat) -> (value, grad)`` of ``fun(params, state)`` from one CUDA
    graph replay a call (see the module docstring).  ``x0`` gives the
    parameters' structure, dtype and device.  Close it (or use it as a
    context manager) to free the buffers and park the graph."""

    def __init__(self, fun: Callable[[Any, Any], torch.Tensor], x0: Any,
                 graph: bool = True):
        flat0, self._unflatten, self.device = _flatten(x0)
        self.dtype = flat0.dtype
        self.graph = graph
        if graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA parameters, got "
                             f"{self.device}")
        self._fun = fun
        d = flat0.shape[0]
        pin = self.device.type == "cuda"
        # the trial point in, the value and gradient out
        self._x_host = torch.empty(d, dtype=self.dtype, pin_memory=pin)
        self._out_host = torch.empty(d + 1, dtype=self.dtype, pin_memory=pin)
        self._x = torch.zeros(d, dtype=self.dtype, device=self.device,
                              requires_grad=True)
        if graph and self.device not in _streams:
            _streams[self.device] = torch.cuda.Stream(self.device)
        self._stream = _streams.get(self.device)
        self._done = torch.cuda.Event() if pin else None
        # the timing pair around a replay, made at the first one timed
        self._events: Optional[Tuple[torch.cuda.Event,
                                     torch.cuda.Event]] = None
        self._key = None
        # a key bound and not yet warmed up (and captured)
        self._fresh = False
        # the state's leaves: a buffer for each tensor, the constants
        self._buffers: List[Any] = []
        self._state = None
        # the launch counts of the graph's kernels (a replay's)
        self._launches: dict = {}
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        # the graph of the last key, kept until the next capture has joined
        # its pool
        self._retired: Optional[torch.cuda.CUDAGraph] = None

    def __enter__(self) -> "GraphedValueAndGrad":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Free the state buffers and park the graph for the next capture
        on the device (see the module docstring)."""
        graph = self._graph if self._graph is not None else self._retired
        self._graph = self._retired = None
        self._key, self._buffers, self._state = None, [], None
        self._fresh = False
        if graph is None:
            return
        old = _parked.get(self.device)
        _parked[self.device] = graph
        if old is not None:
            # two objects' graphs were alive at once, in two pools: free
            # the other pool now, or it would stay reserved
            old.reset()
            torch.cuda.empty_cache()

    def bind(self, state) -> Callable[[torch.Tensor],
                                      Tuple[torch.Tensor, torch.Tensor]]:
        """Copy ``state`` into the buffers (new buffers, and a capture at
        the next call, when its key differs from the last one's) and return
        ``vg``."""
        leaves, spec = tree_flatten(state)
        key = (spec, tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                           if isinstance(t, torch.Tensor) else ("const", t)
                           for t in leaves))
        if key != self._key:
            if self._graph is not None:
                self._retired, self._graph = self._graph, None
            self._buffers = [torch.empty_strided(t.shape, t.stride(),
                                                 dtype=t.dtype,
                                                 device=t.device)
                             if isinstance(t, torch.Tensor) else t
                             for t in leaves]
            self._state = tree_unflatten(self._buffers, spec)
            self._key, self._fresh = key, True
        with torch.no_grad():
            for buf, t in zip(self._buffers, leaves):
                if isinstance(t, torch.Tensor):
                    buf.copy_(t)
        return self._vg

    def _body(self) -> None:
        """Trial point in, forward and backward, value and gradient out:
        what the graph holds."""
        with torch.no_grad():
            self._x.copy_(self._x_host, non_blocking=True)
        with torch.enable_grad():
            v = self._fun(self._unflatten(self._x), self._state)
            (g,) = torch.autograd.grad(v, self._x)
        out = torch.cat([v.detach().reshape(1).to(self.dtype),
                         g.to(self.dtype)])
        self._out_host.copy_(out, non_blocking=True)

    def _result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self._out_host.clone()
        return out[0], out[1:]

    def _wait(self) -> None:
        if self._done is not None:
            self._done.record()
            self._done.synchronize()

    def _vg(self, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        global replays
        if self._state is None:
            raise RuntimeError("GraphedValueAndGrad: bind a state first")
        if self._fresh:
            self._x_host.copy_(flat)
            return self._warm_up_and_capture()
        with trace_annotation("fit.mstep.eval"):
            self._x_host.copy_(flat)
            timer = span_timer() if self.graph else None
            if not self.graph:
                self._body()
            elif timer is None:
                self._graph.replay()
            else:
                if self._events is None:
                    self._events = (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
                start, end = self._events
                start.record()
                self._graph.replay()
                end.record()
            self._wait()
            if self.graph:
                credit_launches(self._launches)
                replays += 1
                if timer is not None:
                    timer.add("mstep.replay_device",
                              1e-3 * start.elapsed_time(end))
                    timer.add("mstep.replays")
            return self._result()

    def _warm_up_and_capture(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first call of a key: one evaluation on the side stream (the
        twin's on the current one), whose result is returned, then the
        capture on the same stream (the twin has none to make)."""
        with trace_annotation("fit.mstep.warmup"):
            if self.graph:
                current = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(current)
                allocated = _allocated_bytes(self.device)
                with torch.cuda.stream(self._stream):
                    self._body()
                    self._done.record(self._stream)
                self._done.synchronize()
            else:
                self._body()
                self._wait()
            result = self._result()
        with trace_annotation("fit.mstep.capture"):
            if self.graph:
                self._capture(current, allocated)
        self._fresh = False
        return result

    def _capture(self, current: torch.cuda.Stream, allocated: int) -> None:
        """Capture the body into the key's graph on the side stream, after
        the warm-up that allocated from ``allocated`` on; ``current`` waits
        for it."""
        global captures, capture_seconds
        t0 = time.perf_counter()
        # the capture allocates no more than the warm-up did in all; an
        # allocation that fails inside a capture cannot be retried, nor can
        # the allocator's cache be freed there, so free it first when the
        # device has less room than that
        need = _allocated_bytes(self.device) - allocated
        if torch.cuda.mem_get_info(self.device)[0] < need:
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        donor = self._retired
        if donor is None:
            donor = _parked.pop(self.device, None)
        pool = None if donor is None else donor.pool()
        with torch.cuda.stream(self._stream), \
                launches_held_out() as self._launches:
            graph.capture_begin(pool=pool)
            try:
                self._body()
            except BaseException:
                # end the failed capture so the stream can be used again;
                # the body's error is the one raised
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        current.wait_stream(self._stream)
        if donor is not None:
            donor.reset()
        self._retired = None
        capture_seconds += time.perf_counter() - t0
        captures += 1
        self._graph = graph
