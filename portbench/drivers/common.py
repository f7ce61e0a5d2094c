"""What both drivers share: the traffic's generator by name, the clock,
and the comparison of an output with the reference's."""

from __future__ import annotations

import importlib
import time

import torch


def generator(traffic: dict):
    """The generator module a traffic file names
    (``portbench/traffic/<generator>.py``)."""
    return importlib.import_module(f"portbench.traffic.{traffic['generator']}")


def clock(device) -> float:
    """Host seconds once the device has finished its queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|; inf where ``got`` is not finite."""
    got = got.to(want.dtype)
    if not bool(torch.all(torch.isfinite(got))):
        return float("inf")
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def worst(acc: dict, values: dict) -> dict:
    """``acc`` with each number raised to the larger of the two."""
    for k, v in values.items():
        v = float(v)
        if v != v:
            v = float("inf")
        acc[k] = max(acc.get(k, 0.0), v)
    return acc
