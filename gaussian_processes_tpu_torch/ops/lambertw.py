"""Lambert W, principal branch, for real non-negative arguments
(counterpart of ``gaussian_processes_tpu/ops/lambertw.py``).

The acquisition scorer evaluates W at z = sigma^2 exp(r sigma^2 + mu) >= 0,
where W0 is smooth.  Halley's method from an asymptotic-aware initial guess,
batched over the whole tensor, in the input's dtype and on its device.
"""

from __future__ import annotations

import math

import torch


def lambertw(z: torch.Tensor, iterations: int = 24) -> torch.Tensor:
    """W0(z) for real z >= 0 (elementwise), to ~machine precision.

    Initial guess: w ~ z/(1+z) for small z (the series w = z - z^2 + ...),
    and w ~ log z - log log z above e.  Then exactly ``iterations`` Halley
    updates, with no early exit (the same iterates as the JAX function):

        w <- w - f / (e^w (w+1) - (w+2) f / (2w+2)),   f = w e^w - z
    """
    tiny = torch.finfo(z.dtype).tiny
    logz = torch.log(torch.clamp(z, min=tiny))
    w_big = logz - torch.log(torch.clamp(logz, min=1.0))
    w_small = z / (1.0 + z)
    w = torch.where(z > math.e, w_big, w_small)
    for _ in range(iterations):
        ew = torch.exp(w)
        f = w * ew - z
        wp1 = w + 1.0
        w = w - f / (ew * wp1 - (w + 2.0) * f / (2.0 * wp1))
    return w
