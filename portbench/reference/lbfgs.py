"""The reference's L-BFGS: optax 0.2.6's ``lbfgs(memory_size=15)`` with its
``scale_by_zoom_linesearch(initial_guess_strategy="one")`` and defaults
(slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, increase_factor 2,
stepsize_precision 1e-5), written out in plain PyTorch, with best-iterate
tracking and a step that leaves non-finite parameters reverted.  This is
the optimiser the reference fit's M-step runs (``varGP``'s L-BFGS as the
JAX port of it drives it), so that the reference's M-step takes the steps
the program's should.

``minimize(vg, x0, num_steps, max_linesearch_steps)``: ``vg(x) -> (value,
grad)`` on a flat vector; returns the best iterate and its value.
"""

from __future__ import annotations

from typing import Callable

import torch

SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5


def _two_loop(grad, S, Y, rho, count, memory):
    """P_k grad by the two-loop recursion over the stored pairs, oldest
    first; the first step a capped reciprocal of the gradient's norm."""
    if count == 0:
        return torch.clamp(1.0 / torch.sqrt(torch.sum(grad * grad)),
                           max=1.0) * grad
    order = [(count + i) % memory for i in range(memory)]
    last = (count - 1) % memory
    den = torch.sum(Y[last] * Y[last])
    scale = torch.where(den > 0.0, torch.dot(Y[last], S[last]) / den, 1.0)
    v, alphas = grad, [None] * memory
    for pos in reversed(range(memory)):
        i = order[pos]
        alphas[pos] = rho[i] * torch.dot(S[i], v)
        v = v - alphas[pos] * Y[i]
    v = scale * v
    for pos in range(memory):
        i = order[pos]
        v = v + (alphas[pos] - rho[i] * torch.dot(Y[i], v)) * S[i]
    return v


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc * dc * v0 - db * db * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / (db * db)))


def _errors(step, value, slope, value0, slope0):
    """(decrease error, curvature error) of a trial: 0 where the strong
    Wolfe conditions (or the approximate decrease) hold, inf for NaN."""
    dec = value - value0 - SLOPE_RTOL * step * slope0
    approx = torch.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope0,
                           value - value0 - APPROX_DEC_RTOL * torch.abs(value0))
    dec = torch.clamp(torch.minimum(approx, dec), min=0.0)
    curv = torch.clamp(torch.abs(slope) - CURV_RTOL * torch.abs(slope0),
                       min=0.0)
    nan_inf = (lambda e: torch.where(torch.isnan(e), float("inf"), e))
    return nan_inf(dec), nan_inf(curv)


def zoom(vg: Callable, x, d, value0, grad0, max_steps: int):
    """The zoom line search along ``d``: (stepsize, value, grad)."""
    slope0 = torch.dot(d, grad0)
    zero = torch.zeros_like(value0)

    def trial(step):
        v, g = vg(x + step * d)
        return v, g, torch.dot(g, d)

    s = dict(count=0, step=zero, value=value0, grad=grad0, slope=slope0,
             dec=torch.full_like(value0, float("inf")), found=False,
             done=False, failed=False, low=zero, v_low=value0, s_low=slope0,
             high=zero, v_high=value0, s_high=slope0, ref=zero,
             v_ref=value0, safe=zero, v_safe=value0, g_safe=grad0)
    while not (s["done"] or s["failed"]):
        if not s["found"]:
            step = torch.ones_like(value0) if s["count"] == 0 \
                else INCREASE_FACTOR * s["step"]
            v, g, sl = trial(step)
            dec, curv = _errors(step, v, sl, value0, slope0)
            high_new = bool((dec > 0.0) | ((v >= s["value"]) & (s["count"] > 0)))
            low_new = bool(sl >= 0.0) and not high_new
            if low_new:
                lo, hi = (step, v, sl), (s["step"], s["value"], s["slope"])
            else:
                lo, hi = (s["step"], s["value"], s["slope"]), (step, v, sl)
            done = bool(torch.maximum(dec, curv) <= 0.0)
            safe = bool(dec <= 0.0)
            s.update(found=high_new or low_new or done, done=done,
                     failed=(s["count"] + 1 >= max_steps) and not done,
                     low=lo[0], v_low=lo[1], s_low=lo[2], high=hi[0],
                     v_high=hi[1], s_high=hi[2], ref=lo[0], v_ref=lo[1])
            if safe:
                s.update(safe=step, v_safe=v, g_safe=g)
        else:
            low, high = s["low"], s["high"]
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            cubic = _cubicmin(low, s["v_low"], s["s_low"], high, s["v_high"],
                              s["ref"], s["v_ref"])
            quad = _quadmin(low, s["v_low"], s["s_low"], high, s["v_high"])
            if bool((cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)):
                step = cubic
            elif bool((quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)):
                step = quad
            else:
                step = (low + high) / 2.0
            v, g, sl = trial(step)
            dec, curv = _errors(step, v, sl, value0, slope0)
            if bool((dec <= 0.0) & (v < s["v_safe"])):
                s.update(safe=step, v_safe=v, g_safe=g)
            done = bool(torch.maximum(dec, curv) <= 0.0)
            high_mid = bool((dec > 0.0) | (v >= s["v_low"]))
            high_low = bool(sl * (high - low) >= 0.0) and not high_mid
            new_high = (step, v, sl) if high_mid else (high, s["v_high"],
                                                       s["s_high"])
            if high_low:
                new_high = (low, s["v_low"], s["s_low"])
            new_low = (low, s["v_low"], s["s_low"]) if high_mid \
                else (step, v, sl)
            ref = (high, s["v_high"]) if (high_mid or high_low) \
                else (low, s["v_low"])
            stuck = (s["count"] + 1 >= max_steps) or (
                bool(delta <= INTERVAL_THRESHOLD) and bool(s["safe"] > 0.0))
            s.update(done=done, failed=stuck and not done, low=new_low[0],
                     v_low=new_low[1], s_low=new_low[2], high=new_high[0],
                     v_high=new_high[1], s_high=new_high[2], ref=ref[0],
                     v_ref=ref[1])
        s.update(count=s["count"] + 1, step=step, value=v, grad=g, slope=sl,
                 dec=dec)
        if s["failed"] and (bool(s["safe"] > 0.0)
                            or bool(torch.isinf(s["dec"]))):
            s.update(step=s["safe"], value=s["v_safe"], grad=s["g_safe"])
    return s["step"], s["value"], s["grad"]


def minimize(vg: Callable, x0: torch.Tensor, num_steps: int,
             max_linesearch_steps: int, memory: int = 15):
    """``num_steps`` L-BFGS steps from ``x0``: (the best finite iterate, its
    value)."""
    inf = torch.full((), float("inf"), dtype=x0.dtype, device=x0.device)
    S = torch.zeros((memory,) + x0.shape, dtype=x0.dtype, device=x0.device)
    Y, rho = torch.zeros_like(S), torch.zeros(memory, dtype=x0.dtype,
                                              device=x0.device)
    x, best, f_best = x0, x0, inf
    x_prev = g_prev = None
    value = grad = None
    frozen = False
    for count in range(num_steps):
        if value is None or not bool(torch.isfinite(value)):
            value, grad = vg(x)
        if not frozen and bool(torch.isfinite(value) & (value < f_best)):
            best, f_best = x, value
        if count > 0:
            i = (count - 1) % memory
            S[i], Y[i] = x - x_prev, grad - g_prev
            yts = torch.dot(Y[i], S[i])
            rho[i] = torch.where(yts == 0.0, 0.0, 1.0 / yts)
        x_prev, g_prev = x, grad
        d = -_two_loop(grad, S, Y, rho, count, memory)
        step, value, grad = zoom(vg, x, d, value, grad, max_linesearch_steps)
        x_new = x + step * d
        frozen = not bool(torch.all(torch.isfinite(x_new)))
        x = x if frozen else x_new
    if value is None or not bool(torch.isfinite(value)):
        value, grad = vg(x)
    if not frozen and bool(torch.isfinite(value) & (value < f_best)):
        best, f_best = x, value
    return best, f_best
