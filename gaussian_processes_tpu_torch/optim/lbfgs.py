"""The inner L-BFGS optimizers and their line searches
(counterpart of ``gaussian_processes_tpu/optim/lbfgs.py``).

The JAX package drives ``optax.lbfgs(memory_size=15,
linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=...,
initial_guess_strategy="one"))`` from a ``lax.scan``.  This module is a
line-by-line PyTorch transcription of that optimizer as optax 0.2.6 writes
it (``optax/_src/transform.py::scale_by_lbfgs`` and
``optax/_src/linesearch.py::zoom_linesearch``, with their defaults:
slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, increase_factor 2,
stepsize_precision 1e-5, tol 0, no maximal stepsize), so that the M-step
takes the same path as the JAX fit.  ``torch.optim.LBFGS`` is not a
substitute: its zoom differs, and on hard data the path the optimizer takes
moves the held-out r^2 by up to 0.14.  The same step loop runs optax's
``scale_by_backtracking_linesearch`` (``lbfgs_minimize_backtracking``) and
carries its state across calls (``lbfgs_minimize_zoom_carry``).  Beside
optax's L-BFGS stand the JAX package's own: the batched Armijo ladder over
lanes (``lbfgs_minimize_armijo``) and the speculative search with a
carryable memory (``lbfgs_minimize_speculative``).

The parameters are a dict of tensors (flattened in sorted-key order, the
pytree leaf order optax uses) or one tensor.  The optimizer's own vectors
and scalars live on the CPU in the parameters' dtype; each objective
evaluation moves the trial point to the parameters' device and brings value
and gradient back in one transfer.  ``lax.cond``/``while_loop`` branches
become Python branches on those CPU scalars.

Contract (``_drive_lbfgs``): ``fun`` may return +inf (a bound violation)
and the line search backtracks; an update that leaves non-finite parameters
is reverted (the iterate freezes for that step); the best finite value seen
and its iterate are returned; nonzero ``gtol``/``ftol``/``ftol_rel`` stop
the steps once the stored gradient's inf-norm or the change of value between
accepted steps falls below them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

# optax scale_by_zoom_linesearch defaults
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INCREASE_FACTOR = 2.0
_INTERVAL_THRESHOLD = 1e-5
_TOL = 0.0
# the JAX package's scale_by_backtracking_linesearch arguments (slope_rtol
# is the default 1e-4, atol = rtol = 0, max_learning_rate 1)
_BT_DECREASE = 0.5
_BT_INCREASE = 2.0

Memory = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _flatten(x0):
    """(flat CPU vector, unflatten(v (..., d)) -> structure with v's leading
    axes in front, device).  A dict flattens in sorted-key order (the
    pytree leaf order optax uses)."""
    if isinstance(x0, dict):
        keys = sorted(x0)
        device = x0[keys[0]].device
        flat = torch.stack([x0[k].detach().reshape(()) for k in keys])

        def unflatten(v):
            return {k: v[..., i] for i, k in enumerate(keys)}
    else:
        device = x0.device
        shape = x0.shape
        flat = x0.detach().reshape(-1)

        def unflatten(v):
            return v.reshape(v.shape[:-1] + shape)
    return flat.to("cpu", copy=True), unflatten, device


def _value_and_grad_fn(fun, unflatten, device, dtype):
    def vg(flat: torch.Tensor):
        xs = flat.detach().to(device, copy=True).requires_grad_(True)
        with torch.enable_grad():
            v = fun(unflatten(xs))
            if v.requires_grad:
                (g,) = torch.autograd.grad(v, xs)
            else:
                g = torch.zeros_like(xs)
        out = torch.cat([v.detach().reshape(1).to(dtype), g.to(dtype)]).cpu()
        return out[0], out[1:]
    return vg


def _linearize_fn(fun, unflatten, device, dtype):
    """``lin(flat) -> (value, pullback)``: the value in one transfer, and
    ``pullback()`` the gradient at the same point from the same evaluation's
    graph (what ``jax.linearize`` and its transpose give optax's
    store_grad backtracking), in one more transfer."""
    def lin(flat: torch.Tensor):
        xs = flat.detach().to(device, copy=True).requires_grad_(True)
        with torch.enable_grad():
            v = fun(unflatten(xs))

        def pullback():
            if not v.requires_grad:
                return torch.zeros_like(flat)
            (g,) = torch.autograd.grad(v, xs)
            return g.to(dtype).cpu()
        return v.detach().to(dtype).cpu(), pullback
    return lin


# ---------------------------------------------------------------------------
# scale_by_lbfgs (optax/_src/transform.py:1497-1753)
# ---------------------------------------------------------------------------

class _LbfgsState(NamedTuple):
    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor      # (memory, d)
    diff_updates: torch.Tensor     # (memory, d)
    weights: torch.Tensor          # (memory,)
    # the line search's state: value/grad at the accepted point, and the
    # backtracking search's learning rate carried to the next step
    value: torch.Tensor
    grad: torch.Tensor
    learning_rate: torch.Tensor


def _lbfgs_init(x0: torch.Tensor, memory_size: int) -> _LbfgsState:
    z = torch.zeros_like(x0)
    zm = torch.zeros((memory_size,) + x0.shape, dtype=x0.dtype)
    return _LbfgsState(0, z, z, zm, zm.clone(),
                       torch.zeros(memory_size, dtype=x0.dtype),
                       torch.tensor(float("inf"), dtype=x0.dtype), z,
                       torch.ones((), dtype=x0.dtype))


def _precondition(updates, dp_mem, du_mem, rhos, identity_scale, memory_idx):
    memory_size = rhos.shape[0]
    indices = [(memory_idx + i) % memory_size for i in range(memory_size)]
    vec = updates
    alphas = [None] * memory_size
    for pos in reversed(range(memory_size)):
        idx = indices[pos]
        alpha = rhos[idx] * torch.dot(dp_mem[idx], vec)
        vec = vec + (-alpha) * du_mem[idx]
        alphas[pos] = alpha
    vec = identity_scale * vec
    for pos in range(memory_size):
        idx = indices[pos]
        beta = rhos[idx] * torch.dot(du_mem[idx], vec)
        vec = vec + (alphas[pos] - beta) * dp_mem[idx]
    return vec


def _scale_by_lbfgs(grad, state: _LbfgsState, params):
    """Memory update + two-loop recursion: returns P_k g and the state."""
    memory_size = state.weights.shape[0]
    memory_idx = state.count % memory_size
    prev_idx = (state.count - 1) % memory_size
    diff_params = params - state.params
    diff_updates = grad - state.updates
    vdot_du_dp = torch.dot(diff_updates, diff_params)
    weight = torch.where(vdot_du_dp == 0.0, 0.0, 1.0 / vdot_du_dp)
    if state.count == 0:
        diff_params = torch.zeros_like(diff_params)
        diff_updates = torch.zeros_like(diff_updates)
        weight = torch.zeros_like(weight)
    dp_mem = state.diff_params.clone()
    du_mem = state.diff_updates.clone()
    rhos = state.weights.clone()
    dp_mem[prev_idx] = diff_params
    du_mem[prev_idx] = diff_updates
    rhos[prev_idx] = weight
    if state.count > 0:
        numerator = torch.dot(diff_updates, diff_params)
        denominator = torch.sum(diff_updates * diff_updates)
        identity_scale = torch.where(denominator > 0.0,
                                     numerator / denominator, 1.0)
    else:
        # first step: a capped reciprocal of the gradient norm
        identity_scale = torch.clamp(
            1.0 / torch.sqrt(torch.sum(grad * grad)), max=1.0)
    precond = _precondition(grad, dp_mem, du_mem, rhos, identity_scale,
                            memory_idx)
    return precond, state._replace(count=state.count + 1, params=params,
                                   updates=grad, diff_params=dp_mem,
                                   diff_updates=du_mem, weights=rhos)


# ---------------------------------------------------------------------------
# zoom_linesearch (optax/_src/linesearch.py:455-1282)
# ---------------------------------------------------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    decrease_error = (value_step - value_init
                      - _SLOPE_RTOL * stepsize * slope_init)
    approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta_values = (value_step - value_init
                    - _APPROX_DEC_RTOL * torch.abs(value_init))
    approx = torch.maximum(approx, delta_values)
    decrease_error = torch.minimum(approx, decrease_error)
    decrease_error = torch.clamp(decrease_error, min=0.0)
    return torch.where(torch.isnan(decrease_error), float("inf"),
                       decrease_error)


def _curvature_error(slope_step, slope_init):
    curvature_error = torch.abs(slope_step) - _CURV_RTOL * torch.abs(slope_init)
    curvature_error = torch.clamp(curvature_error, min=0.0)
    return torch.where(torch.isnan(curvature_error), float("inf"),
                       curvature_error)


class _Zoom(NamedTuple):
    count: int
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    interval_found: bool
    done: bool
    failed: bool
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def _zoom_linesearch(vg, params, updates, value, grad,
                     max_linesearch_steps: int):
    """Returns (stepsize, value, grad) of the accepted point."""
    dtype = params.dtype
    slope_init = torch.dot(updates, grad)
    zero = torch.zeros((), dtype=dtype)
    stepsize_guess = torch.ones((), dtype=dtype)

    def on_line(stepsize):
        v, g = vg(params + stepsize * updates)
        return v, g, torch.dot(g, updates)

    def where(cond, a, b):
        return torch.where(cond, a, b)

    def search_interval(s: _Zoom) -> _Zoom:
        new_stepsize = (stepsize_guess if s.count == 0
                        else _INCREASE_FACTOR * s.stepsize)
        v, g, slope = on_line(new_stepsize)
        de = _decrease_error(new_stepsize, v, slope, value, slope_init)
        ce = _curvature_error(slope, slope_init)
        new_error = torch.maximum(de, ce)
        safe_decrease = de <= _TOL
        set_high_to_new = bool((de > 0.0) | ((v >= s.value) & (s.count > 0)))
        set_low_to_new = bool(slope >= 0.0) and not set_high_to_new
        if set_low_to_new:
            low, value_low, slope_low = new_stepsize, v, slope
            high, value_high, slope_high = s.stepsize, s.value, s.slope
        else:
            low, value_low, slope_low = s.stepsize, s.value, s.slope
            high, value_high, slope_high = new_stepsize, v, slope
        done = bool(new_error <= _TOL)
        interval_found = set_high_to_new or set_low_to_new or done
        failed = (s.count + 1 >= max_linesearch_steps) and not done
        return _Zoom(
            count=s.count + 1, stepsize=new_stepsize, value=v, grad=g,
            slope=slope, decrease_error=de, curvature_error=ce,
            interval_found=interval_found, done=done, failed=failed,
            low=low, value_low=value_low, slope_low=slope_low, high=high,
            value_high=value_high, slope_high=slope_high, cubic_ref=low,
            value_cubic_ref=value_low,
            safe_stepsize=where(safe_decrease, new_stepsize, s.safe_stepsize),
            safe_value=where(safe_decrease, v, s.safe_value),
            safe_grad=where(safe_decrease, g, s.safe_grad))

    def zoom_into_interval(s: _Zoom) -> _Zoom:
        low, high = s.low, s.high
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = bool(delta <= _INTERVAL_THRESHOLD)
        middle_cubic = _cubicmin(low, s.value_low, s.slope_low, high,
                                 s.value_high, s.cubic_ref, s.value_cubic_ref)
        use_cubic = bool((middle_cubic > left + cubic_chk)
                         & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, s.value_low, s.slope_low, high,
                               s.value_high)
        use_quad = (not use_cubic) and bool(
            (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk))
        if use_cubic:
            middle = middle_cubic
        elif use_quad:
            middle = middle_quad
        else:
            middle = (low + high) / 2.0
        v, g, slope = on_line(middle)
        de = _decrease_error(middle, v, slope, value, slope_init)
        ce = _curvature_error(slope, slope_init)
        new_error = torch.maximum(de, ce)
        update_safe = bool((de <= _TOL) & (v < s.safe_value))
        safe_stepsize = middle if update_safe else s.safe_stepsize
        safe_value = v if update_safe else s.safe_value
        safe_grad = g if update_safe else s.safe_grad
        done = bool(new_error <= _TOL)
        set_high_to_middle = bool((de > 0.0) | (v >= s.value_low))
        set_high_to_low = (bool(slope * (high - low) >= 0.0)
                           and not set_high_to_middle)
        set_low_to_middle = not set_high_to_middle
        new_high = (middle, v, slope) if set_high_to_middle else (
            high, s.value_high, s.slope_high)
        if set_high_to_low:
            new_high = (low, s.value_low, s.slope_low)
        new_low = (middle, v, slope) if set_low_to_middle else (
            low, s.value_low, s.slope_low)
        if set_high_to_middle or set_high_to_low:
            cubic_ref, value_cubic_ref = high, s.value_high
        else:
            cubic_ref, value_cubic_ref = low, s.value_low
        presumably_failed = ((s.count + 1 >= max_linesearch_steps)
                             or (too_small_int and bool(safe_stepsize > 0.0)))
        return _Zoom(
            count=s.count + 1, stepsize=middle, value=v, grad=g, slope=slope,
            decrease_error=de, curvature_error=ce,
            interval_found=s.interval_found, done=done,
            failed=presumably_failed and not done,
            low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
            high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
            cubic_ref=cubic_ref, value_cubic_ref=value_cubic_ref,
            safe_stepsize=safe_stepsize, safe_value=safe_value,
            safe_grad=safe_grad)

    def try_safe_step(s: _Zoom) -> _Zoom:
        outside_domain = bool(torch.isinf(s.decrease_error))
        if bool(s.safe_stepsize > 0.0) or outside_domain:
            return s._replace(stepsize=s.safe_stepsize, value=s.safe_value,
                              grad=s.safe_grad)
        return s

    inf = torch.tensor(float("inf"), dtype=dtype)
    s = _Zoom(count=0, stepsize=zero, value=value, grad=grad,
              slope=slope_init, decrease_error=inf, curvature_error=inf,
              interval_found=False, done=False, failed=False,
              low=zero, value_low=value, slope_low=slope_init, high=zero,
              value_high=value, slope_high=slope_init, cubic_ref=zero,
              value_cubic_ref=value, safe_stepsize=zero, safe_value=value,
              safe_grad=grad)
    while not (s.done or s.failed):
        s = zoom_into_interval(s) if s.interval_found else search_interval(s)
        if s.failed:
            s = try_safe_step(s)
    return s.stepsize, s.value, s.grad


# ---------------------------------------------------------------------------
# scale_by_backtracking_linesearch (optax/_src/linesearch.py:75-441), as
# the JAX package configures it: store_grad, decrease 0.5, increase 2
# ---------------------------------------------------------------------------

def _backtracking_linesearch(lin, params, updates, value, grad,
                             learning_rate, max_backtracking_steps: int):
    """Halve the step from min(2 * the carried learning rate, 1) until the
    value decreases by at least slope_rtol * step * slope (at most
    max_backtracking_steps + 1 values; the gradient only at the last).
    Returns (stepsize, value, grad, learning rate to carry): the stepsize
    is 0 when the last decrease error is infinite (a NaN or +inf value),
    and the last trial's value and gradient are returned even when it
    failed, as optax does."""
    inf = torch.tensor(float("inf"), dtype=params.dtype)
    slope = torch.dot(updates, grad)
    lr = torch.clamp(_BT_INCREASE * learning_rate, max=1.0)
    new_value, new_grad = value, torch.zeros_like(params)
    decrease_error = inf
    it = 0
    while not bool(decrease_error <= 0.0) and it <= max_backtracking_steps:
        if it > 0:
            lr = _BT_DECREASE * lr
        new_value, pullback = lin(params + lr * updates)
        decrease_error = new_value - value - lr * _SLOPE_RTOL * slope
        decrease_error = torch.clamp(torch.where(
            torch.isnan(decrease_error), inf, decrease_error), min=0.0)
        if bool(decrease_error <= 0.0) or it == max_backtracking_steps:
            new_grad = pullback()
        it += 1
    lr = torch.where(torch.isinf(decrease_error), 0.0, lr)
    return lr, new_value, new_grad, lr


# ---------------------------------------------------------------------------
# The step loop (gaussian_processes_tpu/optim/lbfgs.py::_drive_lbfgs)
# ---------------------------------------------------------------------------

def _drive_lbfgs(vg: Callable, x0: torch.Tensor, num_steps: int,
                 search: Callable, memory_size: int = 15,
                 state0: Optional[_LbfgsState] = None,
                 return_state: bool = False, gtol: float = 0.0,
                 ftol: float = 0.0, ftol_rel: float = 0.0):
    """``num_steps`` L-BFGS steps from the flat CPU vector ``x0`` with
    best-iterate tracking; returns (x_best, f_best) as CPU tensors, and the
    optimizer state after the last step with ``return_state``.  ``search(x,
    direction, value, grad, state) -> (stepsize, value, grad,
    learning_rate)`` is the line search; ``state0`` a state to start from
    (a fresh one of ``memory_size`` pairs when None)."""
    dtype = x0.dtype
    inf = torch.tensor(float("inf"), dtype=dtype)
    state = _lbfgs_init(x0, memory_size) if state0 is None else state0
    early = (gtol > 0.0) or (ftol > 0.0) or (ftol_rel > 0.0)

    def value_and_grad_from_state(x, state):
        # the value/grad the line search stored for the accepted point, or a
        # fresh evaluation when none is stored (first step, +inf, NaN)
        if bool(torch.isfinite(state.value)):
            return state.value, state.grad
        return vg(x)

    def do_update(x, state, value, grad):
        precond, state = _scale_by_lbfgs(grad, state, x)
        direction = -precond
        lr, ls_value, ls_grad, ls_lr = search(x, direction, value, grad,
                                              state)
        state = state._replace(value=ls_value, grad=ls_grad,
                               learning_rate=ls_lr)
        x_new = x + lr * direction
        bad = not bool(torch.all(torch.isfinite(x_new)))
        if bad:
            x_new = x         # freeze on non-finite parameters
        return x_new, state, bad

    x = x0
    x_best, f_best = x0, inf
    was_frozen, done, f_prev = False, False, inf
    for _ in range(num_steps):
        value, grad = value_and_grad_from_state(x, state)
        # after a frozen step x was reverted but the state still stores the
        # rejected point's value: it must not label x as best
        value_for_best = inf if was_frozen else value
        if bool(torch.isfinite(value_for_best) & (value_for_best < f_best)):
            x_best, f_best = x, value_for_best
        if not early:
            x, state, was_frozen = do_update(x, state, value, grad)
            continue
        conv = False
        if gtol > 0.0:
            gmax = torch.max(torch.abs(grad))
            conv = conv or bool(torch.isfinite(value) & (gmax <= gtol))
        if ftol > 0.0 or ftol_rel > 0.0:
            thresh = ftol + ftol_rel * torch.abs(value)
            conv = conv or bool(torch.abs(value - f_prev) < thresh)
        done = done or (conv and not was_frozen)
        f_prev = inf if was_frozen else value
        if done:
            # identity step; store the value/grad so later steps and the
            # final fold do not re-evaluate the objective
            state = state._replace(value=value, grad=grad)
            was_frozen = False
        else:
            x, state, was_frozen = do_update(x, state, value, grad)
    value_f, _ = value_and_grad_from_state(x, state)
    if was_frozen:
        value_f = inf
    if bool(torch.isfinite(value_f) & (value_f < f_best)):
        x_best, f_best = x, value_f
    if return_state:
        return x_best, f_best, state
    return x_best, f_best


def _zoom(vg, max_linesearch_steps: int) -> Callable:
    """The zoom search as ``_drive_lbfgs``'s ``search``."""
    def search(x, direction, value, grad, state):
        lr, ls_value, ls_grad = _zoom_linesearch(
            vg, x, direction, value, grad, max_linesearch_steps)
        return lr, ls_value, ls_grad, lr
    return search


def lbfgs_minimize(fun: Optional[Callable[[Any], torch.Tensor]], x0: Any,
                   num_steps: int, memory_size: int = 15,
                   max_linesearch_steps: int = 20, gtol: float = 0.0,
                   ftol: float = 0.0, ftol_rel: float = 0.0,
                   vg: Optional[Callable] = None
                   ) -> Tuple[Any, torch.Tensor]:
    """Run ``num_steps`` L-BFGS steps minimizing ``fun`` from ``x0`` (a
    dict of 0-d tensors or one tensor).  Returns ``(x_best, f_best)``:
    x_best in x0's structure on x0's device, f_best a 0-d CPU tensor.
    ``fun`` may return +inf (bound violation); the zoom line search then
    backtracks.  NaN values freeze the iterate.  ``vg(flat) -> (value,
    grad)``, on the flat CPU vector (sorted-key order for a dict), takes
    the place of fun's autograd (``optim/graphed``)."""
    flat0, unflatten, device = _flatten(x0)
    if vg is None:
        vg = _value_and_grad_fn(fun, unflatten, device, flat0.dtype)
    x_best, f_best = _drive_lbfgs(vg, flat0, num_steps,
                                  _zoom(vg, max_linesearch_steps),
                                  memory_size, gtol=gtol, ftol=ftol,
                                  ftol_rel=ftol_rel)
    return unflatten(x_best.to(device)), f_best


def zoom_carry_init(x0: Any, memory_size: int = 15) -> _LbfgsState:
    """A fresh L-BFGS state for ``lbfgs_minimize_zoom_carry`` (a fit builds
    it at init and carries it through the EM iterations)."""
    return _lbfgs_init(_flatten(x0)[0], memory_size)


def lbfgs_minimize_zoom_carry(fun: Optional[Callable[[Any], torch.Tensor]],
                              x0: Any, num_steps: int, state: _LbfgsState,
                              max_linesearch_steps: int = 20,
                              gtol: float = 0.0, ftol: float = 0.0,
                              ftol_rel: float = 0.0,
                              vg: Optional[Callable] = None
                              ) -> Tuple[Any, torch.Tensor, _LbfgsState]:
    """``lbfgs_minimize`` from a carried optimizer ``state``: its curvature
    memory (and step count) persist across calls.  The stored value and
    gradient belong to the previous call's objective, so the value is set
    to +inf here and the first step evaluates the new objective at ``x0``.
    The memory size is the state's; ``vg`` as ``lbfgs_minimize``'s.
    Returns ``(x_best, f_best, state_out)``."""
    flat0, unflatten, device = _flatten(x0)
    if vg is None:
        vg = _value_and_grad_fn(fun, unflatten, device, flat0.dtype)
    state = state._replace(value=torch.full_like(state.value, float("inf")))
    x_best, f_best, state = _drive_lbfgs(
        vg, flat0, num_steps, _zoom(vg, max_linesearch_steps),
        state0=state, return_state=True, gtol=gtol, ftol=ftol,
        ftol_rel=ftol_rel)
    return unflatten(x_best.to(device)), f_best, state


def lbfgs_minimize_backtracking(fun: Callable[[Any], torch.Tensor], x0: Any,
                                num_steps: int, memory_size: int = 15,
                                max_linesearch_steps: int = 15
                                ) -> Tuple[Any, torch.Tensor]:
    """L-BFGS with optax's Armijo backtracking (sufficient decrease only)
    in place of the zoom search: each trial costs a value, and the accepted
    (or last) trial's gradient comes from the same evaluation.  Same
    contract as ``lbfgs_minimize``, without the gates."""
    flat0, unflatten, device = _flatten(x0)
    dtype = flat0.dtype
    vg = _value_and_grad_fn(fun, unflatten, device, dtype)
    lin = _linearize_fn(fun, unflatten, device, dtype)

    def search(x, direction, value, grad, state):
        return _backtracking_linesearch(lin, x, direction, value, grad,
                                        state.learning_rate,
                                        max_linesearch_steps)

    x_best, f_best = _drive_lbfgs(vg, flat0, num_steps, search, memory_size)
    return unflatten(x_best.to(device)), f_best


# ---------------------------------------------------------------------------
# Batched-Armijo L-BFGS (gaussian_processes_tpu/optim/lbfgs.py:
# _two_loop and lbfgs_minimize_armijo), over a leading lane axis
# ---------------------------------------------------------------------------

def _flatten_lanes(x0):
    """(flat (lanes, d), unflatten(v (..., d)) -> structure with the leading
    shape of v[..., 0]).  A dict of (lanes,) tensors flattens in sorted-key
    order (the JAX pytree order); a tensor (lanes, *shape) to (lanes, d)."""
    if isinstance(x0, dict):
        keys = sorted(x0)
        flat = torch.stack([x0[k].detach() for k in keys], dim=-1)

        def unflatten(v):
            return {k: v[..., i] for i, k in enumerate(keys)}
    else:
        shape = x0.shape[1:]
        flat = x0.detach().reshape(x0.shape[0], -1)

        def unflatten(v):
            return v.reshape(*v.shape[:-1], *shape)
    return flat.clone(), unflatten


def _two_loop_lanes(g, S, Y, rho, age):
    """The two-loop recursion of each lane over its memory slots, newest
    first by ``age`` (-1 = empty slot, contributing exactly nothing): the
    direction -H g, (lanes, d)."""
    dtype = g.dtype
    tiny = torch.finfo(dtype).tiny
    order = torch.argsort(-age, dim=1, stable=True)
    valid = (age >= 0).to(dtype)
    d = g.shape[1]
    S_o = S.gather(1, order[..., None].expand(-1, -1, d))
    Y_o = Y.gather(1, order[..., None].expand(-1, -1, d))
    rho_o = rho.gather(1, order)
    valid_o = valid.gather(1, order)
    q = g
    a_list = []
    for i in range(S.shape[1]):
        a_i = rho_o[:, i] * (S_o[:, i] * q).sum(-1) * valid_o[:, i]
        q = q - a_i[:, None] * Y_o[:, i]
        a_list.append(a_i)
    # gamma scaling from the most recent pair
    ys = (Y_o[:, 0] * Y_o[:, 0]).sum(-1)
    sy = 1.0 / torch.where(rho_o[:, 0] > 0, rho_o[:, 0],
                           torch.ones_like(rho_o[:, 0]))
    gamma = torch.where((age >= 0).any(1), sy / torch.clamp(ys, min=tiny),
                        torch.ones_like(ys))
    r = gamma[:, None] * q
    for i in reversed(range(S.shape[1])):
        b_i = rho_o[:, i] * (Y_o[:, i] * r).sum(-1) * valid_o[:, i]
        r = r + (a_list[i] - b_i)[:, None] * S_o[:, i]
    return -r


def lbfgs_minimize_armijo(fun: Callable[[Any], torch.Tensor], x0: Any,
                          num_steps: int, memory_size: int = 8,
                          ls_trials: int = 6, c1: float = 1e-4
                          ) -> Tuple[Any, torch.Tensor]:
    """L-BFGS with a batched Armijo ladder, independently in each lane of a
    leading lane axis (one lane per cell in the population fit).

    ``x0`` is a dict of (lanes,) tensors or a tensor (lanes, *shape).
    ``fun`` takes the same structure with a trial axis after the lane axis
    -- a dict of (lanes, trials) tensors, or a tensor (lanes, trials,
    *shape) -- and returns (lanes, trials) values; lanes and trials must not
    mix.  Each step evaluates the ladder ``0.5 ** arange(ls_trials)`` as one
    call (no gradient), takes the first trial that satisfies Armijo with
    c1, then one value-and-gradient call at the accepted points (trials =
    1; autograd of the sum over lanes gives each lane its own gradient).  A
    non-descent direction falls back to -g; a curvature pair is stored in
    slot ``k % memory_size`` only when s.y > 1e-10 max(s.s, 1e-30); a lane
    whose accepted value or point is not finite keeps its state (frozen),
    and +inf is never accepted.  Returns ``(x_best, f_best)``: the best
    finite iterate of each lane and its value.

    No host synchronization: every decision is a per-lane ``torch.where``
    (the first true trial is an argmax over an integer mask).
    """
    flat, unflatten = _flatten_lanes(x0)
    lanes, d = flat.shape
    dtype, dev = flat.dtype, flat.device
    alphas = 0.5 ** torch.arange(ls_trials, dtype=dtype, device=dev)
    slots = torch.arange(memory_size, device=dev)
    tiny = torch.finfo(dtype).tiny

    def vg(x):
        xs = x.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = fun(unflatten(xs[:, None, :]))[:, 0]
            if v.requires_grad:
                (g,) = torch.autograd.grad(v.sum(), xs)
            else:
                g = torch.zeros_like(xs)
        return v.detach(), g

    f, g = vg(flat)
    S = torch.zeros((lanes, memory_size, d), dtype=dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((lanes, memory_size), dtype=dtype, device=dev)
    age = torch.full((lanes, memory_size), -1, dtype=torch.int64, device=dev)
    x_best = flat
    f_best = torch.where(torch.isfinite(f), f, float("inf"))
    for k in range(num_steps):
        direction = _two_loop_lanes(g, S, Y, rho, age)
        gd = (g * direction).sum(-1)
        # non-descent direction (memory gone stale): fall back to -g
        bad_dir = (gd >= 0) | ~torch.isfinite(gd)
        direction = torch.where(bad_dir[:, None], -g, direction)
        gd = torch.where(bad_dir, -(g * g).sum(-1), gd)

        trials = flat[:, None, :] + alphas[None, :, None] * direction[:, None]
        with torch.no_grad():
            fs = fun(unflatten(trials))
        ok = fs <= f[:, None] + c1 * alphas[None, :] * gd[:, None]
        # first True (0 when none)
        first = torch.argmax(ok.to(torch.int32), dim=1)
        any_ok = ok.any(1)
        alpha = torch.where(any_ok, alphas[first], torch.zeros_like(f))
        x_new = flat + alpha[:, None] * direction
        f_new, g_new = vg(x_new)
        # reject non-finite results (the lane keeps its state)
        finite = torch.isfinite(f_new) & torch.isfinite(x_new).all(1)
        accept = any_ok & finite
        x_new = torch.where(accept[:, None], x_new, flat)
        f_new = torch.where(accept, f_new, f)
        g_new = torch.where(accept[:, None], g_new, g)

        s = x_new - flat
        y = g_new - g
        sy = (s * y).sum(-1)
        store = accept & (sy > 1e-10 * torch.clamp((s * s).sum(-1),
                                                     min=1e-30))
        put = store[:, None] & (slots == k % memory_size)[None, :]
        S = torch.where(put[..., None], s[:, None, :], S)
        Y = torch.where(put[..., None], y[:, None, :], Y)
        rho = torch.where(put, (1.0 / torch.clamp(sy, min=tiny))[:, None],
                          rho)
        age = age.masked_fill(put, k)

        better = torch.isfinite(f_new) & (f_new < f_best)
        x_best = torch.where(better[:, None], x_new, x_best)
        f_best = torch.where(better, f_new, f_best)
        flat, f, g = x_new, f_new, g_new
    return unflatten(x_best), f_best


# ---------------------------------------------------------------------------
# Speculative-accept L-BFGS (gaussian_processes_tpu/optim/lbfgs.py:
# empty_lbfgs_memory and lbfgs_minimize_speculative), one lane
# ---------------------------------------------------------------------------

def empty_lbfgs_memory(d: int, dtype, memory_size: int = 8) -> Memory:
    """An empty carryable L-BFGS memory (S, Y, rho, age) on the CPU, every
    slot unused (age -1); ``d`` is the flattened parameter dimension."""
    return (torch.zeros((memory_size, d), dtype=dtype),
            torch.zeros((memory_size, d), dtype=dtype),
            torch.zeros(memory_size, dtype=dtype),
            torch.full((memory_size,), -1, dtype=torch.int64))


def _two_loop(g, S, Y, rho, age):
    """The two-loop recursion of one lane: the direction -H g, (d,)."""
    return _two_loop_lanes(g[None], S[None], Y[None], rho[None],
                           age[None])[0]


def lbfgs_minimize_speculative(fun: Callable[[Any], torch.Tensor], x0: Any,
                               num_steps: int, memory_size: int = 8,
                               max_backtracks: int = 10, c1: float = 1e-4,
                               memory: Optional[Memory] = None,
                               ladder_fun: Optional[Callable] = None
                               ) -> Tuple[Any, torch.Tensor, Memory]:
    """L-BFGS with a speculative-accept Armijo line search (one lane).

    Each step takes value and gradient at one step of the carried scale
    ``a_spec`` along the two-loop direction.  When that step fails Armijo
    (c1), one value-only call evaluates the whole ladder ``a_spec *
    0.5 ** arange(1, max_backtracks + 1)``, and value and gradient are
    taken at the first rung that passes.  A non-descent or non-finite
    direction falls back to steepest descent scaled by min(1, 1/|g|_1).
    ``a_spec`` starts at 1; an accepted speculation doubles it (at most 1),
    a rung's acceptance adopts the rung, a failure halves it, and it stays
    in [2^-20, 1].  A pair (s, y) is stored only when s.y > 1e-10 max(s.s,
    1e-30), into the oldest slot (``argmin(age)``) with age ``max(age) +
    1``.

    ``memory`` (S, Y, rho, age), from ``empty_lbfgs_memory`` or an earlier
    call, carries the curvature pairs across calls.  ``ladder_fun`` takes
    the ladder's trial points in x0's structure with a leading trial axis
    (a dict of (T,) tensors, or a tensor (T, *shape)) and returns their T
    values in one batched call; without it the ladder loops over ``fun``.
    The optimizer's vectors live on the CPU: each evaluation, and the
    ladder call, makes one transfer.  Returns ``(x_best, f_best,
    memory_out)``."""
    flat0, unflatten, device = _flatten(x0)
    d, dtype = flat0.shape[0], flat0.dtype
    vg = _value_and_grad_fn(fun, unflatten, device, dtype)
    tiny = torch.finfo(dtype).tiny
    ladder = 0.5 ** torch.arange(1, max_backtracks + 1, dtype=dtype)

    def values(trials):
        xs = trials.to(device)
        with torch.no_grad():
            if ladder_fun is not None:
                fs = ladder_fun(unflatten(xs))
            else:
                fs = torch.stack([fun(unflatten(x)) for x in xs])
        return fs.detach().to(dtype).cpu()

    if memory is None:
        S, Y, rho, age = empty_lbfgs_memory(d, dtype, memory_size)
    else:
        S, Y, rho, age = (t.clone() for t in memory)
    flat = flat0
    f, g = vg(flat0)
    inf = torch.tensor(float("inf"), dtype=dtype)
    x_best, f_best = flat0, (f if bool(torch.isfinite(f)) else inf)
    a_spec = torch.ones((), dtype=dtype)
    for _ in range(num_steps):
        direction = _two_loop(g, S, Y, rho, age)
        gd = torch.dot(g, direction)
        if bool((gd >= 0) | ~torch.isfinite(gd)):
            gscale = torch.clamp(
                1.0 / torch.clamp(torch.sum(torch.abs(g)), min=tiny), max=1.0)
            direction = -g * gscale
            gd = -torch.dot(g, g) * gscale

        # the speculative step: value and gradient in one evaluation
        x_new = flat + a_spec * direction
        f_new, g_new = vg(x_new)
        spec_ok = bool(torch.isfinite(f_new)
                       & (f_new <= f + c1 * a_spec * gd)
                       & torch.all(torch.isfinite(g_new)))
        a_used, accept = a_spec, spec_ok
        if not spec_ok:
            # the ladder below a_spec in one value-only call, then value
            # and gradient at its first Armijo rung (JAX also evaluates at
            # step 0 when no rung passes, and discards the result)
            alphas = a_spec * ladder
            fs = values(flat[None, :] + alphas[:, None] * direction[None, :])
            ok = torch.isfinite(fs) & (fs <= f + c1 * alphas * gd)
            accept = bool(ok.any())
            if accept:
                a_used = alphas[int(torch.argmax(ok.to(torch.int32)))]
                x_new = flat + a_used * direction
                f_new, g_new = vg(x_new)
                accept = bool(torch.isfinite(f_new)
                              & torch.all(torch.isfinite(g_new)))
        accept = accept and bool(torch.all(torch.isfinite(x_new)))
        if not accept:
            x_new, f_new, g_new = flat, f, g

        s = x_new - flat
        y = g_new - g
        sy = torch.dot(s, y)
        if accept and bool(sy > 1e-10 * torch.clamp(torch.dot(s, s),
                                                    min=1e-30)):
            slot = int(torch.argmin(age))
            age[slot] = age.max() + 1
            S[slot], Y[slot] = s, y
            rho[slot] = 1.0 / torch.clamp(sy, min=tiny)

        if bool(torch.isfinite(f_new) & (f_new < f_best)):
            x_best, f_best = x_new, f_new
        if accept and spec_ok:
            a_next = torch.clamp(2.0 * a_used, max=1.0)
        elif accept:
            a_next = torch.clamp(a_used, min=tiny)
        else:
            a_next = 0.5 * a_spec
        a_spec = torch.clamp(a_next, 2.0 ** -20, 1.0)
        flat, f, g = x_new, f_new, g_new
    return unflatten(x_best.to(device)), f_best, (S, Y, rho, age)
