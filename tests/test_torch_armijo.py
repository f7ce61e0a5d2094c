"""The port's batched-Armijo L-BFGS (optim/lbfgs.lbfgs_minimize_armijo)
against the JAX package's, float64, on the same objectives and starts.

The port runs a leading lane axis; each JAX run is one lane.  Tolerances:
the best iterate and its value within 1e-12 (relative and absolute: the
same arithmetic up to the summation order of 2- to 6-element dot products),
after 1, 3 and 12 steps.  A batch of lanes equals the lanes run one by one (1e-12), and a
lane whose objective turns NaN stays where it was while the others move.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.optim.lbfgs import lbfgs_minimize_armijo as j_armijo
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.optim.lbfgs import (
    lbfgs_minimize_armijo as t_armijo)

torch.set_num_threads(1)

STEPS = (1, 3, 12)
Q = np.array([[3.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 0.5]])
B = np.array([1.0, -2.0, 0.5])


def quad_j(x):
    return 0.5 * x @ jnp.asarray(Q) @ x - jnp.asarray(B) @ x


def quad_t(x):          # (..., 3)
    Qt, Bt = torch.as_tensor(Q), torch.as_tensor(B)
    return 0.5 * torch.einsum("...i,ij,...j->...", x, Qt, x) - x @ Bt


def rosen_j(x):
    return 0.01 * ((1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2)


def rosen_t(x):
    return 0.01 * ((1 - x[..., 0]) ** 2
                   + 100 * (x[..., 1] - x[..., 0] ** 2) ** 2)


def box_j(x):
    v = jnp.sum((x - 2.0) ** 2)
    return jnp.where(jnp.all(jnp.abs(x) <= 1.0), v, jnp.inf)


def box_t(x):
    v = ((x - 2.0) ** 2).sum(-1)
    return torch.where((x.abs() <= 1.0).all(-1), v, float("inf"))


CASES = {
    "quadratic": (quad_j, quad_t, [[0.0, 0.0, 0.0], [2.0, -1.0, 3.0]]),
    "rosenbrock": (rosen_j, rosen_t, [[-0.5, 0.8], [0.3, 0.2]]),
    "inf_outside_a_box": (box_j, box_t, [[0.0, 0.0], [-0.5, 0.9]]),
}


def close(t, j, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_armijo_matches_jax(case, steps):
    fj, ft, starts = CASES[case]
    x0 = torch.tensor(starts, dtype=torch.float64)
    xt, f_t = t_armijo(ft, x0, steps)
    for lane, start in enumerate(starts):
        xj, f_j = j_armijo(fj, jnp.asarray(start), steps)
        close(xt[lane], xj)
        close(f_t[lane], f_j)
    if case == "inf_outside_a_box":
        assert torch.all(torch.isfinite(f_t))
        assert torch.all(xt.abs() <= 1.0)
    if steps == 12:
        assert torch.all(f_t < ft(x0))     # every lane moved


def test_dict_parameters_flatten_in_key_order():
    """A dict of per-lane scalars flattens in sorted-key order, as JAX's
    ravel_pytree of a dict does."""
    def fj(p):
        return quad_j(jnp.stack([p["c"], p["a"], p["b"]]))

    def ft(p):
        return quad_t(torch.stack([p["c"], p["a"], p["b"]], -1))

    start = {"a": 0.5, "b": -1.0, "c": 2.0}
    xj, f_j = j_armijo(fj, {k: jnp.float64(v) for k, v in start.items()}, 5)
    xt, f_t = t_armijo(ft, {k: torch.tensor([v], dtype=torch.float64)
                            for k, v in start.items()}, 5)
    for k in start:
        close(xt[k][0], xj[k])
    close(f_t[0], f_j)


def test_lanes_equal_lanes_run_alone():
    starts = torch.tensor([[-0.5, 0.8], [0.3, 0.2], [1.5, 2.5]],
                          dtype=torch.float64)
    xb, fb = t_armijo(rosen_t, starts, 12)
    for lane in range(3):
        x1, f1 = t_armijo(rosen_t, starts[lane:lane + 1], 12)
        close(xb[lane], x1[0])
        close(fb[lane], f1[0])


def test_a_nan_lane_stays_frozen_while_the_others_move():
    """Lane 1's objective is NaN away from its start: it never accepts a
    step (its iterate and value stay the start's), and the other lanes take
    exactly the steps they take alone."""
    starts = torch.tensor([[-0.5, 0.8], [0.3, 0.2], [1.5, 2.5]],
                          dtype=torch.float64)

    def fun(x):
        v = rosen_t(x)
        moved = (x[1:2] - starts[1]).abs().sum(-1) > 0
        return torch.cat([v[:1], torch.where(moved, float("nan"), v[1:2]),
                          v[2:]])

    xb, fb = t_armijo(fun, starts, 12)
    close(xb[1], starts[1])
    close(fb[1], rosen_t(starts[1]))
    for lane in (0, 2):
        x1, f1 = t_armijo(rosen_t, starts[lane:lane + 1], 12)
        close(xb[lane], x1[0])
        close(fb[lane], f1[0])
        assert fb[lane] < rosen_t(starts[lane])


def test_fparam_objective_matches_jax():
    """The E-step's profiled f-param objective of a small problem, one lane
    per cell (the population fit's call: moments (L, 1, nt), trials (L, T))
    against JAX one cell at a time: iterates within 1e-12 while the lanes
    still descend (5 steps), values within 1e-12 after 10.  Past its
    optimum a lane takes steps of 1e-8 whose Armijo test compares values
    equal to rounding, so iterates there agree only to that."""
    rng = np.random.default_rng(11)
    L, nt = 3, 50
    lm = rng.standard_normal((L, nt))
    lv = rng.random((L, nt)) * 0.3 + 0.05
    r = rng.poisson(np.exp(0.8 * lm)).astype(float)
    logA0 = np.log([0.01, 0.5, 2.0])
    t = {k: torch.as_tensor(v) for k, v in (("r", r), ("lm", lm), ("lv", lv))}

    def fun(logA):
        return tf._fparam_objective(logA, t["r"][:, None], t["lm"][:, None],
                                    t["lv"][:, None])

    for steps in (5, 10):
        xt, f_t = t_armijo(fun, torch.as_tensor(logA0), steps)
        for c in range(L):
            def fj(logA, c=c):
                return jf._fparam_objective(logA, jnp.asarray(r[c]),
                                            jnp.asarray(lm[c]),
                                            jnp.asarray(lv[c]))
            xj, f_j = j_armijo(fj, jnp.float64(logA0[c]), steps)
            if steps == 5:
                close(xt[c], xj)
            close(f_t[c], f_j)
    assert torch.all(f_t < fun(torch.as_tensor(logA0)[:, None])[:, 0])
