"""The closed active-learning loop of the port against the JAX package,
float64, on the same numpy inputs.

The loop problem keeps the utilities meaningful: at the pool of
tests/test_active.py (rates exp(0.8 X w), 10 start points) the fit drives
logA to about -15 and the utilities to 1e-7 and below, differences of O(1)
entropies; here the rates are exp(1.0 + 1.5 X w) with 24 start points, and
every test checks that the final logA stays above -8.

Tolerances: picks and start sets exactly; utilities, the point r^2 (the
even/odd estimate, since the two packages draw their bootstrap repeats
from different generators) and the held-out log-likelihood rtol 1e-6 (the
fit's parity gate); the device-side growth rtol 1e-12.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import active as jact
from gaussian_processes_tpu.models import inference as ji
from gaussian_processes_tpu.ops.stabilize import block_matrix_inverse as j_bmi
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import active as tact
from gaussian_processes_tpu_torch.models import inference as ti
from gaussian_processes_tpu_torch.ops.stabilize import block_matrix_inverse

from test_active import FP0, N, THETA0
from test_torch_fit import JAX_EXACT

torch.set_num_threads(1)

NPOOL, NSTART, NADD = 64, 24, 3
STEPS = dict(maxiter=3, n_estep=3, n_mstep=2, n_fparamstep=3, n_px_side=N,
             track_variational=False)
LOGA_FLOOR = -8.0


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((NPOOL, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.3 ** 2)).ravel()
    w /= np.linalg.norm(w)
    R = rng.poisson(np.exp(1.0 + 1.5 * X @ w)).astype(float)
    Xt = rng.standard_normal((10, N * N))
    Rt = rng.poisson(np.exp(1.0 + 1.5 * Xt @ w)[None].repeat(12, 0))
    return X, R, Xt, Rt.astype(float)


def jstart():
    return dict(theta={k: jnp.float64(v) for k, v in THETA0.items()},
                f_params={k: jnp.float64(v) for k, v in FP0.items()})


def tstart():
    # numpy pools: without device= the loops would run on the card
    return dict(theta=THETA0, f_params=FP0, device="cpu")


def logA(res):
    return float(res.final_fit.f_params["logA"])


def close(t, j, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(t, float), np.asarray(j, float),
                               rtol=rtol)


@pytest.fixture(scope="module")
def host_loops(pool):
    """The utility arm of both host loops on the same pool, with r^2 and the
    held-out log-likelihood after every refit.  Each package's evaluate is
    wrapped to record the point r^2 of the rates it predicted."""
    X, R, Xt, Rt = pool
    point = {"jax": [], "torch": []}

    def jax_evaluate(res, X_test, R_test, **kw):
        out = ji.evaluate(res, X_test, R_test, **kw)
        r2, _ = ji.explained_variance(out[0], out[1], sigma=False)
        point["jax"].append(float(r2))
        return out

    def torch_evaluate(res, X_test, R_test, **kw):
        out = ti.evaluate(res, X_test, R_test, **kw)
        r2, _ = ti.explained_variance(out[0], out[1], sigma=False)
        point["torch"].append(float(r2))
        return out

    kw = dict(start_idx=np.arange(NSTART), n_add=NADD, seed=0, X_test=Xt,
              R_test=Rt, X_test_ll=Xt, R_test_ll=Rt[0], nbootstrap=20)
    mp = pytest.MonkeyPatch()
    mp.setattr(jact, "evaluate", jax_evaluate)
    mp.setattr(tact, "evaluate", torch_evaluate)
    try:
        jr = jact.active_loop(X, R, cfg=JCfg(**{**JAX_EXACT, **STEPS}),
                              **jstart(), **kw)
        round_times, history = [], []
        tr = tact.active_loop(X, R, cfg=TCfg(**STEPS), **tstart(), **kw,
                              round_times=round_times,
                              utility_history=history)
    finally:
        mp.undo()
    return jr, tr, point, round_times, history


def test_host_loop_matches_jax(host_loops):
    jr, tr, point, _, _ = host_loops
    assert tr.selected_idx == jr.selected_idx
    assert len(set(tr.selected_idx)) == NADD
    assert not any(i < NSTART for i in tr.selected_idx)
    np.testing.assert_array_equal(tr.in_use_idx, jr.in_use_idx)
    close(tr.utilities, jr.utilities)
    assert min(tr.utilities) > 1.0
    assert len(point["torch"]) == len(point["jax"]) == NADD + 1
    close(point["torch"], point["jax"])
    close(tr.test_ll_history, jr.test_ll_history)
    assert len(tr.r2_history) == NADD + 1
    assert np.all(np.isfinite(tr.r2_history + tr.r2_sigma_history))
    assert not tr.final_fit.failed
    assert logA(tr) > LOGA_FLOOR and logA(jr) > LOGA_FLOOR
    for k in THETA0:
        close(tr.final_fit.theta[k], jr.final_fit.theta[k])


def test_host_loop_records_round_times_and_utilities(host_loops):
    _, tr, _, round_times, history = host_loops
    assert len(round_times) == NADD + 1
    for i, times in enumerate(round_times):
        keys = {"refit", "evaluate"} | ({"select"} if i < NADD else set())
        assert set(times) == keys
        assert all(v >= 0.0 for v in times.values())
    assert len(history) == NADD
    for u, pick, best in zip(history, tr.selected_idx, tr.utilities):
        assert u.shape == (NPOOL,) and u[pick] == best == np.max(u)
        assert np.all(np.isneginf(u[:NSTART]))


def test_pipelined_loop_matches_host_loop(pool, host_loops):
    """tests/test_active.py's pipelined-vs-host check on the port, full
    frame: the pick moves to the device, nothing else changes."""
    X, R, _, _ = pool
    cfg = TCfg(**STEPS, crop_window=False)
    kw = dict(start_idx=np.arange(NSTART), n_add=NADD, cfg=cfg, seed=0,
              **tstart())
    host = tact.active_loop(X, R, **kw)
    round_times = []
    pipe = tact.active_loop_pipelined(X, R, round_times=round_times, **kw)
    assert pipe.selected_idx == host.selected_idx
    # the scorer's window does not move the picks on this problem
    assert pipe.selected_idx == host_loops[1].selected_idx
    for k in THETA0:
        close(pipe.final_fit.theta[k], host.final_fit.theta[k])
    close(pipe.utilities, host.utilities)
    assert logA(pipe) > LOGA_FLOOR
    assert [set(t) for t in round_times] == (
        [{"refit", "select"}] * NADD + [{"refit"}])


def test_random_arm_and_ab_experiment_match_jax(pool):
    """Both arms of ab_experiment over two seeds: the start sets and every
    pick equal the JAX package's; the pipelined random arm picks as the
    host loop's does."""
    X, R, _, _ = pool
    steps = dict(STEPS, maxiter=2, n_mstep=0)
    kw = dict(n_start=NSTART, n_add=2, seeds=[0, 1])
    jo = jact.ab_experiment(X, R, cfg=JCfg(**{**JAX_EXACT, **steps}),
                            **jstart(), **kw)
    to = tact.ab_experiment(X, R, cfg=TCfg(**steps), **tstart(), **kw)
    for arm in ("active", "random"):
        for t, j in zip(to[arm], jo[arm]):
            np.testing.assert_array_equal(t.in_use_idx, j.in_use_idx)
            assert logA(t) > LOGA_FLOOR
    for t, j in zip(to["active"], jo["active"]):
        close(t.utilities, j.utilities)
    assert all(np.isnan(u) for t in to["random"] for u in t.utilities)
    pipe = tact.active_loop_pipelined(
        X, R, start_idx=to["random"][1].in_use_idx[:NSTART], n_add=2,
        cfg=TCfg(**steps), select="random", seed=1, **tstart())
    assert pipe.selected_idx == to["random"][1].selected_idx


def test_unknown_selection_raises(pool):
    X, R, _, _ = pool
    for loop in (tact.active_loop, tact.active_loop_pipelined):
        with pytest.raises(ValueError, match="selection"):
            loop(X, R, start_idx=np.arange(4), n_add=1, select="greedy",
                 device="cpu")


def test_numpy_pool_without_device_needs_a_card(pool, monkeypatch):
    """device=None means the input tensor's device, or the card for numpy
    input: with no card that raises instead of running on the CPU."""
    X, R, _, _ = pool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for loop in (tact.active_loop, tact.active_loop_pipelined):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop(X, R, start_idx=np.arange(4), n_add=1, theta=THETA0,
                 f_params=FP0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tact.ab_experiment(X, R, n_start=4, n_add=1, seeds=[0],
                           theta=THETA0, f_params=FP0)


def test_argmax_takes_the_first_maximum_and_nan_as_maximum():
    """The pick of both loops: the first of tied maxima, and the first NaN
    counts as the maximum, in numpy (the host loop), jax and torch (the
    pipelined loop) alike."""
    for u in ([0.5, 2.0, 2.0, 1.0], [0.5, np.nan, 3.0, np.nan],
              [np.inf, np.nan, 1.0], [-np.inf, -np.inf, 1.0, 1.0],
              [-np.inf, -np.inf], [3.0], [np.nan, np.nan]):
        u = np.asarray(u)
        assert (int(torch.argmax(torch.as_tensor(u))) == int(np.argmax(u))
                == int(jnp.argmax(jnp.asarray(u))))


def _grow_case(case, seed=0):
    rng = np.random.default_rng(seed)
    npool, cap, nx, rank = 12, 6, 9, 4
    u = np.linspace(0.0, 1.0, npool)
    used = np.zeros(npool, bool)
    used[11] = True                       # the best is already in use
    if case == "tie":
        u[[4, 7]] = 5.0                   # the first of the two
    elif case == "nan":
        u[6] = np.nan                     # NaN counts as the maximum
    return dict(u=u, used=used,
                X_pool=rng.standard_normal((npool, nx)),
                R_pool=rng.poisson(2.0, npool).astype(float),
                x_buf=np.zeros((cap, nx)), r_buf=np.zeros(cap),
                B=rng.standard_normal((cap, rank)),
                m_b=rng.standard_normal(rank),
                V_b=np.eye(rank) + 0.1 * np.ones((rank, rank)), n=3)


ARGS = ("u", "X_pool", "R_pool", "x_buf", "r_buf", "used", "B", "m_b", "V_b")


@pytest.mark.parametrize("case,pick", [("used_best", 10), ("tie", 4),
                                       ("nan", 6)])
def test_select_and_grow_matches_jax(case, pick):
    c = _grow_case(case)
    j_out = jact._select_and_grow(*(jnp.asarray(c[k]) for k in ARGS),
                                  jnp.asarray(c["n"], jnp.int32))
    t_out = tact._select_and_grow(*(torch.as_tensor(c[k]) for k in ARGS),
                                  c["n"])
    assert int(t_out[5]) == int(j_out[5]) == pick
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-15)
    xb, rb, used, m_o, V_o = (t.numpy() for t in t_out[:5])
    np.testing.assert_array_equal(xb[3], c["X_pool"][pick])
    assert rb[3] == c["R_pool"][pick] and used[pick] and used.sum() == 2
    assert V_o[3, 3] == 1.0
    np.testing.assert_allclose(m_o[3], (c["B"] @ c["m_b"])[:3].mean(),
                               rtol=1e-12)


def test_grow_random_matches_jax():
    c = _grow_case("used_best")
    j_out = jact._grow_random(
        jnp.asarray(2, jnp.int32), jnp.asarray(c["X_pool"]),
        jnp.asarray(c["x_buf"]), jnp.asarray(c["r_buf"]),
        jnp.asarray(c["used"]), jnp.asarray(c["R_pool"]),
        jnp.asarray(c["B"]), jnp.asarray(c["m_b"]), jnp.asarray(c["V_b"]),
        jnp.asarray(c["n"], jnp.int32))
    T = {k: torch.as_tensor(v) for k, v in c.items() if k != "n"}
    t_out = tact._grow_random(2, T["X_pool"], T["x_buf"], T["r_buf"],
                              T["used"], T["R_pool"], T["B"], T["m_b"],
                              T["V_b"], c["n"])
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-15)


def test_block_matrix_inverse_rank1_growth():
    """tests/test_active.py's rank-1 growth check, against JAX and numpy."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((7, 7))
    M = A @ A.T + 7 * np.eye(7)
    col = np.concatenate([M[:6, 6], [M[6, 6]]])
    inv6 = np.linalg.inv(M[:6, :6])
    grown = block_matrix_inverse(torch.as_tensor(inv6), torch.as_tensor(col))
    np.testing.assert_allclose(grown.numpy(), np.linalg.inv(M), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(
        grown.numpy(), np.asarray(j_bmi(jnp.asarray(inv6), jnp.asarray(col))),
        rtol=1e-9, atol=1e-12)
