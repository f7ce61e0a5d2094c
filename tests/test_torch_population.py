"""The port's multi-cell fits (parallel/population.py) against the JAX
package's, float64, on the same numpy inputs.

The JAX side runs ``fit_population`` with test_torch_fit.py's exact knobs
(full eigh, Cholesky solves, exact inverse, log-determinant and Gram), so
both run the same program: init, EM iterations with the batched Armijo
L-BFGS at both inner call sites, the last without an M-step, a fixed crop
window with per-cell corners.  Tolerances: per-cell log-marginal tracks
rtol 1e-8, final theta, f-params and B m_b rtol 1e-8 (B m_b because an
eigenvector's sign is free); converted JAX state's predictions rtol 1e-8.
The JAX runs are module-scoped: each compiles its program (about 10 s).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.ops.kernels import (
    crop_window_for_theta as j_window)
from gaussian_processes_tpu.parallel import population as jpop
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.models import inference as ti
from gaussian_processes_tpu_torch.params import theta_bounds
from gaussian_processes_tpu_torch.parallel import population as tpop
from test_sharding import FP0, THETA0, make_population
from test_torch_fit import JAX_EXACT

torch.set_num_threads(1)

N = 12
STEPS = dict(maxiter=3, n_estep=3, n_mstep=2, n_fparamstep=3)
# the windowed case: 24 px, small RFs at three places, one start theta per
# cell; a 16-trial ladder, since from a start this far off the unscaled
# first step of the 6-trial ladder never passes Armijo
NW = 24
CENTRES = ((-0.3, 0.2), (0.3, -0.3), (0.05, 0.0))
STEPS_W = dict(STEPS, n_mstep=3, crop_bucket=4, armijo_trials=16)


def windowed_problem():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((40, NW * NW))
    lin = np.linspace(-1, 1, NW)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    R = []
    for cx, cy in CENTRES:
        w = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 0.1 ** 2))
        w = w.ravel() / np.linalg.norm(w)
        R.append(rng.poisson(np.exp(0.5 * X @ w)))
    thetas = {"sigma_0": np.ones(3),
              "eps_0x": np.array([c[0] for c in CENTRES]),
              "eps_0y": np.array([c[1] for c in CENTRES]),
              "-2log2beta": np.full(3, -2 * np.log(2 * 0.06)),
              "-log2rho2": np.full(3, -np.log(2 * 0.2 ** 2)),
              "Amp": np.ones(3)}
    return X, np.asarray(R, float), thetas


def problem(case):
    """(x, rs, xtilde, thetas or None, f_params, n_px_side, steps)."""
    if case == "windowed":
        X, R, thetas = windowed_problem()
        return X, R, X[:16], thetas, FP0, NW, STEPS_W
    X, R = make_population(ncells=3, nt=32)
    xt = X if case == "shared" else X[:16]
    if case == "failing_lane":
        R = R.copy()
        R[1, 3] = np.nan
    thetas = None if case == "thetas_none" else THETA0
    return X, R, xt, thetas, FP0, N, STEPS


CASES = ("shared", "nonshared", "windowed", "thetas_none", "failing_lane")


@pytest.fixture(scope="module")
def runs():
    """Each case's JAX and port population fits, run once."""
    cache = {}

    def get(case):
        if case not in cache:
            X, R, xt, th, fp, n, steps = problem(case)
            jc, _ = jpop.fit_population(
                jnp.asarray(X), jnp.asarray(R),
                JCfg(ntilde=xt.shape[0], n_px_side=n, **steps, **JAX_EXACT),
                xtilde=jnp.asarray(xt),
                thetas=None if th is None else {
                    k: jnp.asarray(np.asarray(v, float))
                    for k, v in th.items()},
                f_params={k: jnp.float64(v) for k, v in fp.items()})
            tc, bounds = tpop.fit_population(
                X, R, TCfg(ntilde=xt.shape[0], n_px_side=n, **steps),
                xtilde=xt, thetas=th, f_params=fp, device="cpu")
            cache[case] = (jc, tc, bounds)
        return cache[case]
    return get


def close(t, j, rtol=1e-8, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def Bm(B, m):
    return np.einsum("lij,lj->li", np.asarray(B), np.asarray(m))


@pytest.mark.parametrize("case", [c for c in CASES if c != "failing_lane"])
def test_population_matches_jax(runs, case):
    jc, tc, _ = runs(case)
    assert not np.any(np.asarray(jc.failed)) and not torch.any(tc.failed)
    for name in ("logmarginal", "loglikelihood", "KL"):
        close(getattr(tc.track, name), getattr(jc.track, name))
    np.testing.assert_array_equal(tc.track.n_eigen.numpy(),
                                  np.asarray(jc.track.n_eigen))
    for k in THETA0:
        close(tc.theta[k], jc.theta[k], atol=1e-9)
    for k in FP0:
        close(tc.f_params[k], jc.f_params[k])
    jbm = Bm(jc.kern.es.B, jc.m_b)
    close(Bm(tc.kern.es.B, tc.m_b), jbm, atol=1e-8 * np.abs(jbm).max())
    loss = tc.track.logmarginal.numpy()
    assert np.all(loss[:, -1] > loss[:, 0])
    if case == "windowed":
        X, R, xt, th, _, n, steps = problem(case)
        cfg = TCfg(n_px_side=n, **steps)
        wins = [j_window({k: jnp.asarray(v[c]) for k, v in th.items()}, n,
                         cfg.alpha_threshold, cfg.crop_margin * 1.5,
                         cfg.crop_bucket) for c in range(3)]
        assert all(w < n for _, _, w in wins)
        assert len({(i, j) for i, j, _ in wins}) == 3
        i0s, j0s, w = tpop.population_window(
            {k: torch.as_tensor(v) for k, v in th.items()}, cfg)
        assert w == max(w for _, _, w in wins) < n
        assert sorted(zip(i0s.tolist(), j0s.tolist())) == sorted(
            (i, j) for i, j, _ in wins)
        # theta moved in every cell
        for c in range(3):
            assert max(abs(float(tc.theta[k][c]) - th[k][c])
                       for k in th) > 1e-5


def test_failing_lane_matches_jax_and_spares_the_others(runs):
    """Cell 1's responses hold a NaN: its first iteration is not finite, so
    it reverts to its initial state and freezes (failed at 1), as in JAX;
    cells 0 and 2 run exactly as without it."""
    jc, tc, _ = runs("failing_lane")
    _, clean, _ = runs("nonshared")
    assert tc.failed.tolist() == np.asarray(jc.failed).tolist() == [
        False, True, False]
    assert tc.failed_at.tolist() == np.asarray(jc.failed_at).tolist() == [
        -1, 1, -1]
    for k in THETA0:
        assert float(tc.theta[k][1]) == pytest.approx(THETA0[k])
    assert torch.all(tc.track.logmarginal[1, 1:] == 0)
    for c in (0, 2):
        close(tc.track.logmarginal[c], clean.track.logmarginal[c],
              rtol=1e-13)
        for k in THETA0:
            close(tc.theta[k][c], clean.theta[k][c], rtol=1e-13)
    close(tc.track.logmarginal[[0, 2]],
          np.asarray(jc.track.logmarginal)[[0, 2]])


def test_population_results_split_the_carry(runs):
    X, R, xt, _, _, _, steps = problem("failing_lane")
    _, tc, (lo, hi) = runs("failing_lane")
    cfg = TCfg(ntilde=16, n_px_side=N, **steps)
    res = tpop.population_results(tc, cfg, torch.as_tensor(xt), lo, hi)
    assert len(res) == 3
    assert [r.failed for r in res] == [False, True, False]
    assert [r.failed_at for r in res] == [-1, 1, -1]
    for c, r in enumerate(res):
        assert torch.equal(r.m_b, tc.m_b[c])
        assert torch.equal(r.B, tc.kern.es.B[c])
        # (the failed cell's row 0 is NaN: its responses hold one)
        np.testing.assert_array_equal(r.track.logmarginal.numpy(),
                                      tc.track.logmarginal[c].numpy())
        assert set(r.theta) == set(THETA0)
        assert r.values_track()["loss_track"]["logmarginal"].shape == (3,)
        rates, _, _ = ti.predict(r, torch.as_tensor(X[:5]))
        assert rates.shape == (5,) and torch.all(torch.isfinite(rates))


def test_converted_jax_carry_predicts_like_the_port(runs):
    X, R, xt, _, _, _, steps = problem("nonshared")
    jc, tc, (lo, hi) = runs("nonshared")
    cfg = TCfg(ntilde=16, n_px_side=N, **steps)
    res = tpop.population_results(tc, cfg, torch.as_tensor(xt), lo, hi)
    xtest = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (7, N * N)))
    cells = convert.population_states_from_numpy(jc, np.asarray(xt))
    assert len(cells) == 3
    for r, (st, th, fp) in zip(res, cells):
        got = ti.predict_rates(xtest, st.xtilde, th, fp, st.m_b, st.V_b,
                               st.B, st.k_tilde_b_diag, st.k_tilde_inv_diag,
                               n_px_side=N)
        want = ti.predict(r, xtest)
        for g, w in zip(got, want):
            close(g, w)


def test_lanes_match_single_cell_armijo_fits():
    """Each lane of the batched program is the single-cell fit with the
    Armijo line search on the full frame (the per-lane oracle)."""
    X, R = make_population(ncells=2, nt=32)
    cfg = TCfg(ntilde=16, n_px_side=N, crop_window=False, **STEPS)
    tc, _ = tpop.fit_population(X, R, cfg, xtilde=X[:16], thetas=THETA0,
                                f_params=FP0, device="cpu")
    one = dataclasses.replace(cfg, linesearch="armijo")
    x = torch.as_tensor(X)
    for c in range(2):
        res = tf.fit(x, torch.as_tensor(R[c]), one, xtilde=x[:16],
                     theta=THETA0, f_params=FP0)
        close(tc.track.logmarginal[c], res.track.logmarginal, rtol=1e-10)
        for k in THETA0:
            close(tc.theta[k][c], res.theta[k], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["nonshared", "windowed"])
def test_ladder_chunks_change_nothing(runs, monkeypatch, case):
    """Grams in chunks of one item (as a card with little free memory would
    size them): the M-step's ladder, its gradient call and the kernel
    rebuilds give the same fit as in one chunk."""
    X, R, xt, th, fp, n, steps = problem(case)
    _, one, _ = runs(case)
    monkeypatch.setattr(tpop, "ladder_items", lambda *args: 1)
    chunked, _ = tpop.fit_population(
        X, R, TCfg(ntilde=xt.shape[0], n_px_side=n, **steps), xtilde=xt,
        thetas=th, f_params=fp, device="cpu")
    close(chunked.track.logmarginal, one.track.logmarginal, rtol=1e-14)
    for k in THETA0:
        close(chunked.theta[k], one.theta[k], rtol=1e-14)


def test_fit_cells_sequential_matches_jax():
    X, R = make_population(ncells=2, nt=24)
    steps = dict(STEPS, n_px_side=N, crop_window=False)
    kw = dict(thetas=THETA0, f_params=FP0)
    jr = jpop.fit_cells_sequential(
        jnp.asarray(X), jnp.asarray(R),
        JCfg(ntilde=12, **steps, **JAX_EXACT), xtilde=jnp.asarray(X[:12]),
        thetas={k: jnp.float64(v) for k, v in THETA0.items()},
        f_params={k: jnp.float64(v) for k, v in FP0.items()})
    tr = tpop.fit_cells_sequential(X, R, TCfg(ntilde=12, **steps),
                                   xtilde=X[:12], device="cpu", **kw)
    assert len(tr) == 2 and not any(r.failed for r in tr)
    for t, j in zip(tr, jr):
        close(t.track.logmarginal, j.track.logmarginal)
        for k in THETA0:
            close(t.theta[k], j.theta[k], atol=1e-9)


def test_vmap_safe_config():
    """The batched program runs the Armijo search in place of zoom, refuses
    the single-lane searches (fit_population) and the zoom search
    (fit_cells_program); a safe config passes unchanged."""
    used = tpop._vmap_safe_config(TCfg(linesearch="zoom",
                                       max_linesearch_steps=15))
    assert used.linesearch == "armijo" and used.max_linesearch_steps == 15
    assert tpop._vmap_safe_config(used) == used
    kept = TCfg(linesearch="armijo", max_linesearch_steps=3)
    assert tpop._vmap_safe_config(kept) == kept
    X, R = make_population(ncells=2, nt=16)
    x = torch.as_tensor(X)
    stim = tf.cell_stimuli(x, x, True, TCfg(n_px_side=N))
    with pytest.raises(ValueError, match="Armijo"):
        tf.fit_cells_program(
            stim, torch.as_tensor(R, dtype=x.dtype),
            tpop._per_cell(THETA0, 2, x.dtype, "cpu"),
            tpop._per_cell(FP0, 2, x.dtype, "cpu"), True,
            TCfg(n_px_side=N, **STEPS), theta_bounds())
    for search in ("speculative", "backtracking", "zoom_carry"):
        with pytest.raises(ValueError, match="fit_cells_sequential"):
            tpop._vmap_safe_config(TCfg(linesearch=search))
    with pytest.raises(ValueError):
        TCfg(linesearch="newton")


def test_numpy_input_without_device_needs_a_card(monkeypatch):
    X, R = make_population(ncells=2, nt=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCfg(ntilde=16, n_px_side=N, **STEPS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpop.fit_population(X, R, cfg, thetas=THETA0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpop.fit_cells_sequential(X, R, cfg, thetas=THETA0)


# The device memory one (cell, trial) item of the ladder's value call took
# on an H100 (NVIDIA H100 80GB HBM3, 700 W) at nt 3160, ntilde 2100, by
# contraction, in bytes: the slope of the call's peak between chunks of 2
# and 8 items, and of the gradient call's between chunks of 1 and 4 (the
# largest of its readings).
ITEM_BYTES_ON_THE_CARD = {1024: (247.2e6, 539.6e6), 4096: (589.2e6, 1034.6e6),
                          11664: (1235.5e6, 2272.5e6)}


@pytest.mark.parametrize("k", sorted(ITEM_BYTES_ON_THE_CARD))
def test_ladder_items_count_an_items_state(monkeypatch, k):
    """``ladder_item_bytes`` covers what an item took on the card at
    ntilde 2100, and its gradient call's GRAD_CHUNK_DIVISOR times that
    too, with at most 20% to spare in the value call (the count is fitted
    to these readings, not a bound far above them); and ``ladder_items``
    gives LADDER_MEMORY_SHARE of the free memory over it."""
    value, gradient = ITEM_BYTES_ON_THE_CARD[k]
    per_item = tpop.ladder_item_bytes(3160, 2100, k)
    assert value <= per_item <= 1.2 * value
    assert tf.GRAD_CHUNK_DIVISOR * per_item >= gradient
    assert per_item == (3160 + 2100) * (20 * k + 16 * 2100)
    free, reserved, allocated = 70 * 2 ** 30, 6 * 2 ** 30, 2 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (free, 80 * 2 ** 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device: allocated)
    want = int((free + reserved - allocated) * tpop.LADDER_MEMORY_SHARE) \
        // per_item
    assert tpop.ladder_items(3160, 2100, k, "cuda") == want
    assert tpop.ladder_items(3160, 2100, k, "cpu") is None
