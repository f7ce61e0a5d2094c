"""The port's benchmark modules (gaussian_processes_tpu_torch/benchmarks/)
against the JAX scripts they port (the repository's benchmarks/) and the
JAX functions those drive, float64 on the CPU at small shapes, and the
port bench's runner of the secondaries against the JAX bench's.

Data: each module's arrays equal the script's numpy construction bit for
bit (rebuilt here with the script's own default_rng(0) calls).
Tolerances: the scorer's utilities rtol 1e-8 (the same float64 algebra),
the refit's and the population's log-marginals and the refit's m_b (as
B m_b: an eigenvector's sign is free) rtol 1e-6 (the fit's parity gate),
the large path's Gram and factor rtol 1e-10, the parity pipeline's
float64 moments rtol 1e-9; picks exactly.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import active as jact
from gaussian_processes_tpu.models.acquisition import (
    score_candidates as j_score)
from gaussian_processes_tpu.models.fit import fit as j_fit
from gaussian_processes_tpu.ops.kernels import (
    crop_window_for_theta as j_window, gram_matrices as j_gram)
from gaussian_processes_tpu.ops.stabilize import (
    compute_eigenspace as j_eigenspace)
from gaussian_processes_tpu.parallel import large as jlarge
from gaussian_processes_tpu.parallel import population as jpop
from gaussian_processes_tpu_torch import bench as tb
from gaussian_processes_tpu_torch.benchmarks import (
    ab_active_vs_random_hard, acquisition, active_pipelined, active_refit,
    bad_init, common, fparam_route, hard_quality, large_ntilde,
    parity_production, population)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 12
MODULES = (acquisition, active_refit, large_ntilde, active_pipelined,
           population, parity_production, hard_quality, bad_init,
           ab_active_vs_random_hard, fparam_route)
SMALL = dict(maxiter=3, n_estep=3, n_mstep=2, n_fparamstep=3)


def jax_config(cfg, **kw):
    """The JAX FitConfig of a port config, as JAX's per-iteration fit runs
    it (the whole-fit program and the TPU's schedule and precision off)."""
    names = {f.name for f in dataclasses.fields(JCfg)}
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name in names}
    return JCfg(**{**fields, **kw}, jit_whole_fit=False,
                static_schedule=False, eigh_impl="eigh",
                mstep_precision="highest")


def jtheta(values):
    return {k: jnp.float64(v) for k, v in values.items()}


def close(t, j, rtol):
    np.testing.assert_allclose(np.asarray(t, float), np.asarray(j, float),
                               rtol=rtol)


# ---- the data, bit for bit --------------------------------------------------

def script_rf(n_px, cx=None, cy=None):
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    if cx is None:
        w = np.exp(-(xx ** 2 + yy ** 2) / (2 * 0.1 ** 2)).ravel()
    else:
        w = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                   / (2 * 0.1 ** 2)).ravel()
    w /= np.linalg.norm(w)
    return w


def script_acquisition():
    rng = np.random.default_rng(0)
    xstar = rng.standard_normal((40, N * N))
    xtilde = rng.standard_normal((16, N * N))
    return (xstar, xtilde), acquisition.make_data(40, 16, N)


def script_refit():
    rng = np.random.default_rng(0)
    x_buf = rng.standard_normal((24, N * N)).astype(np.float32)
    r_buf = rng.poisson(np.exp(0.8 * x_buf @ script_rf(N))).astype(
        np.float32)
    mask = (np.arange(24) < 20).astype(np.float32)
    return (x_buf, r_buf, mask), active_refit.make_data(24, 20, N)


def script_large():
    n, px = 8200, 4             # two chunks of the script's 8,192 rows
    rng = np.random.default_rng(0)
    xt = np.empty((n, px * px), np.float32)
    for i in range(0, n, 8192):
        j = min(i + 8192, n)
        xt[i:j] = rng.standard_normal((j - i, px * px)).astype(np.float32)
    return (xt,), (large_ntilde.make_data(n, px),)


def script_pipelined():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, N * N)).astype(np.float32)
    R = rng.poisson(np.exp(0.8 * X @ script_rf(N))).astype(np.float32)
    return (X, R), active_pipelined.make_data(60, N)


def script_population():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, N * N)).astype(np.float32)
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    R = np.zeros((3, 40), np.float32)
    for c in range(3):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        w = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 0.1 ** 2)).ravel()
        w /= np.linalg.norm(w)
        R[c] = rng.poisson(np.exp(0.8 * X @ w))
    return (X, R), population.make_data(3, 40, N)


def script_parity():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, N * N))
    Xstar = rng.standard_normal((8, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.1 ** 2)).ravel()
    w /= np.linalg.norm(w)
    R = rng.poisson(np.exp(0.8 * X @ w)).astype(np.float64)
    Xtilde = X[rng.permutation(64)[:24]]
    return (X, R, Xtilde, Xstar), parity_production.make_data(64, N, 24, 8)


@pytest.mark.parametrize("build", [
    script_acquisition, script_refit, script_large, script_pipelined,
    script_population, script_parity], ids=lambda f: f.__name__[7:])
def test_data_equals_the_scripts_bit_for_bit(build):
    want, got = build()
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_start_values_are_the_scripts():
    assert common.THETA == {
        "sigma_0": 1.0, "eps_0x": 1e-4, "eps_0y": 1e-4,
        "-2log2beta": -2 * np.log(0.2), "-log2rho2": -np.log(0.02),
        "Amp": 1.0}
    assert common.F_PARAMS == {"logA": np.log(0.01), "lambda0": 1.0}
    assert acquisition.F_PARAMS == {"logA": np.log(0.05), "lambda0": 0.3}
    assert parity_production.THETA == {
        "sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
        "-2log2beta": -2 * np.log(2 * 0.1),
        "-log2rho2": -np.log(2 * 0.1 ** 2), "Amp": 1.0}
    assert large_ntilde.THETA == {
        "sigma_0": 1.0, "eps_0x": 0.0, "eps_0y": 0.0,
        "-2log2beta": -2 * np.log(2 * 0.25),
        "-log2rho2": -np.log(2 * 0.1 ** 2), "Amp": 1.0}
    # the JAX FitConfig defaults that the scripts rely on
    jdef = JCfg()
    assert all(getattr(jdef, k) == v for k, v in common.JAX_DEFAULTS.items())


# ---- each module against the JAX functions it drives ------------------------

def test_acquisition_matches_jax_score_candidates():
    """At 40 px, where the start theta's crop window (32 px) is smaller
    than the frame."""
    n_px = 40
    rec, vals = acquisition.run(nstar=40, ntilde=16, n_px=n_px, reps=2,
                                chain=2, device="cpu", dtype=torch.float64)
    xs, xt = acquisition.make_data(40, 16, n_px)
    th, fp = jtheta(common.THETA), jtheta(acquisition.F_PARAMS)
    K_tilde, _, _ = j_gram(th, jnp.asarray(xt), jnp.asarray(xt), n_px,
                           shared=True)
    es = j_eigenspace(K_tilde)
    i0, j0, w = j_window(th, n_px)
    assert w < n_px and rec["window"] == [i0, j0, w]
    u, best = j_score(jnp.asarray(xs), jnp.asarray(xt), th, fp,
                      jnp.zeros(16), jnp.diag(es.k_tilde_b_diag), es.B,
                      es.k_tilde_inv_diag, n_px_side=n_px,
                      win_i0=jnp.asarray(i0, jnp.int32),
                      win_j0=jnp.asarray(j0, jnp.int32), win_w=w)
    close(vals["utilities"], u, 1e-8)
    assert vals["best"] == int(best) == rec["best"]
    assert rec["ok"] and rec["unit"] == "ms" and rec["device"]["name"] == "cpu"


def test_active_refit_matches_jax_fit(monkeypatch):
    """The bench's gates, read when run is called; at 80 images with 30 in
    use the JAX rule's budget (64) is below the capacity, so the reduced
    arm runs: each arm against JAX's per-iteration fit under its config
    with the same sample_weight."""
    monkeypatch.setenv("GPTPU_REFIT_MSTEP_FTOL", "0.3")
    monkeypatch.setenv("GPTPU_REFIT_ESTEP_TOL", "1e-3")
    rec, vals = active_refit.run(capacity=80, n_active=30, n_px=N, reps=1,
                                 device="cpu", dtype=torch.float64, **SMALL)
    cfg = vals["config"]
    assert (cfg.mstep_ftol, cfg.estep_tol, cfg.reduced_rank) == (0.3, 1e-3,
                                                                 False)
    x, r, mask = active_refit.make_data(80, 30, N)
    xj = jnp.asarray(x, jnp.float64)

    def jfit(c):
        return j_fit(xj, jnp.asarray(r, jnp.float64), jax_config(c),
                     xtilde=xj, theta=jtheta(common.THETA),
                     f_params=jtheta(common.F_PARAMS),
                     sample_weight=jnp.asarray(mask, jnp.float64))

    jr = jfit(cfg)
    close(vals["loss"], -np.asarray(jr.track.logmarginal), 1e-6)
    # m_b in the eigenbasis, whose vectors' signs are free: B m_b
    close(vals["result"].B @ vals["m_b"], jr.B @ jr.m_b, 1e-6)
    red = vals["reduced"]
    jred = jfit(red.config)
    assert red.config.reduced_rank
    close(red.track.logmarginal, jred.track.logmarginal, 1e-6)
    assert rec["ok"] and rec["reduced_rank_budget"] == 64
    assert set(rec["reduced_rank_budgets"]) == {64}
    assert rec["gates"] == {"mstep_ftol": 0.3, "estep_tol": 1e-3}


def test_active_refit_skips_the_reduced_arm_when_the_budget_covers(
        monkeypatch):
    """As the JAX script: no reduced arm when the budget reaches the
    capacity (here 20 of 24 kept: a budget of 24)."""
    rec, vals = active_refit.run(capacity=24, n_active=20, n_px=N, reps=1,
                                 device="cpu", dtype=torch.float64, **SMALL)
    assert vals["reduced"] is None and rec["ok"]
    assert rec["reduced_rank_budget"] == 24 and "reduced_rank_s" not in rec
    assert rec["reduced_route"].startswith("not run")


def test_large_ntilde_matches_jax(monkeypatch):
    """The Gram (captured as the Cholesky receives it) and the factor."""
    seen = {}
    real = large_ntilde.large.large_cholesky

    def capture(K, **kw):
        seen["K"] = K.clone()
        return real(K, **kw)

    monkeypatch.setattr(large_ntilde.large, "large_cholesky", capture)
    rec, vals = large_ntilde.run(sizes=(40,), n_px=N, device="cpu",
                                 dtype=torch.float64)
    xt = jnp.asarray(large_ntilde.make_data(40, N), jnp.float64)
    K_j = jlarge.large_gram(jtheta(large_ntilde.THETA), xt, N, mesh=None)
    close(seen["K"], K_j, 1e-10)
    L_j = jlarge.large_cholesky(K_j, mesh=None, jitter=1.0, nb=2048)
    close(torch.tril(vals["L"]), jnp.tril(L_j), 1e-10)
    assert rec["ok"] and [row["n"] for row in rec["rows"]] == [40]


def test_large_ntilde_falls_back_on_out_of_memory_only(monkeypatch):
    calls = []

    def oom_then_run(n, n_px, device, dtype):
        calls.append(n)
        if n > 40:
            raise torch.cuda.OutOfMemoryError("no room")
        return real(n, n_px, device, dtype)

    real = large_ntilde.run_at
    monkeypatch.setattr(large_ntilde, "run_at", oom_then_run)
    rec, _ = large_ntilde.run(sizes=(64, 48, 40, 32), n_px=N, device="cpu",
                              dtype=torch.float64)
    assert calls == [64, 48, 40]
    assert [("error" in row, row["n"]) for row in rec["rows"]] == [
        (True, 64), (True, 48), (False, 40)]
    assert rec["metric"] == "large_ntilde_cholesky_n40"

    def bad_factor(K, **kw):
        return -torch.eye(K.shape[0], dtype=K.dtype)

    monkeypatch.setattr(large_ntilde, "run_at", real)
    monkeypatch.setattr(large_ntilde.large, "large_cholesky", bad_factor)
    with pytest.raises(RuntimeError, match="not finite and positive"):
        large_ntilde.run(sizes=(40, 32), n_px=N, device="cpu",
                         dtype=torch.float64)


def test_population_matches_jax_fit_population():
    idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), 40)[:16])
    rec, vals = population.run(nt=40, n_px=N, ntilde=16, cells=[3], nseq=1,
                               xtilde_idx=idx, device="cpu",
                               dtype=torch.float64, **SMALL)
    X, R = population.make_data(3, 40, N)
    Xj = jnp.asarray(X, jnp.float64)
    jc, _ = jpop.fit_population(Xj, jnp.asarray(R, jnp.float64),
                                jax_config(vals["config"]),
                                xtilde=Xj[idx], thetas=jtheta(common.THETA),
                                f_params=jtheta(common.F_PARAMS))
    close(vals["logmarginal"], jc.track.logmarginal, 1e-6)
    assert rec["ok"] and rec["ncells"] == 3 and rec["oom_at"] == []


def test_population_draws_the_jax_inducing_rows():
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(0),
                                             3160)[:512])
    np.testing.assert_array_equal(population.inducing_rows(512), want)
    for nt, ntilde in ((3160, 2101), (40, 16)):
        with pytest.raises(ValueError, match="xtilde_idx"):
            population.inducing_rows(ntilde, nt)


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_parity_float64_matches_the_jax_script(monkeypatch):
    script = load_script("parity_production")
    monkeypatch.setattr(script, "N_PX", N)
    monkeypatch.setattr(script, "NTILDE", 24)
    rec, vals = parity_production.run(nt=64, n_px=N, ntilde=24, n_star=8,
                                      device="cpu")
    X, R, Xtilde, Xstar = parity_production.make_data(64, N, 24, 8)
    theta = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
             "-2log2beta": -2 * np.log(2 * 0.1),
             "-log2rho2": -np.log(2 * 0.1 ** 2), "Amp": 1.0}
    f_params = {"logA": np.log(0.01), "lambda0": 1.0}
    mu, var, n_keep = script.posterior_pipeline(X, R, Xtilde, Xstar, theta,
                                                f_params, jnp.float64)
    close(vals["float64"][0], mu, 1e-9)
    close(vals["float64"][1], var, 1e-9)
    assert rec["detail"]["n_keep"] == n_keep
    assert set(rec["arms"]) == set(parity_production.ARMS) - {"float64"}
    assert rec["ok"] and all(a["pass"] for a in rec["arms"].values())


def test_pipelined_picks_match_jax():
    """On a non-degenerate pool (tests/test_torch_active.py's: rates
    exp(1 + 1.5 X w), 24 start points), the utility arm's picks and
    utilities equal JAX's active_loop_pipelined; the host loop picks as
    the pipelined one does."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((64, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.3 ** 2)).ravel()
    w /= np.linalg.norm(w)
    R = rng.poisson(np.exp(1.0 + 1.5 * X @ w)).astype(float)
    rec, out = active_pipelined.run(n_start=24, n_add=3, n_px=N, pool=(X, R),
                                    device="cpu", dtype=torch.float64,
                                    **SMALL)
    cfg = active_pipelined.make_config(N, **SMALL)
    jo = jact.active_loop_pipelined(
        X, R, start_idx=np.arange(24), n_add=3, cfg=jax_config(cfg),
        theta=jtheta(common.THETA), f_params=jtheta(common.F_PARAMS),
        select="utility", seed=0)
    assert out["utility"].selected_idx == list(jo.selected_idx)
    assert out["host_loop"].selected_idx == out["utility"].selected_idx
    close(out["utility"].utilities, jo.utilities, 1e-6)
    assert float(out["utility"].final_fit.f_params["logA"]) > -8.0
    assert rec["ok"] and rec["n_add"] == 3
    assert set(rec["picks"]) == {"random", "utility", "host_loop"}


# ---- entry points and exit codes --------------------------------------------

@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_run_defaults_to_the_card(module, monkeypatch):
    """device=None is the CUDA card: without one, run raises before it
    draws any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run()


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_main_exits_nonzero_when_its_check_fails(module, monkeypatch,
                                                 capsys):
    """Run from the command line with no arguments."""
    monkeypatch.setattr(sys, "argv", [module.__name__])
    for ok, code in ((True, 0), (False, 1)):
        monkeypatch.setattr(module, "run",
                            lambda *args, **kwargs: ({"ok": ok}, {}))
        assert module.main() == code
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
            "ok": ok}


# ---- the bench's runner of the secondaries ----------------------------------

def jax_bench():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    return bench


def test_secondary_list_is_the_jax_benchs():
    jb = jax_bench()
    scripts = {"acquisition": "bench_acquisition",
               "active_refit": "bench_active_refit",
               "large_ntilde": "bench_large_ntilde",
               "active_pipelined": "bench_active_pipelined",
               "population": "bench_population"}
    assert len(tb.SECONDARY) == len(jb.SECONDARY) == 5
    for (name, module, tmo, env), (jname, script, jtmo, jenv) in zip(
            tb.SECONDARY, jb.SECONDARY):
        assert (name, tmo, env) == (jname, jtmo, jenv)
        assert all(isinstance(v, str) for v in env.values())
        package, _, short = module.rpartition(".")
        assert package == "gaussian_processes_tpu_torch.benchmarks"
        assert script == f"benchmarks/{scripts[short]}.py"
    assert "parity_production" not in [m for _, m, _, _ in tb.SECONDARY]


@pytest.mark.parametrize("budget,left", [(1500, 10_000), (3000, 10_000),
                                         (300, 10_000), (1500, 200)])
def test_secondary_timeouts_scale_as_the_jax_benchs(budget, left,
                                                    monkeypatch):
    """The same deadline and budget give the same timeouts and the same
    skips on both runners (each child a stand-in that prints JSON).  Both
    runners read the clock for the time left; it is frozen, so that they
    read the same time."""
    jb = jax_bench()
    seen = {"jax": [], "torch": []}

    def fake(side):
        def run(cmd, **kw):
            seen[side].append(round(kw["timeout"], 6))
            return subprocess.CompletedProcess(cmd, 0, '{"x": 1}\n', "")
        return run

    now = jb.time.monotonic()
    monkeypatch.setattr(jb.time, "monotonic", lambda: now)
    monkeypatch.setattr(tb.time, "monotonic", lambda: now)
    monkeypatch.setattr(jb.subprocess, "run", fake("jax"))
    deadline = now + left
    monkeypatch.setitem(jb._state, "secondary", {})
    jb._run_secondary(deadline, budget)
    jax_out = dict(jb._state["secondary"])
    monkeypatch.setattr(tb.subprocess, "run", fake("torch"))
    out = tb.run_secondary(deadline, budget)
    assert seen["torch"] == pytest.approx(seen["jax"], abs=1e-3)
    assert out == jax_out
    assert list(out) == [name for name, _, _, _ in tb.SECONDARY]


def test_failing_children_are_recorded_not_raised(tmp_path, monkeypatch):
    (tmp_path / "standin_ok.py").write_text(
        "print('a line first')\nprint('{\"metric\": \"m\", \"ok\": true}')\n")
    (tmp_path / "standin_fail.py").write_text(
        "import sys\nsys.stderr.write('it broke')\nsys.exit(1)\n")
    (tmp_path / "standin_nojson.py").write_text("print('no record here')\n")
    (tmp_path / "standin_slow.py").write_text("print('{}')\n")
    env = {"PYTHONPATH": str(tmp_path)}
    monkeypatch.setattr(tb, "SECONDARY", [
        (name, f"standin_{name}", 120, env)
        for name in ("ok", "fail", "nojson", "slow")])
    real = subprocess.run

    def run(cmd, **kw):
        if cmd[-1] == "standin_slow":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        return real(cmd, **kw)

    monkeypatch.setattr(tb.subprocess, "run", run)
    progress = tb.Progress()
    out = tb.run_secondary(tb.time.monotonic() + 10_000, 10_000, progress)
    assert out["ok"] == {"metric": "m", "ok": True}
    assert "it broke" in out["fail"]["error"]
    assert out["nojson"] == {"error": "no JSON output"}
    assert out["slow"] == {"error": "timeout after 120s"}
    assert progress.record(True)["secondary"] == out


@pytest.mark.parametrize("flag,env,runs", [
    (True, None, True), (False, "1", True), (False, None, False),
    (False, "0", False)])
def test_secondary_switch_reaches_the_runner(flag, env, runs, monkeypatch,
                                             capsys):
    calls = []
    monkeypatch.setattr(tb, "run_bench", lambda **kw: (
        {"metric": "one_cell_fit_wallclock", "value": 1.0, "quality": {}},
        True))

    def runner(deadline, budget, progress=None):
        calls.append(budget)
        return {"acquisition": {"ok": True}}

    monkeypatch.setattr(tb, "run_secondary", runner)
    if env is None:
        monkeypatch.delenv("GPTPU_BENCH_SECONDARY", raising=False)
    else:
        monkeypatch.setenv("GPTPU_BENCH_SECONDARY", env)
    monkeypatch.setenv("GPTPU_BENCH_BUDGET", "1234")
    assert tb.main(["--device", "cpu"] + (["--secondary"] if flag else [])
                   ) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert calls == ([1234.0] if runs else [])
    assert ("secondary" in rec) == runs
