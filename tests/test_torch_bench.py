"""The port's headline bench (``gaussian_processes_tpu_torch/bench.py``)
against the JAX package and the JAX bench (the repository's ``bench.py``),
on the CPU, in float64 where a fit runs.

* ``bench_draws.npz`` equals a fresh JAX draw of the inducing rows and of
  the bootstrap's permutations, exactly (``jax_draws`` below generated it;
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bench.py``
  writes it anew);
* ``make_data``, the held-out set, the constants and ``GOLDEN`` equal the
  JAX bench's; ``make_config`` equals the JAX bench's converted config
  field by field, under the defaults and under env overrides;
* ``explained_variance`` with the checked-in permutations equals JAX's
  ``explained_variance(nbootstrap=200, seed=0)`` to 1e-10 relative;
* the hard problem's arrays equal the JAX package's at a small shape, and
  the STA init's theta JAX's to 1e-10;
* the slice as a whole at a small shape (nt 120, 16 x 16 px, ntilde 48, 3
  EM iterations of 3/3/3 steps): ``run_bench`` on the CPU in float64
  against the JAX fit under the JAX bench's config (its TPU-only knobs at
  their defaults) on the same inputs, the log-marginal trajectories within
  rtol 1e-6 (test_torch_warm_fit.py's bound for the same solver set; at
  16 px the crop window is the full frame and the rank budget 64 covers
  ntilde, so ROADMAP queue 3's crop-window and budget entries do not
  apply); the record's keys, forced gate failures, and the watchdog.

Importing the JAX bench sets ``GPTPU_GRAD_PRECISION`` (bench.py:52); the
import here restores it, since other JAX test files may share the worker.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussian_processes_tpu import data as jdata
from gaussian_processes_tpu import params as jparams
from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.models import inference as jinf
from gaussian_processes_tpu_torch import bench as tb
from gaussian_processes_tpu_torch.convert import config_from_any
from gaussian_processes_tpu_torch.models.inference import explained_variance

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(nt=120, n_px=16, ntilde=48, maxiter=3, n_estep=3, n_mstep=3,
             n_fparamstep=3)
HARD_SMALL = dict(n_px_side=16, n_train=100, n_val=20)
# the JAX bench's knobs that only its TPU path has, at the JAX FitConfig's
# defaults
JAX_TPU_DEFAULTS = dict(jit_whole_fit=False, whole_fit_rank=None,
                        pin_rank=None, pin_window_w=None, init_rank=None,
                        eigh_impl="eigh", static_schedule=False)
JAX_RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "phase",
                   "quality"}
JAX_QUALITY_KEYS = {"easy_final_loss", "easy_loss_gap_vs_ungated_golden",
                    "easy_loss_budget", "easy_gate_ok", "easy_r2_saturated",
                    "hard_r2", "hard_r2_sigma", "hard_r2_min",
                    "hard_final_loss", "hard_gate_ok", "gates_passed"}


def jax_draws(nt=3160, ntilde=2100, nbootstrap=200, nrep=30):
    """The JAX bench's inducing rows (bench.py:395-397) and the repeat
    permutations of JAX's explained_variance(nbootstrap, seed=0)
    (gaussian_processes_tpu/models/inference.py:128-152), as int32."""
    idx = jax.random.permutation(jax.random.PRNGKey(0), nt)[:ntilde]
    keys = jax.random.split(jax.random.PRNGKey(0), nbootstrap)
    perms = jax.vmap(lambda k: jax.random.permutation(k, nrep))(keys)
    return (np.asarray(idx).astype(np.int32),
            np.asarray(perms).astype(np.int32))


def jax_bench():
    """The repository's bench.py, imported with GPTPU_GRAD_PRECISION
    restored."""
    saved = os.environ.get("GPTPU_GRAD_PRECISION")
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO))
        if saved is None:
            os.environ.pop("GPTPU_GRAD_PRECISION", None)
        else:
            os.environ["GPTPU_GRAD_PRECISION"] = saved
    return bench


def test_draws_file_equals_a_fresh_jax_draw():
    with np.load(tb.DRAWS) as f:
        idx, perms = f["xtilde_idx"], f["bootstrap_perms"]
    want_idx, want_perms = jax_draws()
    assert idx.dtype == perms.dtype == np.int32
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(perms, want_perms)
    assert idx[:4].tolist() == [1192, 963, 888, 746]
    assert len(set(idx.tolist())) == 2100 and perms.shape == (200, 30)
    assert all(sorted(p) == list(range(30)) for p in perms.tolist())


def test_data_constants_and_golden_equal_the_jax_bench():
    jb = jax_bench()
    for name in ("BASELINE_SECONDS", "NT", "N_PX", "NTILDE", "MAXITER",
                 "N_ESTEP", "N_MSTEP", "N_FPARAMSTEP", "GOLDEN"):
        assert getattr(tb, name) == getattr(jb, name), name
    X, R = tb.make_data()
    jX, jR = jb.make_data()
    assert X.dtype == jX.dtype == np.float32 and X.shape == (3160, 11664)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(R, jR)


def test_held_out_set_is_the_jax_bench_s():
    """bench.py:463-474, as the JAX bench builds it."""
    Xt, Rt = tb.make_test_data()
    rng = np.random.default_rng(1)
    lin = np.linspace(-1, 1, 108)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.1 ** 2)).ravel()
    w = (w / np.linalg.norm(w)).astype(np.float32)
    want_X = rng.standard_normal((30, 108 * 108)).astype(np.float32)
    lam_t = np.exp(0.8 * want_X @ w)
    want_R = rng.poisson(lam_t[None, :].repeat(30, 0)).astype(np.float32)
    np.testing.assert_array_equal(Xt, want_X)
    np.testing.assert_array_equal(Rt, want_R)


@pytest.mark.parametrize("env,rung", [
    ({}, "exact_dyn"),
    ({"GPTPU_BENCH_MAX_LS": "8"}, "headline: max_linesearch_steps=8"),
    ({"GPTPU_BENCH_ESTEP_SOLVER": "chol"}, "exact_dyn"),
    ({"GPTPU_BENCH_LINESEARCH": "backtracking", "GPTPU_BENCH_N_ESTEP": "5",
      "GPTPU_BENCH_MSTEP_FTOL_REL": "1e-4", "GPTPU_BENCH_ESTEP_TOL": "1e-3",
      "GPTPU_BENCH_PROJ_RANK": "56", "GPTPU_BENCH_REFRESH_EVERY": "2"},
     "headline: mstep_ftol_rel=0.0001, estep_tol=0.001"),
], ids=["defaults", "max_ls", "estep_solver", "several"])
def test_make_config_equals_the_jax_bench_s(monkeypatch, env, rung):
    jb = jax_bench()
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = tb.make_config()
    want = config_from_any(jb.make_config(JCfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.reduced_rank, got.eigensolver, got.mstep_logdet) == (
        True, "subspace", "series")
    assert tb.rung(got) == rung


def test_explained_variance_with_the_jax_draws():
    rng = np.random.default_rng(5)
    lam = rng.gamma(2.0, 1.0, 30)
    rtst = rng.poisson(np.broadcast_to(lam, (30, 30))).astype(np.float64)
    f_pred = lam * np.exp(0.3 * rng.standard_normal(30))
    r2_j, s_j = jinf.explained_variance(jnp.asarray(rtst), jnp.asarray(f_pred),
                                        nbootstrap=200, seed=0)
    _, perms = tb.load_draws()
    r2_t, s_t = explained_variance(torch.as_tensor(rtst),
                                   torch.as_tensor(f_pred),
                                   perms=torch.as_tensor(perms))
    np.testing.assert_allclose(float(r2_t), float(r2_j), rtol=1e-10)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-10)


def test_hard_problem_and_sta_init_equal_jax_s(monkeypatch):
    monkeypatch.setenv("GPTPU_DATA_CACHE", "")
    X, R, Xte, Rte = tb.make_hard_problem(0, **HARD_SMALL)
    # benchmarks/bench_hard_quality.py:73-83 at this shape
    ds = jdata.synthetic_retina_hard(n_cells=1, seed=0, **HARD_SMALL)
    jX, jR = ds.full_train()
    jXte, _ = ds.test()
    for got, want in ((X, jX.astype(np.float32)),
                      (R, jR[:, 0].astype(np.float32)),
                      (Xte, jXte.reshape(jXte.shape[0], -1)
                       .astype(np.float32)),
                      (Rte, ds.responses_test[:, :, 0].astype(np.float32))):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert X.shape == (120, 256) and Rte.shape == (30, 30)
    # bench_hard_quality.py:105-112, in float64
    x64, r64 = X.astype(np.float64), R.astype(np.float64)
    theta, f_params = tb.sta_init(torch.as_tensor(x64), torch.as_tensor(r64),
                                  16)
    _, _, (row, col) = jparams.get_sta(jnp.asarray(x64), jnp.asarray(r64), 16)
    lin = np.linspace(-1, 1, 16)
    jtheta, _, _ = jparams.generate_theta(
        jnp.asarray(x64), jnp.asarray(r64), 16,
        eps_0x=float(lin[int(col)]), eps_0y=float(lin[int(row)]))
    for k in jtheta:
        np.testing.assert_allclose(float(theta[k]), float(jtheta[k]),
                                   rtol=1e-10, atol=1e-12, err_msg=k)
        assert theta[k].dtype == torch.float64
    for k, v in jparams.default_f_params().items():
        np.testing.assert_allclose(float(f_params[k]), float(v), rtol=1e-7)


@pytest.fixture(scope="module")
def small_idx():
    idx, _ = jax_draws(nt=SMALL["nt"], ntilde=SMALL["ntilde"])
    return idx


def small_bench(small_idx, **kwargs):
    os.environ["GPTPU_DATA_CACHE"] = ""
    try:
        return tb.run_bench(**SMALL, repeats=1, device="cpu",
                            dtype=torch.float64, xtilde_idx=small_idx,
                            hard_kwargs=HARD_SMALL, **kwargs)
    finally:
        del os.environ["GPTPU_DATA_CACHE"]


@pytest.fixture(scope="module")
def small_run(small_idx):
    return small_bench(small_idx)


def test_slice_matches_the_jax_fit_at_a_small_shape(small_run, small_idx):
    rec, _ = small_run
    jb = jax_bench()
    cfg = dataclasses.replace(
        jb.make_config(JCfg, maxiter=SMALL["maxiter"]),
        ntilde=SMALL["ntilde"], n_px_side=SMALL["n_px"],
        n_estep=SMALL["n_estep"], n_mstep=SMALL["n_mstep"],
        n_fparamstep=SMALL["n_fparamstep"], **JAX_TPU_DEFAULTS)
    X, R = tb.make_data(0, SMALL["nt"], SMALL["n_px"])
    X = X.astype(np.float64)
    res = jf.fit(jnp.asarray(X), jnp.asarray(R.astype(np.float64)), cfg,
                 xtilde=jnp.asarray(X[small_idx]),
                 theta={k: jnp.float64(v) for k, v in tb.THETA0.items()},
                 f_params={k: jnp.float64(v)
                           for k, v in tb.F_PARAMS0.items()})
    assert not res.failed
    want = -np.asarray(res.track.logmarginal)
    np.testing.assert_allclose(rec["profile"]["loss"], want, rtol=1e-6)
    np.testing.assert_allclose(rec["final_losses"][-1], want[-1], rtol=1e-6)
    assert rec["profile"]["kept_rank"] == np.asarray(
        res.track.n_eigen).tolist()


def test_record_has_jax_s_keys(small_run):
    """The record of the default run at the small shape: JAX's keys, the
    gates' verdicts consistent with vs_baseline and the note, and the first
    timed run's profile."""
    rec, ok = small_run
    q = rec["quality"]
    assert JAX_RECORD_KEYS <= set(rec) and JAX_QUALITY_KEYS <= set(q)
    assert rec["metric"] == "one_cell_fit_wallclock" and rec["unit"] == "s"
    assert rec["phase"] == "complete" and rec["kernel"] == "plain (cpu)"
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    assert ok is (q["easy_gate_ok"] and q["hard_gate_ok"]) is q[
        "gates_passed"]
    assert (rec["vs_baseline"] > 0) is ok and ("note" in rec) is (not ok)
    assert q["easy_final_loss"] == round(rec["final_losses"][-1], 1)
    assert q["hard_config"] == "exact_dyn" and not q["hard_failed"]
    assert math.isfinite(q["hard_r2"]) and math.isfinite(q["hard_r2_sigma"])
    assert rec["value"] == round(float(np.median(rec["runs_s"])), 3)
    assert rec["min"] == min(rec["runs_s"]) and rec["warmup_s"] > 0
    assert "kernel_max_rel_err" not in q
    prof = rec["profile"]
    assert prof["launches"]["gram"] == 0          # the plain Gram on the CPU
    assert prof["evaluations"]["fparam"] > 0 and prof["evaluations"][
        "mstep"] > 0
    assert prof["evaluations"]["newton"] == 3 * (3 - 1)   # no E-step at i 0
    assert "fit.estep.fparams" in prof["spans_s"]
    assert len(prof["loss"]) == len(prof["kept_rank"]) == 3
    json.dumps(rec)


@pytest.mark.parametrize("golden,ok,note", [
    (dict(easy_ungated_loss=0.0, easy_loss_budget=25.0, hard_r2_min=-1e9),
     False, "gates FAILED: easy loss gap"),
    (dict(easy_ungated_loss=1e9, easy_loss_budget=25.0, hard_r2_min=2.0),
     False, "gates FAILED: hard-regime r2 gate failed"),
    (dict(easy_ungated_loss=1e9, easy_loss_budget=25.0, hard_r2_min=-1e9),
     True, None),
], ids=["easy_fails", "hard_fails", "both_pass"])
def test_a_forced_gate_sets_vs_baseline(monkeypatch, small_idx, golden, ok,
                                        note):
    for key, value in golden.items():
        monkeypatch.setitem(tb.GOLDEN, key, value)
    rec, got_ok = small_bench(small_idx, warmup=False)
    assert got_ok is ok and rec["quality"]["gates_passed"] is ok
    assert rec["quality"]["easy_gate_ok"] is (golden["easy_ungated_loss"] > 0)
    assert rec["quality"]["hard_gate_ok"] is (golden["hard_r2_min"] < 0)
    assert "warmup_s" not in rec
    if ok:
        assert "note" not in rec
        assert rec["vs_baseline"] == round(tb.BASELINE_SECONDS
                                           / rec["runs_s"][0], 2) > 0
    else:
        assert rec["note"].startswith(note) and rec["vs_baseline"] == 0.0


def test_watchdog_emits_what_was_measured_and_exits_3():
    code = (
        "import threading\n"
        "from gaussian_processes_tpu_torch import bench\n"
        "p = bench.Progress()\n"
        "p.phase = 'timed'\n"
        "p.runs.append(80.0)\n"
        "bench._watchdog(p, 0.1, threading.Event())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 3, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] == 80.0 and rec["vs_baseline"] == 0.0
    assert rec["phase"] == "timed" and rec["note"].startswith("watchdog")


def test_repeats_must_be_positive():
    with pytest.raises(ValueError, match="repeats"):
        tb.run_bench(repeats=0, device="cpu")


if __name__ == "__main__":
    idx, perms = jax_draws()
    np.savez(tb.DRAWS, xtilde_idx=idx, bootstrap_perms=perms)
    print(f"wrote {tb.DRAWS}")
