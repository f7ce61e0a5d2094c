"""The port's utils (checkpoint I/O, metrics, tracing, guards, plotting)
against the JAX package's, float64, on the same inputs.

Checkpoints: the port's own round trip is exact; a checkpoint written by
the JAX package's ``save_model`` loads in a fresh interpreter that never
imports jax or the JAX package and predicts JAX's rates within 1e-10 (the
same arrays through the same math), and the JAX package loads the port's.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.config import FitConfig as JCfg
from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.models import inference as ji
from gaussian_processes_tpu.utils import guards as jg
from gaussian_processes_tpu.utils import io as jio
from gaussian_processes_tpu.utils import metrics as jmet
from gaussian_processes_tpu_torch import convert
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.models import inference as ti
from gaussian_processes_tpu_torch.utils import guards as tg
from gaussian_processes_tpu_torch.utils import io as tio
from gaussian_processes_tpu_torch.utils import metrics as tmet
from gaussian_processes_tpu_torch.utils import tracing as ttr

from test_torch_fit import FP0, JAX_EXACT, THETA0, planted

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NT, NTILDE = 12, 60, 30
STEPS = dict(maxiter=3, n_estep=2, n_mstep=2, n_fparamstep=2, n_px_side=N)
# a smooth prior (rho 0.5) keeps about 21 of 30 eigenvalues, so a tight
# budget (21 + 2, a multiple of 4) runs the fits below ntilde
THETA = dict(THETA0, **{"-log2rho2": -np.log(2 * 0.5 ** 2)})
RANK = dict(reduced_rank=True, rank_slack=1.0, rank_pad=2, rank_bucket=4)


@pytest.fixture(scope="module")
def problem():
    x, lam, rng = planted(N, NT, 0, gain=0.5)
    r = rng.poisson(lam).astype(float)
    idx = rng.permutation(NT)[:NTILDE]
    xs, _, _ = planted(N, 15, 1)
    return dict(x=x, r=r, idx=idx, x_test=xs)


@pytest.fixture(scope="module")
def port_fit(problem):
    p = problem
    x = torch.as_tensor(p["x"])
    return tf.fit(x, torch.as_tensor(p["r"]),
                  TCfg(ntilde=NTILDE, track_basis=True, **RANK, **STEPS),
                  xtilde=x[torch.as_tensor(p["idx"])], theta=THETA,
                  f_params=FP0)


@pytest.fixture(scope="module")
def jax_fit(problem):
    p = problem
    return jf.fit(jnp.asarray(p["x"]), jnp.asarray(p["r"]),
                  JCfg(ntilde=NTILDE, **STEPS,
                       **dict(JAX_EXACT, **RANK)),
                  xtilde=jnp.asarray(p["x"][p["idx"]]),
                  theta={k: jnp.float64(v) for k, v in THETA.items()},
                  f_params={k: jnp.float64(v) for k, v in FP0.items()})


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_save_load_round_trip_is_exact(tmp_path, problem, port_fit):
    d = str(tmp_path / "cell0")
    desc = tio.save_model(port_fit, d, additional_description="r2 = 0.5")
    assert "Model Description" in desc and desc.endswith("r2 = 0.5")
    with open(os.path.join(d, "metadata")) as f:
        assert f.read() == desc
    back = tio.load_model(d, device="cpu")
    assert back.config == port_fit.config
    for name in ("xtilde", "m_b", "V_b", "B", "keep", "eigvals",
                 "k_tilde_b_diag", "k_tilde_inv_diag", "K_tilde", "K",
                 "Kvec", "K_b", "a"):
        a, b = getattr(back, name), getattr(port_fit, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name, v in port_fit.track._asdict().items():
        w = getattr(back.track, name)
        if name == "theta":
            assert all(torch.equal(w[k], v[k]) for k in v)
        else:
            assert torch.equal(w, v), name
    assert (back.failed, back.failed_at) == (False, -1)
    assert back.theta_lower == port_fit.theta_lower
    xs = torch.as_tensor(problem["x_test"])
    for a, b in zip(ti.predict(back, xs), ti.predict(port_fit, xs)):
        assert torch.equal(a, b)
    # a second load of the same directory, reconstructing an iteration
    again = tio.load_model(d, device="cpu")
    assert torch.equal(ti.state_at_iteration(again, 1)[2],
                       ti.state_at_iteration(port_fit, 1)[2])


def test_save_refuses_an_existing_directory(tmp_path, port_fit):
    d = tmp_path / "exists"
    d.mkdir()
    with pytest.raises(ValueError, match="already exists"):
        tio.save_model(port_fit, str(d))


def test_load_without_a_device_needs_a_card(tmp_path, port_fit,
                                            monkeypatch):
    d = str(tmp_path / "m")
    tio.save_model(port_fit, d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_model(d)


def test_load_refuses_other_globals(tmp_path):
    """A pickle that would call a function on load is refused before the
    call."""
    d = tmp_path / "evil"
    d.mkdir()

    class Sneaky:
        def __reduce__(self):
            return (os.getcwd, ())
    with open(d / "model", "wb") as f:
        pickle.dump({"x": Sneaky()}, f)
    with pytest.raises(pickle.UnpicklingError, match="getcwd"):
        tio.load_model(str(d), device="cpu")


LOAD_WITHOUT_JAX = """
import json, sys
import numpy as np
from gaussian_processes_tpu_torch.models.inference import predict
from gaussian_processes_tpu_torch.utils.io import load_model
import torch
res = load_model(sys.argv[1], device="cpu")
xs = torch.as_tensor(np.load(sys.argv[2]))
rates, mu, var = predict(res, xs)
np.save(sys.argv[3], np.stack([t.numpy() for t in (rates, mu, var)]))
print(json.dumps({
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                            "gaussian_processes_tpu")),
    "rank": res.m_b.shape[0], "reduced": res.config.reduced_rank,
    "n_eigen": res.track.n_eigen.tolist(), "failed": res.failed}))
"""


def test_jax_checkpoint_loads_without_jax(tmp_path, problem, jax_fit):
    d = str(tmp_path / "jax_model")
    jio.save_model(jax_fit, d)
    xs_file = str(tmp_path / "xs.npy")
    out_file = str(tmp_path / "rates.npy")
    np.save(xs_file, problem["x_test"])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", LOAD_WITHOUT_JAX, d, xs_file,
                          out_file], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["loaded"] == []
    assert info["reduced"] and info["rank"] == jax_fit.m_b.shape[0] < NTILDE
    assert info["n_eigen"] == np.asarray(jax_fit.track.n_eigen).tolist()
    assert info["failed"] is False
    got = np.load(out_file)
    for t, j in zip(got, ji.predict(jax_fit, jnp.asarray(problem["x_test"]))):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-10)


def test_jax_package_loads_a_port_checkpoint(tmp_path, problem, port_fit):
    d = str(tmp_path / "port_model")
    tio.save_model(port_fit, d)
    jr = jio.load_model(d)
    xs = problem["x_test"]
    np.testing.assert_allclose(
        np.asarray(ji.predict(jr, jnp.asarray(xs))[0]),
        ti.predict(port_fit, torch.as_tensor(xs))[0].numpy(), rtol=1e-10)


# ---------------------------------------------------------------------------
# Metrics and tracing
# ---------------------------------------------------------------------------

def test_iteration_records_equal_jax(jax_fit):
    port = convert.fit_result_from_numpy(jax_fit, device="cpu")
    assert tmet.iteration_records(port) == jmet.iteration_records(jax_fit)


def test_metrics_logger_writes_jsonl(tmp_path, port_fit, capsys):
    path = str(tmp_path / "logs" / "fit.jsonl")
    with tmet.MetricsLogger(path, echo=True) as log:
        rec = log.log(step=np.int64(3), loss=torch.tensor(1.5), name="a")
        log.log_fit(port_fit, prefix="cell0.")
    assert rec == {"step": 3, "loss": 1.5, "name": "a"}
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 + port_fit.config.maxiter
    assert lines[1]["cell0.iteration"] == 0
    assert lines[-1]["cell0.logmarginal"] == pytest.approx(
        float(port_fit.track.logmarginal[-1]))
    assert "step=3 loss=1.5 name=a" in capsys.readouterr().out


def test_phase_timer_accumulates():
    timer = ttr.PhaseTimer()
    for _ in range(3):
        with timer.phase("estep", sync=torch.ones(2)):
            sum(range(1000))
    with timer.phase("mstep", sync=[torch.ones(1), torch.zeros(1)]):
        pass
    assert timer.counts == {"estep": 3, "mstep": 1}
    assert all(v >= 0.0 for v in timer.totals.values())
    lines = timer.summary().splitlines()
    assert len(lines) == 2 and "3 calls" in timer.summary()


def test_trace_spans_are_seen_by_the_profiler(problem):
    from torch.profiler import ProfilerActivity, profile
    p = problem
    x = torch.as_tensor(p["x"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttr.trace_annotation("gp.test_span"):
            tf.fit(x, torch.as_tensor(p["r"]),
                   TCfg(ntilde=NTILDE, **dict(STEPS, maxiter=3)),
                   xtilde=x[torch.as_tensor(p["idx"])], theta=THETA0,
                   f_params=FP0)
    names = {e.name for e in prof.events()}
    for span in ("gp.test_span", "fit.init", "fit.iteration",
                 "fit.kernel_state", "fit.estep", "fit.estep.newton",
                 "fit.estep.fparams", "fit.mstep", "fit.finalize"):
        assert span in names, span


def test_collect_spans_times_the_fit_spans(problem):
    p = problem
    x = torch.as_tensor(p["x"])
    with ttr.collect_spans() as spans:
        tf.fit(x, torch.as_tensor(p["r"]), TCfg(ntilde=NTILDE, **STEPS),
               xtilde=x[torch.as_tensor(p["idx"])], theta=THETA0,
               f_params=FP0)
    c = spans.counts
    assert c["fit.init"] == c["fit.finalize"] == 1
    assert c["fit.iteration"] == c["fit.kernel_state"] == STEPS["maxiter"] - 1
    assert c["fit.mstep"] == STEPS["maxiter"] - 2      # not in the last one
    assert c["fit.estep.newton"] == c["fit.estep.fparams"] == (
        STEPS["n_estep"] * (STEPS["maxiter"] - 1))
    assert spans.totals["fit.estep"] >= spans.totals["fit.estep.fparams"]
    # outside the block nothing is collected
    with ttr.trace_annotation("fit.iteration"):
        pass
    assert c["fit.iteration"] == STEPS["maxiter"] - 1


# ---------------------------------------------------------------------------
# Guards and plotting
# ---------------------------------------------------------------------------

def test_guards_match_jax(capsys):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    spd = A @ A.T + np.eye(6)
    for M in (spd, A, -spd):
        with pytest.warns(UserWarning) if M is not spd else _no_warning():
            got = tg.is_posdef(torch.as_tensor(M), name="M")
        assert got == jg.is_posdef(M, name="M")
    assert tg.is_symmetric(spd) and tg.is_simmetric(spd)
    x = rng.uniform(0.1, 2.0, 5)
    np.testing.assert_allclose(tg.safe_log(torch.as_tensor(x)).numpy(),
                               np.asarray(jg.safe_log(x)), rtol=1e-15)
    for bad in (np.array([1.0, 0.0]), np.array([1e-12])):
        with pytest.raises(ValueError):
            tg.safe_log(torch.as_tensor(bad))
    c = np.array([-1.0, -0.3, 0.0, 0.999999999, 1.0])
    np.testing.assert_allclose(tg.safe_acos(torch.as_tensor(c)).numpy(),
                               np.asarray(jg.safe_acos(c)), rtol=1e-14)
    jg.print_hyp({k: jnp.float64(v) for k, v in THETA0.items()})
    want = capsys.readouterr().out
    tg.print_hyp({k: torch.tensor(v, dtype=torch.float64)
                  for k, v in THETA0.items()})
    assert capsys.readouterr().out == want


class _no_warning:
    def __enter__(self):
        import warnings
        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._w.__exit__(*exc)


def test_plots_render_with_agg(problem, port_fit):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    from gaussian_processes_tpu_torch.utils import plotting
    figs = [plotting.plot_training_dashboard(port_fit),
            plotting.plot_receptive_field(port_fit)]
    rates = ti.predict(port_fit, torch.as_tensor(problem["x_test"]))[0]
    figs.append(plotting.plot_fit(rates, torch.ones((4, 15)), 0.5, 0.1))
    for fig in figs:
        fig.canvas.draw()
        plt.close(fig)
