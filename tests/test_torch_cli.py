"""The port's user-facing entry points on the CPU: the command line
(``python -m gaussian_processes_tpu_torch``, in a subprocess at 16 px with
``--device cpu``), the example workflows, and ``entry()`` against the JAX
package's ``entry()`` forward in float32 (rtol 1e-4: two float32 Gram
routes, the Pallas-free XLA one and the port's plain one).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_processes_tpu_torch import __main__ as cli
from gaussian_processes_tpu_torch.entry import entry
from gaussian_processes_tpu_torch.examples import large_scale_posterior
from gaussian_processes_tpu_torch.models.inference import predict
from gaussian_processes_tpu_torch.utils.io import load_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_FIT = ["--n-px", "16", "--ntilde", "60", "--maxiter", "3",
             "--n-estep", "3", "--n-mstep", "3", "--n-fparamstep", "3"]


def run_cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "gaussian_processes_tpu_torch", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


def test_cli_fit_saves_a_model(tmp_path):
    out_dir = str(tmp_path / "cell0")
    res = run_cli("fit", "--device", "cpu", *SMALL_FIT, "--out", out_dir)
    assert res.returncode == 0, res.stderr
    assert "r2 = " in res.stdout and f"Saved model to {out_dir}" in res.stdout
    model = load_model(out_dir, device="cpu")
    assert model.config.reduced_rank and model.config.n_px_side == 16
    # the JAX example's solvers (the JAX FitConfig defaults)
    assert (model.config.eigensolver, model.config.estep_solver,
            model.config.mstep_inverse, model.config.mstep_logdet) == (
        "subspace", "schulz", "schulz", "series")
    assert not model.failed and model.xtilde.dtype == torch.float32
    rates, _, _ = predict(model, torch.zeros((3, 256)))
    assert torch.isfinite(rates).all()
    with open(os.path.join(out_dir, "metadata")) as f:
        assert "r2 = " in f.read()


@pytest.mark.parametrize("cmd,args,expect", [
    ("active", ["--n-px", "16", "--npool", "80", "--n-start", "20",
                "--n-add", "2", "--maxiter", "2", "--ab-control"],
     ["[seed 0] ACTIVE", "[seed 0] RANDOM"]),
    ("population", ["--n-px", "16", "--nt", "40", "--ntilde", "20",
                    "--ncells", "2", "--maxiter", "2"],
     ["2 cells fit in", "cell 1: loss"]),
])
def test_cli_workflows_run_on_the_cpu(cmd, args, expect):
    res = run_cli(cmd, "--device", "cpu", *args)
    assert res.returncode == 0, res.stderr
    for text in expect:
        assert text in res.stdout


@pytest.mark.parametrize("argv,rc,text", [
    (["--help"], 0, "population"), ([], 0, "fit"),
    (["bench", "--help"], 0, "one_cell_fit"),
    (["train"], 2, "unknown command"),
])
def test_cli_commands(argv, rc, text, capsys):
    assert cli.main(argv) == rc
    assert text in capsys.readouterr().out


def test_cli_subprocess_exit_codes():
    assert run_cli("--help").returncode == 0
    res = run_cli("nope")
    assert res.returncode == 2 and "unknown command" in res.stdout
    res = run_cli("fit", "--help")
    assert res.returncode == 0 and "--device" in res.stdout


@pytest.mark.parametrize("argv", [["fit", *SMALL_FIT], ["bench"]],
                         ids=["fit", "bench"])
def test_cli_fit_defaults_to_the_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_examples_return_their_results(tmp_path):
    out = cli.COMMANDS["fit"].main(["--device", "cpu", "--f64", *SMALL_FIT])
    assert out["result"].xtilde.dtype == torch.float64
    assert np.isfinite(out["r2"]) and out["seconds"] > 0
    big = large_scale_posterior.main(["--n", "300", "--n-px", "12",
                                      "--nstar", "8", "--device", "cpu"])
    assert big["mu"].shape == (8,) and np.isfinite(big["corr"])


def test_entry_matches_jax_entry():
    import jax
    from __graft_entry__ import entry as jax_entry

    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in (args[0], args[3], args[5]))
    assert args[0].dtype == torch.float32 and args[0].shape == (32, 108 * 108)
    rates = fn(*args)
    jfn, jargs = jax_entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert rates.shape == want.shape == (32,)
    np.testing.assert_allclose(rates.numpy(), want, rtol=1e-4)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
