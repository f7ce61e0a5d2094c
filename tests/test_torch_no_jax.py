"""The port imports neither jax nor optax nor the JAX package nor the JAX
bench and its scripts (the repository's bench.py and benchmarks/): every
module of gaussian_processes_tpu_torch is imported in a fresh interpreter,
which must end with no jax, optax, gaussian_processes_tpu, bench or
benchmarks module loaded (and no matplotlib: the plotting module imports it
inside its functions)."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import torch

import gaussian_processes_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    pkg = gaussian_processes_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_every_module_is_listed():
    names = _modules()
    for expected in ("config", "params", "data", "convert", "ops.kernels",
                     "ops.gram_cuda", "ops.stabilize", "ops.lambertw",
                     "ops.fparam_search", "ops.cuda_build",
                     "ops.analytic_grads",
                     "models.moments", "models.estep", "models.fit",
                     "models.inference", "models.acquisition",
                     "models.active", "optim.lbfgs", "optim.graphed",
                     "parallel",
                     "parallel.population", "parallel.large",
                     "parallel.mesh", "parallel.collectives",
                     "parallel.sharded_linalg", "utils",
                     "utils.guards", "utils.io", "utils.metrics",
                     "utils.tracing", "utils.plotting", "examples",
                     "examples.one_cell_fit", "examples.active_training",
                     "examples.population_fit",
                     "examples.large_scale_posterior", "__main__", "entry",
                     "bench", "benchmarks", "benchmarks.common",
                     "benchmarks.acquisition", "benchmarks.active_refit",
                     "benchmarks.large_ntilde", "benchmarks.active_pipelined",
                     "benchmarks.population",
                     "benchmarks.parity_production",
                     "benchmarks.hard_quality", "benchmarks.bad_init",
                     "benchmarks.ab_active_vs_random_hard",
                     "benchmarks.fparam_route"):
        assert f"gaussian_processes_tpu_torch.{expected}" in names


def test_port_imports_no_jax_or_optax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'matplotlib',\n"
        "                           'gaussian_processes_tpu', 'bench',\n"
        "                           'benchmarks'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_file_imports_jax_or_the_jax_package():
    """By the text: every module of the port and chip_smoke.py (which runs
    where jax is not installed)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|"
                         r"gaussian_processes_tpu|bench|benchmarks)(\.|\s|$)",
                         re.M)
    pkg = os.path.join(REPO, "gaussian_processes_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f) for root, _, names in os.walk(pkg)
        for f in names if f.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as fh:
            found = pattern.findall(fh.read())
        assert not found, (path, found)
