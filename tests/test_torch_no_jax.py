"""The port imports neither jax nor optax: every module of
gaussian_processes_tpu_torch is imported in a fresh interpreter, which must
end with no jax or optax module loaded."""

import json
import os
import pkgutil
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
                     "models.moments", "models.estep", "models.fit",
                     "models.inference", "models.acquisition",
                     "models.active", "optim.lbfgs", "parallel",
                     "parallel.population", "parallel.large"):
        assert f"gaussian_processes_tpu_torch.{expected}" in names


def test_port_imports_no_jax_or_optax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'optax'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
