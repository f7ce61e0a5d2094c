"""Checkpoint I/O: save and load fitted models (counterpart of
``gaussian_processes_tpu/utils/io.py`` without its orbax route).

The reference's pickle persistence (Spatial_GP_repo/utils.py:46-109,
312-324): a ``model`` pickle and a human-readable ``metadata`` description in
a directory that must not exist yet.  Tensors are stored as numpy arrays
and the track as a plain dict, so the JAX package's ``load_model`` reads
these checkpoints too.  ``load_model`` also reads checkpoints written by the
JAX package, without importing it: their track is pickled as
``gaussian_processes_tpu.models.fit.Track``, which the unpickler maps to
this package's ``Track``.  The unpickler resolves only numpy's array
reconstruction and that class, and refuses every other global.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from datetime import datetime

import numpy as np
import torch

from ..config import resolve_device
from ..params import logbetaexpr_to_beta, logrhoexpr_to_rho

# what a checkpoint of numpy arrays may name: numpy's array and scalar
# reconstruction (module paths of numpy 1 and 2)
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}
_TRACK_GLOBALS = {("gaussian_processes_tpu.models.fit", "Track"),
                  ("gaussian_processes_tpu_torch.models.fit", "Track")}


def _numpy(v):
    """Tensors as numpy arrays, through dicts (theta, bounds, the track)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy(x) for k, x in v.items()}
    return v


def describe(result) -> str:
    t = {k: _numpy(v) for k, v in result.track._asdict().items()}
    th = t["theta"]
    cfg = result.config
    lines = [
        "Model Description:",
        f"  cellid:   {cfg.cellid}",
        f"  ntilde:   {cfg.ntilde}",
        f"  maxiter:  {cfg.maxiter}  nEstep: {cfg.n_estep}  "
        f"nMstep: {cfg.n_mstep}  nFparamstep: {cfg.n_fparamstep}",
        f"  eigval_tol: {cfg.eigval_tol}  reduced_rank: {cfg.reduced_rank}",
        "",
        "Hyperparameters (start -> end):",
    ]
    for k, v in th.items():
        lines.append(f"  {k:<12}: {float(v[0]):>10.4f} -> "
                     f"{float(v[-1]):>10.4f}")
    beta = [float(logbetaexpr_to_beta(float(th["-2log2beta"][i])))
            for i in (0, -1)]
    rho = [float(logrhoexpr_to_rho(float(th["-log2rho2"][i])))
           for i in (0, -1)]
    lines += [
        f"  beta        : {beta[0]:>10.4f} -> {beta[1]:>10.4f}",
        f"  rho         : {rho[0]:>10.4f} -> {rho[1]:>10.4f}",
        "",
        f"  logA        : {float(t['logA'][0]):>10.4f} -> "
        f"{float(t['logA'][-1]):>10.4f}",
        f"  lambda0     : {float(t['lambda0'][0]):>10.4f} -> "
        f"{float(t['lambda0'][-1]):>10.4f}",
        f"  loss        : {-float(t['logmarginal'][0]):>10.4f} -> "
        f"{-float(t['logmarginal'][-1]):>10.4f}",
        f"  failed      : {result.failed} (at iteration {result.failed_at})",
    ]
    return "\n".join(lines)


def save_model(result, directory: str, additional_description: str = None):
    """Write ``result`` to a new ``directory``; an existing one is refused,
    exactly like the reference (utils.py:54-57).  Returns the
    description."""
    if os.path.exists(directory):
        raise ValueError(f"Directory {directory} already exists")
    os.makedirs(directory)

    description = describe(result)
    if additional_description:
        description += f"\n\n{additional_description}"

    payload = {f.name: _numpy(getattr(result, f.name))
               for f in dataclasses.fields(result)
               if f.name not in ("config", "track")}
    payload["config"] = dataclasses.asdict(result.config)
    payload["track"] = _numpy(result.track._asdict())
    payload["__description__"] = description
    payload["__saved_at__"] = datetime.now().isoformat()

    with open(os.path.join(directory, "model"), "wb") as f:
        pickle.dump(payload, f)
    with open(os.path.join(directory, "metadata"), "w") as f:
        f.write(description)
    return description


class _Unpickler(pickle.Unpickler):
    """Resolves numpy's reconstruction globals and the track class of
    either package (as this package's ``Track``); refuses the rest."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if (module, name) in _TRACK_GLOBALS:
            from ..models.fit import Track
            return Track
        raise pickle.UnpicklingError(
            f"a checkpoint may not name {module}.{name}")


def load_model(directory: str, device=None, dtype=None):
    """The ``FitResult`` saved in ``directory`` by this package's
    ``save_model`` or the JAX package's, its tensors on ``device`` (default:
    the CUDA card; raises without one) in their saved dtype unless
    ``dtype`` is given.  Config fields this package does not have are
    dropped."""
    from ..convert import fit_result_from_numpy

    device = resolve_device(None, device)
    with open(os.path.join(directory, "model"), "rb") as f:
        payload = _Unpickler(f).load()
    payload.pop("__description__", None)
    payload.pop("__saved_at__", None)
    return fit_result_from_numpy(payload, dtype=dtype, device=device)
