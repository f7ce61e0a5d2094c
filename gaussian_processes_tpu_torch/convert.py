"""Carry hyperparameters and fitted state between the JAX package and this
port.

Everything crosses as numpy arrays, so this module needs neither package's
arrays: ``np.asarray`` of a JAX array is the JAX side's export, and the
``*_to_numpy`` functions are this side's.  theta and f-params are dicts of
scalars; the fitted state is the eight arrays a prediction needs
(``FittedState``).  A population fit's cell-stacked carry converts cell by
cell (``population_states_from_numpy``), and a whole fit, at any rank, as
the port's ``FitResult`` (``fit_result_from_numpy``, which checkpoints load
through).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, NamedTuple

import numpy as np
import torch

from .config import FitConfig
from .params import THETA_KEYS


def _tensor(v, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def theta_from_numpy(theta: Mapping[str, object], dtype=torch.float64,
                     device=None) -> dict:
    """theta (the six keys of ``params.THETA_KEYS``) as 0-d tensors."""
    return {k: _tensor(theta[k], dtype, device) for k in THETA_KEYS}


def theta_to_numpy(theta: Mapping[str, torch.Tensor]) -> dict:
    """theta as numpy 0-d arrays, for the JAX package."""
    return {k: theta[k].detach().cpu().numpy() for k in THETA_KEYS}


def f_params_from_numpy(f_params: Mapping[str, object], dtype=torch.float64,
                        device=None) -> dict:
    """{logA, lambda0} as 0-d tensors."""
    return {k: _tensor(f_params[k], dtype, device)
            for k in ("logA", "lambda0")}


class FittedState(NamedTuple):
    """The fitted posterior a prediction needs (``predict_rates``)."""
    xtilde: torch.Tensor
    m_b: torch.Tensor
    V_b: torch.Tensor
    B: torch.Tensor
    keep: torch.Tensor
    eigvals: torch.Tensor
    k_tilde_b_diag: torch.Tensor
    k_tilde_inv_diag: torch.Tensor


def state_from_numpy(state: Mapping[str, object], dtype=torch.float64,
                     device=None) -> FittedState:
    """A fitted state given as numpy arrays (or any object with those
    attributes, such as the JAX package's ``FitResult``) as tensors."""
    def get(name):
        return state[name] if isinstance(state, Mapping) else getattr(
            state, name)
    fields = {}
    for name in FittedState._fields:
        arr = np.array(get(name))
        fields[name] = torch.as_tensor(
            arr, dtype=torch.bool if name == "keep" else dtype, device=device)
    return FittedState(**fields)


class CellState(NamedTuple):
    """One cell of a population fit: what a prediction needs."""
    state: FittedState
    theta: dict
    f_params: dict


def population_states_from_numpy(carry, xtilde, dtype=torch.float64,
                                 device=None) -> List[CellState]:
    """Each cell's state from a cell-stacked population carry: the JAX
    package's ``fit_population`` carry (numpy-convertible arrays with a
    leading cell axis: ``theta``, ``f_params``, ``m_b``, ``V_b`` and
    ``kern.es``'s ``B``, ``eigvals``, ``keep``, ``k_tilde_b_diag``,
    ``k_tilde_inv_diag``), or the port's own.  ``xtilde`` is the inducing
    set all cells share (the carry does not hold it)."""
    def arr(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v)

    es = carry.kern.es
    fields = {"m_b": carry.m_b, "V_b": carry.V_b, "B": es.B,
              "keep": es.keep, "eigvals": es.eigvals,
              "k_tilde_b_diag": es.k_tilde_b_diag,
              "k_tilde_inv_diag": es.k_tilde_inv_diag}
    fields = {k: arr(v) for k, v in fields.items()}
    theta = {k: arr(v) for k, v in carry.theta.items()}
    f_params = {k: arr(v) for k, v in carry.f_params.items()}
    xt = arr(xtilde)
    out = []
    for c in range(fields["m_b"].shape[0]):
        state = state_from_numpy(
            dict({k: v[c] for k, v in fields.items()}, xtilde=xt), dtype,
            device)
        out.append(CellState(
            state,
            theta_from_numpy({k: v[c] for k, v in theta.items()}, dtype,
                             device),
            f_params_from_numpy({k: v[c] for k, v in f_params.items()},
                                dtype, device)))
    return out


def _field(obj, name, default=None):
    if isinstance(obj, Mapping):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _plain(v):
    """Numpy scalars and 0-d arrays as Python numbers, through dicts and
    lists (a checkpoint's timing and bounds)."""
    if isinstance(v, Mapping):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.ndarray, np.generic)) and np.ndim(v) == 0:
        return v.item()
    return v


def config_from_any(cfg) -> FitConfig:
    """The port's ``FitConfig`` from a config given as a dict or as an
    object with the same attributes (the JAX package's ``FitConfig``):
    the fields the port has, the rest dropped."""
    kw = {}
    for f in dataclasses.fields(FitConfig):
        v = _field(cfg, f.name, dataclasses.MISSING)
        if v is not dataclasses.MISSING:
            kw[f.name] = _plain(v)
    return FitConfig(**kw)


def fit_result_from_numpy(result, dtype=None, device=None):
    """The port's ``FitResult`` from a fit given as numpy-convertible
    arrays: the JAX package's ``FitResult`` (full or reduced rank), the
    payload of a checkpoint (a dict of its fields) or the port's own.
    Float arrays keep their dtype unless ``dtype`` is given; every tensor
    is row-major on ``device``."""
    from .models.fit import FitResult, Track

    def tensor(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
        arr = np.array(v, order="C")        # a row-major, writable copy
        want = dtype if (dtype is not None and arr.dtype.kind == "f") else None
        return torch.as_tensor(arr, device=device, dtype=want)

    def tensors(d):
        return {k: tensor(v) for k, v in d.items()}

    track = _field(result, "track")
    t = Track(**{name: (tensors(_field(track, name)) if name == "theta"
                        else tensor(_field(track, name)))
                 for name in Track._fields})
    arrays = {name: tensor(_field(result, name)) for name in (
        "xtilde", "m_b", "V_b", "B", "keep", "eigvals", "k_tilde_b_diag",
        "k_tilde_inv_diag", "K_tilde", "K", "Kvec", "K_b", "a")}
    return FitResult(
        config=config_from_any(_field(result, "config")), track=t,
        theta=tensors(_field(result, "theta")),
        f_params=tensors(_field(result, "f_params")),
        theta_lower=_plain(dict(_field(result, "theta_lower"))),
        theta_upper=_plain(dict(_field(result, "theta_upper"))),
        failed=bool(_plain(_field(result, "failed"))),
        failed_at=int(_plain(_field(result, "failed_at"))),
        timing=_plain(_field(result, "timing")),
        used_warm_basis=bool(_plain(_field(result, "used_warm_basis",
                                           False))),
        **arrays)
