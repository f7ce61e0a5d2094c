"""Carry hyperparameters and fitted state between the JAX package and this
port.

Everything crosses as numpy arrays, so this module needs neither package's
arrays: ``np.asarray`` of a JAX array is the JAX side's export, and the
``*_to_numpy`` functions are this side's.  theta and f-params are dicts of
scalars; the fitted state is the eight arrays a prediction needs
(``FittedState``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

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
