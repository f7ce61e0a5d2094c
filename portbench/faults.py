"""Faults planted under the program's timed path, for the checks to catch:
the CPU fault tests and ``calibrate --fault`` (the faults' readings at a
cell's own size on the card) plant them.

* ``state_unchanged``: every EM iteration's E-step and M-step run and
  return the state they were given; the iteration still records its loss
  (at that state) in the fit's track;
* ``mstep_unchanged``: the same of the M-step alone;
* ``half_batch``: the likelihood counts the first half of the training
  rows twice and leaves out the rest;
* ``rates_altered``: the predicted rates come out 5% high where they are
  produced.

Each is a context manager that patches the program's functions and puts
them back on exit.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def mstep_unchanged():
    from gaussian_processes_tpu_torch.models import fit as fit_module
    real = fit_module._minimize

    def minimize(cfg, fun, x0, *args, **kwargs):
        x, f = real(cfg, fun, x0, *args, **kwargs)
        return (x0, f) if isinstance(x0, dict) else (x, f)
    with _patched(fit_module, "_minimize", minimize):
        yield


@contextlib.contextmanager
def state_unchanged():
    from gaussian_processes_tpu_torch.models import fit as fit_module
    real = fit_module._estep_block

    def estep_block(r, kern, m_b, V_b, f_params, lambda_m, lambda_var,
                    *args, **kwargs):
        real(r, kern, m_b, V_b, f_params, lambda_m, lambda_var, *args,
             **kwargs)
        return m_b, V_b, f_params, lambda_m, lambda_var
    with _patched(fit_module, "_estep_block", estep_block), mstep_unchanged():
        yield


@contextlib.contextmanager
def half_batch():
    from gaussian_processes_tpu_torch.models import fit as fit_module
    real = fit_module.poisson_ell

    def half(r, f_mean, lambda_m, f_params, weight=None, rows=None):
        keep = torch.zeros_like(r)
        keep[..., :r.shape[-1] // 2] = 2.0
        w = keep if weight is None else weight * keep
        return real(r, f_mean, lambda_m, f_params, weight=w, rows=rows)
    with _patched(fit_module, "poisson_ell", half):
        yield


@contextlib.contextmanager
def rates_altered():
    from gaussian_processes_tpu_torch.models import inference
    real = inference.predict

    def predict(result, xstar):
        rates, mu, var = real(result, xstar)
        return rates * 1.05, mu, var
    with _patched(inference, "predict", predict):
        yield


FAULTS = {"state_unchanged": state_unchanged,
          "mstep_unchanged": mstep_unchanged, "half_batch": half_batch,
          "rates_altered": rates_altered}
