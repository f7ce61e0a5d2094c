"""Metrics: structured per-iteration records (counterpart of
``gaussian_processes_tpu/utils/metrics.py``).

The reference tracks everything in an in-memory ``values_track`` dict and
prints the loss per iteration (Spatial_GP_repo/utils.py:1713-1727,
1969-1991).  The fit returns the same history as tensors (models/fit.py
``Track``); this module turns it into flat records, read from the device
in one transfer, and optionally streams them as JSONL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

_SCALARS = ("logmarginal", "loglikelihood", "KL", "logA", "lambda0")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def iteration_records(result) -> List[Dict]:
    """One flat dict per EM iteration of a FitResult."""
    t = result.track
    cols = {k: _host(getattr(t, k)) for k in _SCALARS + ("n_eigen",)}
    theta = {k: _host(v) for k, v in t.theta.items()}
    recs = []
    for i in range(len(cols["logmarginal"])):
        rec = {"iteration": i}
        rec.update({k: float(cols[k][i]) for k in _SCALARS})
        rec["n_eigen"] = int(cols["n_eigen"][i])
        for k, v in theta.items():
            rec[f"theta.{k}"] = float(v[i])
        recs.append(rec)
    return recs


class MetricsLogger:
    """Append-only JSONL metrics stream (one object per call)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, **metrics):
        rec = {k: (v.item() if isinstance(v, (np.generic, torch.Tensor))
                   else v) for k, v in metrics.items()}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in rec.items()))
        return rec

    def log_fit(self, result, prefix: str = ""):
        for rec in iteration_records(result):
            if prefix:
                rec = {f"{prefix}{k}": v for k, v in rec.items()}
            self.log(**rec)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
