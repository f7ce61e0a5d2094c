"""The generator of population traffic: a synthetic multi-cell recording,
many retinal cells' responses to one stimulus set, made on the device
from a seed (one_cell_fit.ipynb cell4: 41 cells shown the same images).

Each cell is ``retina.py``'s model at the mix's envelope (a rotated
difference-of-Gaussians RF with an orthogonal energy term, low rates),
with its own centre within ``center_range`` and its own angle; every cell
sees the same ``n_train`` training images and the same ``n_test`` test
images, each shown ``n_repeats`` times.  Each cell's drive is normalised
from one calibration draw of ``n_calibration`` images, shared by the
cells (the stimulus statistics are the recording's, not a cell's).

``make_recording(params, seed, index, device)`` gives request ``index``
of a run seeded ``seed``: the same pair gives the same arrays.  With
``panel_size`` 1 in the mix every request of every seed is the one
recording drawn from ``panel_seed`` (``retina.cell_key``); a negative
index (the warm-up) is a recording of its own.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .retina import (DEFAULTS, cell_key, filters, lowpassed_images,  # noqa: F401
                     pass_size, stream_seed)

# streams of a recording's key: the cells' places, the calibration draw,
# the images and the responses (the driver draws the inducing rows from
# stream 4)
PLACES, CALIBRATION, IMAGES, RESPONSES = 0, 1, 2, 3


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def make_recording(params: Dict, seed: int, index: int, device) -> Dict:
    """Request ``index`` of a run seeded ``seed``: ``x`` (n_train, nx) and
    ``rs`` (n_cells, n_train) float32, ``x_test`` (n_test, nx), ``r_test``
    (n_cells, n_repeats, n_test) float32, the true test rates
    ``rates_test`` (n_cells, n_test) float64, and each cell's ``centres``
    and ``angles``."""
    p = dict(DEFAULTS, **params)
    device = torch.device(device)
    key = cell_key(params, seed, index)
    rng = np.random.default_rng(stream_seed(*key, PLACES))
    c = p["center_range"]
    places = [(float(rng.uniform(-c, c)), float(rng.uniform(-c, c)),
               float(rng.uniform(0.0, math.pi)))
              for _ in range(p["n_cells"])]
    w_lin, w_en = (torch.stack(w, dim=1) for w in zip(
        *(filters(p, cx, cy, angle, device) for cx, cy, angle in places)))

    def drives(x):
        xd = x.to(torch.float64)
        return xd @ w_lin, torch.abs(xd @ w_en)      # (n, n_cells) each

    cal = _generator(stream_seed(*key, CALIBRATION), device)
    s_lin, s_en = drives(lowpassed_images(p["n_calibration"], p, cal, device))
    mu_l, sd_l = s_lin.mean(0), s_lin.std(0, unbiased=False)
    mu_e, sd_e = s_en.mean(0), s_en.std(0, unbiased=False)
    norm = math.sqrt(1.0 + p["energy_weight"] ** 2)

    def drive(s_lin, s_en):
        return p["gain"] * ((s_lin - mu_l) / sd_l
                            + p["energy_weight"] * (s_en - mu_e) / sd_e) / norm

    log_mean_exp = torch.log(torch.exp(drive(s_lin, s_en)).mean(0))
    del s_lin, s_en

    images = _generator(stream_seed(*key, IMAGES), device)
    x = lowpassed_images(p["n_train"], p, images, device)
    x_test = lowpassed_images(p["n_test"], p, images, device)

    def rates(x):
        return (p["rate_scale"]
                * torch.exp(drive(*drives(x)) - log_mean_exp)).T

    lam, lam_test = rates(x), rates(x_test)
    spikes = _generator(stream_seed(*key, RESPONSES), device)
    rs = torch.poisson(lam, generator=spikes).to(torch.float32)
    r_test = torch.poisson(
        lam_test[:, None, :].expand(-1, p["n_repeats"], -1).contiguous(),
        generator=spikes).to(torch.float32)
    return dict(x=x, rs=rs, x_test=x_test, r_test=r_test,
                rates_test=lam_test, centres=[pl[:2] for pl in places],
                angles=[pl[2] for pl in places])
