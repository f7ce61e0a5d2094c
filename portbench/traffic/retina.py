"""The one generator of the benchmark's traffic: synthetic retinal cells
in the hard regime, made on the device from a seed.

A torch rewrite of the port's numpy ``data.synthetic_retina_hard`` (which
takes ~48 s of one CPU core for one cell, most of it the low-pass over
~7,200 images): the same model, so a fit lands where the lab's real data
does (noise-corrected r^2 ~ 0.7):

* white-noise images low-passed in Fourier space (sigma
  ``stim_corr_sigma`` px) and standardised: natural-image second-order
  statistics;
* a rotated, anisotropic difference-of-Gaussians RF (centre ``sx`` by
  ``sy``, surround ``surround_scale`` times wider at ``surround_weight``),
  outside the model class of the GP's isotropic envelope;
* an orthogonal energy (complex-cell) term at ``energy_weight``;
* low rates (``rate_scale`` spikes an image on average), normalised from a
  calibration draw of ``n_calibration`` images, never from the split made.

Departures from the numpy generator: the random streams are torch's
(``torch.Generator`` on the device), so the arrays differ from it bit for
bit; the train and validation images are one draw of ``n_train`` images,
standardised together; ``rf_scale`` scales both envelopes (centre and
surround, linear and energy) and ``center_range`` bounds the centres, so
one mix can ask for wide receptive fields.

Every number a mix sets is a key of its traffic file's ``params``; this
module holds no mix of its own.  ``make_cell(params, seed, index, device)``
gives request ``index`` of a run seeded ``seed``: the same pair gives the
same arrays.  Each index is a new cell (centre, angle and responses), or,
in a mix with a panel (``cell_key``), the panel's cells in an order drawn
from the seed.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

DEFAULTS = dict(n_px_side=108, n_train=3160, n_test=30, n_repeats=30,
                n_calibration=4000, gain=1.0, energy_weight=1.0,
                surround_weight=0.6, surround_scale=2.2, stim_corr_sigma=2.0,
                rate_scale=2.0, sx=0.13, sy=0.07, rf_scale=1.0,
                center_range=0.35)


def stream_seed(seed: int, index: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of request ``index`` of a run
    seeded ``seed`` (any whole number, also above 2**32)."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, int(index) % 2 ** 64,
                                 int(stream)])
    return int(rng.integers(0, 2 ** 63 - 1))


def cell_key(params: Dict, seed: int, index: int):
    """(seed, index) of the cell that serves request ``index`` of a run
    seeded ``seed``.  With ``panel_size`` P in the mix, the requests cycle
    through a fixed panel of P cells drawn from ``panel_seed``, in an
    order drawn from ``seed``: every run does the same work, in another
    order.  Without it, each request is a new cell drawn from ``seed``.
    A negative index (the warm-up) is a cell of its own either way."""
    size = params.get("panel_size")
    if not size:
        return seed, index
    if index < 0:
        return params["panel_seed"], index
    order = np.random.default_rng(stream_seed(seed, 0, 5)).permutation(size)
    return params["panel_seed"], int(order[index % size])


def pass_size(params: Dict) -> int:
    """Requests in one pass over the panel (1 without a panel)."""
    return int(params.get("panel_size") or 1)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _grid(n: int, device) -> tuple:
    lin = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    return xx, yy


def _rotated(xx, yy, cx, cy, angle):
    ca, sa = math.cos(angle), math.sin(angle)
    u = ca * (xx - cx) + sa * (yy - cy)
    v = -sa * (xx - cx) + ca * (yy - cy)
    return u, v


def filters(p: Dict, cx: float, cy: float, angle: float, device):
    """The cell's linear (DoG) and energy filters, unit norm, (nx,) float64
    each, the energy filter orthogonal to the linear one."""
    xx, yy = _grid(p["n_px_side"], device)
    u, v = _rotated(xx, yy, cx, cy, angle)
    sx, sy = p["sx"] * p["rf_scale"], p["sy"] * p["rf_scale"]
    ss = p["surround_scale"]
    centre = torch.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2))
    surround = torch.exp(-0.5 * ((u / (sx * ss)) ** 2 + (v / (sy * ss)) ** 2))
    w_lin = (centre - p["surround_weight"] * surround).reshape(-1)
    w_lin = w_lin / torch.linalg.vector_norm(w_lin)
    g = (centre * torch.sin(2 * math.pi * u / sx)).reshape(-1)
    g = g - (g @ w_lin) * w_lin
    return w_lin, g / torch.linalg.vector_norm(g)


def lowpassed_images(n: int, p: Dict, gen: torch.Generator, device):
    """(n, nx) float32 stimuli: white noise low-passed in Fourier space and
    standardised over the draw."""
    side = p["n_px_side"]
    x = torch.randn((n, side, side), generator=gen, dtype=torch.float32,
                    device=device)
    f = torch.fft.fftfreq(side, device=device, dtype=torch.float32)
    fy, fx = torch.meshgrid(f, f, indexing="ij")
    h = torch.exp(-2.0 * (math.pi * p["stim_corr_sigma"]) ** 2
                  * (fx ** 2 + fy ** 2))
    x = torch.fft.ifft2(torch.fft.fft2(x) * h).real
    x = x / x.std()
    return x.reshape(n, side * side).contiguous()


def make_cell(params: Dict, seed: int, index: int, device) -> Dict:
    """Request ``index`` of a run seeded ``seed``: ``x`` (n_train, nx) and
    ``r`` (n_train,) float32, ``x_test`` (n_test, nx) and ``r_test``
    (n_repeats, n_test) float32, the true test rates ``rates_test``
    (float64) and the cell's ``centre`` and ``angle``."""
    p = dict(DEFAULTS, **params)
    device = torch.device(device)
    seed, index = cell_key(params, seed, index)
    rng = np.random.default_rng(stream_seed(seed, index, 0))
    c = p["center_range"]
    cx, cy = (float(v) for v in rng.uniform(-c, c, 2))
    angle = float(rng.uniform(0.0, math.pi))
    w_lin, w_en = filters(p, cx, cy, angle, device)

    def drives(x):
        xd = x.to(torch.float64)
        return xd @ w_lin, torch.abs(xd @ w_en)

    cal = _generator(stream_seed(seed, index, 1), device)
    s_lin, s_en = drives(lowpassed_images(p["n_calibration"], p, cal, device))
    mu_l, sd_l = s_lin.mean(), s_lin.std(unbiased=False)
    mu_e, sd_e = s_en.mean(), s_en.std(unbiased=False)
    norm = math.sqrt(1.0 + p["energy_weight"] ** 2)

    def drive(s_lin, s_en):
        return p["gain"] * ((s_lin - mu_l) / sd_l
                            + p["energy_weight"] * (s_en - mu_e) / sd_e) / norm

    log_mean_exp = torch.log(torch.exp(drive(s_lin, s_en)).mean())

    gen = _generator(stream_seed(seed, index, 2), device)

    def draw(n):
        x = lowpassed_images(n, p, gen, device)
        lam = p["rate_scale"] * torch.exp(drive(*drives(x)) - log_mean_exp)
        return x, lam

    x, lam = draw(p["n_train"])
    x_test, lam_test = draw(p["n_test"])
    r = torch.poisson(lam, generator=gen).to(torch.float32)
    r_test = torch.poisson(lam_test.expand(p["n_repeats"], -1).contiguous(),
                           generator=gen).to(torch.float32)
    return dict(x=x, r=r, x_test=x_test, r_test=r_test, rates_test=lam_test,
                centre=(cx, cy), angle=angle)
