"""Data layer: dataset container and synthetic generators, pure numpy
(a copy of ``gaussian_processes_tpu/data.py``, which cannot be imported
here: that package's ``__init__`` imports jax).

Successor of the reference's ``Spatial_GP_repo/data.py`` Dataset (same
surface: train/val/test splits, cell selection, epoch-permuted minibatches,
pickle save/load) plus synthetic retina generators that plant receptive
fields and Poisson responses.  The arrays are identical to the JAX
package's for the same arguments.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    """Images are (n, px, px) or (n, px*px); responses are (n, ncells);
    test responses are (nrep, nimg, ncells) (reference: data.py:9-108,
    one_cell_fit.ipynb:cell4)."""

    images_train: np.ndarray
    responses_train: np.ndarray
    images_val: np.ndarray
    responses_val: np.ndarray
    images_test: np.ndarray
    responses_test: np.ndarray

    def __post_init__(self):
        self.num_neurons = self.responses_train.shape[1]
        self.num_train_samples = self.images_train.shape[0]
        self.px_y = self.images_train.shape[1]
        self.px_x = (self.images_train.shape[2]
                     if self.images_train.ndim > 2 else self.px_y)
        self._minibatch_idx = np.iinfo(np.int64).max
        self._train_perm = np.empty(0, np.int64)
        self.cell_selection: Optional[Sequence[int]] = None

    # ---- selection ----
    def get_cell_nbs(self):
        return list(range(self.num_neurons))

    def select_cells(self, selection):
        self.cell_selection = None if selection == "all" else selection

    def _select(self, responses):
        if self.cell_selection is not None:
            return responses[..., self.cell_selection]
        return responses

    # ---- splits ----
    def train(self):
        return self.images_train, self._select(self.responses_train)

    def val(self):
        return self.images_val, self._select(self.responses_val)

    def test(self, averages: bool = True):
        responses = self._select(self.responses_test)
        if averages:
            responses = responses.mean(axis=0)
        return self.images_test, responses

    def full_train(self) -> Tuple[np.ndarray, np.ndarray]:
        """train + val concatenated and flattened — the working set of the
        notebooks (one_cell_fit.ipynb:cell4)."""
        X = np.concatenate([self.images_train, self.images_val], axis=0)
        R = np.concatenate([self.responses_train, self.responses_val], axis=0)
        return X.reshape(X.shape[0], -1), R

    # ---- minibatching (epoch-permuted, reference: data.py:86-95) ----
    def minibatch(self, batch_size: int):
        if self._minibatch_idx + batch_size > self.num_train_samples:
            self.next_epoch()
        idx = self._train_perm[self._minibatch_idx
                               + np.arange(batch_size)]
        self._minibatch_idx += batch_size
        return self.images_train[idx], self.responses_train[idx]

    def next_epoch(self):
        self._minibatch_idx = 0
        self._train_perm = np.random.permutation(self.num_train_samples)

    # ---- persistence ----
    def save(self, data_file: str):
        if os.path.isfile(data_file):
            raise FileExistsError(data_file)
        with open(data_file, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(data_file: str) -> "Dataset":
        with open(data_file, "rb") as f:
            return pickle.load(f)


def _lowpass(X: np.ndarray, sigma_px: float) -> np.ndarray:
    """Gaussian low-pass in Fourier space (per image), giving spatially
    correlated 'natural-ish' stimuli.  X is (n, px, px)."""
    n_px = X.shape[-1]
    f = np.fft.fftfreq(n_px)
    fy, fx = np.meshgrid(f, f, indexing="ij")
    H = np.exp(-2.0 * (np.pi * sigma_px) ** 2 * (fx ** 2 + fy ** 2))
    Xf = np.fft.fft2(X, axes=(-2, -1))
    Xs = np.real(np.fft.ifft2(Xf * H[None], axes=(-2, -1)))
    # re-standardize per pixel ensemble so the overall contrast is unchanged
    Xs = Xs / Xs.std()
    return Xs.astype(np.float32)


def _dog_rf(n_px_side: int, cx: float, cy: float, sx: float, sy: float,
            angle: float, surround_weight: float,
            surround_scale: float) -> np.ndarray:
    """Rotated anisotropic difference-of-Gaussians receptive field — the
    center-surround antagonism of a real RGC, deliberately OUTSIDE the
    model class of the localized-Gaussian-envelope prior
    (reference localker: utils.py:861-914 assumes an isotropic envelope)."""
    lin = np.linspace(-1, 1, n_px_side)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    ca, sa = np.cos(angle), np.sin(angle)
    u = ca * (xx - cx) + sa * (yy - cy)
    v = -sa * (xx - cx) + ca * (yy - cy)
    center = np.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2))
    surround = np.exp(-0.5 * ((u / (sx * surround_scale)) ** 2
                              + (v / (sy * surround_scale)) ** 2))
    w = center - surround_weight * surround
    w = w.ravel()
    return (w / np.linalg.norm(w)).astype(np.float32)


def synthetic_retina_hard(n_px_side: int = 108, n_train: int = 2910,
                          n_val: int = 250, n_test: int = 30,
                          n_repeats: int = 30, n_cells: int = 1,
                          gain: float = 1.0, energy_weight: float = 1.0,
                          surround_weight: float = 0.6,
                          surround_scale: float = 2.2,
                          stim_corr_sigma: float = 2.0,
                          rate_scale: float = 2.0,
                          seed: int = 0) -> Dataset:
    """HARD validation regime: model-mismatched, low-SNR synthetic retina.

    The easy ``synthetic_retina`` plants an isotropic-Gaussian linear RF
    with an exponential link — exactly the model class the spatial GP can
    represent — so its noise-corrected r^2 SATURATES at ~1.0 and cannot
    rank fits.  The reference's whole quality story lives at r^2 ~= 0.72
    on real retinal data (one_cell_fit.ipynb:cell8 output,
    utils.py:1502-1541).  This generator is built so a correct,
    exact-semantics fit lands in that regime, by violating the model
    assumptions the way a real RGC does:

    * **Spatially correlated stimuli** (Gaussian low-pass, sigma
      ``stim_corr_sigma`` px): natural-image-like second-order statistics
      instead of white noise.
    * **Rotated anisotropic difference-of-Gaussians RF**: center-surround
      antagonism; the model prior assumes an isotropic localized envelope.
    * **An orthogonal energy (complex-cell-like) component**: rate depends
      on |x . w_energy| with weight ``energy_weight`` relative to the
      linear drive — not representable by any monotone function of one
      linear projection, so it caps the achievable correlation with the
      true rate (the r^2 knob: 0 -> easy, 0.5-0.7 -> r^2 ~= 0.7).
    * **Low firing rates** (``rate_scale`` ~ 1 spike/image mean): the
      30x30 test repeats have realistic reliability < 1, so the
      noise-corrected r^2 carries real bootstrap variance like the
      reference's 0.72 +/- 0.04.

    Defaults were tuned (round 4) so the UNGATED headline-config fit
    measures r^2 ~= 0.7; see benchmarks/bench_hard_quality.py and
    COVERAGE.md's gate-requalification table.

    Generation costs ~48 s of single-core CPU (the Gaussian low-pass over
    ~7,200 images dominates); because bench.py's hard quality gate and the
    multi-seed ladder runs re-create the same dataset in fresh processes,
    the result is disk-cached under ``GPTPU_DATA_CACHE`` (default
    ``<repo>/.data_cache``; set to empty to disable), keyed by every
    generator parameter.
    """
    cache_key = ("hard-v1", n_px_side, n_train, n_val, n_test, n_repeats,
                 n_cells, gain, energy_weight, surround_weight,
                 surround_scale, stim_corr_sigma, rate_scale, seed)
    cache_dir = os.environ.get(
        "GPTPU_DATA_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".data_cache"))
    cache_path = None
    if cache_dir:
        import hashlib
        h = hashlib.sha1(repr(cache_key).encode()).hexdigest()[:16]
        # a name of its own: the JAX package's pickles name its Dataset class
        cache_path = os.path.join(cache_dir, f"retina_hard_torch_{h}.pkl")
        if os.path.exists(cache_path):
            with open(cache_path, "rb") as fh:
                return pickle.load(fh)

    rng = np.random.default_rng(seed)

    cxs = rng.uniform(-0.35, 0.35, n_cells)
    cys = rng.uniform(-0.35, 0.35, n_cells)
    angles = rng.uniform(0, np.pi, n_cells)
    ws_lin = np.stack([
        _dog_rf(n_px_side, cxs[i], cys[i], sx=0.13, sy=0.07,
                angle=angles[i], surround_weight=surround_weight,
                surround_scale=surround_scale)
        for i in range(n_cells)])
    # energy filter: same envelope, odd symmetry along u (Gabor-like pair),
    # orthogonalized against the linear RF
    lin = np.linspace(-1, 1, n_px_side)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    ws_en = []
    for i in range(n_cells):
        ca, sa = np.cos(angles[i]), np.sin(angles[i])
        u = ca * (xx - cxs[i]) + sa * (yy - cys[i])
        v = -sa * (xx - cxs[i]) + ca * (yy - cys[i])
        env = np.exp(-0.5 * ((u / 0.13) ** 2 + (v / 0.07) ** 2))
        g = (env * np.sin(2 * np.pi * u / 0.13)).ravel()
        g = g - (g @ ws_lin[i]) * ws_lin[i]
        ws_en.append(g / np.linalg.norm(g))
    ws_en = np.stack(ws_en).astype(np.float32)

    # The cell's nonlinearity is FIXED: normalization constants come from a
    # one-time calibration draw, never from the split being generated (the
    # test split's 30 images must see the same cell as training).
    def raw_drives(n, r):
        Xw = r.standard_normal((n, n_px_side, n_px_side))
        X = _lowpass(Xw, stim_corr_sigma)
        Xf = X.reshape(n, -1)
        return X, Xf @ ws_lin.T, np.abs(Xf @ ws_en.T)   # (n, ncells) each

    cal_rng = np.random.default_rng(seed + 987654321)
    _, cal_lin, cal_en = raw_drives(4000, cal_rng)
    mu_l, sd_l = cal_lin.mean(0), cal_lin.std(0)
    mu_e, sd_e = cal_en.mean(0), cal_en.std(0)
    norm = np.sqrt(1.0 + energy_weight ** 2)

    def drive_of(s_lin, s_en):
        z_l = (s_lin - mu_l) / sd_l
        z_e = (s_en - mu_e) / sd_e
        return gain * (z_l + energy_weight * z_e) / norm

    # mean-rate calibration: E[exp(drive)] from the same draw
    log_mean_exp = np.log(np.exp(drive_of(cal_lin, cal_en)).mean(0))

    def draw(n):
        X, s_lin, s_en = raw_drives(n, rng)
        lam = rate_scale * np.exp(drive_of(s_lin, s_en)
                                  - log_mean_exp[None, :])
        return X, lam

    Xtr, lam_tr = draw(n_train)
    Xv, lam_v = draw(n_val)
    Xte, lam_te = draw(n_test)
    Rtr = rng.poisson(lam_tr).astype(np.float32)
    Rv = rng.poisson(lam_v).astype(np.float32)
    Rte = rng.poisson(np.broadcast_to(
        lam_te, (n_repeats, n_test, n_cells))).astype(np.float32)
    ds = Dataset(Xtr, Rtr, Xv, Rv, Xte, Rte)
    ds.ground_truth_rfs = ws_lin
    ds.ground_truth_energy_rfs = ws_en
    ds.ground_truth_rates_test = lam_te
    if cache_path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        # a temporary name of this process's own, then an atomic rename, so
        # concurrent generators never write into one file
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=cache_dir)
        try:
            with os.fdopen(fd, "wb") as fh:
                pickle.dump(ds, fh, protocol=4)
            os.replace(tmp, cache_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ds


def synthetic_retina(n_px_side: int = 108, n_train: int = 2910,
                     n_val: int = 250, n_test: int = 30, n_repeats: int = 30,
                     n_cells: int = 41, gain: float = 0.8,
                     rf_sigma: float = 0.1, seed: int = 0) -> Dataset:
    """Plant Gaussian RFs and Poisson responses at the reference dataset's
    shapes (3,160 train+val images of 108x108, 41 cells, 30x30 test;
    one_cell_fit.ipynb:cell4)."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, n_px_side)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")

    centers = rng.uniform(-0.5, 0.5, (n_cells, 2))
    ws = np.stack([
        np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * rf_sigma ** 2)).ravel()
        for cx, cy in centers])
    ws /= np.linalg.norm(ws, axis=1, keepdims=True)

    def draw(n):
        X = rng.standard_normal((n, n_px_side, n_px_side)).astype(np.float32)
        lam = np.exp(gain * X.reshape(n, -1) @ ws.T)       # (n, ncells)
        return X, lam

    Xtr, lam_tr = draw(n_train)
    Xv, lam_v = draw(n_val)
    Xte, lam_te = draw(n_test)
    Rtr = rng.poisson(lam_tr).astype(np.float32)
    Rv = rng.poisson(lam_v).astype(np.float32)
    Rte = rng.poisson(
        np.broadcast_to(lam_te, (n_repeats, n_test, n_cells))).astype(np.float32)
    ds = Dataset(Xtr, Rtr, Xv, Rv, Xte, Rte)
    ds.ground_truth_rfs = ws
    ds.ground_truth_centers = centers
    return ds
