"""The port's population program (``parallel/population.fit_population``)
against the benchmark's plain reference of it
(``portbench/reference/population.py``), lane by lane, in float64 on the
CPU, at the ``pop108`` configuration's knobs on a small recording: 3
cells, nt 64, 12 x 12 px, ntilde 24, 3 EM iterations of 10/10/10.

Tolerance 1e-8 (relative, or absolute on values near 0) on the recorded
losses, the final theta, the f-params and the basis-free state (B m_b and
B V_b B^T, since an eigenvector's sign is free): the two compute the same
steps in float64 and differ by rounding (the reference's Grams zero the
envelope outside the window where the program crops the images; its
M-step inverse is Cholesky's where the program's is Newton-Schulz's), which
three EM iterations of Newton and L-BFGS steps carry to ~1e-11.  The two
Armijo searches on a seeded objective agree to 1e-12: the same arithmetic
on a few numbers.  Imports torch, numpy, the port and the reference only.
"""

import math

import numpy as np
import pytest
import torch

from gaussian_processes_tpu_torch.config import FitConfig
from gaussian_processes_tpu_torch.optim.lbfgs import lbfgs_minimize_armijo
from gaussian_processes_tpu_torch.parallel import population as tpop
from portbench.reference import population as ref_pop

torch.set_num_threads(1)

N, NT, NTILDE, NCELLS = 12, 64, 24, 3
# pop108's knobs (portbench/configs/pop108.json) at 3 EM iterations
KNOBS = dict(maxiter=3, n_estep=10, n_mstep=10, n_fparamstep=10,
             track_variational=False, reduced_rank=False, crop_margin=1.25,
             linesearch="armijo", armijo_trials=6, estep_solver="chol",
             mstep_logdet="chol", mstep_inverse="schulz", schulz_steps=12,
             schulz_fallback="poison", mstep_gram="exact")
CENTRES = ((-0.3, 0.25), (0.3, -0.3), (0.05, 0.0))
TOL = 1e-8


def recording(seed=7, width=0.12):
    """Three cells with Gaussian RFs at ``CENTRES`` of one stimulus set."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((NT, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    rs = []
    for cx, cy in CENTRES:
        w = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * width ** 2))
        w = w.ravel() / np.linalg.norm(w)
        rs.append(rng.poisson(np.exp(0.5 * x @ w)))
    return torch.as_tensor(x), torch.as_tensor(np.asarray(rs, float))


def start_thetas(beta):
    """One start theta a cell, its centre at the cell's RF."""
    return {"sigma_0": torch.ones(NCELLS),
            "eps_0x": torch.tensor([c[0] for c in CENTRES]),
            "eps_0y": torch.tensor([c[1] for c in CENTRES]),
            "-2log2beta": torch.full((NCELLS,), -2 * math.log(2 * beta)),
            "-log2rho2": torch.full((NCELLS,), -math.log(2 * 0.2 ** 2)),
            "Amp": torch.ones(NCELLS)}


FP0 = {"logA": math.log(0.01), "lambda0": 1.0}
# "windowed": narrow RFs, a 4-px bucket, so the population's window is 8
# px of 12 (per-cell corners), and a 16-trial ladder, which accepts steps
# from this start; "failing_lane": the whole frame, 6 trials, cell 1's
# responses not finite from its 4th image on (its first iteration rolls
# back and the lane freezes)
CASES = {"windowed": (0.05, dict(crop_bucket=4, armijo_trials=16), None),
         "failing_lane": (0.3, {}, 1)}


def _run(case):
    beta, knobs, bad = CASES[case]
    x, rs = recording()
    if bad is not None:
        rs = rs.clone()
        rs[bad, 3] = float("nan")
    thetas = {k: v.double() for k, v in start_thetas(beta).items()}
    cfg = FitConfig(ntilde=NTILDE, n_px_side=N, **dict(KNOBS, **knobs))
    xtilde = x[torch.randperm(NT, generator=torch.Generator()
                              .manual_seed(3))[:NTILDE]]
    carry, _ = tpop.fit_population(x, rs, cfg, xtilde=xtilde, thetas=thetas,
                                   f_params=FP0, device="cpu")
    starts = [{k: float(v[c]) for k, v in thetas.items()}
              for c in range(NCELLS)]
    window = ref_pop.population_window(starts, N, cfg.crop_margin,
                                       cfg.crop_bucket)
    fit = dict(KNOBS, **knobs)
    lanes = [ref_pop.fit_lane(x, rs[c], xtilde, starts[c], FP0,
                              None if window is None else window[c], fit, N)
             for c in range(NCELLS)]
    return carry, lanes, window, starts


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted(request):
    return request.param, _run(request.param)


def _close(got, want, tol=TOL):
    """Within ``tol`` relative (absolute below 1), NaN where NaN (a failed
    lane's init loss)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want,
                                                      dtype=torch.float64)
    return torch.allclose(got, want, rtol=tol, atol=tol, equal_nan=True)


def test_population_matches_the_reference_lane_by_lane(fitted):
    case, (carry, lanes, window, starts) = fitted
    for c, want in enumerate(lanes):
        assert int(carry.failed_at[c]) == want["failed_at"], c
        assert _close(carry.track.logmarginal[c], want["track"]), c
        for k, v in want["theta"].items():
            assert _close(carry.theta[k][c], v), (c, k)
        for k, v in want["f_params"].items():
            assert _close(carry.f_params[k][c], v), (c, k)
        B = carry.kern.es.B[c]
        assert _close(B @ carry.m_b[c], want["B"] @ want["m_b"]), c
        assert _close(B @ carry.V_b[c] @ B.T,
                      want["B"] @ want["V_b"] @ want["B"].T), c
    if case == "windowed":
        assert window is not None and window[0][2] == 8
        assert len({w[:2] for w in window}) == NCELLS
        # the searches moved theta and logA
        assert any(want["theta"] != starts[c] for c, want in enumerate(lanes))
        assert any(want["f_params"]["logA"] != FP0["logA"] for want in lanes)
    else:
        assert window is None
        assert [w["failed_at"] for w in lanes] == [-1, 1, -1]
        assert lanes[1]["theta"] == starts[1]


def test_population_window_is_the_programs():
    """The reference's rule against ``population_window`` at 108 px on start
    thetas of every width, near the frame's edges too."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        n = 5
        thetas = {"eps_0x": torch.tensor(rng.uniform(-1, 1, n)),
                  "eps_0y": torch.tensor(rng.uniform(-1, 1, n)),
                  "-2log2beta": torch.tensor(rng.uniform(2.0, 8.0, n)),
                  "sigma_0": torch.ones(n), "-log2rho2": torch.ones(n),
                  "Amp": torch.ones(n)}
        cfg = FitConfig(n_px_side=108, crop_margin=1.25)
        want = tpop.population_window(thetas, cfg)
        got = ref_pop.population_window(
            [{k: float(v[c]) for k, v in thetas.items()} for c in range(n)],
            108, 1.25)
        if want is None:
            assert got is None
        else:
            assert got == [(int(i), int(j), want[2])
                           for i, j in zip(want[0], want[1])]


def _terms(lanes, d):
    g = torch.Generator().manual_seed(11)
    A = torch.randn(lanes, d, d, generator=g, dtype=torch.float64)
    H = A @ A.mT + 0.5 * torch.eye(d, dtype=torch.float64)
    return H, torch.randn(lanes, d, generator=g, dtype=torch.float64)


def _objective(x, H, c):
    """Per lane: a rotated quadratic plus a quartic, +inf past x_0 = 2.5;
    x (..., d) with H (..., d, d) and c (..., d) broadcast to it."""
    z = x - c
    v = 0.5 * torch.einsum("...d,...de,...e->...", z, H, z) \
        + 0.1 * torch.sum(x ** 4, -1)
    return torch.where(x[..., 0] > 2.5, torch.full_like(v, math.inf), v)


@pytest.mark.parametrize("trials", [6, 16])
def test_reference_armijo_search_is_the_programs_lane_by_lane(trials):
    x0 = torch.tensor([[0.0, 0.0, 0.0, 0.0], [2.4, -1.0, 0.5, 3.0],
                       [1.0, 2.0, -2.0, 0.1]], dtype=torch.float64)
    H, c = _terms(*x0.shape)
    got_x, got_f = lbfgs_minimize_armijo(
        lambda x: _objective(x, H[:, None], c[:, None]), x0, 10,
        ls_trials=trials)
    for lane in range(x0.shape[0]):
        value, vg = ref_pop._flat_vg(
            lambda p, lane=lane: _objective(p, H[lane], c[lane]))
        want_x, want_f = ref_pop.armijo_minimize(value, vg, x0[lane], 10,
                                                 trials)
        assert torch.allclose(got_x[lane], want_x, rtol=1e-12, atol=1e-12)
        assert float(got_f[lane]) == pytest.approx(float(want_f), rel=1e-12)
        assert float(want_f) < float(value(x0[lane]))
