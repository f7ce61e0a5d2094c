"""The benchmark's population cell on the CPU: the ``recording`` traffic
generator, the cell's files found by name, and a run of ``pop108.recording``
at a tiny size past the look for a card (``portbench.run.measure``): the
sound run comes out correct with no failed lane, and a fault planted under
the timed path (the checked lane's first EM iteration hands back the state
it was given) makes the ``estep`` check fail.  Imports torch, numpy, the
port and the benchmark only.
"""

from __future__ import annotations

import contextlib
import math

import pytest
import torch

from gaussian_processes_tpu_torch.models import fit as fit_module
from gaussian_processes_tpu_torch.models.fit import _where_cells
from portbench import run
from portbench.drivers import population_requests as drv
from portbench.traffic import recording

torch.set_num_threads(1)

CELL = "pop108.recording"
SEED = 2 ** 41 + 11
TINY = dict(n_px_side=16, n_train=120, n_calibration=200, n_test=10,
            n_repeats=6, n_cells=3)


def tiny_spec(trials: int = 6) -> run.Spec:
    """The cell at 16 px, 120 images, 48 inducing rows and 3 cells, 4
    M-step steps of ``trials`` rungs (at 6, as at full size, every rung
    of the first ladder leaves the box; at 16 the smallest rungs are
    inside it and steps are taken)."""
    spec = run.Spec(CELL)
    spec.traffic["params"].update(TINY)
    spec.config.update(n_px_side=16, nbootstrap=20, nt=120, ntilde=48,
                       n_cells=3)
    spec.config["fit"].update(n_mstep=4, armijo_trials=trials)
    return spec


# ---- the generator -----------------------------------------------------

def test_recording_shows_every_cell_one_stimulus_set():
    p = dict(TINY)
    a = recording.make_recording(p, SEED, 0, "cpu")
    assert a["x"].shape == (120, 256) and a["x"].dtype == torch.float32
    assert a["rs"].shape == (3, 120) and a["r_test"].shape == (3, 6, 10)
    assert a["x_test"].shape == (10, 256)
    assert abs(float(a["x"].std()) - 1.0) < 1e-3
    # each cell its own RF: its own place and responses
    assert len(set(a["centres"])) == 3 and len(set(a["angles"])) == 3
    assert not torch.equal(a["rs"][0], a["rs"][1])
    assert float(a["rs"].mean()) > 0.5
    # each cell's responses follow its own filter on the shared images (at
    # 16 px the RFs overlap, so the others' drives correlate too)
    w = torch.stack([recording.filters(dict(recording.DEFAULTS, **p), cx, cy,
                                       ang, "cpu")[0]
                     for (cx, cy), ang in zip(a["centres"], a["angles"])])
    drive = (a["x"].double() @ w.T).T
    corr = torch.corrcoef(torch.cat([drive, a["rs"].double()]))[3:, :3]
    assert float(torch.diagonal(corr).min()) > 0.4


def test_recording_repeats_from_its_seed_and_index():
    a = recording.make_recording(TINY, SEED, 0, "cpu")
    b = recording.make_recording(TINY, SEED, 0, "cpu")
    c = recording.make_recording(TINY, SEED + 1, 0, "cpu")
    d = recording.make_recording(TINY, SEED, 1, "cpu")
    for k in ("x", "rs", "x_test", "r_test"):
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k]) and not torch.equal(a[k], d[k])
    # one fixed recording: every request of every seed, the warm-up apart
    p = dict(TINY, panel_size=1, panel_seed=1)
    one = recording.make_recording(p, SEED, 0, "cpu")
    for seed, index in ((SEED, 3), (SEED + 5, 0)):
        other = recording.make_recording(p, seed, index, "cpu")
        assert all(torch.equal(one[k], other[k]) for k in ("x", "rs"))
    warm = recording.make_recording(p, SEED, -1, "cpu")
    assert not torch.equal(one["x"], warm["x"])


# ---- the cell's files --------------------------------------------------

def test_the_cell_finds_its_files():
    spec = run.Spec(CELL)
    assert spec.config["name"] == "pop108"
    assert spec.traffic["generator"] == "recording"
    assert run.driver_for(spec.config) is drv
    assert [m["name"] for m in spec.end_to_end] == ["fit_s", "setup_s"]
    assert [m["name"] for m in spec.per_layer] == [
        "pop.mstep_s", "pop.kernel_state_s", "pop.estep_s",
        "pop.gram_roofline", "pop.gram_items_per_chunk"]
    assert run.read_per_layer(spec, {"trace": None}) == {}
    # the configuration's fit knobs are what fit_population runs
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.parallel.population import \
        _vmap_safe_config
    cfg = FitConfig(ntilde=spec.config["ntilde"], **spec.config["fit"])
    assert _vmap_safe_config(cfg) == cfg
    assert spec.traffic["params"]["n_cells"] == spec.config["n_cells"]


def test_the_chunk_reader():
    read = run.load_module(run.BENCH_DIR / "metrics"
                           / "pop.gram_items_per_chunk.py").read
    ctx = {"requests": 2, "spans": {"grams.chunks": 40.0,
                                    "grams.items": 520.0}}
    assert read(ctx) == 13.0
    assert read({"requests": 2, "spans": {}}) is None
    assert read({}) is None


# ---- a run at a tiny size ----------------------------------------------

@pytest.fixture
def measure(monkeypatch):
    """``run.measure`` in this process, which the suite's conftest has
    loaded JAX into (the benchmark's own processes refuse to run with it:
    ``portbench/tests``)."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    return run.measure


def test_sound_run_is_correct(measure):
    result = measure(tiny_spec(), SEED, 1.0, False, "cpu")
    assert result["attempted"] >= 3 and result["attempted"] % 3 == 0
    assert result["failed"] == 0
    assert result["correct"], result["checks"]
    assert math.isfinite(result["metrics"]["fit_s"]["value"])


@contextlib.contextmanager
def lane_unchanged(lane: int):
    """The first EM iteration of lane ``lane`` hands back the state it was
    given (its E-step and M-step run, their results dropped)."""
    real = fit_module._fit_iteration_cells

    def iteration(i, c, *args, **kwargs):
        out = real(i, c, *args, **kwargs)
        if i != drv.CHECKED_ITERATION:
            return out
        mask = torch.zeros(out.m_b.shape[0], dtype=torch.bool)
        mask[lane] = True
        return out._replace(
            theta=_where_cells(mask, c.theta, out.theta),
            f_params=_where_cells(mask, c.f_params, out.f_params),
            m_b=_where_cells(mask, c.m_b, out.m_b),
            V_b=_where_cells(mask, c.V_b, out.V_b))
    fit_module._fit_iteration_cells = iteration
    try:
        yield
    finally:
        fit_module._fit_iteration_cells = real


def test_an_unchanged_lane_fails_the_estep_check(measure):
    spec = tiny_spec()
    lane = drv.checked_lane(drv.Session(spec.config, spec.traffic["params"],
                                        SEED, torch.device("cpu"), None,
                                        recording), 0)
    with lane_unchanged(lane):
        result = measure(spec, SEED, 1e-3, False, "cpu")
    assert not result["correct"]
    c = result["checks"]["estep"]
    assert c["value"] > c["limit"], result["checks"]
    assert c["value"] == pytest.approx(1.0, abs=1e-3)


@contextlib.contextmanager
def ladder_inf():
    """Every rung of the population M-step's ladders reads +inf (the
    value-and-gradient calls as they are)."""
    real = fit_module._mstep_objective_cells

    def objective(*args, **kwargs):
        v = real(*args, **kwargs)
        return v if torch.is_grad_enabled() else torch.full_like(v, math.inf)
    fit_module._mstep_objective_cells = objective
    try:
        yield
    finally:
        fit_module._mstep_objective_cells = real


@contextlib.contextmanager
def last_step_skipped():
    """The batched Armijo search leaves out its last step's calls."""
    real = fit_module.lbfgs_minimize_armijo

    def search(fun, x0, num_steps, *args, **kwargs):
        return real(fun, x0, num_steps - 1, *args, **kwargs)
    fit_module.lbfgs_minimize_armijo = search
    try:
        yield
    finally:
        fit_module.lbfgs_minimize_armijo = real


@pytest.mark.parametrize("trials, fault, caught_by", [
    (16, None, None), (16, ladder_inf, "ladder"),
    (16, last_step_skipped, "ladder"), (6, None, None),
    (6, ladder_inf, "ladder0")])
def test_the_searchs_calls_are_checked(measure, trials, fault, caught_by):
    """The M-step's search is held call by call.  At 16 rungs the smallest
    rungs are inside theta's box and steps are taken; at 6, as at full
    size, every rung the search tries leaves the box and reads +inf on
    both sides, so the pulled ladder (``pulled_ladder``, inside the box)
    is what holds the ladder's computation.  The sound program's search
    numbers read under their limits; a ladder that reads +inf at every
    rung, or a search that skips its last step, fails ``caught_by``."""
    with fault() if fault else contextlib.nullcontext():
        result = measure(tiny_spec(trials), SEED, 1e-3, False, "cpu")
    checks = result["checks"]
    if caught_by is None:
        for name in drv.SEARCH_NUMBERS:
            assert checks[name]["value"] <= checks[name]["limit"], checks
    else:
        assert not result["correct"]
        assert checks[caught_by]["value"] > checks[caught_by]["limit"], checks
