"""CPU tests of the benchmark's harness: discovery by name, the traffic's
generator, the counts of work, the trace's reduction, the imports, and
the plain reference against the program's plain route at a tiny size.

    python -m pytest -q portbench/tests
"""

from __future__ import annotations

import ast
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from portbench import counts, run, trace
from portbench.reference import gp as ref
from portbench.traffic import retina

BENCH = Path(run.__file__).resolve().parent
ROOT = BENCH.parent
TINY = dict(n_px_side=16, n_train=120, n_calibration=200, n_test=10,
            n_repeats=6)


# ---- discovery by name -------------------------------------------------

def _copy_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    (root / BENCH.name).mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, root / BENCH.name / sub)
    return root


def test_every_cell_finds_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = run.Spec(cell["name"])
        assert spec.config["name"] == cell["config"]
        assert spec.traffic["generator"] == "retina"
        assert spec.end_to_end and spec.per_layer
        assert run.driver_for(spec.config).check
        for m in spec.per_layer:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(spec.config["limits"])


@pytest.mark.parametrize("what", ["config", "cell", "metric"])
def test_a_new_entry_needs_only_new_files(tmp_path, what):
    """A configuration, a cell or a per-layer metric added as a file and a
    BENCHMARK.json entry is found with no file of the harness edited."""
    root = _copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg_name, cell_name = "rf108", "rf108.extra"
    if what == "config":
        cfg_name = "rf108b"
        cfg = json.loads((BENCH / "configs" / "rf108.json").read_text())
        cfg["name"] = cfg_name
        (root / BENCH.name / "configs" / "rf108b.json").write_text(
            json.dumps(cfg))
        bench["configs"].append(dict(bench["configs"][0], name=cfg_name,
                                     file="portbench/configs/rf108b.json"))
        cell_name = "rf108b.natural"
    traffic = json.loads((BENCH / "traffic" / "rf108.natural.json")
                         .read_text())
    traffic["params"]["rf_scale"] = 0.5
    (root / BENCH.name / "traffic" / f"{cell_name}.json").write_text(
        json.dumps(traffic))
    bench["workloads"].append({"name": cell_name, "config": cfg_name,
                               "traffic": "extra", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rf108.natural" in m.get("workloads", []):
            m["workloads"].append(cell_name)
    if what == "metric":
        (root / BENCH.name / "metrics" / "extra.count.py").write_text(
            "UNIT = 'n'\n\ndef read(ctx):\n    return ctx.get('requests')\n")
        bench["per_layer"].append({
            "name": "extra.count", "unit": "n", "better": "higher",
            "source": "program_counter", "layer": "whole fit",
            "moves": "fit_s", "workloads": [cell_name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = run.Spec(cell_name, root)
    assert spec.config["name"] == cfg_name
    assert spec.traffic["params"]["rf_scale"] == 0.5
    ctx = {"requests": 3, "wall_s": 0.0, "spans": {}, "evals": {}}
    got = run.read_per_layer(spec, ctx, root / BENCH.name / "metrics")
    if what == "metric":
        assert got["extra.count"] == {"value": 3.0, "unit": "n"}
    else:
        assert "extra.count" not in got


def test_a_reader_that_finds_nothing_returns_nothing():
    spec = run.Spec("rf108.natural")
    assert run.read_per_layer(spec, {"trace": None}) == {}
    got = run.read_per_layer(spec, {"trace": None, "requests": 2,
                                    "wall_s": 20.0, "spans": {},
                                    "evals": {}})
    assert "device.idle_share.fit" not in got


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    rc = run.main(["--workload", "rf108.natural", "--seed", str(2 ** 40 + 3),
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_checks_are_judged_against_their_limits():
    checks = run.judged({"a": 1e-6, "b": 2.0}, {"a": 1e-5, "b": 1.0})
    assert list(checks) == ["a", "b"]
    assert not run.is_correct(checks)
    assert run.is_correct(run.judged({"a": 1e-6}, {"a": 1e-5}))
    assert not run.is_correct(run.judged({"a": math.nan}, {"a": 1e-5}))


# ---- imports -----------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_module_of_the_benchmark_imports_jax():
    """Top-level names compared whole: the port's name begins with the
    JAX package's."""
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name, level in _imports(f):
            if level == 0:
                assert name not in run.FORBIDDEN, (f, name)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level == 0, (f, "relative import")
                if node.module.split(".")[0] == "portbench":
                    assert node.module == "portbench.reference", f
                    continue
        for name, level in _imports(f):
            assert name in ("__future__", "contextlib", "math", "typing",
                            "torch", "portbench"), (f, name)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "gaussian_processes_tpu_torch_x",
                        object())
    assert "gaussian_processes_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


# ---- the generator -----------------------------------------------------

def test_generator_repeats_from_its_seed_and_changes_with_it():
    seed = 2 ** 40 + 17
    a = retina.make_cell(TINY, seed, 0, "cpu")
    b = retina.make_cell(TINY, seed, 0, "cpu")
    c = retina.make_cell(TINY, seed + 1, 0, "cpu")
    d = retina.make_cell(TINY, seed, 1, "cpu")
    for k in ("x", "r", "x_test", "r_test"):
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
        assert not torch.equal(a[k], d[k])
    assert a["x"].shape == (120, 256) and a["r_test"].shape == (6, 10)
    assert a["x"].dtype == torch.float32
    assert abs(float(a["x"].std()) - 1.0) < 1e-3
    assert float(a["r"].mean()) > 0.5


def test_a_panel_gives_every_seed_the_same_cells_in_another_order():
    p = dict(TINY, panel_size=4, panel_seed=9)
    assert retina.pass_size(p) == 4 and retina.pass_size(TINY) == 1

    def centres(seed):
        return [retina.make_cell(p, seed, i, "cpu")["centre"]
                for i in range(4)]
    a, b = centres(2 ** 40 + 1), centres(2 ** 40 + 2)
    assert sorted(a) == sorted(b) and a != b
    assert centres(2 ** 40 + 1) == a
    again = retina.make_cell(p, 2 ** 40 + 1, 4, "cpu")
    assert again["centre"] == a[0]
    assert torch.equal(again["x"], retina.make_cell(p, 2 ** 40 + 1, 0,
                                                    "cpu")["x"])
    warm = retina.make_cell(p, 2 ** 40 + 1, -1, "cpu")["centre"]
    assert warm not in a


def test_generator_scales_the_envelope():
    p = dict(retina.DEFAULTS, **TINY)
    w1, _ = retina.filters(dict(p, rf_scale=1.0), 0.0, 0.0, 0.3, "cpu")
    w2, _ = retina.filters(dict(p, rf_scale=2.5), 0.0, 0.0, 0.3, "cpu")

    def spread(w):
        lin = torch.linspace(-1, 1, 16, dtype=torch.float64)
        yy, xx = torch.meshgrid(lin, lin, indexing="ij")
        return float(torch.sum(w * w * (xx * xx + yy * yy).reshape(-1)))
    assert spread(w2) > 2.0 * spread(w1)


# ---- counts ------------------------------------------------------------

@pytest.mark.parametrize("shape,flops,nbytes", [
    ((1, 2100, 2100, 6400), 2 * 2100 * 2100 * 6400,
     4 * (2100 * 6400 * 2 + 2100 * 2 + 2100 * 2100)),
    ((3, 30, 300, 11664), 3 * 2 * 30 * 300 * 11664,
     3 * 4 * (30 * 11664 + 300 * 11664 + 30 + 300 + 30 * 300)),
])
def test_gram_counts_by_hand(shape, flops, nbytes):
    assert counts.gram_flops(*shape) == flops
    assert counts.gram_bytes(*shape) == nbytes
    bound = max(flops / 165e12, nbytes / 3.35e12)
    assert counts.gram_forward_bound({shape: 2}) == pytest.approx(2 * bound)


def test_gram_backward_counts_by_hand():
    # the two products of a 3160 x 2100 Gram at k 4096, and its epilogue
    prods = {"1x2100x4096 k3160": 1, "1x3160x4096 k2100": 1}
    epi = {"1x3160x2100": 1}
    f = 2 * 2100 * 4096 * 3160
    want = 2 * max(f / 165e12, 4 * (2100 * 3160 + 4096 * 3160
                                    + 2100 * 4096) / 3.35e12)
    want += 12 * 3160 * 2100 / 3.35e12
    assert counts.gram_backward_bound(prods, epi) == pytest.approx(want)
    assert counts.gram_products_flops({(1, 3160, 2100, 4096): 1}, prods) \
        == pytest.approx(3 * f)


# ---- the trace's reduction ---------------------------------------------

def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_trace_reduction():
    events = [
        _ev("user_annotation", trace.WINDOW_SPAN, 0, 100),
        _ev("user_annotation", "fit.mstep", 10, 40),
        _ev("user_annotation", "fit.estep", 60, 30),
        _ev("cuda_runtime", "cudaGraphLaunch", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=2),
        _ev("kernel", "acos_gram_tf32x3_kernel(CUtensorMap)", 20, 10, corr=1),
        _ev("kernel", "elementwise", 25, 10, corr=1),
        _ev("kernel", "fparam_lbfgs_kernel<float, true, false>", 70, 10,
            corr=2),
    ]
    tr = trace.reduce_chrome_trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_seconds() == pytest.approx(25e-6)
    assert tr.device_seconds(lambda op: tr.inside("fit.mstep", op[3])) \
        == pytest.approx(20e-6)
    from portbench.kernels import is_fparam, is_gram, is_gram_backward
    assert tr.device_seconds(lambda op: is_gram(op[0])) == pytest.approx(10e-6)
    assert is_fparam("fparam_lbfgs_kernel<float, true, false>")
    assert not is_gram_backward("tf32_split_kernel")
    assert is_gram_backward("tf32_split_t_kernel")
    b = tr.breakdown()
    assert b["device_ops"][0][0] in ("elementwise", "fparam_lbfgs_kernel"
                                     "<float, true, false>",
                                     "acos_gram_tf32x3_kernel(CUtensorMap)")
    idle = dict(b["idle_gaps"])
    assert idle["fit.mstep"] == pytest.approx(10e-6 + 15e-6)
    assert idle["fit.estep"] == pytest.approx(10e-6 + 10e-6)
    assert idle["host"] == pytest.approx(10e-6 + 10e-6 + 10e-6)
    assert sum(idle.values()) == pytest.approx(75e-6)


# ---- the reference against the program's plain route --------------------

def _theta(dtype):
    return {"sigma_0": 0.8, "eps_0x": 0.1, "eps_0y": -0.2,
            "-2log2beta": -2 * math.log(2 * 0.3),
            "-log2rho2": -math.log(2 * 0.15 ** 2), "Amp": 1.3}


def test_reference_grams_match_the_programs_plain_route():
    from gaussian_processes_tpu_torch.ops.kernels import gram_matrices
    cell = retina.make_cell(TINY, 5, 0, "cpu")
    x = cell["x"].double()
    xt = x[:40]
    th = _theta(torch.float64)
    want = gram_matrices({k: torch.tensor(v, dtype=torch.float64)
                          for k, v in th.items()}, x, xt, 16, shared=False,
                         backend="torch")
    got = ref.grams(th, x, xt, 16, shared=False)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-12, atol=1e-12)


def _tiny_fit(shared: bool):
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models.fit import fit
    cell = retina.make_cell(TINY, 7, 0, "cpu")
    x, r = cell["x"].double(), cell["r"].double()
    xt = x if shared else x[:48]
    cfg = FitConfig(ntilde=xt.shape[0], maxiter=4, n_estep=10, n_mstep=4,
                    n_fparamstep=10, n_px_side=16, track_variational=False)
    res = fit(x, r, cfg, xtilde=xt)
    return cell, x, r, xt, res


@pytest.mark.parametrize("shared", [False, True])
def test_reference_loss_matches_the_programs_fit(shared):
    cell, x, r, xt, res = _tiny_fit(shared)
    st = ref.State({k: float(v) for k, v in res.theta.items()},
                   {k: float(v) for k, v in res.f_params.items()}, res.m_b,
                   res.V_b, res.B, res.keep, torch.float64, "cpu")
    grams = ref.grams(st.theta, x, xt, 16, shared)
    assert torch.allclose(grams[0], res.K_tilde, rtol=1e-10, atol=1e-12)
    loss, terms = ref.log_marginal(st, *grams, r, shared)
    assert float(loss) == pytest.approx(float(res.track.logmarginal[-1]),
                                        rel=1e-9)
    best = ref.best_logA(st.f["logA"], r, terms["lam_m"], terms["lam_var"])
    assert abs(float(best) - float(res.f_params["logA"])) < 1e-4


@pytest.mark.parametrize("n_px,tol", [(16, 1e-9), (108, 1e-7)])
def test_reference_em_iteration_matches_the_programs_in_float64(n_px, tol):
    """The reference's first EM iteration, from the state the program's
    started from, against the program's at the configuration's knobs in
    float64 on the CPU: the same steps, up to the program's Schulz
    inverses, log-determinant series and 10-step f-param searches.  At 108
    px the iteration runs on a crop window."""
    from portbench.drivers import fit_requests as drv
    from portbench.tests.test_portbench_faults import SEED, tiny_spec
    spec = tiny_spec("rf108.natural")
    spec.config["n_px_side"] = spec.traffic["params"]["n_px_side"] = n_px
    s = drv.setup(spec.config, spec.traffic, SEED, "cpu")
    cell = drv.inputs(s, 0)
    cell64 = dict(cell, x=cell["x"].double(), r=cell["r"].double())
    with drv.em_probe() as probe:
        res, rates, r2 = drv.serve(s, cell64)
    k = drv.kept(res, rates, r2, probe)
    assert k["step"] is not None and not k["failed"]
    window = ref.crop_window(k["step"]["in"]["theta"], n_px,
                             spec.config["fit"]["crop_margin"])
    assert (window is None) == (n_px == 16)
    want = drv.reference_step(s, cell64, k["step"], torch.float64)
    want.update(logA0=float(k["step"]["in"]["f_params"]["logA"]),
                theta0={n: float(v)
                        for n, v in k["step"]["in"]["theta"].items()})
    got = drv.step_numbers(drv.program_step(k["step"]), want,
                           float(cell["r"].sum()), want["K_tilde"])
    assert got["estep"] < 1e-7
    assert got["mstep"] < tol and got["mstep_theta"] < tol
    assert got["grad0"] < 1e-10 and got["value0"] < 1e-12
    assert got["basis"] < 1e-10
    # the states moved: the E-step from m_b = 0, the M-step from theta0
    assert float(torch.max(torch.abs(want["m"]))) > 0.1
    assert max(abs(want["theta"][n] - want["theta0"][n])
               for n in want["theta0"]) > 1e-3


def test_reference_prediction_and_r2_match_the_program():
    from gaussian_processes_tpu_torch.models.inference import evaluate
    cell, x, r, xt, res = _tiny_fit(False)
    _, rates, r2, _ = evaluate(res, cell["x_test"].double(),
                               cell["r_test"].double(), nbootstrap=50, seed=0)
    st = ref.State({k: float(v) for k, v in res.theta.items()},
                   {k: float(v) for k, v in res.f_params.items()}, res.m_b,
                   res.V_b, res.B, res.keep, torch.float64, "cpu")
    k, kinv = ref.basis_terms(st, ref.grams(st.theta, x, xt, 16, False)[0])
    Ks, Kvs = ref.cross_gram(st.theta, cell["x_test"].double(), xt, 16)
    want, _, _ = ref.predict(st, Ks, Kvs, k, kinv)
    assert torch.allclose(rates, want, rtol=1e-9)
    perms = ref.bootstrap_perms(6, 50, 0)
    assert float(ref.explained_variance(cell["r_test"].double(), want,
                                        perms)) == pytest.approx(float(r2),
                                                                 abs=1e-12)


def test_bootstrap_perms_are_the_programs_draws():
    from gaussian_processes_tpu_torch.models.inference import \
        explained_variance
    rt = torch.rand(6, 10, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    f = torch.rand(10, dtype=torch.float64)
    got, _ = explained_variance(rt, f, nbootstrap=30, seed=4)
    want = ref.explained_variance(rt, f, ref.bootstrap_perms(6, 30, 4))
    assert float(got) == pytest.approx(float(want), abs=1e-14)


def test_reference_crop_window_is_the_programs():
    from gaussian_processes_tpu_torch.ops.kernels import \
        crop_window_from_scalars
    for lb, ex, ey in [(5.0, 0.1, -0.2), (3.0, -0.9, 0.95), (7.5, 0.3, 0.0),
                       (1.0, 0.0, 0.0), (6.2, 0.71, -0.66)]:
        want = crop_window_from_scalars(lb, ex, ey, 108, 1e-3, 1.25, 16)
        got = ref.crop_window({"-2log2beta": lb, "eps_0x": ex,
                               "eps_0y": ey}, 108, 1.25)
        assert got == (None if want[2] == 108 else want)
