"""The port's mesh (parallel/mesh.py, parallel/collectives.py,
parallel/sharded_linalg.py and the mesh routes of fit, fit_population and
the large path) against the JAX package's, float64, on the same numpy
inputs.

The port side runs in one gloo world of 4 CPU processes started by the
port's launcher (``parallel.mesh.run_world``) for the whole module; its
ranks import this module, so jax is imported only inside the tests, never
at its top.  The JAX side runs in the pytest process on sub-meshes of 4 of
the 8 virtual CPU devices that tests/conftest.py makes.

Tolerances: the Cholesky factor atol 1e-10 and its solve 1e-9 (JAX's
test_distributed_cholesky), the Grams 1e-12 and the large path 1e-10 /
1e-9 (test_sharding.py's); fit(mesh=) against the port's unsharded fit
rtol 1e-10 and against JAX's fit(mesh=) 1e-6 (the port-vs-JAX fit
tolerance of test_torch_fit.py; JAX's crop window lags one iteration);
fit_population(mesh=) against the port's unsharded population 1e-8 and
against JAX's unsharded population 1e-8 (JAX's sharded population program
takes minutes to compile on the CPU; JAX's own test_population_sharded_over
_mesh ties it to the unsharded one at 1e-8); gradients of the two
differentiated objectives against the unsharded ones 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.parallel import collectives as C
from gaussian_processes_tpu_torch.parallel import large as tlarge
from gaussian_processes_tpu_torch.parallel import mesh as M
from gaussian_processes_tpu_torch.parallel import population as tpop
from gaussian_processes_tpu_torch.parallel import sharded_linalg as SL
from gaussian_processes_tpu_torch.params import theta_bounds

torch.set_num_threads(1)

WORLD = 4
# test_sharding.py's shapes and start values (copied: that module imports
# jax at its top, and the ranks import this one)
N = 12
THETA0 = {"sigma_0": 1.0, "eps_0x": 0.0, "eps_0y": 0.0,
          "-2log2beta": -2 * np.log(2 * 0.3),
          "-log2rho2": -np.log(2 * 0.15 ** 2), "Amp": 1.0}
FP0 = {"logA": np.log(0.01), "lambda0": 1.0}
STEPS = dict(maxiter=3, n_estep=3, n_mstep=2, n_fparamstep=3, n_px_side=N,
             track_variational=True, max_linesearch_steps=5)
CHOL_N = (256, 213)
FIT_NT = (48, 50)
JITTER = 0.5


def make_population(ncells=4, nt=32, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((nt, N * N))
    lin = np.linspace(-1, 1, N)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    R = np.zeros((ncells, nt))
    for c in range(ncells):
        cx, cy = rng.uniform(-0.4, 0.4, 2)
        w = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 0.3 ** 2)).ravel()
        w /= np.linalg.norm(w)
        R[c] = rng.poisson(np.exp(0.8 * X @ w))
    return X, R


def spd(n, seed=0):
    W = np.random.default_rng(seed).standard_normal((n, n))
    return W @ W.T + n * np.eye(n)


def inputs():
    """Every case's numpy inputs, made once from seeds."""
    rng = np.random.default_rng(2)
    large = dict(xt=rng.standard_normal((96, N * N)),
                 xs=rng.standard_normal((8, N * N)),
                 y=rng.standard_normal(96))
    rng = np.random.default_rng(1)
    gram = dict(x=rng.standard_normal((64, N * N)),
                xt=rng.standard_normal((16, N * N)))
    fits = {}
    for nt in FIT_NT:
        X, R = make_population(ncells=1, nt=nt)
        fits[nt] = dict(x=X, r=R[0], xt=X[:16].copy())
    X, R = make_population(ncells=4, nt=32)
    return dict(chol={n: (spd(n), np.random.default_rng(n).standard_normal(n))
                      for n in CHOL_N},
                gram=gram, large=large, fits=fits, pop=dict(x=X, r=R))


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


FIT_CFG = TCfg(ntilde=16, **STEPS)
POP_CFG = TCfg(ntilde=32, **dict(STEPS, track_variational=False))


def port_fit(case, mesh=None):
    return tf.fit(t64(case["x"]), t64(case["r"]), FIT_CFG,
                  xtilde=t64(case["xt"]), theta=THETA0, f_params=FP0,
                  mesh=mesh)


def port_population(case, mesh=None):
    x = t64(case["x"])
    return tpop.fit_population(x, t64(case["r"]), POP_CFG, xtilde=x,
                               thetas=THETA0, f_params=FP0, mesh=mesh)[0]


def fit_summary(res):
    return dict(track={k: getattr(res.track, k).numpy() for k in
                       ("logmarginal", "loglikelihood", "KL", "m_b")},
                theta={k: float(v) for k, v in res.theta.items()},
                f_params={k: float(v) for k, v in res.f_params.items()},
                m_b=res.m_b.numpy(), B=res.B.numpy(), V_b=res.V_b.numpy(),
                K=res.K.numpy(), Kvec=res.Kvec.numpy(), K_b=res.K_b.numpy(),
                a=res.a.numpy(), failed=res.failed)


def carry_summary(c):
    return dict(track={k: getattr(c.track, k).numpy() for k in
                       ("logmarginal", "loglikelihood", "KL", "n_eigen")},
                m_b=c.m_b.numpy(), B=c.kern.es.B.numpy(), K=c.kern.K.numpy(),
                Kvec=c.kern.Kvec.numpy(), a=c.kern.a.numpy(),
                lambda_m=c.lambda_m.numpy(),
                theta={k: v.numpy() for k, v in c.theta.items()},
                f_params={k: v.numpy() for k, v in c.f_params.items()},
                failed=c.failed.numpy())


# ---------------------------------------------------------------------------
# The gradient trap: the two differentiated objectives at a fit's state
# ---------------------------------------------------------------------------

def objective_state(case, rows=None):
    """The M-step objective at THETA0 and the f-param objective at FP0's
    logA, from the unsharded start state of ``case`` (whole on every rank),
    with this rank's rows under ``rows``."""
    x, r, xt = t64(case["x"]), t64(case["r"]), t64(case["xt"])
    cfg = FIT_CFG
    th = {k: torch.tensor(v, dtype=torch.float64) for k, v in THETA0.items()}
    fp = {k: torch.tensor(v, dtype=torch.float64) for k, v in FP0.items()}
    with torch.no_grad():
        kern = tf._build_kernel_state(th, x, xt, False, cfg)
        m_b = 0.3 * kern.es.B.T @ torch.linspace(-1.0, 1.0, xt.shape[0],
                                                 dtype=torch.float64)
        V_b = torch.diag(kern.es.k_tilde_b_diag)
        lam_m, lam_v = tf.lambda_moments(kern.a, kern.K_b, kern.Kvec, m_b,
                                         V_b)
    if rows is not None:
        x, r = rows.take(x, 0), rows.take(r, 0)
        lam_m, lam_v = rows.take(lam_m, 0), rows.take(lam_v, 0)
    lower, upper = theta_bounds()
    return dict(mstep=lambda t: tf._mstep_objective(
        t, x, xt, r, kern.es, m_b, V_b, fp, False, cfg, lower, upper,
        rows=rows),
        fparam=lambda logA: tf._fparam_objective(logA, r, lam_m, lam_v,
                                                 rows=rows))


def value_and_grads(case, rows=None):
    obj = objective_state(case, rows)
    th = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in THETA0.items()}
    f_m = obj["mstep"](th)
    g_m = torch.autograd.grad(f_m, list(th.values()))
    logA = torch.tensor(FP0["logA"] + 0.3, dtype=torch.float64,
                        requires_grad=True)
    f_f = obj["fparam"](logA)
    (g_f,) = torch.autograd.grad(f_f, [logA])
    return dict(mstep=(f_m.item(), torch.stack(g_m).numpy()),
                fparam=(f_f.item(), g_f.item()))


class _AllReduceBothWays(C.Rows):
    """Rows whose sum differentiates as another all-reduce (the autograd
    all-reduce of torch.distributed.nn)."""

    def sum(self, t):
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t, group=self.group)


class _NoEnter(C.Rows):
    """Rows whose sums hand back only this rank's share's gradient."""

    def enter(self, t):
        return t


# ---------------------------------------------------------------------------
# The world: every case's port side in one gloo world of WORLD processes
# ---------------------------------------------------------------------------

def _world(data):
    out = {"rank": dist.get_rank()}
    # make_mesh's shapes and refusals (JAX test_mesh_shapes on 4 devices)
    out["mesh_shapes"] = [tuple(M.make_mesh(**kw).mesh.shape) for kw in (
        {}, {"n_data_axis": 2}, {"n_cells_axis": 1})]
    refused = []
    for kw in ({"n_cells_axis": 3, "n_data_axis": 3},
               {"device_type": "cuda"}):
        try:
            M.make_mesh(**kw)
        except ValueError as e:
            refused.append(str(e))
    out["mesh_refused"] = refused
    data4 = M.make_mesh(1, WORLD)
    mesh22 = M.make_mesh(2, 2)

    out["chol"] = {}
    for n, (A, b) in data["chol"].items():
        A_rows = t64(A)[SL.block_rows(n, data4)].clone()
        L_rows = SL.distributed_cholesky(A_rows, data4)
        x = SL.distributed_cholesky_solve(L_rows, t64(b), data4)
        out["chol"][n] = (L_rows.numpy(), x.numpy())

    g = data["gram"]
    out["gram"] = [t.numpy() for t in SL.sharded_gram(
        THETA0, t64(g["x"]), t64(g["xt"]), N, data4)]

    lg = data["large"]
    K_rows = tlarge.large_gram(THETA0, t64(lg["xt"]), N, nb=16, mesh=data4)
    L_rows = tlarge.large_cholesky(K_rows.clone(), jitter=JITTER,
                                   mesh=data4)
    mu, alpha = tlarge.large_posterior_mean(
        THETA0, t64(lg["xt"]), t64(lg["y"]), t64(lg["xs"]), N,
        noise_var=JITTER, nb=16, mesh=data4)
    out["large"] = dict(K=K_rows.numpy(), L=L_rows.numpy(), mu=mu.numpy(),
                        alpha=alpha.numpy())

    C.calls.clear()
    out["fits"] = {nt: fit_summary(port_fit(case, data4))
                   for nt, case in data["fits"].items()}
    out["fit_calls"] = dict(C.calls)
    out["pop"] = carry_summary(port_population(data["pop"], mesh22))

    case = data["fits"][FIT_NT[1]]
    rows = C.data_rows(data4, len(case["r"]), t64(case["r"]))
    fields = {f.name: getattr(rows, f.name) for f in dataclasses.fields(rows)}
    out["grads"] = {
        name: value_and_grads(case, cls(**fields))
        for name, cls in (("rows", C.Rows), ("both_ways", _AllReduceBothWays),
                          ("no_enter", _NoEnter))}
    return out


@pytest.fixture(scope="module")
def data():
    return inputs()


@pytest.fixture(scope="module")
def world(data):
    return M.run_world(_world, WORLD, data, timeout=300)


def gathered(parts, key):
    """The rows every rank returned under ``key``, in rank order."""
    return np.concatenate([part[key] for part in parts])


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_mesh_shapes(world):
    """make_mesh's defaults and refusals, as JAX's test_mesh_shapes."""
    from gaussian_processes_tpu.parallel.mesh import make_mesh as j_make_mesh
    import jax
    for w in world:
        assert w["mesh_shapes"] == [(4, 1), (2, 2), (1, 4)]
        assert len(w["mesh_refused"]) == 2
        assert "3x3 != 4" in w["mesh_refused"][0]
    devs = jax.devices()[:4]
    assert j_make_mesh(devices=devs).devices.shape == (4, 1)
    assert j_make_mesh(n_data_axis=2, devices=devs).devices.shape == (2, 2)
    with pytest.raises(ValueError):
        j_make_mesh(n_cells_axis=3, n_data_axis=3, devices=devs)


def jax_theta():
    import jax.numpy as jnp
    return ({k: jnp.float64(v) for k, v in THETA0.items()},
            {k: jnp.float64(v) for k, v in FP0.items()})


def jax_mesh(n_cells, n_data):
    import jax
    from gaussian_processes_tpu.parallel.mesh import make_mesh
    return make_mesh(n_cells, n_data, devices=jax.devices()[:WORLD])


def jax_cfg(ntilde, **steps):
    from gaussian_processes_tpu.config import FitConfig as JCfg
    from test_torch_fit import JAX_EXACT
    return JCfg(ntilde=ntilde, **{**steps, **JAX_EXACT})


def close(t, j, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n", CHOL_N)
def test_distributed_cholesky_matches_jax_and_lapack(world, data, n):
    """The row blocks of the factor against JAX's distributed_cholesky and
    LAPACK's; n 213 is not a multiple of 4 (identity padding)."""
    import jax.numpy as jnp
    from gaussian_processes_tpu.parallel.sharded_linalg import (
        distributed_cholesky)
    A, b = data["chol"][n]
    L = gathered([w["chol"][n] for w in world], 0)
    assert L.shape == (n, n)
    np.testing.assert_allclose(L, np.linalg.cholesky(A), atol=1e-10)
    L_j = distributed_cholesky(jnp.asarray(A), jax_mesh(1, WORLD))
    np.testing.assert_allclose(L, np.asarray(L_j), atol=1e-10)
    for w in world:
        np.testing.assert_allclose(A @ w["chol"][n][1], b, atol=1e-9)


def test_sharded_gram_matches_jax(world, data):
    import jax.numpy as jnp
    from gaussian_processes_tpu.parallel.sharded_linalg import (
        sharded_gram as j_sharded_gram)
    g = data["gram"]
    Kt, K, Kv = j_sharded_gram(jax_theta()[0], jnp.asarray(g["x"]),
                               jnp.asarray(g["xt"]), N, jax_mesh(1, WORLD))
    for w in world:
        np.testing.assert_allclose(w["gram"][0], np.asarray(Kt), atol=1e-12)
    # rows split as torch.tensor_split splits them
    assert [w["gram"][1].shape[0] for w in world] == [16] * 4
    np.testing.assert_allclose(gathered([w["gram"] for w in world], 1),
                               np.asarray(K), atol=1e-12)
    np.testing.assert_allclose(gathered([w["gram"] for w in world], 2),
                               np.asarray(Kv), atol=1e-12)


@pytest.fixture(scope="module")
def jax_large(data):
    """JAX's large path through its mesh route on the data-4 mesh."""
    import jax.numpy as jnp
    from gaussian_processes_tpu.parallel import large as jlarge
    lg, mesh, th = data["large"], jax_mesh(1, WORLD), jax_theta()[0]
    K = jlarge.large_gram(th, jnp.asarray(lg["xt"]), N, mesh=mesh)
    L = jlarge.large_cholesky(K, mesh=mesh, jitter=JITTER)
    mu, alpha = jlarge.large_posterior_mean(
        th, jnp.asarray(lg["xt"]), jnp.asarray(lg["y"]),
        jnp.asarray(lg["xs"]), N, mesh=mesh, noise_var=JITTER, nb=16)
    return dict(K=np.asarray(K), L=np.asarray(L), mu=np.asarray(mu),
                alpha=np.asarray(alpha))


def test_large_gram_matches_jax_mesh_route(world, jax_large):
    K = gathered([w["large"] for w in world], "K")
    np.testing.assert_allclose(K, jax_large["K"], atol=1e-12)


def test_large_cholesky_matches_jax_mesh_route(world, jax_large):
    L = gathered([w["large"] for w in world], "L")
    np.testing.assert_allclose(L, jax_large["L"], atol=1e-10)


def test_large_posterior_mean_matches_jax_mesh_route(world, jax_large):
    for w in world:
        np.testing.assert_allclose(w["large"]["alpha"], jax_large["alpha"],
                                   atol=1e-9)
        np.testing.assert_allclose(w["large"]["mu"], jax_large["mu"],
                                   atol=1e-9)


# The final f-params are where the last f-param L-BFGS stops, on a flat
# objective: at nt 48 one-ulp differences in its values move logA by 8e-9
# and lambda0 by 1e-7 relative while every other leaf agrees to 2e-14, so
# they are held at the port-vs-JAX fit tolerance.
FPARAMS_RTOL = 1e-6


def compare_fits(got, want, rtol, theta_atol=0.0):
    assert not got["failed"]
    for k in ("logmarginal", "loglikelihood", "KL"):
        close(got["track"][k], want["track"][k], rtol)
    for k in THETA0:
        close(got["theta"][k], want["theta"][k], rtol, theta_atol)
    for k in FP0:
        close(got["f_params"][k], want["f_params"][k],
              max(rtol, FPARAMS_RTOL))
    Bm = want["B"] @ want["m_b"]
    close(got["B"] @ got["m_b"], Bm, rtol, rtol * np.abs(Bm).max())


@pytest.mark.parametrize("nt", FIT_NT)
def test_fit_mesh_matches_unsharded_port(world, data, nt):
    """fit(mesh=) on data 4 (nt 50: rows 13, 13, 12, 12) against the
    port's own unsharded fit; every rank returns the whole result."""
    want = fit_summary(port_fit(data["fits"][nt]))
    loss = want["track"]["logmarginal"]
    assert loss[-1] > loss[0]
    for w in world:
        got = w["fits"][nt]
        compare_fits(got, want, 1e-10)
        for k in ("K", "Kvec", "K_b", "a", "V_b"):
            close(got[k], want[k], 1e-10, 1e-10 * np.abs(want[k]).max())


@pytest.mark.parametrize("nt", FIT_NT)
def test_fit_mesh_matches_jax(world, data, nt):
    """Against JAX's fit(mesh=) on data 4 at nt 48.  At nt 50 JAX's fit
    refuses the mesh (device_put needs rows divisible by the axis), so the
    port's uneven split is held against JAX's unsharded fit, which JAX's
    docstring calls numerically identical."""
    import jax.numpy as jnp
    from gaussian_processes_tpu.models import fit as jf
    case = data["fits"][nt]
    mesh = jax_mesh(1, WORLD)
    theta, fp = jax_theta()

    def run(mesh):
        return jf.fit(jnp.asarray(case["x"]), jnp.asarray(case["r"]),
                      jax_cfg(16, **STEPS), xtilde=jnp.asarray(case["xt"]),
                      theta=theta, f_params=fp, mesh=mesh)
    if nt % WORLD:
        with pytest.raises(ValueError, match="divisible"):
            run(mesh)
        mesh = None
    j = run(mesh)
    want = dict(track={k: np.asarray(getattr(j.track, k))
                       for k in ("logmarginal", "loglikelihood", "KL")},
                theta={k: float(v) for k, v in j.theta.items()},
                f_params={k: float(v) for k, v in j.f_params.items()},
                m_b=np.asarray(j.m_b), B=np.asarray(j.B))
    for w in world:
        compare_fits(w["fits"][nt], want, 1e-6, 1e-9)


def test_population_mesh_matches_unsharded_port(world, data):
    """fit_population on the 2 x 2 mesh (2 cells on each "cells"
    coordinate, 16 of the 32 shared rows on each "data" one) against the
    port's unsharded population; every rank returns the whole carry."""
    want = carry_summary(port_population(data["pop"]))
    for w in world:
        got = w["pop"]
        assert not got["failed"].any()
        close(got["track"]["logmarginal"], want["track"]["logmarginal"],
              1e-8)
        for k in ("m_b", "K", "Kvec", "a", "lambda_m"):
            close(got[k], want[k], 1e-8, 1e-8 * np.abs(want[k]).max())
        for k in THETA0:
            close(got["theta"][k], want["theta"][k], 1e-8, 1e-9)


def test_population_mesh_matches_jax(world, data):
    """Against JAX's fit_population on its own 2 x 2 mesh."""
    import jax.numpy as jnp
    from gaussian_processes_tpu.parallel.population import fit_population
    X = jnp.asarray(data["pop"]["x"])
    theta, fp = jax_theta()
    jc, _ = fit_population(X, jnp.asarray(data["pop"]["r"]),
                           jax_cfg(32, **dict(STEPS,
                                              track_variational=False)),
                           xtilde=X, thetas=theta, f_params=fp,
                           mesh=jax_mesh(2, 2))
    for w in world:
        got = w["pop"]
        for k in ("logmarginal", "loglikelihood", "KL"):
            close(got["track"][k], np.asarray(getattr(jc.track, k)), 1e-8)
        np.testing.assert_array_equal(got["track"]["n_eigen"],
                                      np.asarray(jc.track.n_eigen))
        for k in THETA0:
            close(got["theta"][k], np.asarray(jc.theta[k]), 1e-8, 1e-9)
        for k in FP0:
            close(got["f_params"][k], np.asarray(jc.f_params[k]), 1e-8)
        jbm = np.einsum("lij,lj->li", np.asarray(jc.kern.es.B),
                        np.asarray(jc.m_b))
        close(np.einsum("lij,lj->li", got["B"], got["m_b"]), jbm, 1e-8,
              1e-8 * np.abs(jbm).max())


def test_gradients_match_unsharded(world, data):
    """The M-step objective's theta gradient and the f-param objective's
    logA gradient on data 4 (nt 50, uneven rows) equal the unsharded ones
    on every rank, and so do the values."""
    want = value_and_grads(data["fits"][FIT_NT[1]])
    for w in world:
        got = w["grads"]["rows"]
        for name in ("mstep", "fparam"):
            close(got[name][0], want[name][0], 1e-12)
            g, g_ref = np.atleast_1d(got[name][1]), np.atleast_1d(
                want[name][1])
            np.testing.assert_allclose(g, g_ref,
                                       atol=1e-12 * np.abs(g_ref).max())


@pytest.mark.parametrize("variant", ["both_ways", "no_enter"])
def test_gradient_test_catches_the_wrong_collectives(world, data, variant):
    """What the test above fails on: a sum that all-reduces its gradient
    too (torch.distributed.nn.functional.all_reduce: 4x the gradient), or
    a sum with no enter_rows (each rank's share's gradient only).  The
    values stay right; the gradients miss by far more than its 1e-12."""
    want = value_and_grads(data["fits"][FIT_NT[1]])
    for w in world:
        got = w["grads"][variant]
        for name in ("mstep", "fparam"):
            close(got[name][0], want[name][0], 1e-12)
            g, g_ref = np.atleast_1d(got[name][1]), np.atleast_1d(
                want[name][1])
            assert np.abs(g - g_ref).max() > 0.1 * np.abs(g_ref).max()
    if variant == "both_ways":
        for w in world:
            close(w["grads"][variant]["fparam"][1], WORLD * want["fparam"][1],
                  1e-12)


def test_every_rank_takes_the_same_branches(world):
    """Each rank's host decisions read values the collectives made the
    same on every rank: the fits and the population end bit for bit alike
    on all four, after the same collectives."""
    first = world[0]
    for w in world[1:]:
        assert w["fit_calls"] == first["fit_calls"]
        for nt in FIT_NT:
            for k in ("m_b", "V_b", "K", "a"):
                np.testing.assert_array_equal(w["fits"][nt][k],
                                              first["fits"][nt][k])
            np.testing.assert_array_equal(
                w["fits"][nt]["track"]["logmarginal"],
                first["fits"][nt]["track"]["logmarginal"])
        np.testing.assert_array_equal(w["pop"]["m_b"], first["pop"]["m_b"])
    assert first["fit_calls"]["all_reduce"] > 0
    # the end's gathers: K, Kvec, K_b and a of each of the two fits
    assert first["fit_calls"]["all_gather"] == 8


def test_dryrun_multichip_on_cpu():
    """The parity gate in a gloo world of 4 CPU processes, float64."""
    from gaussian_processes_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(WORLD, device="cpu")


def test_row_layouts():
    """row_range splits as torch.tensor_split; block_rows cuts ceil(n / P)
    blocks at n; population_shardings pairs a cell slice with row_range."""
    for n in (48, 50, 3, 213):
        for p in (1, 2, 3, 4):
            parts = torch.tensor_split(torch.arange(n), p)
            for i, part in enumerate(parts):
                sl = M.row_range(n, p, i)
                assert torch.equal(torch.arange(n)[sl], part)
    mesh = _StubMesh("cpu", (2, 2), (1, 0))
    assert M.population_shardings(mesh, 4, 50) == (slice(2, 4), slice(0, 25))
    with pytest.raises(ValueError, match="divide"):
        M.population_shardings(mesh, 3, 50)
    starts = [SL.block_rows(213, _StubMesh("cpu", (1, 4), (0, k)))
              for k in range(4)]
    assert starts == [slice(0, 54), slice(54, 108), slice(108, 162),
                      slice(162, 213)]
    assert SL.block_rows(5, _StubMesh("cpu", (1, 4), (0, 3))) == slice(5, 5)


class _StubMesh:
    """A mesh's shape, coordinates and device type, without a process
    group (for what is decided before any collective)."""

    def __init__(self, device_type, shape, coord):
        self.device_type, self.shape, self.coord = device_type, shape, coord

    def size(self, dim=0):
        return self.shape[dim]

    def get_local_rank(self, name=None):
        return self.coord[0 if name is None else M.AXES.index(name)]

    def __getitem__(self, name):
        i = M.AXES.index(name)
        return _StubMesh(self.device_type, (self.shape[i],), (self.coord[i],))


def test_a_tensor_off_the_mesh_device_raises():
    """A CPU tensor handed to a CUDA (NCCL) mesh raises before any
    collective, in every entry point that takes a mesh."""
    mesh = _StubMesh("cuda", (1, 1), (0, 0))
    case = inputs()["fits"][FIT_NT[0]]
    x = t64(case["x"])
    with pytest.raises(ValueError, match="cpu tensor"):
        port_fit(case, mesh)
    with pytest.raises(ValueError, match="cpu tensor"):
        tpop.fit_population(x, t64(case["r"])[None], FIT_CFG,
                            xtilde=x[:16], thetas=THETA0, mesh=mesh)
    with pytest.raises(ValueError, match="cpu tensor"):
        SL.sharded_gram(THETA0, x, x[:16], N, mesh)
    with pytest.raises(ValueError, match="cpu tensor"):
        SL.distributed_cholesky(t64(spd(8)), mesh)
