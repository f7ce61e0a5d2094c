"""The port's spectrally projected M-step Gram (ops/kernels.py:
``window_smooth_d2``, ``suggest_proj_rank``, ``smooth_projection_basis``,
``gram_matrices_projected``) against the JAX package's, float64, on the
same numpy inputs.

Bases are compared as projectors (an eigenvector's sign, or a rotation
inside a degenerate eigenspace, is free); the Grams and the guard are
compared with the JAX function handed the port's basis, so both project on
the same subspace.  Both backends run: "cuda" on CPU tensors takes the
fused-Gram wrapper's plain forward and its hand-written backward, so the
autograd Function is on the path.  Tolerances: values rtol 1e-10, theta
gradients rtol 1e-8, integers equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu_torch.ops import gram_cuda
from gaussian_processes_tpu_torch.ops import kernels as tk

from test_torch_kernels import THETA, images
from test_torch_kernels import jtheta as _jtheta
from test_torch_kernels import ttheta as _ttheta

torch.set_num_threads(1)

N = 16
BACKENDS = ["torch", "cuda"]
# the window of test_torch_kernels' narrow RF: corner (2, 2), 12 px
WIN = (2, 2, 12)
# a smooth prior (rho 0.5), whose smoothing spectrum decays within the
# window: rank 10 projects within tolerance at 12 and 16 px, rank 4 does not
THETA = dict(THETA, **{"-log2rho2": -np.log(2 * 0.5 ** 2)})


def jtheta(vals=None, dtype=jnp.float64):
    return _jtheta(THETA if vals is None else vals, dtype)


def ttheta(vals=None, dtype=torch.float64, grad=False):
    return _ttheta(THETA if vals is None else vals, dtype, grad)


def close(t, j, rtol=1e-10, atol=1e-12):
    if isinstance(t, torch.Tensor):
        t = t.detach()
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def projector(E):
    E = np.asarray(E.detach() if isinstance(E, torch.Tensor) else E)
    return E @ np.swapaxes(E, -1, -2)


@pytest.mark.parametrize("w,n_px", [(12, 16), (16, 16), (80, 108)])
def test_window_smooth_d2_matches_jax(w, n_px):
    got = tk.window_smooth_d2(w, n_px, torch.float64)
    close(got, jk.window_smooth_d2(w, n_px, jnp.float64), rtol=0, atol=0)


@pytest.mark.parametrize("w,n_px", [(12, 16), (24, 24), (80, 108),
                                    (108, 108)])
@pytest.mark.parametrize("rho", [0.05, 0.1, 0.18, 0.5])
def test_suggest_proj_rank_equals_jax(w, n_px, rho):
    gr = 1.0 / (2 * rho ** 2)
    assert tk.suggest_proj_rank(gr, w, n_px) == jk.suggest_proj_rank(
        gr, w, n_px)


def test_suggest_proj_rank_at_the_bench_theta():
    """bench.py's rho 0.1 on its 108 px grid: the full-frame rank of the
    port's sizing, and the rank at the crop window's 80 px."""
    gr = 1.0 / (2 * 0.1 ** 2)
    assert tk.suggest_proj_rank(gr, 108, 108) == 56
    assert tk.suggest_proj_rank(gr, 80, 108) == jk.suggest_proj_rank(
        gr, 80, 108)


# ranks whose cut lies between eigenvalues well above rounding: deeper in
# the spectrum the subspace itself is conditioned only to ~eps / gap
@pytest.mark.parametrize("rank", [2, 4, 6])
def test_smooth_projection_basis_matches_jax_as_projectors(rank):
    E = tk.smooth_projection_basis(ttheta(), 12, N, rank)
    jE = jk.smooth_projection_basis(jtheta(), 12, N, rank)
    assert E.shape == (12, rank)
    close(projector(E), projector(jE), atol=1e-12)
    close(E.mT @ E, np.eye(rank), atol=1e-12)


def test_smooth_projection_basis_batched_and_poisoned():
    """A theta of (B,) tensors gives (B, w, R), item by item the 2-D
    basis's projector; a non-finite theta gives zeros, as in JAX."""
    vals = {k: np.array([v, v, v]) for k, v in THETA.items()}
    vals["-log2rho2"] = vals["-log2rho2"] + np.array([0.0, 0.5, np.nan])
    th = {k: torch.as_tensor(v) for k, v in vals.items()}
    E = tk.smooth_projection_basis(th, 12, N, 8)
    assert E.shape == (3, 12, 8)
    for b in range(2):
        one = tk.smooth_projection_basis(
            {k: v[b] for k, v in th.items()}, 12, N, 8)
        close(projector(E[b]), projector(one), atol=1e-12)
    assert not bool(E[2].any())
    jE = jk.smooth_projection_basis(
        {k: jnp.asarray(v[2]) for k, v in vals.items()}, 12, N, 8)
    assert not np.any(np.asarray(jE))


def _operands(windowed: bool, shared: bool, m=20, n=12):
    """Pre-cropped stimuli (the window's or the full frame's) and corner."""
    x, xt = images(0, m), images(1, n)
    if shared:
        xt = x
    if not windowed:
        return x, xt, 0, 0, N
    i0, j0, w = WIN
    crop = [np.asarray(jk.crop_images(jnp.asarray(a), i0, j0, w, N))
            for a in (x, xt)]
    return crop[0], crop[1], i0, j0, w


def _both(theta_vals, xc, xtc, i0, j0, E, shared, backend, tol=3e-6):
    jout = jk.gram_matrices_projected(
        jtheta(theta_vals), jnp.asarray(xc), jnp.asarray(xtc),
        jnp.asarray(E.numpy()), i0, j0, N, shared, tol=tol)
    tout = tk.gram_matrices_projected(
        ttheta(theta_vals), torch.as_tensor(xc), torch.as_tensor(xtc), E,
        i0, j0, N, shared, tol=tol, backend=backend)
    return tout, jout


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("windowed,shared", [(False, False), (True, False),
                                             (True, True)])
@pytest.mark.parametrize("rank,within", [(10, True), (4, False)])
def test_gram_matrices_projected_matches_jax(windowed, shared, rank, within,
                                             backend):
    """In tolerance (rank 10 of 12-16 px) and out of it (rank 4): K_tilde,
    K and Kvec at rtol 1e-10 and the same guard."""
    xc, xtc, i0, j0, w = _operands(windowed, shared)
    E = tk.smooth_projection_basis(ttheta(), w, N, rank)
    tout, jout = _both(THETA, xc, xtc, i0, j0, E, shared, backend)
    assert bool(tout[3]) == bool(jout[3]) == within
    for t, j in zip(tout[:3], jout[:3]):
        close(t, j)


def test_projected_gram_is_the_exact_gram_at_full_rank():
    """E spanning the whole window: P S P = S, so the projected Gram is the
    windowed Gram (to rounding) and the guard holds."""
    xc, xtc, i0, j0, w = _operands(True, False)
    E = tk.smooth_projection_basis(ttheta(), w, N, w)
    *grams, ok = tk.gram_matrices_projected(
        ttheta(), torch.as_tensor(xc), torch.as_tensor(xtc), E, i0, j0, N,
        False)
    exact = tk.gram_matrices_windowed(
        ttheta(), torch.as_tensor(images(0, 20)),
        torch.as_tensor(images(1, 12)), N, False, *WIN)
    assert bool(ok)
    for g, e in zip(grams, exact):
        close(g, e.numpy(), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gram_matrices_projected_batched_matches_per_item_jax(backend):
    """theta (B,) with per-item bases, corners and crops (the population's
    and the ladder's form): item b is JAX's 2-D call on item b."""
    offsets = np.array([0.0, 0.3, -0.2])
    vals = {k: np.full(3, v) for k, v in THETA.items()}
    vals["-log2rho2"] = vals["-log2rho2"] + offsets
    th = {k: torch.as_tensor(v) for k, v in vals.items()}
    corners = [(2, 2), (0, 4), (4, 0)]
    x, xt = images(0, 20), images(1, 12)
    xc = np.stack([np.asarray(jk.crop_images(jnp.asarray(x), i, j, 12, N))
                   for i, j in corners])
    xtc = np.stack([np.asarray(jk.crop_images(jnp.asarray(xt), i, j, 12, N))
                    for i, j in corners])
    E = tk.smooth_projection_basis(th, 12, N, 10)
    i0 = torch.tensor([c[0] for c in corners])
    j0 = torch.tensor([c[1] for c in corners])
    Kt, K, Kv, ok = tk.gram_matrices_projected(
        th, torch.as_tensor(xc), torch.as_tensor(xtc), E, i0, j0, N, False,
        backend=backend)
    assert Kt.shape == (3, 12, 12) and K.shape == (3, 20, 12)
    for b, (i, j) in enumerate(corners):
        jout = jk.gram_matrices_projected(
            {k: jnp.asarray(v[b]) for k, v in vals.items()},
            jnp.asarray(xc[b]), jnp.asarray(xtc[b]),
            jnp.asarray(E[b].numpy()), i, j, N, False)
        assert bool(ok[b]) == bool(jout[3])
        for t, jv in zip((Kt[b], K[b], Kv[b]), jout[:3]):
            close(t, jv)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("windowed", [False, True])
def test_gram_matrices_projected_theta_gradient_matches_jax(windowed,
                                                            backend):
    """d/dtheta of a weighted sum of K_tilde, K and Kvec, the basis fixed
    (as in the M-step, where it is taken at the iteration-start theta):
    against jax.grad, rtol 1e-8."""
    xc, xtc, i0, j0, w = _operands(windowed, False)
    E = tk.smooth_projection_basis(ttheta(), w, N, 10)
    rng = np.random.default_rng(3)
    W = rng.standard_normal((20, 12))

    def jloss(th):
        Kt, K, Kv, _ = jk.gram_matrices_projected(
            th, jnp.asarray(xc), jnp.asarray(xtc), jnp.asarray(E.numpy()),
            i0, j0, N, False)
        return jnp.sum(Kt) + jnp.sum(jnp.asarray(W) * K) + jnp.sum(Kv)

    th = ttheta(grad=True)
    Kt, K, Kv, _ = tk.gram_matrices_projected(
        th, torch.as_tensor(xc), torch.as_tensor(xtc), E, i0, j0, N, False,
        backend=backend)
    loss = Kt.sum() + (torch.as_tensor(W) * K).sum() + Kv.sum()
    grads = torch.autograd.grad(loss, list(th.values()))
    jg = jax.grad(jloss)(jtheta())
    for (k, g) in zip(th, grads):
        close(g, jg[k], rtol=1e-8, atol=1e-10)


def test_cuda_backend_hands_the_kernel_the_projected_contraction(
        monkeypatch):
    """Under backend="cuda" both cross forms go through the fused-Gram
    wrapper at contraction R^2, with u1 = Amp Z and s2 = Y."""
    calls = []
    real = gram_cuda.acos_gram

    def spy(*args, **kwargs):
        calls.append(tuple(tuple(a.shape) for a in args))
        return real(*args, **kwargs)
    monkeypatch.setattr(gram_cuda, "acos_gram", spy)
    xc, xtc, i0, j0, w = _operands(True, False)
    E = tk.smooth_projection_basis(ttheta(), w, N, 10)
    tk.gram_matrices_projected(ttheta(), torch.as_tensor(xc),
                               torch.as_tensor(xtc), E, i0, j0, N, False,
                               backend="cuda")
    assert [c[:2] for c in calls] == [((12, 100), (12, 100)),
                                      ((20, 100), (12, 100))]


def test_projection_guard_runs_in_float64_for_float32_inputs():
    """The residual ||S||^2 - ||E^T S E||^2 is formed in float64 whatever
    the stimuli's dtype: float32 operands with the fit's float64 basis give
    the float64 guard's answer at rank 7 of 12 px, whose relative squared
    residual (7.5e-12) sits just inside tol^2 = 9e-12, far below float32's
    rounding, and at rank 6 just outside."""
    xc, xtc, i0, j0, w = _operands(True, False)
    for rank, want in ((6, False), (7, True)):
        E = tk.smooth_projection_basis(ttheta(), w, N, rank)
        ok64 = tk.gram_matrices_projected(
            ttheta(), torch.as_tensor(xc), torch.as_tensor(xtc), E, i0, j0,
            N, False)[3]
        ok32 = tk.gram_matrices_projected(
            ttheta(dtype=torch.float32),
            torch.as_tensor(xc, dtype=torch.float32),
            torch.as_tensor(xtc, dtype=torch.float32), E, i0, j0, N,
            False)[3]
        jok = jk.gram_matrices_projected(
            jtheta(), jnp.asarray(xc), jnp.asarray(xtc),
            jnp.asarray(E.numpy()), i0, j0, N, False)[3]
        assert bool(ok64) == bool(ok32) == bool(jok) == want
    # the JAX package forms the residual in the fit's dtype: in float32 it
    # reads float32 noise (~6e-7 relative, against tol^2 = 9e-12) and
    # refuses every projection, even at full rank
    j32 = jtheta(dtype=jnp.float32)
    E32 = jk.smooth_projection_basis(j32, w, N, w, dtype=jnp.float32)
    assert not bool(jk.gram_matrices_projected(
        j32, jnp.asarray(xc, jnp.float32), jnp.asarray(xtc, jnp.float32),
        E32, i0, j0, N, False)[3])
