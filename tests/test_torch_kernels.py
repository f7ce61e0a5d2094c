"""The port's kernel construction (gaussian_processes_tpu_torch/ops/kernels.py)
and fused Gram (ops/gram_cuda.py) against the JAX package, on the same
numpy inputs.

Tolerances: float64 values rtol 1e-10 (same math, summation order only);
the plain Gram forward at float32 against the Pallas kernel in interpret
mode rtol 3e-6 / atol 1e-6 (tests/test_pallas_gram.py's tolerance, which
covers the Pallas arccos polynomial's 2e-8 rad); theta-gradients rtol 1e-8.
On CPU tensors the fused-Gram wrapper runs its plain forward; the CUDA
kernel itself is compared with it on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu.ops.gram_pallas import acos_gram_pallas
from gaussian_processes_tpu_torch.ops import gram_cuda
from gaussian_processes_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

N = 16
THETA = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
         "-2log2beta": -2 * np.log(2 * 0.4),
         "-log2rho2": -np.log(2 * 0.18 ** 2), "Amp": 1.3}
# a narrow RF whose crop window (margin 1.25, bucket 4) is 12 of 16 px
THETA_NARROW = dict(THETA, **{"-2log2beta": -2 * np.log(2 * 0.1)})
BACKENDS = ["torch", "cuda"]


def jtheta(vals=THETA, dtype=jnp.float64):
    return {k: jnp.asarray(v, dtype) for k, v in vals.items()}


def ttheta(vals=THETA, dtype=torch.float64, grad=False):
    return {k: torch.tensor(v, dtype=dtype, requires_grad=grad)
            for k, v in vals.items()}


def images(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, N * N)).astype(dtype)


def close(t, j, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def narrow_window():
    return jk.crop_window_from_scalars(
        THETA_NARROW["-2log2beta"], THETA_NARROW["eps_0x"],
        THETA_NARROW["eps_0y"], N, margin=1.25, bucket=4)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pixel_coords", "local_envelope",
                                  "smooth_factor", "materialize_C",
                                  "smooth_apply", "quad_forms", "acosker",
                                  "acosker_diag", "acos_J"])
def test_building_blocks_match_jax(name):
    x1, x2 = images(0, 9), images(1, 6)
    jt, tt = jtheta(), ttheta()
    if name == "pixel_coords":
        pairs = zip(tk.pixel_coords(N, torch.float64),
                    jk.pixel_coords(N, jnp.float64))
    elif name == "local_envelope":
        pairs = zip(tk.local_envelope(tt, N), jk.local_envelope(jt, N))
    elif name == "smooth_factor":
        pairs = [(tk.smooth_factor(tt, N), jk.smooth_factor(jt, N))]
    elif name == "materialize_C":
        pairs = zip(tk.materialize_C(tt, N), jk.materialize_C(jt, N))
    elif name == "smooth_apply":
        S = np.array(jk.smooth_factor(jt, N))
        pairs = [(tk.smooth_apply(torch.as_tensor(S), torch.as_tensor(x1), N),
                  jk.smooth_apply(jnp.asarray(S), jnp.asarray(x1), N))]
    elif name == "quad_forms":
        pairs = zip(tk.quad_forms(tt, torch.as_tensor(x1),
                                  torch.as_tensor(x2), N),
                    jk.quad_forms(jt, jnp.asarray(x1), jnp.asarray(x2), N))
    elif name == "acosker":
        pairs = [(tk.acosker(tt, torch.as_tensor(x1), torch.as_tensor(x2),
                             n_px_side=N),
                  jk.acosker(jt, jnp.asarray(x1), jnp.asarray(x2),
                             n_px_side=N)),
                 (tk.acosker(tt, torch.as_tensor(x1), n_px_side=N),
                  jk.acosker(jt, jnp.asarray(x1), n_px_side=N))]
    elif name == "acosker_diag":
        pairs = [(tk.acosker(tt, torch.as_tensor(x1), n_px_side=N, diag=True),
                  jk.acosker(jt, jnp.asarray(x1), n_px_side=N, diag=True))]
    else:
        c = np.linspace(-1.0, 1.0, 41)
        pairs = [(tk.acos_J(torch.as_tensor(c)), jk.acos_J(jnp.asarray(c)))]
    for t, j in pairs:
        if t.dtype == torch.bool:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            close(t, j)


def test_crop_window_and_coords_match_jax():
    for lb in (0.5, 3.2, 5.0):
        for ex, ey in ((0.0, 0.0), (0.7, -0.9), (-1.0, 1.0)):
            for bucket in (1, 4, 16):
                assert (tk.crop_window_from_scalars(lb, ex, ey, N, 1e-3, 1.25,
                                                   bucket)
                        == jk.crop_window_from_scalars(lb, ex, ey, N, 1e-3,
                                                       1.25, bucket))
    i0, j0, w = narrow_window()
    assert w < N
    x = images(2, 5)
    close(tk.crop_images(torch.as_tensor(x), i0, j0, w, N),
          jk.crop_images(jnp.asarray(x), i0, j0, w, N), rtol=0, atol=0)
    for t, j in zip(tk.window_coords(i0, j0, w, N, torch.float64),
                    jk.window_coords(i0, j0, w, N, jnp.float64)):
        close(t, j, rtol=0, atol=0)


def test_acos_J_gradient_is_finite_at_the_ends():
    c = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0], dtype=torch.float64,
                     requires_grad=True)
    (g,) = torch.autograd.grad(tk.acos_J(c).sum(), c)
    jg = jax.vmap(jax.grad(jk.acos_J))(jnp.asarray(c.detach().numpy()))
    close(g, jg)
    assert torch.all(torch.isfinite(g))


# ---------------------------------------------------------------------------
# Grams against the JAX xla path (float64)
# ---------------------------------------------------------------------------

SHAPES = [(True, 32, 32), (False, 32, 16), (False, 37, 5)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shared,m,n", SHAPES)
def test_gram_matrices_match_xla(shared, m, n, backend):
    x = images(3, m)
    xt = x if shared else images(4, n)
    jout = jk.gram_matrices(jtheta(), jnp.asarray(x), jnp.asarray(xt), N,
                            shared=shared, backend="xla")
    tx = torch.as_tensor(x)
    tout = tk.gram_matrices(ttheta(), tx, tx if shared else torch.as_tensor(xt),
                            N, shared=shared, backend=backend)
    if shared:
        assert tout[1] is tout[0]
    for t, j in zip(tout, jout):
        close(t, j)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shared,m,n", SHAPES)
def test_gram_matrices_windowed_match_xla(shared, m, n, backend):
    i0, j0, w = narrow_window()
    x = images(5, m)
    xt = x if shared else images(6, n)
    jth, tth = jtheta(THETA_NARROW), ttheta(THETA_NARROW)
    jout = jk.gram_matrices_windowed(jth, jnp.asarray(x), jnp.asarray(xt), N,
                                     shared, i0, j0, w, backend="xla")
    jfull = jk.gram_matrices(jth, jnp.asarray(x), jnp.asarray(xt), N,
                             shared=shared, backend="xla")
    tx = torch.as_tensor(x)
    txt = tx if shared else torch.as_tensor(xt)
    tout = tk.gram_matrices_windowed(tth, tx, txt, N, shared, i0, j0, w,
                                     backend=backend)
    tpre = tk.gram_matrices_precropped(
        tth, tk.crop_images(tx, i0, j0, w, N),
        tk.crop_images(txt, i0, j0, w, N), N, shared, i0, j0, w,
        backend=backend)
    for t, p, j, jf in zip(tout, tpre, jout, jfull):
        close(t, j)
        close(p, j)
        close(t, jf)      # the window covers the mask: equal to the full grid


# ---------------------------------------------------------------------------
# The plain Gram forward at float32 against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared,m,n", [(True, 20, 20), (False, 20, 12),
                                        (False, 37, 5)])
def test_gram_float32_matches_pallas(shared, m, n):
    x = images(7, m, np.float32)
    xt = x if shared else images(8, n, np.float32)
    jout = jk.gram_matrices(jtheta(dtype=jnp.float32), jnp.asarray(x),
                            jnp.asarray(xt), N, shared=shared,
                            backend="pallas")
    tx = torch.as_tensor(x)
    tout = tk.gram_matrices(ttheta(dtype=torch.float32), tx,
                            tx if shared else torch.as_tensor(xt), N,
                            shared=shared, backend="cuda")
    assert tout[0].dtype == torch.float32 and tout[1].shape == (m, n)
    close(tout[0], jout[0], rtol=3e-6, atol=1e-6)
    close(tout[1], jout[1], rtol=3e-6, atol=1e-6)
    close(tout[2], jout[2], rtol=1e-6, atol=0)
    if shared:
        np.testing.assert_array_equal(tout[0].numpy(), tout[0].numpy().T)


def test_acos_gram_torch_matches_pallas_kernel():
    rng = np.random.default_rng(9)
    u1 = rng.standard_normal((37, 300)).astype(np.float32)
    s2 = rng.standard_normal((21, 300)).astype(np.float32)
    q11 = (u1 * u1).sum(1) * 1.1
    q22 = (s2 * s2).sum(1) * 0.9
    s0 = np.float32(0.8)
    jK = acos_gram_pallas(jnp.asarray(u1), jnp.asarray(s2.T), jnp.asarray(q11),
                          jnp.asarray(q22), jnp.asarray(s0), interpret=True)
    tK = gram_cuda.acos_gram_torch(*(torch.as_tensor(a) for a in
                                     (u1, s2, q11, q22, s0)))
    close(tK, jK, rtol=3e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shared,windowed", [(True, False), (False, False),
                                             (False, True)])
def test_theta_gradient_matches_jax(shared, windowed, backend):
    """d/dtheta of a fixed weighted sum of K_tilde and K: the port's
    autograd (through AcosGram's hand backward for backend="cuda") against
    jax.grad of the xla path."""
    vals = THETA_NARROW if windowed else THETA
    i0, j0, w = narrow_window()
    x = images(10, 24)
    xt = x if shared else images(11, 10)
    rng = np.random.default_rng(12)
    W1 = rng.standard_normal((xt.shape[0], xt.shape[0]))
    W2 = rng.standard_normal((x.shape[0], xt.shape[0]))

    def jloss(th):
        if windowed:
            Kt, K, Kv = jk.gram_matrices_windowed(
                th, jnp.asarray(x), jnp.asarray(xt), N, shared, i0, j0, w)
        else:
            Kt, K, Kv = jk.gram_matrices(th, jnp.asarray(x), jnp.asarray(xt),
                                         N, shared=shared)
        return jnp.sum(W1 * Kt) + jnp.sum(W2 * K) + jnp.sum(Kv)

    jg = jax.grad(jloss)(jtheta(vals))
    th = ttheta(vals, grad=True)
    tx = torch.as_tensor(x)
    txt = tx if shared else torch.as_tensor(xt)
    if windowed:
        Kt, K, Kv = tk.gram_matrices_windowed(th, tx, txt, N, shared, i0, j0,
                                              w, backend=backend)
    else:
        Kt, K, Kv = tk.gram_matrices(th, tx, txt, N, shared=shared,
                                     backend=backend)
    loss = (torch.sum(torch.as_tensor(W1) * Kt)
            + torch.sum(torch.as_tensor(W2) * K) + torch.sum(Kv))
    tg = torch.autograd.grad(loss, list(th.values()))
    for k, g in zip(th, tg):
        np.testing.assert_allclose(g.item(), float(jg[k]), rtol=1e-8,
                                   atol=1e-10, err_msg=k)


def _gradcheck_inputs(near_one: bool):
    rng = np.random.default_rng(13)
    u1 = rng.standard_normal((6, 20))
    if near_one:
        # a shared Gram: s2 = u1, and the diagonal norms 0.1% above the
        # cross form, so the diagonal cosines sit at c ~ 1 - 1e-3 (a 1e-6
        # finite-difference step stays clear of the clip)
        s2 = u1.copy()
        q = (u1 * u1).sum(1) * 1.001
        q11, q22 = q, q.copy()
    else:
        s2 = rng.standard_normal((4, 20))
        q11 = (u1 * u1).sum(1) * 1.3
        q22 = (s2 * s2).sum(1) * 0.8
    return tuple(torch.tensor(a, dtype=torch.float64, requires_grad=True)
                 for a in (u1, s2, q11, q22, 0.7))


@pytest.mark.parametrize("near_one", [False, True])
def test_acos_gram_gradcheck(near_one):
    inputs = _gradcheck_inputs(near_one)
    if near_one:
        K = gram_cuda.acos_gram(*inputs)
        c = K.diagonal() / (inputs[2] + 0.49)      # X1X2 = q + s0^2 here
        assert torch.all(c > 0.998) and torch.all(c < 1.0)
    assert torch.autograd.gradcheck(gram_cuda.acos_gram, inputs)


def test_acos_gram_backward_finite_on_an_exact_shared_diagonal():
    """At c = 1 exactly (clipped), the hand backward gives finite values
    equal to the composite's analytic-derivative gradient."""
    x = images(14, 12)
    th = ttheta(grad=True)
    Kt, _, _ = tk.gram_matrices(th, torch.as_tensor(x), torch.as_tensor(x), N,
                                shared=True, backend="cuda")
    g_kernel = torch.autograd.grad(Kt.sum(), list(th.values()))
    th2 = ttheta(grad=True)
    Kt2, _, _ = tk.gram_matrices(th2, torch.as_tensor(x), torch.as_tensor(x),
                                 N, shared=True, backend="torch")
    g_plain = torch.autograd.grad(Kt2.sum(), list(th2.values()))
    for a, b in zip(g_kernel, g_plain):
        assert torch.isfinite(a)
        np.testing.assert_allclose(a.item(), b.item(), rtol=1e-10)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    u1 = torch.zeros(3, 4)
    with pytest.raises(ValueError):
        gram_cuda._check(u1, torch.zeros(2, 5), torch.zeros(3), torch.zeros(2),
                         torch.zeros(1))
    with pytest.raises(TypeError):
        gram_cuda._check(u1.double(), torch.zeros(2, 4), torch.zeros(3),
                         torch.zeros(2), torch.zeros(1))
    with pytest.raises(ValueError):
        gram_cuda._check(torch.zeros(4, 3).T, torch.zeros(2, 4),
                         torch.zeros(3), torch.zeros(2), torch.zeros(1))
