"""The port's large-ntilde path (parallel/large.py) against the JAX
package's single-device route, float64, on the same numpy inputs: the
single-device half of tests/test_sharding.py::test_large_path_small_scale.

Tolerances are that test's: the Gram atol 1e-12 (the same float64 products
in row blocks), the Cholesky factor atol 1e-10 (cuSOLVER/LAPACK's blocked
factorization against JAX's left-looking block loop), the posterior mean
and its weights atol 1e-9.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.ops.kernels import gram_matrices as j_gram
from gaussian_processes_tpu.parallel import large as jlarge
from gaussian_processes_tpu_torch.ops.kernels import gram_matrices as t_gram
from gaussian_processes_tpu_torch.parallel import large as tlarge
from test_sharding import N, THETA0

torch.set_num_threads(1)

JITTER = 0.5


def inputs(n, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, N * N)), rng.standard_normal((8, N * N)),
            rng.standard_normal(n))


def jtheta():
    return {k: jnp.float64(v) for k, v in THETA0.items()}


@pytest.mark.parametrize("n", [96, 100])
def test_large_gram_matches_jax(n):
    """Row blocks of 16 (n = 100: a ragged last block here, JAX picks a
    divisor, 20) equal JAX's large_gram and the one-pass Gram."""
    xt, _, _ = inputs(n)
    K = tlarge.large_gram(THETA0, xt, N, nb=16, device="cpu")
    K_j = jlarge.large_gram(jtheta(), jnp.asarray(xt), N, mesh=None, nb=16)
    K_ref, _, _ = j_gram(jtheta(), jnp.asarray(xt), jnp.asarray(xt), N,
                         shared=True)
    assert K.shape == (n, n) and K.dtype == torch.float64
    np.testing.assert_allclose(K.numpy(), np.asarray(K_j), atol=1e-12)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_ref), atol=1e-12)
    th = {k: torch.tensor(v, dtype=torch.float64) for k, v in THETA0.items()}
    K_t, _, _ = t_gram(th, torch.as_tensor(xt), torch.as_tensor(xt), N,
                       shared=True)
    np.testing.assert_allclose(K.numpy(), K_t.numpy(), atol=1e-12)


@pytest.mark.parametrize("n", [96, 100])
def test_large_cholesky_matches_lapack_and_jax(n):
    """The factor of K + jitter I, in K's own buffer, against LAPACK and
    JAX's single-device left-looking loop (nb 16 < n)."""
    xt, _, _ = inputs(n)
    K_ref, _, _ = j_gram(jtheta(), jnp.asarray(xt), jnp.asarray(xt), N,
                         shared=True)
    A = np.asarray(K_ref)
    L_ref = np.linalg.cholesky(A + JITTER * np.eye(n))
    buf = torch.tensor(A)
    L = tlarge.large_cholesky(buf, jitter=JITTER, nb=16)
    assert L.data_ptr() == buf.data_ptr()
    np.testing.assert_allclose(L.numpy(), L_ref, atol=1e-10)
    L_j = jlarge._chol_single_device(jnp.asarray(A).copy(), nb=16,
                                     jitter=JITTER)
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), atol=1e-10)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)


@pytest.mark.parametrize("n", [96, 100])
def test_large_posterior_mean_matches_jax(n):
    xt, xs, y = inputs(n)
    mu, alpha = tlarge.large_posterior_mean(THETA0, xt, y, xs, N,
                                            noise_var=JITTER, nb=16,
                                            device="cpu")
    mu_j, alpha_j = jlarge.large_posterior_mean(
        jtheta(), jnp.asarray(xt), jnp.asarray(y), jnp.asarray(xs), N,
        mesh=None, noise_var=JITTER, nb=16)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_j), atol=1e-9)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-9)
    K_ref, K_star, _ = j_gram(jtheta(), jnp.asarray(xs), jnp.asarray(xt), N,
                              shared=False)
    A = np.asarray(j_gram(jtheta(), jnp.asarray(xt), jnp.asarray(xt), N,
                          shared=True)[0]) + JITTER * np.eye(n)
    alpha_ref = np.linalg.solve(A, y)
    np.testing.assert_allclose(alpha.numpy(), alpha_ref, atol=1e-9)
    np.testing.assert_allclose(mu.numpy(), np.asarray(K_star) @ alpha_ref,
                               atol=1e-9)


def test_numpy_input_without_device_needs_a_card(monkeypatch):
    """device=None means xtilde's own device, or the card for numpy input:
    with no card that raises instead of running on the CPU."""
    xt, xs, y = inputs(32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlarge.large_gram(THETA0, xt, N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlarge.large_posterior_mean(THETA0, xt, y, xs, N)
    # a CPU tensor runs where it lies
    K = tlarge.large_gram(THETA0, torch.as_tensor(xt), N, nb=16)
    assert K.device.type == "cpu"
