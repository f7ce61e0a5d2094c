"""The CUDA Gram kernel on the card, against its plain PyTorch version.

Every test here needs a CUDA device (the kernel has no CPU mode) and skips
without one.  This file imports torch and the port only, so that it runs on
a machine without jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from gaussian_processes_tpu_torch.ops import gram_cuda
from gaussian_processes_tpu_torch.ops import kernels

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(37, 5, 256), (130, 129, 13), (1, 1, 1),
                                   (257, 300, 1001)])
def test_kernel_matches_plain_on_card(dev, m, n, k):
    """Ragged edges in rows, columns and the contraction (k = 13 and 1001
    take the scalar-load path, 256 the float4 path)."""
    gen = torch.Generator().manual_seed(m * 1000 + k)
    u1 = torch.randn(m, k, generator=gen).to(dev)
    s2 = torch.randn(n, k, generator=gen).to(dev)
    q11 = (u1 * u1).sum(1)
    q22 = (s2 * s2).sum(1)
    s0 = torch.tensor(0.7, device=dev)
    before = gram_cuda.launches
    K = gram_cuda.acos_gram(u1, s2, q11, q22, s0)
    torch.cuda.synchronize()
    assert gram_cuda.launches == before + 1
    ref = gram_cuda.acos_gram_torch(u1, s2, q11, q22, s0)
    assert float((K - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_theta_gradient_through_kernel_matches_plain(dev):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(48, 16 * 16, generator=gen).to(dev)
    vals = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
            "-2log2beta": 1.0, "-log2rho2": 2.0, "Amp": 1.3}

    def grads(backend):
        th = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in vals.items()}
        Kt, K, _ = kernels.gram_matrices(th, x, x[:20], 16, shared=False,
                                         backend=backend)
        w = torch.linspace(-1.0, 1.0, K.numel(), device=dev)
        loss = Kt.sum() + (K.reshape(-1) * w).sum()
        return torch.stack(torch.autograd.grad(loss, list(th.values())))

    g_kernel, g_plain = grads("cuda"), grads("torch")
    assert float((g_kernel - g_plain).abs().max()
                 / g_plain.abs().max()) <= 1e-3


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(dev):
    u1 = torch.randn(8, 32, device=dev)
    s2 = torch.randn(4, 32, device=dev)
    q11, q22 = (u1 * u1).sum(1), (s2 * s2).sum(1)
    s0 = torch.tensor(0.5, device=dev)
    with pytest.raises(TypeError):
        gram_cuda.acos_gram(u1.double(), s2.double(), q11.double(),
                            q22.double(), s0.double())
    with pytest.raises(ValueError):
        gram_cuda.acos_gram(u1, s2[:, :16], q11, q22, s0)
