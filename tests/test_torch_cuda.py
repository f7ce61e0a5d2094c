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
                                   (257, 300, 1001), (30, 2100, 11664),
                                   (64, 200, 31), (300, 260, 1002)])
def test_kernel_matches_plain_on_card(dev, m, n, k):
    """Ragged edges in rows, columns and the contraction (k = 13, 31, 1001
    and 1002 are not multiples of 4 and take the split pass's scalar path;
    13 and 31 are below one 32-float block), and the shapes the planner
    splits over k (30 x 2100 x 11664 is the prediction's K*)."""
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


def _operands(dev, m, n, k, seed):
    gen = torch.Generator().manual_seed(seed)
    u1 = torch.randn(m, k, generator=gen).to(dev)
    s2 = torch.randn(n, k, generator=gen).to(dev)
    return u1, s2, (u1 * u1).sum(1), (s2 * s2).sum(1), torch.tensor(
        0.7, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(5, 13), (37, 256), (130, 1001), (3, 1)])
def test_split_pass_matches_plain_bit_for_bit(dev, rows, k):
    """The split kernel against tf32_split_torch, NaN and inf included (the
    k = 256 case takes the float4 path)."""
    a = torch.randn(rows, k, generator=torch.Generator().manual_seed(k))
    a[0, 0] = float("nan")
    a[-1, -1] = float("inf")
    big, small = gram_cuda.tf32_split(a.to(dev))
    want_big, want_small = gram_cuda.tf32_split_torch(a)
    for got, want in ((big, want_big), (small, want_small)):
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got, nan=7.0),
                           torch.nan_to_num(want, nan=7.0))
    assert torch.isnan(small[0, 0]) and torch.isnan(small[-1, -1])


@pytest.mark.cuda
def test_nan_in_one_row_poisons_exactly_that_row(dev):
    u1, s2, q11, q22, s0 = _operands(dev, 200, 150, 1000, 1)
    u1[37, 500] = float("nan")
    K = gram_cuda.acos_gram(u1, s2, q11, q22, s0)
    bad = torch.isnan(K).cpu()
    assert bool(bad[37].all())
    bad[37] = False
    assert not bool(bad.any())
    assert bool(torch.isfinite(K[:37]).all() and torch.isfinite(K[38:]).all())


@pytest.mark.cuda
def test_sign_coherent_diagonal_at_k_11664(dev):
    """u1 = s2 with positive entries: every term of the diagonal has the
    same sign, where a biased accumulation would add up over k.  The norms
    are doubled so that c ~ 0.5 stays clear of the clip."""
    gen = torch.Generator().manual_seed(5)
    u = torch.randn(256, 11664, generator=gen).abs().to(dev)
    q = 2.0 * (u.double() * u.double()).sum(1).float()
    s0 = torch.tensor(0.5, device=dev)
    K = gram_cuda.acos_gram(u, u, q, q, s0)
    ref = gram_cuda.acos_gram_torch(u.double(), u.double(), q.double(),
                                    q.double(), s0.double())
    err = (K.diagonal().double() - ref.diagonal()).abs() / ref.diagonal()
    assert float(err.max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(130, 129, 64), (30, 200, 4096)])
def test_nothing_written_outside_out(dev, m, n, k):
    """out and the split-k workspace sit inside guard bands of a sentinel;
    the kernels write (m, n) and (splits, m, n) and nothing else (the first
    shape runs one split, the second several)."""
    u1, s2, q11, q22, s0 = _operands(dev, m, n, k, 2)
    plan = gram_cuda.plan_gram(m, n, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    guard = 4096
    sentinel = -12345.0
    out_buf = torch.full((2 * guard + m * n,), sentinel, device=dev)
    ws_buf = torch.full((2 * guard + plan.splits * m * n,), sentinel,
                        device=dev)
    out = out_buf[guard:guard + m * n].view(m, n)
    ws = ws_buf[guard:guard + plan.splits * m * n].view(plan.splits, m, n)
    gram_cuda._run(out, ws, plan, u1, s2, q11, q22, s0.reshape(1))
    torch.cuda.synchronize()
    for buf, size in ((out_buf, m * n), (ws_buf, plan.splits * m * n)):
        assert bool((buf[:guard] == sentinel).all())
        assert bool((buf[guard + size:] == sentinel).all())
    assert not bool((out == sentinel).any())
    ref = gram_cuda.acos_gram_torch(u1, s2, q11, q22, s0)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-5
    if plan.splits == 1:
        assert bool((ws == sentinel).all())
