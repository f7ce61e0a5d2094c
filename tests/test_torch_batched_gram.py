"""The batched Gram (one item per (cell, line-search trial) of the
population fit) against the same Gram item by item, float64 on the CPU.

A batch is theta as a dict of (B,) tensors, per-item crop corners with one
shared side, and stimuli shared by all items or given per item.  Each
item of the batched result must equal the 2-D call on that item's
arguments to rtol 1e-12 (the same products, batched by torch.matmul); the
batched AcosGram's hand backward passes gradcheck and agrees with the
autograd of its plain batched forward to rtol 1e-10.  backend="cuda" on
CPU tensors runs the wrapper's plain forward and the hand backward; the
kernel itself is held to it on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from gaussian_processes_tpu_torch.ops import gram_cuda
from gaussian_processes_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

N = 16
B = 3
THETAS = {"sigma_0": [1.0, 0.7, 1.4], "eps_0x": [0.1, -0.3, 0.25],
          "eps_0y": [-0.2, 0.3, 0.0],
          "-2log2beta": list(-2 * np.log(2 * np.array([0.15, 0.1, 0.2]))),
          "-log2rho2": list(-np.log(2 * np.array([0.18, 0.1, 0.25]) ** 2)),
          "Amp": [1.3, 0.8, 1.0]}


def batch_theta():
    return {k: torch.tensor(v, dtype=torch.float64) for k, v in THETAS.items()}


def item(theta, b):
    return {k: v[b] for k, v in theta.items()}


def images(seed, n):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, N * N)))


def close(t, want, rtol=1e-12, atol=1e-13):
    np.testing.assert_allclose(t.detach().numpy(), want.detach().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_full_frame_grams_equal_item_by_item(shared, backend):
    x = images(1, 20)
    xt = x if shared else images(2, 9)
    th = batch_theta()
    out = tk.gram_matrices(th, x, xt, N, shared, backend=backend)
    assert out[0].shape == (B, xt.shape[0], xt.shape[0])
    assert out[1].shape == (B, x.shape[0], xt.shape[0])
    for b in range(B):
        want = tk.gram_matrices(item(th, b), x, xt, N, shared,
                                backend=backend)
        for got, w in zip(out, want):
            close(got[b], w)


def test_per_item_crops_and_coordinates_equal_item_by_item():
    x = images(3, 7)
    i0s, j0s, w = torch.tensor([0, 4, 2]), torch.tensor([3, 0, 6]), 10
    xc = tk.crop_images(x, i0s, j0s, w, N)
    assert xc.shape == (B, 7, w * w) and xc.is_contiguous()
    coords = tk.window_coords(i0s, j0s, w, N, torch.float64)
    for b in range(B):
        i0, j0 = int(i0s[b]), int(j0s[b])
        assert torch.equal(xc[b], tk.crop_images(x, i0, j0, w, N))
        for got, want in zip(coords, tk.window_coords(i0, j0, w, N,
                                                      torch.float64)):
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_precropped_grams_equal_item_by_item(shared, backend):
    """Per-item corners, one side: each item's Grams are the 2-D
    pre-cropped call at its own corner."""
    x = images(4, 15)
    xt = x if shared else images(5, 8)
    i0s, j0s, w = torch.tensor([2, 5, 0]), torch.tensor([4, 1, 6]), 10
    xc = tk.crop_images(x, i0s, j0s, w, N)
    xtc = xc if shared else tk.crop_images(xt, i0s, j0s, w, N)
    th = batch_theta()
    out = tk.gram_matrices_precropped(th, xc, xtc, N, shared, i0s, j0s, w,
                                      backend=backend)
    for b in range(B):
        i0, j0 = int(i0s[b]), int(j0s[b])
        want = tk.gram_matrices_precropped(
            item(th, b), tk.crop_images(x, i0, j0, w, N),
            tk.crop_images(xt, i0, j0, w, N), N, shared, i0, j0, w,
            backend=backend)
        for got, wnt in zip(out, want):
            close(got[b], wnt)


def test_batched_smooth_apply_equals_item_by_item():
    rng = np.random.default_rng(6)
    S = torch.as_tensor(rng.standard_normal((B, N, N)))
    Sx = torch.as_tensor(rng.standard_normal((B, N, N)))
    w = torch.as_tensor(rng.standard_normal((B, 5, N * N)))
    got = tk.smooth_apply(S, w, N, Sx)
    for b in range(B):
        close(got[b], tk.smooth_apply(S[b], w[b], N, Sx[b]))


def _batched_inputs(grad=True):
    rng = np.random.default_rng(13)
    u1 = rng.standard_normal((2, 5, 12))
    s2 = rng.standard_normal((2, 4, 12))
    q11 = (u1 * u1).sum(-1) * 1.3
    q22 = (s2 * s2).sum(-1) * 0.8
    return tuple(torch.tensor(a, dtype=torch.float64, requires_grad=grad)
                 for a in (u1, s2, q11, q22, [0.7, 1.1]))


def test_batched_acos_gram_gradcheck():
    assert torch.autograd.gradcheck(gram_cuda.acos_gram, _batched_inputs())


def test_batched_hand_backward_equals_plain_autograd():
    """AcosGram's backward against autograd through acos_gram_torch, on a
    batch whose items have their own sigma0."""
    a = _batched_inputs()
    b = _batched_inputs()
    W = torch.as_tensor(np.random.default_rng(14).standard_normal((2, 5, 4)))
    ga = torch.autograd.grad((gram_cuda.acos_gram(*a) * W).sum(), a)
    gb = torch.autograd.grad((gram_cuda.acos_gram_torch(*b) * W).sum(), b)
    for x, y in zip(ga, gb):
        close(x, y, rtol=1e-10, atol=1e-12)
    K = gram_cuda.acos_gram(*(t.detach() for t in a))
    for i in range(2):
        close(K[i], gram_cuda.acos_gram_torch(*(t.detach()[i] for t in a)))


def test_out_writes_a_row_block_in_place():
    """out= on CPU tensors: the plain forward copied into the view; rows
    outside it untouched; no gradient through out=."""
    u1, s2, q11, q22, s0 = (t.detach() for t in _batched_inputs(False))
    x, q = s2[0], q22[0]
    K = torch.full((4, 4), -7.0, dtype=torch.float64)
    got = gram_cuda.acos_gram(x[1:3], x, q[1:3], q, s0[0], out=K[1:3])
    assert got.data_ptr() == K[1:3].data_ptr()
    close(K[1:3], gram_cuda.acos_gram_torch(x[1:3], x, q[1:3], q, s0[0]))
    assert torch.all(K[0] == -7.0) and torch.all(K[3] == -7.0)
    with pytest.raises(ValueError, match="gradient"):
        gram_cuda.acos_gram(x[1:3], x, q[1:3], q,
                            torch.tensor(0.7, dtype=torch.float64,
                                         requires_grad=True), out=K[1:3])
