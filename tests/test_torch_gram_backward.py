"""The fused Gram's backward (gaussian_processes_tpu_torch/ops/gram_cuda.py)
against the JAX package, on the same numpy inputs.

The plain backward epilogue ``acos_gram_bwd_torch`` takes the q12 at which
the forward computed K; it is held against ``jax.vjp`` of the JAX package's
XLA assembly ``_acos_from_quads`` (``gaussian_processes_tpu/ops/kernels.py``)
at the same q11, q22, q12 and sigma0, for dL/dq12, dL/dq11, dL/dq22 and
dL/dsigma0: rtol 1e-10 in float64 (the same formulas, other summation
orders), 1e-5 in float32, each with an absolute floor of the same multiple
of the largest gradient entry (the row and column sums cancel).  The cases:
generic cosines, cosines clipped exactly at +-1 (where the clip passes half
the gradient, as ``jnp.clip``'s tie rule does), |ratio| > 1 (no gradient
through c), and a batch of items with their own sigma0 (JAX item by item).
Also the plain full backward ``gram_backward_torch`` (the epilogue, then
dU1 = dq12 S2 and dS2 = dq12^T U1) against ``jax.vjp`` with q12 formed
from U1 and S2 inside, the plain versions of the transposing split pass
and of the product, the forward's q12 output, and the wrapper's routing
and counters on CPU tensors.  The kernels themselves are held to these plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu_torch.ops import gram_cuda

torch.set_num_threads(1)

RTOL = {np.float64: 1e-10, np.float32: 1e-5}
JITTER = 1e-7


def generic(rng, m, n, k, dtype, batch=None):
    """q11, q22, q12 of random rows, the norms scaled apart so that every
    cosine sits inside (-1, 1)."""
    lead = () if batch is None else (batch,)
    u1 = rng.standard_normal(lead + (m, k))
    s2 = rng.standard_normal(lead + (n, k))
    q11 = (u1 * u1).sum(-1) * 1.3
    q22 = (s2 * s2).sum(-1) * 0.8
    q12 = u1 @ np.swapaxes(s2, -1, -2)
    return [a.astype(dtype) for a in (q11, q22, q12)]


def at_ratio(dtype, ratios):
    """q11 (3,), q22 (4,), q12 (3, 4) and sigma0 0.5, built so that the
    entries where ``ratios`` is given have (q12 + s0^2) / (X1 X2 + 1e-7)
    exactly that value in ``dtype`` arithmetic (X1, X2 and their product
    are exact there), the others generic."""
    s0 = dtype(0.5)
    s02 = s0 * s0
    q11 = np.array([3.75, 1.0, 2.0], dtype)     # X1 = 2, ~1.118, 1.5
    q22 = np.array([2.0, 0.75, 3.75, 1.5], dtype)  # X2 = 1.5, 1, 2, ~1.32
    X1 = np.sqrt(q11 + s02)
    X2 = np.sqrt(q22 + s02)
    den = X1[:, None] * X2[None, :] + dtype(JITTER)
    q12 = (np.linspace(-0.6, 0.7, 12).astype(dtype).reshape(3, 4) * den
           - s02)
    for (i, j), r in ratios.items():
        q12[i, j] = dtype(r) * den[i, j] - s02
    ratio = (q12 + s02) / den
    for (i, j), r in ratios.items():
        assert ratio[i, j] == dtype(r), (i, j, ratio[i, j])
    return q11, q22, q12, s0


def jax_grads(g, q11, q22, q12, s0):
    """jax.vjp of _acos_from_quads (2-D) at these inputs: dq12, dq11, dq22,
    dsigma0."""
    def f(th, a, b, c):
        return jk._acos_from_quads(th, a, b, c, symmetrize=False)
    _, vjp = jax.vjp(f, {"sigma_0": jnp.asarray(s0)}, jnp.asarray(q11),
                     jnp.asarray(q22), jnp.asarray(q12))
    dth, d11, d22, d12 = vjp(jnp.asarray(g))
    return [np.asarray(a) for a in (d12, d11, d22, dth["sigma_0"])]


def torch_grads(g, q11, q22, q12, s0):
    out = gram_cuda.acos_gram_bwd_torch(*(torch.as_tensor(np.asarray(a))
                                          for a in (g, q12, q11, q22, s0)))
    return [t.numpy() for t in out]


def assert_close(got, want, dtype, what):
    rtol = RTOL[dtype]
    for name, a, b in zip(("dq12", "dq11", "dq22", "dsigma0"), got, want):
        assert a.dtype == dtype and a.shape == np.shape(b), (what, name)
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * float(np.max(np.abs(b))),
            err_msg=f"{what}: {name}")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_backward_matches_jax_vjp_generic(dtype):
    rng = np.random.default_rng(0)
    q11, q22, q12 = generic(rng, 7, 5, 12, dtype)
    s0 = dtype(0.7)
    g = rng.standard_normal((7, 5)).astype(dtype)
    assert_close(torch_grads(g, q11, q22, q12, s0),
                 jax_grads(g, q11, q22, q12, s0), dtype, "generic")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_backward_matches_jax_vjp_clipped_exactly_at_the_bounds(dtype):
    """Entries whose cosine is exactly +1 or -1: the clip passes half the
    gradient there (1 inside, 0 beyond), in both packages."""
    q11, q22, q12, s0 = at_ratio(dtype, {(0, 0): 1.0, (0, 2): -1.0,
                                         (2, 1): 1.0, (2, 0): -1.0})
    g = np.random.default_rng(1).standard_normal((3, 4)).astype(dtype)
    got = torch_grads(g, q11, q22, q12, s0)
    assert_close(got, jax_grads(g, q11, q22, q12, s0), dtype, "at +-1")
    assert np.all(np.isfinite(np.concatenate([np.ravel(a) for a in got])))
    # the half: dq12 at the bound is half of its value just inside
    inside = torch_grads(g, q11, q22, q12 - dtype(1e-3) * np.sign(q12), s0)
    assert 0.4 < got[0][0, 0] / inside[0][0, 0] < 0.6


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_backward_matches_jax_vjp_beyond_the_bounds(dtype):
    """|ratio| > 1: c is clipped, so no gradient reaches q12 there, while
    q11, q22 and sigma0 still get X1 X2's part."""
    q11, q22, q12, s0 = at_ratio(dtype, {(0, 0): 1.25, (0, 2): -1.5,
                                         (2, 1): 2.0, (1, 3): -1.125})
    g = np.random.default_rng(2).standard_normal((3, 4)).astype(dtype)
    got = torch_grads(g, q11, q22, q12, s0)
    assert_close(got, jax_grads(g, q11, q22, q12, s0), dtype, "beyond")
    assert got[0][0, 0] == 0 and got[0][0, 2] == 0 and got[0][2, 1] == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_backward_batch_matches_jax_item_by_item(dtype):
    rng = np.random.default_rng(3)
    q11, q22, q12 = generic(rng, 6, 9, 10, dtype, batch=3)
    s0 = np.array([0.7, 1.1, 0.4], dtype)
    g = rng.standard_normal((3, 6, 9)).astype(dtype)
    got = torch_grads(g, q11, q22, q12, s0)
    for b in range(3):
        assert_close([a[b] for a in got],
                     jax_grads(g[b], q11[b], q22[b], q12[b], s0[b]), dtype,
                     f"item {b}")


@pytest.mark.parametrize("shape", [(5, 7), (4, 9), (2, 3, 13), (1, 1)])
def test_transposing_split_plain_version(shape):
    """big + small is a^T exactly, big keeps 10 mantissa bits (the low 13
    are zero), and the rows past rows (up to a multiple of 4) are zero."""
    a = torch.as_tensor(np.random.default_rng(4).standard_normal(shape),
                        dtype=torch.float32)
    rows, cols = shape[-2:]
    buf = gram_cuda.tf32_split_t_torch(a)
    rowsp = -(-rows // 4) * 4
    assert buf.shape == (2,) + shape[:-2] + (cols, rowsp)
    big, small = buf[0], buf[1]
    assert torch.equal(big[..., :rows] + small[..., :rows], a.mT)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool((buf[..., rows:] == 0).all())
    # the same planes as the split pass of a^T
    want_big, want_small = gram_cuda.tf32_split_torch(a.mT.contiguous())
    assert torch.equal(big[..., :rows], want_big)
    assert torch.equal(small[..., :rows], want_small)


def test_product_plain_version():
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((3, 6, 11)))
    b = torch.as_tensor(rng.standard_normal((3, 4, 11)))
    want = torch.matmul(a, b.transpose(1, 2))
    assert torch.equal(gram_cuda.nt_product_torch(a, b), want)


def _operands(dtype=torch.float64, batch=None, grad=False):
    rng = np.random.default_rng(6)
    lead = () if batch is None else (batch,)
    u1 = rng.standard_normal(lead + (7, 10))
    s2 = rng.standard_normal(lead + (5, 10))
    q11 = (u1 * u1).sum(-1) * 1.2
    q22 = (s2 * s2).sum(-1) * 0.9
    s0 = 0.6 if batch is None else np.linspace(0.5, 1.0, batch)
    return [torch.tensor(x, dtype=dtype, requires_grad=grad)
            for x in (u1, s2, q11, q22, s0)]


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_with_and_without_q12_is_the_same_on_cpu(batch, dtype):
    ops = _operands(dtype, batch)
    K = gram_cuda._forward(*ops)
    K2, q12 = gram_cuda._forward(*ops, keep_q12=True)
    assert torch.equal(K, K2)
    assert torch.equal(K, gram_cuda.acos_gram_torch(*ops))
    assert torch.equal(q12, ops[0] @ ops[1].mT)


@pytest.mark.parametrize("batch", [None, 3])
def test_gram_backward_on_cpu_is_the_plain_backward_and_products(batch):
    """``gram_backward`` on CPU tensors: the plain epilogue at the given q12
    and the plain products, and AcosGram's gradient is that; the plain
    backward's CUDA-call count stays 0 on the CPU."""
    u1, s2, q11, q22, s0 = _operands(batch=batch)
    rng = np.random.default_rng(7)
    g = torch.as_tensor(rng.standard_normal((() if batch is None
                                             else (batch,)) + (7, 5)))
    q12 = u1 @ s2.mT
    gram_cuda.reset_counts()
    got = gram_cuda.gram_backward(g, u1, s2, q11, q22, s0, q12)
    dq12, dq11, dq22, dsig = gram_cuda.acos_gram_bwd_torch(g, q12, q11, q22,
                                                           s0)
    for a, b, c in zip(got, (dq12 @ s2, dq12.mT @ u1, dq11, dq22, dsig),
                       gram_cuda.gram_backward_torch(g, u1, s2, q11, q22, s0,
                                                     q12)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert got[4].shape == s0.shape
    none = gram_cuda.gram_backward(g, u1, s2, q11, q22, s0, q12,
                                   need_u1=False, need_s2=False)
    assert none[0] is None and none[1] is None
    ops = _operands(batch=batch, grad=True)
    K = gram_cuda.acos_gram(*ops)
    assert type(K.grad_fn).__name__ == "AcosGramBackward"
    grads = torch.autograd.grad((K * g).sum(), ops)
    for a, b in zip(grads, got):
        assert torch.equal(a, b)
    counts = gram_cuda.read_counts()
    assert counts["plain_bwd_cuda"] == 0
    assert (counts["bwd"], counts["split_t"], counts["product"]) == (0, 0, 0)
    assert counts["bwd_shapes"] == {} and counts["product_shapes"] == {}


def test_no_gradient_no_graph():
    """Without a gradient the wrapper builds no autograd node and keeps no
    q12; under no_grad the same, even for inputs that require one."""
    ops = _operands()
    assert gram_cuda.acos_gram(*ops).grad_fn is None
    with torch.no_grad():
        assert gram_cuda.acos_gram(*_operands(grad=True)).grad_fn is None


def jax_full_grads(g, u1, s2, q11, q22, s0):
    """jax.vjp of _acos_from_quads (2-D) with q12 = u1 s2^T formed inside:
    du1, ds2, dq11, dq22, dsigma0."""
    def f(th, a, b, c, d):
        return jk._acos_from_quads(th, c, d, a @ b.T, symmetrize=False)
    _, vjp = jax.vjp(f, {"sigma_0": jnp.asarray(s0)}, jnp.asarray(u1),
                     jnp.asarray(s2), jnp.asarray(q11), jnp.asarray(q22))
    dth, du1, ds2, d11, d22 = vjp(jnp.asarray(g))
    return [np.asarray(a) for a in (du1, ds2, d11, d22, dth["sigma_0"])]


@pytest.mark.parametrize("case", ["2-D", "batch of 3", "square, u1 is s2"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_full_backward_matches_jax_vjp(dtype, case):
    """``gram_backward_torch`` (the plain epilogue at u1 s2^T, then the two
    products) against jax.vjp through the JAX package's assembly with q12
    formed from u1 and s2, for du1, ds2, dq11, dq22 and dsigma0; with
    need_u1 / need_s2 off the skipped gradient is None and the rest the
    same bits."""
    rng = np.random.default_rng(8)
    batch = 3 if case == "batch of 3" else None
    lead = () if batch is None else (batch,)
    m, n, k = (9, 9, 14) if case.startswith("square") else (8, 6, 15)
    u1 = rng.standard_normal(lead + (m, k)).astype(dtype)
    s2 = u1 if case.startswith("square") else rng.standard_normal(
        lead + (n, k)).astype(dtype)
    q11 = ((u1 * u1).sum(-1) * 1.2).astype(dtype)
    q22 = ((s2 * s2).sum(-1) * 0.9).astype(dtype)
    s0 = (np.array([0.5, 0.8, 1.1], dtype) if batch else dtype(0.6))
    g = rng.standard_normal(lead + (m, n)).astype(dtype)
    t = [torch.as_tensor(np.asarray(a)) for a in (g, u1, s2, q11, q22, s0)]
    got = gram_cuda.gram_backward_torch(*t, t[1] @ t[2].mT)
    names = ("du1", "ds2", "dq11", "dq22", "dsigma0")
    for b in ([None] if batch is None else range(batch)):
        want = jax_full_grads(*(a if b is None else a[b]
                                for a in (g, u1, s2, q11, q22, s0)))
        for name, a, w in zip(names, got, want):
            a = a.numpy() if b is None else a[b].numpy()
            assert a.dtype == dtype and a.shape == np.shape(w), name
            rtol = RTOL[dtype]
            np.testing.assert_allclose(
                a, w, rtol=rtol, atol=rtol * float(np.max(np.abs(w))),
                err_msg=f"{case}, item {b}: {name}")
    u1_only = gram_cuda.gram_backward_torch(*t, t[1] @ t[2].mT,
                                            need_s2=False)
    s2_only = gram_cuda.gram_backward_torch(*t, t[1] @ t[2].mT,
                                            need_u1=False)
    assert u1_only[1] is None and s2_only[0] is None
    assert torch.equal(u1_only[0], got[0]) and torch.equal(s2_only[1], got[1])
    for a, b, c in zip(got[2:], u1_only[2:], s2_only[2:]):
        assert torch.equal(a, b) and torch.equal(a, c)
