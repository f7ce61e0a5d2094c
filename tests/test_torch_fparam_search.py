"""The E-step's f-param search (ops/fparam_search.py) on the CPU, float64,
against autograd and against the JAX package's search.

(a) The closed-form value and logA derivative that the kernel computes
(``fparam_value_and_grad_torch``) against autograd through the port's
``_fparam_objective``, with and without padded rows: 1e-12 relative.
(b) ``fparam_search`` on CPU tensors (its plain version, the host-driven
zoom L-BFGS) against JAX's ``lbfgs_minimize`` on JAX's
``_fparam_objective``, 10 steps at max_linesearch_steps 15 and 4: the same
trial points (1e-9) in the same order up to convergence, the best value
1e-13 relative and logA 1e-10 apart; at 4 trials also the same number of
evaluations in all.  At 15, once both searches sit at the minimum their
trials are decided by last-ulp differences between XLA's and PyTorch's
evaluation of the objective, so the number of evaluations after that
point is not compared (weighted case: 65 for JAX, 79 for the port).
(c) The fit's E-step on CPU tensors takes the route through
``fparam_search`` under the zoom searches, and never loads the kernel's
library.  (d) ``utils.tracing.objective_counts`` counts the plain route's
evaluations, and adds what the kernel's device counters gained.
(e) The kernel's reduction tree, emulated in numpy: a block of 32, 128 or
256 threads, each carrying 1024 / THREADS virtual threads, reduces the max,
a sum and three sums bit for bit as the block of 1024 threads did, in
float32 and float64, at nt 1 to 3161, with and without weight-0 rows.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from gaussian_processes_tpu.models import fit as jf
from gaussian_processes_tpu.optim import lbfgs as jl
from gaussian_processes_tpu_torch.config import FitConfig as TCfg
from gaussian_processes_tpu_torch.models import fit as tf
from gaussian_processes_tpu_torch.ops import fparam_search as fs
from gaussian_processes_tpu_torch.optim.lbfgs import lbfgs_minimize
from gaussian_processes_tpu_torch.utils.tracing import objective_counts

from test_torch_fit import FP0, NTILDE, STEPS, THETA0, planted

torch.set_num_threads(1)

NT, PAD, STEPS_F = 64, 4, 10
LOGA0 = float(np.log(0.01))


@pytest.fixture(scope="module")
def moments():
    """Moments and responses whose best logA (~ -1.2) lies far from the
    start log(0.01), so the search takes several steps and zooms; the
    weight zeroes the last PAD rows, as the active loop's buffer does."""
    rng = np.random.default_rng(0)
    lm = rng.standard_normal(NT)
    lv = rng.uniform(0.1, 0.5, NT)
    r = rng.poisson(np.exp(0.4 * lm + 0.08 * lv + 0.2)).astype(float)
    w = np.ones(NT)
    w[-PAD:] = 0.0
    return dict(r=r, lm=lm, lv=lv, w=w)


def _args(m, weighted, lib=torch):
    conv = torch.as_tensor if lib is torch else jnp.asarray
    return (conv(m["r"]), conv(m["lm"]), conv(m["lv"]),
            conv(m["w"]) if weighted else None)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("logA", [-4.0, -1.2, 0.5])
def test_closed_form_value_and_grad_match_autograd(moments, weighted, logA):
    r, lm, lv, wt = _args(moments, weighted)
    x = torch.tensor(logA, dtype=torch.float64, requires_grad=True)
    with torch.enable_grad():
        v = tf._fparam_objective(x, r, lm, lv, wt=wt)
        (g,) = torch.autograd.grad(v, x)
    v = v.detach()
    v2, g2 = fs.fparam_value_and_grad_torch(x.detach(), r, lm, lv, wt)
    assert abs(float(v2 - v)) <= 1e-12 * abs(float(v))
    assert abs(float(g2 - g)) <= 1e-12 * abs(float(g))


def _converged_at(trials, f_best):
    """Index of the first evaluation whose value is within 1e-12 relative
    of the search's best (from there on rounding decides the trials)."""
    return next(i for i, (_, v) in enumerate(trials)
                if abs(v - f_best) <= 1e-12 * abs(f_best))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("max_ls", [15, 4])
def test_search_matches_jax(moments, monkeypatch, weighted, max_ls):
    jax_trials = []
    jr, jlm, jlv, jw = _args(moments, weighted, jnp)

    def jfun(logA):
        v = jf._fparam_objective(logA, jr, jlm, jlv, wt=jw)
        jax.debug.callback(
            lambda x, y: jax_trials.append((float(x), float(y))), logA, v)
        return v

    xj, fj = jl.lbfgs_minimize(jfun, jnp.float64(LOGA0), STEPS_F,
                               max_linesearch_steps=max_ls)
    port_trials = []
    real = tf._fparam_objective

    def record(logA, *args, **kwargs):
        v = real(logA, *args, **kwargs)
        port_trials.append((float(logA.detach()), float(v.detach())))
        return v

    monkeypatch.setattr(tf, "_fparam_objective", record)
    r, lm, lv, wt = _args(moments, weighted)
    xt, ft = fs.fparam_search(torch.tensor(LOGA0, dtype=torch.float64), r,
                              lm, lv, wt, STEPS_F, max_ls)
    assert fs.launches == 0
    assert abs(float(xt) - float(xj)) <= 1e-10
    assert abs(float(ft) - float(fj)) <= 1e-13 * abs(float(fj))
    k = _converged_at(jax_trials, float(fj))
    assert _converged_at(port_trials, float(ft)) == k
    got = np.array(port_trials[:k + 1])
    want = np.array(jax_trials[:k + 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-9)
    if max_ls == 4:
        assert len(port_trials) == len(jax_trials)


def test_plain_version_is_lbfgs_minimize_on_the_objective(moments):
    r, lm, lv, wt = _args(moments, True)
    x0 = torch.tensor(LOGA0, dtype=torch.float64)
    want = lbfgs_minimize(
        lambda a: tf._fparam_objective(a, r, lm, lv, wt=wt), x0, STEPS_F,
        max_linesearch_steps=4)
    for backend in (None, "cuda", "torch"):
        got = fs.fparam_search(x0, r, lm, lv, wt, STEPS_F, 4, backend=backend)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        fs.fparam_search(x0, r, lm, lv, wt, STEPS_F, 4, backend="triton")


@pytest.mark.parametrize("case", ["dtype", "mixed", "length", "logA",
                                  "steps", "strided"])
def test_wrapper_check_refuses_what_the_kernel_cannot_take(moments, case):
    r, lm, lv, wt = _args(moments, True)
    x0 = torch.tensor(LOGA0, dtype=torch.float64)
    args = [x0, r, lm, lv, wt, STEPS_F, 15]
    if case == "dtype":
        args[1:5] = [t.to(torch.float16) for t in args[1:5]]
    elif case == "mixed":
        args[2] = lm.float()
    elif case == "length":
        args[3] = lv[:-1]
    elif case == "logA":
        args[0] = torch.zeros(2, dtype=torch.float64)
    elif case == "steps":
        args[5] = -1
    else:
        args[1] = torch.stack([r, r], 1)[:, 0]
    with pytest.raises((TypeError, ValueError)):
        fs._check(*args)
    assert fs._check(x0, r, lm, lv, wt, STEPS_F, 15) == NT


@pytest.fixture(scope="module")
def problem():
    x, lam, rng = planted(24, 256, 0)
    r = rng.poisson(lam).astype(float)
    idx = rng.permutation(256)[:NTILDE]
    return torch.as_tensor(x), torch.as_tensor(r), torch.as_tensor(idx)


@pytest.mark.parametrize("linesearch,routed", [
    ("zoom", True), ("zoom_carry", True), ("backtracking", False),
    ("speculative", False), ("armijo", False)])
def test_estep_routes_zoom_searches_and_never_loads_the_kernel(
        problem, monkeypatch, linesearch, routed):
    x, r, idx = problem
    calls = []
    real = tf.fparam_search

    def spy(*args, **kwargs):
        calls.append(args[0].device)
        return real(*args, **kwargs)

    def refuse():
        raise AssertionError("the kernel library was loaded on the CPU")

    monkeypatch.setattr(tf, "fparam_search", spy)
    monkeypatch.setattr(fs, "load_library", refuse)
    launches = fs.launches
    res = tf.fit(x, r, TCfg(ntilde=NTILDE, linesearch=linesearch, **STEPS),
                 xtilde=x[idx], theta=THETA0, f_params=FP0)
    assert not res.failed
    assert fs.launches == launches == 0
    n_searches = (STEPS["maxiter"] - 1) * STEPS["n_estep"]
    assert len(calls) == (n_searches if routed else 0)


def test_objective_counts_counts_the_plain_routes_evaluations(moments):
    r, lm, lv, wt = _args(moments, True)
    x0 = torch.tensor(LOGA0, dtype=torch.float64)
    n = [0]

    def counted(a):
        n[0] += 1
        return tf._fparam_objective(a, r, lm, lv, wt=wt)

    lbfgs_minimize(counted, x0, STEPS_F, max_linesearch_steps=15)
    with objective_counts() as counts:
        fs.fparam_search(x0, r, lm, lv, wt, STEPS_F, 15)
    assert counts["fparam"] == n[0] > STEPS_F


def test_objective_counts_adds_the_device_counters(monkeypatch):
    """The kernel's running counters (one per device; CPU tensors stand in
    for them here) are read at the block's exit: what they gained inside
    the block is added to "fparam", a counter first made inside the block
    counts whole."""
    dev_a, dev_b = torch.device("cpu"), torch.device("meta")
    counters = {dev_a: torch.tensor(40, dtype=torch.int64)}
    monkeypatch.setattr(fs, "_counters", counters)
    with objective_counts() as counts:
        counters[dev_a] += 7
        counters[dev_b] = torch.tensor(5, dtype=torch.int64)
    assert counts["fparam"] == 12


# ---------------------------------------------------------------------------
# The kernel's reduction tree (csrc/fparam_lbfgs.cu), emulated in numpy
# ---------------------------------------------------------------------------

LANES = np.arange(32)


def _combine(a, b, is_max):
    """One node of the tree: a + b, or the NaN-propagating max (a > b ? a :
    b, NaN when either is NaN), in the operands' type."""
    if not is_max:
        return a + b
    out = np.where(a > b, a, b)
    return np.where(np.isnan(a) | np.isnan(b), np.nan, out).astype(a.dtype)


def _virtual_partials(vals, keep, is_max):
    """(1024, N): virtual thread v's own reduction of its rows v, v + 1024,
    ... that count, in that order (init 0, or -inf for the max)."""
    acc = np.full((1024, vals.shape[1]), -np.inf if is_max else 0,
                  vals.dtype)
    for base in range(0, len(vals), 1024):
        chunk, k = vals[base:base + 1024], keep[base:base + 1024, None]
        n = len(chunk)
        acc[:n] = np.where(k, _combine(acc[:n], chunk, is_max), acc[:n])
    return acc


def _butterfly(x, is_max, offsets=(16, 8, 4, 2, 1)):
    """The xor butterfly over the lane axis (-2): every lane adds its
    partner's value to its own."""
    for off in offsets:
        x = _combine(x, x[..., LANES ^ off, :], is_max)
    return x


def _reduce_1024(vals, keep, is_max):
    """The 1024-thread block's reduction (the kernel's first version,
    commit f0bea62): 32 warps of 32 threads, each warp's
    butterfly, lane 0's partials, warp 0's butterfly, lane 0's result."""
    acc = _virtual_partials(vals, keep, is_max).reshape(32, 32, -1)
    return _butterfly(_butterfly(acc, is_max)[:, 0], is_max)[0]


def _reduce_layout(vals, keep, is_max, threads):
    """The kernel's block_reduce at THREADS = ``threads``: thread w * 32 + L
    holds virtual threads w * 32 + L + threads k; the butterfly's levels at
    offsets 16, 8, ... halve the accumulators a lane holds (lower lane's
    value first), the rest is the butterfly, which leaves virtual warp w +
    warps k on lanes k * warps.. of warp w; the levels of warp 0's pass
    that pair virtual warps of one warp (offsets 16 down to warps) run in
    the warp on lane 0, the last ones over the warps' partials."""
    vpt, warps = 1024 // threads, threads // 32
    acc = _virtual_partials(vals, keep, is_max)
    v = acc.reshape(vpt, warps, 32, -1).transpose(1, 2, 0, 3)
    levels = vpt.bit_length() - 1
    for s in range(levels):
        off, half = 16 >> s, vpt >> (s + 1)
        upper = ((LANES & off) != 0)[None, :, None, None]
        lo, hi = v[:, :, :half], v[:, :, half:2 * half]
        o = np.where(upper, lo, hi)[:, LANES ^ off]
        v = np.where(upper, _combine(o, hi, is_max),
                     _combine(lo, o, is_max))
    v = _butterfly(v[:, :, 0], is_max,
                   [16 >> s for s in range(levels, 5)])
    v = _butterfly(v, is_max, [off for off in (16, 8, 4, 2, 1)
                               if off >= warps])
    t = v[:, 0]
    off = warps // 2
    while off:
        t = _combine(t[:off], t[off:2 * off], is_max)
        off //= 2
    return t[0]


def _tree_inputs(nt, weighted, dtype, seed=7):
    """Rows of mixed sign spread over six decades (so that the order of a
    float sum shows in its bits), and which of them count."""
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal((nt, 3))
            * 10.0 ** rng.uniform(-3, 3, (nt, 3))).astype(dtype)
    keep = np.ones(nt, bool)
    if weighted:
        keep[rng.random(nt) < 0.1] = False
        keep[-4:] = False
    return vals, keep


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nt", [1, 31, 254, 3160, 3161])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("threads", [32, 128, 256])
def test_reduction_layout_keeps_the_1024_thread_trees_bits(
        threads, dtype, nt, weighted):
    """The kernel's block of THREADS threads reduces in the order of the
    block of 1024 threads: the max of one value, the sum of one and the sums of
    three, bit for bit (the bits of the results as integers)."""
    vals, keep = _tree_inputs(nt, weighted, dtype)
    for is_max, cols in ((True, [0]), (False, [1]), (False, [0, 1, 2])):
        v = np.ascontiguousarray(vals[:, cols])
        want = _reduce_1024(v, keep, is_max)
        got = _reduce_layout(v, keep, is_max, threads)
        assert got.dtype == want.dtype == dtype
        assert np.array_equal(got.view(f"u{got.itemsize}"),
                              want.view(f"u{want.itemsize}")), (is_max, cols)


def test_reduction_inputs_tell_sum_orders_apart():
    """The rows above do tell orders apart: in float32 the tree's sum is not
    the sequential one's, nor the tree's of the rows reversed."""
    vals, keep = _tree_inputs(3160, False, np.float32)
    v = np.ascontiguousarray(vals[:, [1]])
    tree = _reduce_1024(v, keep, False)[0]
    seq = np.float32(0)
    for x in v[:, 0]:
        seq = np.float32(seq + x)
    assert tree != seq
    assert tree != _reduce_1024(v[::-1].copy(), keep, False)[0]
