"""The arithmetic and the work plan of the 3xTF32 Gram kernel, on the CPU
(gaussian_processes_tpu_torch/ops/gram_cuda.py).

The CUDA kernel cannot run here, so this file tests what surrounds it:

- the split pass's plain version ``tf32_split_torch``: big + small == a
  exactly, big a TF32 value, NaN and inf kept as poison;
- the 3xTF32 product the tensor cores compute, emulated in float32 from the
  split (small truncated to TF32 as the hardware reads it): against the JAX
  package's float64 Gram at a crop window built by ``_gram_core``, and on a
  sign-coherent diagonal at the full grid's k = 11664, within the kernel's
  1e-5 gate.  The single TF32 product (big * big) is recorded beside it;
- the planner ``plan_gram``: every output element covered once, each split
  a partition of [0, k), and the waves at least 85% full at the five shapes
  of the main path.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gaussian_processes_tpu.ops import kernels as jk
from gaussian_processes_tpu_torch.ops import gram_cuda
from gaussian_processes_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

GATE = 1e-5   # the kernel's agreement gate (chip_smoke.py KERNEL_RTOL)
LOW13 = 0x1FFF


def tf32_truncate(a: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 operand: the low 13
    mantissa bits dropped."""
    return (a.view(torch.int32) & ~LOW13).view(torch.float32)


def q12_3xtf32(u1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """small * big + big * small + big * big, accumulated in float32."""
    ub, us = gram_cuda.tf32_split_torch(u1)
    sb, ss = gram_cuda.tf32_split_torch(s2)
    us, ss = tf32_truncate(us), tf32_truncate(ss)
    return us @ sb.T + ub @ ss.T + ub @ sb.T


def q12_1xtf32(u1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    return gram_cuda.tf32_split_torch(u1)[0] @ gram_cuda.tf32_split_torch(
        s2)[0].T


def wide_range(seed, shape):
    """float32 values over 40 binades, both signs."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 10.0 ** rng.uniform(-20, 20, shape)
    return torch.as_tensor(a.astype(np.float32))


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_exact_and_big_is_tf32(seed):
    a = wide_range(seed, (64, 257))
    big, small = gram_cuda.tf32_split_torch(a)
    assert big.dtype == small.dtype == torch.float32
    assert torch.equal(big + small, a)
    # big keeps 10 mantissa bits, and rounding moved it by at most half a
    # TF32 ulp: |small| <= 2^-11 |a|
    assert not bool((big.view(torch.int32) & LOW13).any())
    assert bool((small.abs() <= a.abs() * 2.0 ** -11).all())
    # what the tensor cores read of small is TF32 too, within 2^-10 of it
    small_t = tf32_truncate(small)
    assert not bool((small_t.view(torch.int32) & LOW13).any())
    assert bool(((small - small_t).abs() <= small.abs() * 2.0 ** -10).all())


def test_split_rounds_to_nearest_ties_away():
    half = 2.0 ** -11                     # half a TF32 ulp at 1
    a = torch.tensor([1 + half, -(1 + half), 1 + half / 2, 1 - half / 2,
                      0.0, -0.0], dtype=torch.float32)
    big, _ = gram_cuda.tf32_split_torch(a)
    want = torch.tensor([1 + 2 * half, -(1 + 2 * half), 1.0, 1.0, 0.0, 0.0])
    assert torch.equal(big, want)


def test_split_keeps_nan_and_inf_as_poison():
    a = torch.tensor([float("nan"), float("inf"), -float("inf"), 2.5])
    big, small = gram_cuda.tf32_split_torch(a)
    assert bool(torch.isnan(big[0])) and bool(torch.isnan(small[0]))
    assert big[1] == float("inf") and big[2] == -float("inf")
    assert bool(torch.isnan(small[1:3]).all())
    assert big[3] == 2.5 and small[3] == 0.0


def test_split_wrapper_uses_the_plain_version_on_cpu():
    a = wide_range(2, (5, 13))
    for got, want in zip(gram_cuda.tf32_split(a),
                         gram_cuda.tf32_split_torch(a)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Emulated 3xTF32 against float64
# ---------------------------------------------------------------------------

N = 32
# chip_smoke.py's start theta (bench.py's): a narrow RF, rho 0.1
THETA = {"sigma_0": 1.0, "eps_0x": 0.0001, "eps_0y": 0.0001,
         "-2log2beta": -2 * math.log(2 * 0.1),
         "-log2rho2": -math.log(2 * 0.1 ** 2), "Amp": 1.0}


def _window():
    i0, j0, w = jk.crop_window_from_scalars(THETA["-2log2beta"],
                                            THETA["eps_0x"], THETA["eps_0y"],
                                            N, margin=1.25, bucket=4)
    assert w < N
    return i0, j0, w


@pytest.fixture(scope="module")
def crop_grams():
    """K_tilde and K at a crop window: the JAX xla path in float64, and the
    port's _gram_core in float32 with the kernel's contraction emulated
    three ways."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, N * N))
    xt = x[rng.permutation(96)[:48]]
    i0, j0, w = _window()
    jth = {k: jnp.asarray(v, jnp.float64) for k, v in THETA.items()}
    ref = jk.gram_matrices_windowed(jth, jnp.asarray(x), jnp.asarray(xt), N,
                                    False, i0, j0, w, backend="xla")
    tth = {k: torch.tensor(v, dtype=torch.float32) for k, v in THETA.items()}
    out = {}
    real = gram_cuda.acos_gram
    for name, q12 in (("3xTF32", q12_3xtf32), ("1xTF32", q12_1xtf32),
                      ("float32", lambda u, s: u @ s.T)):
        def emulated(u1, s2, q11, q22, sigma0, q12=q12):
            return gram_cuda.acos_epilogue_torch(q12(u1, s2), q11, q22,
                                                 sigma0)
        gram_cuda.acos_gram = emulated
        try:
            out[name] = tk.gram_matrices_windowed(
                tth, torch.as_tensor(x, dtype=torch.float32),
                torch.as_tensor(xt, dtype=torch.float32), N, False, i0, j0, w,
                backend="cuda")
        finally:
            gram_cuda.acos_gram = real
    return ref, out


def _rel(t, j):
    j = np.asarray(j)
    return float(np.max(np.abs(t.double().numpy() - j)) / np.max(np.abs(j)))


@pytest.mark.parametrize("which", ["K_tilde", "K"])
def test_emulated_3xtf32_crop_window_gram_matches_float64(crop_grams, which,
                                                          record_property):
    ref, out = crop_grams
    i = 0 if which == "K_tilde" else 1
    errs = {name: _rel(grams[i], ref[i]) for name, grams in out.items()}
    print(f"{which} at a {_window()[2]}^2-px crop window, max|dK|/max|K| "
          f"against float64: {errs}")
    for name, e in errs.items():
        record_property(f"{which} {name}", e)
    assert errs["3xTF32"] <= GATE


def test_emulated_3xtf32_sign_coherent_diagonal_at_k_11664(record_property):
    """Every term of the diagonal has the same sign: no cancellation hides
    a biased rounding of the operands."""
    rng = np.random.default_rng(1)
    u = torch.as_tensor(np.abs(rng.standard_normal((16, 11664)))
                        .astype(np.float32))
    ref = (u.double() @ u.double().T).diagonal()
    errs = {}
    for name, q12 in (("3xTF32", q12_3xtf32), ("1xTF32", q12_1xtf32)):
        d = q12(u, u).diagonal().double()
        errs[name] = float(((d - ref).abs() / ref).max())
        record_property(f"diagonal {name}", errs[name])
    print(f"sign-coherent diagonal, k 11664, max relative error against "
          f"float64: {errs}")
    assert errs["3xTF32"] <= GATE


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 700), k=st.integers(1, 6000),
       sms=st.integers(1, 200))
def test_plan_covers_every_output_once_and_partitions_k(m, n, k, sms):
    plan = gram_cuda.plan_gram(m, n, k, sms)
    tiles_n, tiles_m, splits = plan.grid
    cover = np.zeros((m, n), np.int32)
    for by in range(tiles_m):
        for bx in range(tiles_n):
            cover[by * gram_cuda.BM:(by + 1) * gram_cuda.BM,
                  bx * gram_cuda.BN:(bx + 1) * gram_cuda.BN] += 1
    assert (cover == 1).all()
    # the split ranges: consecutive, non-empty, whole blocks, [0, k) in all
    ranges = [plan.k_range(z) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    for lo, hi in ranges:
        assert lo < hi and lo % gram_cuda.BK == 0
    assert 1 <= splits <= gram_cuda.MAX_SPLITS
    if splits > 1:
        assert plan.kblocks // splits >= gram_cuda.MIN_KBLOCKS_PER_SPLIT
    assert 0 < plan.fill <= 1


@pytest.mark.parametrize("m,n,k,splits", [
    (2100, 2100, 6400, 2),     # K_tilde at the crop window
    (3160, 2100, 6400, 2),     # K at the crop window
    (2100, 2100, 11664, 2),    # K_tilde on the full grid
    (3160, 2100, 11664, 2),    # K on the full grid
    (30, 2100, 11664, 7),      # K* of the prediction
])
def test_plan_fills_the_waves_at_the_main_path_shapes(m, n, k, splits):
    plan = gram_cuda.plan_gram(m, n, k, sms=132)
    assert plan.splits == splits
    assert plan.fill >= gram_cuda.TARGET_FILL


def test_plan_keeps_one_split_where_the_tiles_fill_the_card():
    plan = gram_cuda.plan_gram(128 * 33, 128 * 16, 4096, sms=132)
    assert plan.splits == 1 and plan.fill == 1.0


def test_plan_rejects_empty_sizes():
    with pytest.raises(ValueError):
        gram_cuda.plan_gram(0, 5, 5)


@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 700), k=st.integers(1, 6000),
       sms=st.integers(1, 200), batch=st.integers(1, 3000))
def test_batched_plan_counts_every_items_tiles(m, n, k, sms, batch):
    """With a batch the grid's z runs over items x splits (within 65535),
    every item's tiles count toward the fill, and the batch fills its waves
    at least as well as one item (the target, or one item's best), with no
    more splits where one item reaches the target."""
    plan = gram_cuda.plan_gram(m, n, k, sms, batch)
    one = gram_cuda.plan_gram(m, n, k, sms)
    tiles_n, tiles_m, z = plan.grid
    assert (tiles_n, tiles_m) == (one.tiles_n, one.tiles_m)
    assert z == batch * plan.splits <= gram_cuda.MAX_GRID_Z
    assert plan.units == batch * tiles_m * tiles_n * plan.splits
    assert 0 < plan.fill <= 1
    assert plan.fill >= min(gram_cuda.TARGET_FILL, one.fill)
    if one.fill >= gram_cuda.TARGET_FILL:
        assert plan.splits <= one.splits


@pytest.mark.parametrize("m,n", [(512, 512), (3160, 512)])
def test_plan_needs_no_split_for_the_populations_ladder(m, n):
    """96 (cell, trial) items -- 16 cells x 6 trials -- at the population's
    K_tilde and K, full frame: the items alone fill the card."""
    plan = gram_cuda.plan_gram(m, n, 11664, sms=132, batch=96)
    assert plan.splits == 1 and plan.fill >= gram_cuda.TARGET_FILL
    assert plan.grid[2] == 96


def test_plan_rejects_a_batch_beyond_the_grid():
    with pytest.raises(ValueError):
        gram_cuda.plan_gram(5, 5, 5, batch=gram_cuda.MAX_GRID_Z + 1)
    with pytest.raises(ValueError):
        gram_cuda.plan_gram(5, 5, 5, batch=0)
    assert gram_cuda.plan_gram(5, 5, 4096,
                               batch=gram_cuda.MAX_GRID_Z).splits == 1
