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


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(3160, 258, 6400), (258, 258, 6400),
                                   (3160, 258, 11664), (30, 258, 11664)])
def test_kernel_at_the_active_loops_shapes(dev, m, n, k):
    """The pool's K* and the refit's K_tilde at the 258-point capacity
    buffer, whose last 8 rows are padding (zero): those rows come out
    finite, and the whole Gram agrees with the plain version."""
    u1, s2, q11, q22, s0 = _operands(dev, m, n, k, 7)
    s2[-8:] = 0.0
    q22[-8:] = 0.0
    if m == n:
        u1, q11 = s2, q22
    K = gram_cuda.acos_gram(u1, s2, q11, q22, s0)
    ref = gram_cuda.acos_gram_torch(u1, s2, q11, q22, s0)
    assert bool(torch.isfinite(K).all())
    assert float((K - ref).abs().max() / ref.abs().max()) <= 1e-5
    if m == n:
        d = ref.diagonal()
        assert float(((K.diagonal() - d).abs() / d.abs()).max()) <= 1e-5


@pytest.mark.cuda
def test_lambertw_float32_on_card_matches_float64(dev):
    from gaussian_processes_tpu_torch.ops.lambertw import lambertw
    z = torch.cat([torch.zeros(1, dtype=torch.float64),
                   torch.logspace(-12, -1, 40, dtype=torch.float64),
                   torch.linspace(0.0, 5.0, 101, dtype=torch.float64),
                   torch.logspace(1, 37, 120, dtype=torch.float64)])
    want = lambertw(z)
    got = lambertw(z.float().to(dev)).cpu().double()
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs() / want.abs().clamp(min=1e-30)
    assert float(err[want > 0].max()) <= 1e-6
    assert float(got[0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case,pick", [("nan", 777), ("tie", 900)])
def test_select_and_grow_issues_no_host_sync(dev, case, pick):
    """The pipelined loop's pick, growth and warm start run with CUDA's
    sync debugging set to raise on any host synchronization.  The pick is
    the first NaN among the unused rows (a NaN counts as the maximum; the
    NaN at row 5 lies in the used start set), or the first of two tied
    maxima."""
    from gaussian_processes_tpu_torch.models.active import _select_and_grow
    gen = torch.Generator().manual_seed(3)
    npool, cap, nx = 3160, 258, 64
    u = torch.rand(npool, generator=gen).to(dev)
    u[5] = float("nan")       # used: masked out
    if case == "nan":
        u[777] = float("nan")
        u[1500] = float("nan")
    else:
        u[1200] = 2.0
    u[900] = 2.0
    used = torch.zeros(npool, dtype=torch.bool, device=dev)
    used[:250] = True
    X_pool = torch.randn(npool, nx, generator=gen).to(dev)
    R_pool = torch.rand(npool, generator=gen).to(dev)
    x_buf = torch.zeros(cap, nx, device=dev)
    r_buf = torch.zeros(cap, device=dev)
    B = torch.randn(cap, cap, generator=gen).to(dev)
    m_b = torch.randn(cap, generator=gen).to(dev)
    V_b = torch.eye(cap, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _select_and_grow(u, X_pool, R_pool, x_buf, r_buf, used, B, m_b,
                               V_b, 250)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    x_buf, r_buf, used, m_o, V_o, best, ubest = out
    assert best.is_cuda and best.dim() == 0
    assert int(best) == pick
    assert bool(torch.isnan(ubest)) == (case == "nan")
    assert bool(used[pick]) and int(used.sum()) == 251
    assert torch.equal(x_buf[250], X_pool[pick])
    assert float(V_o[250, 250]) == 1.0


@pytest.mark.cuda
def test_argmax_on_card_matches_numpy(dev):
    """The pipelined loop's pick is torch.argmax on the card: np.argmax's
    rule (the first maximum; the first NaN wins) at the pool's length, with
    NaN and ties at several places."""
    import numpy as np
    rng = np.random.default_rng(11)
    for nans, ties in (((), ()), ((3,), ()), ((2000, 40), ()),
                       ((3159,), ()), ((), (17, 3000)), ((1500,), (10,))):
        u = rng.random(3160).astype(np.float32)
        u[list(ties)] = 5.0
        u[list(nans)] = np.nan
        got = torch.argmax(torch.as_tensor(u, device=dev))
        assert got.is_cuda and int(got) == int(np.argmax(u))


def _batched_operands(dev, B, m, n, k, seed):
    gen = torch.Generator().manual_seed(seed)
    u1 = torch.randn(B, m, k, generator=gen).to(dev)
    s2 = torch.randn(B, n, k, generator=gen).to(dev)
    s0 = (0.3 + torch.rand(B, generator=gen)).to(dev)
    return u1, s2, (u1 * u1).sum(-1), (s2 * s2).sum(-1), s0


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,k", [(5, 130, 129, 1001), (3, 37, 300, 4096),
                                     (6, 512, 512, 2048), (2, 1, 1, 1)])
def test_batched_kernel_matches_plain_and_2d_calls(dev, B, m, n, k):
    """One launch for B items, each with its own q11, q22 and sigma0: the
    ragged tiles of one item read zeros, not the next item's rows (m = 130,
    37), and the second shape splits k.  Each item also agrees with the
    2-D call on its operands (bit for bit where both plans split k alike)."""
    ops = _batched_operands(dev, B, m, n, k, B * 100 + m)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launches, batched, items = (gram_cuda.launches, gram_cuda.batched_launches,
                                gram_cuda.items)
    K = gram_cuda.acos_gram(*ops)
    torch.cuda.synchronize()
    assert K.shape == (B, m, n)
    assert gram_cuda.launches == launches + 1
    assert gram_cuda.batched_launches == batched + 1
    assert gram_cuda.items == items + B
    ref = gram_cuda.acos_gram_torch(*ops)
    assert bool(torch.isfinite(K).all())
    assert float((K - ref).abs().max() / ref.abs().max()) <= 1e-5
    same_plan = (gram_cuda.plan_gram(m, n, k, sms, B).splits
                 == gram_cuda.plan_gram(m, n, k, sms).splits)
    for b in range(B):
        Kb = gram_cuda.acos_gram(*(t[b] for t in ops))
        if same_plan:
            assert torch.equal(Kb, K[b])
        assert float((Kb - ref[b]).abs().max() / ref[b].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_nan_in_one_item_stays_in_that_item(dev):
    u1, s2, q11, q22, s0 = _batched_operands(dev, 4, 200, 150, 1000, 3)
    u1[2, 37, 500] = float("nan")
    bad = torch.isnan(gram_cuda.acos_gram(u1, s2, q11, q22, s0)).cpu()
    assert bool(bad[2, 37].all())
    bad[2, 37] = False
    assert not bool(bad.any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,k", [(300, 128, 64), (600, 100, 4096)])
def test_out_row_block_writes_only_its_rows(dev, n, nb, k):
    """``out=K[r0:r1]`` of a row-major (n, n) buffer: the block's rows hold
    the Gram, every other row keeps its sentinel (the second shape splits
    k, so its workspace must not alias the block)."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, k, generator=gen).to(dev)
    q = (x * x).sum(1)
    s0 = torch.tensor(0.7, device=dev)
    sentinel = -12345.0
    K = torch.full((n, n), sentinel, device=dev)
    r0, r1 = nb, min(2 * nb, n)
    got = gram_cuda.acos_gram(x[r0:r1], x, q[r0:r1], q, s0, out=K[r0:r1])
    torch.cuda.synchronize()
    assert got.data_ptr() == K[r0:r1].data_ptr()
    assert bool((K[:r0] == sentinel).all()) and bool((K[r1:] == sentinel).all())
    ref = gram_cuda.acos_gram_torch(x[r0:r1], x, q[r0:r1], q, s0)
    assert float((K[r0:r1] - ref).abs().max() / ref.abs().max()) <= 1e-5
    with pytest.raises(ValueError):
        gram_cuda.acos_gram(x[r0:r1], x, q[r0:r1], q, s0, out=K[:, :10])


@pytest.mark.cuda
def test_large_gram_row_blocks_match_plain(dev):
    from gaussian_processes_tpu_torch.parallel.large import large_gram
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(300, 16 * 16, generator=gen).to(dev)
    theta = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
             "-2log2beta": 1.0, "-log2rho2": 2.0, "Amp": 1.3}
    K = large_gram(theta, x, 16, nb=128)
    th = {k: torch.tensor(v, device=dev) for k, v in theta.items()}
    _, ref, _ = kernels.gram_matrices(th, x, x, 16, shared=False,
                                      backend="torch")
    assert float((K - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_batched_armijo_issues_no_host_sync(dev):
    """Both inner L-BFGS calls of a population EM iteration -- the M-step
    over every (cell, trial) Gram through the batched kernel, in chunks of
    two items (the gradient call's one at a time), and the E-step's f-param
    search -- run with CUDA's sync debugging set to raise on any host
    synchronization PyTorch issues, and the profiler records no
    synchronizing runtime call (which also sees those inside cuSOLVER or
    MAGMA: a batched LU inverse or cholesky_solve has them)."""
    from torch.profiler import ProfilerActivity, profile
    import math
    from functools import partial
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as tf
    from gaussian_processes_tpu_torch.optim.lbfgs import lbfgs_minimize_armijo
    from gaussian_processes_tpu_torch.params import theta_bounds
    gen = torch.Generator().manual_seed(4)
    L, nt, npx, ntilde = 3, 96, 16, 24
    x = torch.randn(nt, npx * npx, generator=gen).to(dev)
    rs = torch.poisson(torch.full((L, nt), 2.0), generator=gen).to(dev)
    cfg = FitConfig(ntilde=ntilde, n_px_side=npx, linesearch="armijo")
    vals = {"sigma_0": 1.0, "eps_0x": 0.1, "eps_0y": -0.2,
            "-2log2beta": 1.0, "-log2rho2": 2.0, "Amp": 1.3}
    thetas = {k: torch.full((L,), v, device=dev) for k, v in vals.items()}
    fps = {"logA": torch.full((L,), math.log(0.01), device=dev),
           "lambda0": torch.ones(L, device=dev)}
    stim = tf.cell_stimuli(x, x[:ntilde], False, cfg)
    with torch.no_grad():
        c = tf._fit_init_cells(stim, rs, thetas, fps, False, cfg, "cuda")
    lower, upper = theta_bounds()
    mstep = partial(tf._mstep_objective_cells, stim=stim, r=rs,
                    es=c.kern.es, m_b=c.m_b, V_b=c.V_b, f_params=c.f_params,
                    shared=False, cfg=cfg, lower=lower, upper=upper,
                    backend="cuda", max_items=2)
    fparam = partial(tf._fparam_objective, r=rs[:, None],
                     lambda_m=c.lambda_m[:, None],
                     lambda_var=c.lambda_var[:, None])
    launches = gram_cuda.batched_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                theta, f_theta = lbfgs_minimize_armijo(mstep, c.theta, 2)
                logA, f_logA = lbfgs_minimize_armijo(fparam, fps["logA"], 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [e.name for e in prof.events() if "Synchronize" in e.name]
    assert syncs == []
    assert gram_cuda.batched_launches > launches
    assert bool(torch.isfinite(f_theta).all() & torch.isfinite(f_logA).all())
    assert all(bool(torch.isfinite(v).all()) for v in theta.values())


@pytest.mark.cuda
def test_reduced_rank_fit_through_kernel_matches_plain(dev, tmp_path):
    """The reduced-rank fit (a smooth prior keeps about 50 of 128
    eigenvalues, so the budget sits below ntilde) through the kernel
    against the same fit through the plain Gram, float32 on the card (two
    summation orders: log-marginal within 1e-3); its last iteration
    reconstructed from the tracked basis, and its checkpoint, predict what
    the fit predicts."""
    import math

    import numpy as np

    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models.fit import fit
    from gaussian_processes_tpu_torch.models.inference import (evaluate,
                                                               predict)
    from gaussian_processes_tpu_torch.utils.io import load_model, save_model

    rng = np.random.default_rng(0)
    n_px, nt, ntilde = 24, 256, 128
    x = rng.standard_normal((nt, n_px * n_px))
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2)).ravel()
    r = rng.poisson(np.exp(0.6 * x @ (w / np.linalg.norm(w))))
    idx = torch.as_tensor(rng.permutation(nt)[:ntilde], device=dev)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rt = torch.as_tensor(r, dtype=torch.float32, device=dev)
    theta = {"sigma_0": 1.0, "eps_0x": 1e-4, "eps_0y": 1e-4,
             "-2log2beta": -2 * math.log(0.2),
             "-log2rho2": -math.log(2 * 0.3 ** 2), "Amp": 1.0}
    fp = {"logA": math.log(0.01), "lambda0": 1.0}
    cfg = FitConfig(ntilde=ntilde, maxiter=4, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=n_px, crop_window=False,
                    reduced_rank=True, rank_bucket=16, track_basis=True)
    runs = {}
    for backend in ("cuda", "torch"):
        before = gram_cuda.launches
        runs[backend] = fit(xt, rt, cfg, xtilde=xt[idx], theta=theta,
                            f_params=fp, backend=backend, profile=True)
        launched = gram_cuda.launches - before
        assert (launched > 0) == (backend == "cuda")
    k, p = runs["cuda"], runs["torch"]
    assert not k.failed and max(k.timing["rank"]) < ntilde
    n_eigen = k.track.n_eigen.tolist()
    assert all(n_eigen[i] < b for i, b in enumerate(k.timing["rank"], 1))
    lk = k.track.logmarginal.double()
    lp = p.track.logmarginal.double()
    assert float(((lk - lp).abs() / lp.abs()).max()) <= 1e-3
    xs = xt[:20]
    rates = predict(k, xs)[0]
    _, last, _, _ = evaluate(k, xs, torch.ones((4, 20), device=dev),
                             at_iteration=3, nbootstrap=5)
    assert float(((last - rates).abs() / rates).max()) <= 1e-5
    save_model(k, str(tmp_path / "m"))
    loaded = load_model(str(tmp_path / "m"))
    assert loaded.B.device.type == "cuda"
    assert all(torch.equal(a, b) for a, b in zip(predict(loaded, xs),
                                                 predict(k, xs)))


def _planted_on(dev, n_px=24, nt=256, seed=0):
    """test_torch_fit's planted data (float32 on the card), the inducing
    rows of its permutation, THETA0 and FP0."""
    import math

    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nt, n_px * n_px))
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2)).ravel()
    r = rng.poisson(np.exp(0.6 * x @ (w / np.linalg.norm(w))))
    idx = torch.as_tensor(rng.permutation(nt)[:64], device=dev)
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    theta = {"sigma_0": 1.0, "eps_0x": 1e-4, "eps_0y": 1e-4,
             "-2log2beta": -2 * math.log(0.2),
             "-log2rho2": -math.log(2 * 0.1 ** 2), "Amp": 1.0}
    fp = {"logA": math.log(0.01), "lambda0": 1.0}
    return (xt, torch.as_tensor(r, dtype=torch.float32, device=dev), xt[idx],
            theta, fp)


@pytest.mark.cuda
def test_speculative_fit_through_kernel_matches_plain(dev):
    """The speculative search with its memory carried over two M-steps and
    a 16-rung ladder, through the kernel against the same fit through the
    plain Gram, float32 on the card (two summation orders: log-marginal
    within 1e-3).  Its M-step ladders launch the batched kernel; the plain
    fit launches nothing."""
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models.fit import fit

    x, r, xtilde, theta, fp = _planted_on(dev)
    cfg = FitConfig(ntilde=64, maxiter=4, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=24, crop_bucket=4,
                    linesearch="speculative", armijo_trials=16)
    runs = {}
    for backend in ("cuda", "torch"):
        before = gram_cuda.launches, gram_cuda.batched_launches
        runs[backend] = fit(x, r, cfg, xtilde=xtilde, theta=theta,
                            f_params=fp, backend=backend)
        torch.cuda.synchronize()
        launched = (gram_cuda.launches - before[0],
                    gram_cuda.batched_launches - before[1])
        assert (min(launched) > 0) == (backend == "cuda"), launched
    k, p = runs["cuda"], runs["torch"]
    assert not k.failed and not p.failed
    lk = k.track.logmarginal.double()
    lp = p.track.logmarginal.double()
    assert float(((lk - lp).abs() / lp.abs()).max()) <= 1e-3
    assert float(lk[-1]) > float(lk[0])


@pytest.mark.cuda
def test_mstep_ladder_through_kernel_matches_per_trial_calls(dev):
    """The M-step's batched ladder evaluator through the kernel (one
    batched launch for K_tilde and one for K over the T trials) against
    the M-step objective at each trial through the 2-D kernel calls, on
    the start window: float32, two summation orders, within 1e-5 relative;
    an out-of-bounds trial is +inf in both."""
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as tf
    from gaussian_processes_tpu_torch.params import theta_bounds

    x, r, xtilde, theta, fp = _planted_on(dev)
    cfg = FitConfig(ntilde=64, n_px_side=24, crop_bucket=4)
    th0 = {k: torch.tensor(v, device=dev) for k, v in theta.items()}
    fp0 = {k: torch.tensor(v, device=dev) for k, v in fp.items()}
    win = kernels.crop_window_for_theta(th0, 24, cfg.alpha_threshold,
                                        cfg.crop_margin, cfg.crop_bucket)
    assert win[2] < 24
    with torch.no_grad():
        c = tf._fit_init(x, r, xtilde, th0, fp0,
                         torch.zeros(64, device=dev), None, False, False,
                         cfg, win)
    lower, upper = theta_bounds()
    args = dict(x=x, xtilde=xtilde, r=r, es=c.kern.es, m_b=c.m_b, V_b=c.V_b,
                f_params=c.f_params, shared=False, cfg=cfg, lower=lower,
                upper=upper, win=win)
    gen = torch.Generator().manual_seed(3)
    T = 6
    trials = {k: (v + 0.05 * 0.5 ** torch.arange(T)
                  * torch.randn(1, generator=gen)).to(dev)
              for k, v in theta.items()}
    trials["Amp"][-1] = -1.0                 # out of bounds: +inf
    with torch.no_grad():
        before = gram_cuda.launches, gram_cuda.batched_launches
        got = tf._mstep_ladder(**args)(trials)
        torch.cuda.synchronize()
        assert (gram_cuda.launches - before[0],
                gram_cuda.batched_launches - before[1]) == (2, 2)
        want = torch.stack([tf._mstep_objective(
            {k: v[t] for k, v in trials.items()}, **args) for t in range(T)])
    assert bool(torch.isinf(got[-1])) and bool(torch.isinf(want[-1]))
    err = ((got[:-1].double() - want[:-1].double()).abs()
           / want[:-1].double().abs())
    assert bool(torch.isfinite(got[:-1]).all())
    assert float(err.max()) <= 1e-5


@pytest.mark.cuda
def test_projected_gram_through_kernel_matches_plain(dev):
    """The projected Gram hands the kernel its cross forms at contraction
    R^2 (u1 = Amp Z, s2 = Y): K_tilde and K through the kernel against the
    plain composite at rank 16 of a 24 px frame (k 256), float32, within
    1e-5 relative, two launches, and the same float64 guard."""
    import math

    x, _, xtilde, theta, _ = _planted_on(dev)
    th = {k: torch.tensor(v, device=dev) for k, v in theta.items()}
    th["-log2rho2"] = torch.tensor(-math.log(2 * 0.5 ** 2), device=dev)
    E = kernels.smooth_projection_basis(th, 24, 24, 16, dtype=torch.float64)
    with torch.no_grad():
        before = gram_cuda.launches
        got = kernels.gram_matrices_projected(th, x, xtilde, E, 0, 0, 24,
                                              False, backend="cuda")
        torch.cuda.synchronize()
        assert gram_cuda.launches == before + 2
        want = kernels.gram_matrices_projected(th, x, xtilde, E, 0, 0, 24,
                                               False, backend="torch")
    assert bool(got[3]) and bool(want[3])
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_masked_inverse_warm_on_card_matches_cpu_float64(dev):
    """The warm-seeded M-step inverse on the card (float32, the guard read
    once) against the float64 inverse on the CPU: a K_tilde_b-like kept
    block near its diagonal seed, within 1e-5 of max|X| (condition 1e2),
    and the Schulz route taken."""
    from gaussian_processes_tpu_torch.ops import stabilize
    from gaussian_processes_tpu_torch.utils.tracing import decisions

    gen = torch.Generator().manual_seed(0)
    n, drop = 96, 8
    ev = 10.0 * torch.exp(-torch.arange(n, dtype=torch.float64)
                          * 4.6 / n).flip(0)
    keep = torch.arange(n) >= drop
    A = torch.randn(n, n, generator=gen, dtype=torch.float64)
    s = ev.sqrt()
    M = torch.diag(ev) + 0.005 * s[:, None] * (A + A.T) / 2 * s[None, :]
    M = M * (keep[:, None] & keep[None, :])
    inv_diag = torch.where(keep, 1.0 / ev, torch.zeros_like(ev))
    want = stabilize.masked_inverse_spd(M, keep)
    decisions.clear()
    got = stabilize.masked_inverse_warm(M.float().to(dev), keep.to(dev),
                                        inv_diag.float().to(dev))
    decisions.fold()
    assert decisions["mstep.schulz"] == 1
    err = (got.double().cpu() - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("max_ls", [15, 4])
@pytest.mark.parametrize("pad", [0, 4])
def test_fparam_search_kernel_matches_plain(dev, dtype, max_ls, pad):
    """The f-param search kernel against its plain version (the host-driven
    zoom L-BFGS through autograd) at nt 3160, 10 steps, one launch.
    float64: run for k = 1..10 steps, the same number of evaluations and
    logA within 1e-9 until the plain search sits at its minimum (value
    within 1e-12 of its last), past which last-ulp differences decide the
    trials; at 10 steps the best values within 1e-12 and logA within 1e-9.
    float32 by outcome: the
    objective at the two results within 1e-5 relative, logA within 1e-4
    or within the float32 rounding width of the minimum (as chip_smoke.py
    phase 6b bounds it)."""
    import math

    import numpy as np

    from gaussian_processes_tpu_torch.ops import fparam_search as fs
    from gaussian_processes_tpu_torch.utils.tracing import objective_counts

    rng = np.random.default_rng(3)
    nt = 3160
    lm = rng.standard_normal(nt)
    lv = rng.uniform(0.1, 0.5, nt)
    r = rng.poisson(np.exp(0.4 * lm + 0.08 * lv + 0.2)).astype(float)
    w = np.ones(nt)
    w[nt - pad:] = 0.0
    args = [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (r, lm, lv)] + [
        torch.as_tensor(w, dtype=dtype, device=dev) if pad else None]
    x0 = torch.tensor(math.log(0.01), dtype=dtype, device=dev)

    def search(k, backend=None):
        with objective_counts() as ev:
            x, f = fs.fparam_search(x0, *args, k, max_ls, backend=backend)
            x, f = float(x), float(f)
        return x, f, ev["fparam"]

    launches = fs.launches
    xk, fk, nk = search(10)
    assert fs.launches == launches + 1
    xp, fp, npl = search(10, "torch")
    a64 = [None if a is None else a.double() for a in args]

    def vg(x):
        v, g = fs.fparam_value_and_grad_torch(
            torch.tensor(x, dtype=torch.float64, device=dev), *a64)
        return float(v), float(g)

    assert abs(vg(xk)[0] - vg(xp)[0]) <= (
        1e-12 if dtype == torch.float64 else 1e-5) * abs(vg(xp)[0])
    if dtype == torch.float32:
        curv = (vg(xp + 1e-4)[1] - vg(xp - 1e-4)[1]) / 2e-4
        width = math.sqrt(2 * 2.0 ** -23 * abs(vg(xp)[0]) / curv)
        assert abs(xk - xp) <= max(1e-4, width)
        return
    assert abs(fk - fp) <= 1e-12 * abs(fp)
    assert abs(xk - xp) <= 1e-9
    for k in range(1, 11):
        xpk, fpk, npk = search(k, "torch")
        xkk, _, nkk = search(k)
        if abs(fpk - fp) <= 1e-12 * abs(fp) and (
                abs(xkk - xpk) > 1e-9 or nkk != npk):
            break
        assert abs(xkk - xpk) <= 1e-9 and nkk == npk


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [dict(gtol=1.0), dict(ftol=1e-3),
                                  dict(ftol_rel=1e-8)],
                         ids=["gtol", "ftol", "ftol_rel"])
def test_fparam_search_kernel_gates_match_plain(dev, gate):
    """The gtol/ftol/ftol_rel gates (0 at the fit's f-param site) stop the
    kernel's search where they stop the plain search: float64, nt 3160, 20
    steps, the same evaluations, logA within 1e-9 and the best values
    within 1e-12; each gate stops it well before the ungated 20 steps
    (which take 227 evaluations on the CPU)."""
    import math

    import numpy as np

    from gaussian_processes_tpu_torch.ops import fparam_search as fs
    from gaussian_processes_tpu_torch.utils.tracing import objective_counts

    rng = np.random.default_rng(3)
    nt = 3160
    lm = rng.standard_normal(nt)
    lv = rng.uniform(0.1, 0.5, nt)
    r = rng.poisson(np.exp(0.4 * lm + 0.08 * lv + 0.2)).astype(float)
    args = [torch.as_tensor(a, dtype=torch.float64, device=dev)
            for a in (r, lm, lv)] + [None]
    x0 = torch.tensor(math.log(0.01), dtype=torch.float64, device=dev)

    def search(backend=None, **kw):
        with objective_counts() as ev:
            x, f = fs.fparam_search(x0, *args, 20, 15, backend=backend, **kw)
            x, f = float(x), float(f)
        return x, f, ev["fparam"]

    xk, fk, nk = search(**gate)
    xp, fp, npl = search("torch", **gate)
    _, _, n_all = search("torch")
    assert nk == npl < n_all // 4
    assert abs(xk - xp) <= 1e-9
    assert abs(fk - fp) <= 1e-12 * abs(fp)


@pytest.mark.cuda
def test_fparam_search_raises_instead_of_falling_back(dev):
    from gaussian_processes_tpu_torch.ops import fparam_search as fs

    r = torch.ones(8, device=dev)
    x0 = torch.tensor(-1.0, device=dev)
    with pytest.raises(TypeError):
        fs.fparam_search(x0.half(), r.half(), r.half(), r.half(), None, 3,
                         4)
    with pytest.raises(ValueError):
        fs.fparam_search(x0, r, r[:4], r, None, 3, 4)


def fparam_moments(nt, pad, dtype, dev):
    """(r, lambda_m, lambda_var, w) on ``dev``: the seeded moments of
    test_fparam_search_kernel_matches_plain at ``nt`` rows, the last
    ``pad`` of them weight 0 (w None without any)."""
    import numpy as np

    rng = np.random.default_rng(3)
    lm = rng.standard_normal(nt)
    lv = rng.uniform(0.1, 0.5, nt)
    r = rng.poisson(np.exp(0.4 * lm + 0.08 * lv + 0.2)).astype(float)
    w = np.ones(nt)
    w[nt - pad:] = 0.0
    return [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (r, lm, lv)] + [
        torch.as_tensor(w, dtype=dtype, device=dev) if pad else None]


# (logA, value) as float.hex and evaluations of the block-of-1024 kernel
# (csrc/fparam_lbfgs.cu at commit f0bea62) on the seeded operands of
# test_fparam_search_kernel_matches_plain, 10 steps from log(0.01), on an
# NVIDIA H100 80GB HBM3 at 700 W.
FPARAM_BLOCK1024_BITS = {
    (torch.float32, 15, 0): ("-0x1.36a91a0000000p+0", "0x1.566a080000000p+11",
                             105),
    (torch.float32, 15, 4): ("-0x1.3612ae0000000p+0", "0x1.55d1b60000000p+11",
                             64),
    (torch.float32, 4, 0): ("-0x1.c203900000000p+0", "0x1.5bd4240000000p+11",
                            41),
    (torch.float32, 4, 4): ("-0x1.c020900000000p+0", "0x1.5b2d340000000p+11",
                            41),
    (torch.float64, 15, 0): ("-0x1.36a918e9787d6p+0", "0x1.566a086030ac2p+11",
                             63),
    (torch.float64, 15, 4): ("-0x1.3612af3c93384p+0", "0x1.55d1b6851fef2p+11",
                             77),
    (torch.float64, 4, 0): ("-0x1.c20386ed7eea8p+0", "0x1.5bd4203ddb856p+11",
                            41),
    (torch.float64, 4, 4): ("-0x1.c020901c591d6p+0", "0x1.5b2d2f0739848p+11",
                            41),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("max_ls", [15, 4])
@pytest.mark.parametrize("pad", [0, 4])
def test_fparam_search_kernel_keeps_the_block1024_bits(dev, dtype, max_ls,
                                                      pad):
    """The kernel, whose block of 256 threads carries the reduction tree of
    its first version's block of 1024 threads (source commit f0bea62),
    returns exactly that version's logA, value and evaluation count, as
    recorded on an NVIDIA H100 80GB HBM3 (700 W), on the seeded operands of
    test_fparam_search_kernel_matches_plain: nt 3160, 0 or 4 weight-0 rows,
    15 or 4 trials, float32 and float64."""
    import math

    from gaussian_processes_tpu_torch.ops import fparam_search as fs
    from gaussian_processes_tpu_torch.utils.tracing import objective_counts

    args = fparam_moments(3160, pad, dtype, dev)
    x0 = torch.tensor(math.log(0.01), dtype=dtype, device=dev)
    with objective_counts() as ev:
        x, f = fs.fparam_search(x0, *args, 10, max_ls)
        x, f = float(x), float(f)
    assert (x.hex(), f.hex(), ev["fparam"]) == FPARAM_BLOCK1024_BITS[
        (dtype, max_ls, pad)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("weighted,pad", [(False, 0), (True, 0), (True, 4)],
                         ids=["unweighted", "weighted", "weighted-pad4"])
def test_fparam_search_kernel_rows_in_global_memory(dev, dtype, weighted,
                                                    pad):
    """Past the shared memory the kernel reads its rows from global memory
    (the last block of 1024 rows part full: 300 rows).  At the first nt
    that does so, for the rows with and without a weight: against the
    plain route at 10 steps and 15 trials, with the bounds of
    test_fparam_search_kernel_matches_plain at 10 steps; and with a weight
    (1, or 0 on the last ``pad`` rows), bit for bit the search without one
    on the rows of weight 1, which still sit in shared memory (a weight of
    1 changes no product, and rows of weight 0 add nothing)."""
    import math

    from gaussian_processes_tpu_torch.ops import fparam_search as fs
    from gaussian_processes_tpu_torch.utils.tracing import objective_counts

    lib = fs.load_library()
    size = torch.empty((), dtype=dtype).element_size()
    blocks = 1
    while lib.fparam_lbfgs_smem_bytes(blocks * 1024, int(weighted), size):
        blocks += 1
    nt = (blocks - 1) * 1024 + 300
    assert lib.fparam_lbfgs_smem_bytes(nt, int(weighted), size) == 0
    assert lib.fparam_lbfgs_smem_bytes(nt - 300, int(weighted), size) > 0
    r, lm, lv, _ = fparam_moments(nt, 0, dtype, dev)
    wt = None
    if weighted:
        wt = torch.ones(nt, dtype=dtype, device=dev)
        wt[nt - pad:] = 0.0
    x0 = torch.tensor(math.log(0.01), dtype=dtype, device=dev)

    def search(args, backend=None):
        with objective_counts() as ev:
            x, f = fs.fparam_search(x0, *args, 10, 15, backend=backend)
            x, f = float(x), float(f)
        return x, f, ev["fparam"]

    xk, fk, nk = search((r, lm, lv, wt))
    xp, fp, _ = search((r, lm, lv, wt), "torch")
    a64 = [None if a is None else a.double() for a in (r, lm, lv, wt)]

    def vg(x):
        v, g = fs.fparam_value_and_grad_torch(
            torch.tensor(x, dtype=torch.float64, device=dev), *a64)
        return float(v), float(g)

    assert math.isfinite(fk) and nk > 0
    assert abs(vg(xk)[0] - vg(xp)[0]) <= (
        1e-12 if dtype == torch.float64 else 1e-5) * abs(vg(xp)[0])
    if dtype == torch.float32:
        curv = (vg(xp + 1e-4)[1] - vg(xp - 1e-4)[1]) / 2e-4
        width = math.sqrt(2 * 2.0 ** -23 * abs(vg(xp)[0]) / curv)
        assert abs(xk - xp) <= max(1e-4, width)
    else:
        assert abs(fk - fp) <= 1e-12 * abs(fp)
        assert abs(xk - xp) <= 1e-9
    if weighted:
        n = nt - pad
        assert lib.fparam_lbfgs_smem_bytes(n, 0, size) > 0
        assert (xk, fk, nk) == search((r[:n], lm[:n], lv[:n], None))


# ---------------------------------------------------------------------------
# The Gram's backward kernels (acos_gram_bwd, tf32_split_t, nt_product),
# through gram_backward and the launchers it calls
# ---------------------------------------------------------------------------

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _close(got, want, rtol=1e-5):
    """Each output within rtol of the plain value's largest magnitude."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rtol * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,k", [(None, 37, 301, 1002), (None, 130, 129, 13),
                                     (None, 1, 1, 1), (None, 257, 45, 999),
                                     (3, 37, 301, 1002), (3, 131, 67, 258)])
def test_backward_kernels_match_plain(dev, B, m, n, k):
    """m, n and k off multiples of 4 and 32; a batch of 3 with its own
    sigma0; the forward's q12 against u1 @ s2^T, K the same bits with and
    without it; every output of the kernel backward within 1e-5 of the
    plain backward's on the same g and q12, and two runs bit for bit; the
    first shape's products split k (more than one range)."""
    ops = (_batched_operands(dev, B, m, n, k, m + n) if B
           else _operands(dev, m, n, k, m + n))
    u1, s2, q11, q22, s0 = ops
    K, q12 = gram_cuda._forward(*ops, keep_q12=True)
    assert torch.equal(K, gram_cuda._forward(*ops))
    assert float((q12 - u1 @ s2.mT).abs().max()
                 / (u1 @ s2.mT).abs().max()) <= 1e-5
    g = torch.randn(K.shape, generator=torch.Generator().manual_seed(k)).to(dev)
    counts = gram_cuda.read_counts()
    got = gram_cuda.gram_backward(g, u1, s2, q11, q22, s0, q12)
    again = gram_cuda.gram_backward(g, u1, s2, q11, q22, s0, q12)
    torch.cuda.synchronize()
    after = gram_cuda.read_counts()
    assert after["bwd"] == counts["bwd"] + 2
    assert after["product"] == counts["product"] + 4
    assert after["split_t"] == counts["split_t"] + 4   # u1 and s2, not dq12
    assert after["plain_bwd_cuda"] == counts["plain_bwd_cuda"]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _close(got, gram_cuda.gram_backward_torch(g, u1, s2, q11, q22, s0, q12))
    if (B, m, n, k) == (None, 37, 301, 1002):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert gram_cuda.plan_gram(m, k, n, sms).splits > 1


# The first 16 hex digits of the sha256 of K's float32 bytes from the Gram
# kernel as it was before the forward could write q12 (commit 5320bcf), on
# an NVIDIA H100 80GB HBM3, at each (B, m, n, k) on the seeded operands
# below (seed m + n + k)
PARENT_K_SHA = {(None, 37, 301, 1002): "81a097836f405071",
                (None, 2100, 2100, 6400): "ea7bd910522ddb1e",
                (None, 3160, 2100, 9216): "1e02a01c483da895",
                (3, 131, 67, 258): "bad89e62506e40f4"}


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,k", sorted(PARENT_K_SHA, key=str))
def test_forward_keeps_its_bits_with_the_q12_output(dev, B, m, n, k):
    """K with and without the q12 output has the bits the kernel gave
    before it could write q12: split k (37x301), one range of k at the
    M-step's K_tilde and K, and a batch."""
    import hashlib

    seed = m + n + k
    ops = (_batched_operands(dev, B, m, n, k, seed) if B
           else _operands(dev, m, n, k, seed))
    with torch.no_grad():
        K = gram_cuda.acos_gram(*ops)
    K2, _ = gram_cuda._forward(*ops, keep_q12=True)
    for got in (K, K2):
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        assert digest[:16] == PARENT_K_SHA[(B, m, n, k)]


# The first 16 hex digits of the sha256 of each backward output (du1, ds2,
# dq11, dq22, dsigma0) from the backward kernels as they were before the
# product and epilogue redesign (commit c51b73d), on an NVIDIA H100 80GB
# HBM3, at each (B, m, n, k) on benchmarks/gram_backward.operands: split k
# (37x301), the M-step's K_tilde and K, a small Gram and a batch
PARENT_BWD_SHA = {
    (None, 37, 301, 1002): ["1c5f09dd780d5f9a", "23ae0e595b2f28f1",
        "6cad6369121f47b3", "b1486872540e1a38", "45ac2daa32451b61"],
    (3, 131, 67, 258): ["62b7b76e53971116", "a91efc9d7d0a71e9",
        "76876de230d0d843", "b8e1cbea17a04db8", "f92d6c770d636b81"],
    (None, 2100, 2100, 6400): ["6ade6b83bf500c7e", "2a2dd468cecfc9b3",
        "ef506a905e1fe629", "14b8921589f0474f", "5d84fcde1c2d83e7"],
    (None, 3160, 2100, 6400): ["c466eda93b49d5c7", "c2fdac4a995753bb",
        "b926c009d63c6cd4", "65b7c09f3cbccd12", "5c4b7ad4bfd13cbd"],
    (None, 256, 64, 576): ["17cbc7f104aab728", "48ced922819d7a75",
        "7400b652fd807815", "d7bc75646679ae69", "f860235d4f50ccd3"]}


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,k", sorted(PARENT_BWD_SHA, key=str))
def test_backward_keeps_its_bits(dev, B, m, n, k):
    """Every output of the backward has the bits of the kernels before the
    redesign: the products keep the forward's main loop and plan_gram's
    cuts of k, the epilogue its formulas and the order of every sum."""
    from gaussian_processes_tpu_torch.benchmarks import gram_backward

    ops, g = gram_backward.operands(dev, B, m, n, k)
    _, q12 = gram_cuda._forward(*ops, keep_q12=True)
    got = gram_cuda.gram_backward(g, *ops, q12)
    assert gram_backward.digests(got) == PARENT_BWD_SHA[(B, m, n, k)]


@pytest.mark.cuda
def test_backward_epilogue_at_the_clip(dev):
    """Cosines exactly at +-1 and beyond: the kernel decides the clip from
    the same rounded ratio as the plain version (1 inside, 1/2 on a bound,
    0 beyond), so dq12 agrees there too, and NaN stays NaN."""
    gen = torch.Generator().manual_seed(11)
    m, n = 45, 70
    q11 = torch.rand(m, generator=gen) * 3 + 0.5
    q22 = torch.rand(n, generator=gen) * 3 + 0.5
    s0 = torch.tensor(0.5)
    s02 = s0 * s0
    den = (torch.sqrt(q11 + s02)[:, None] * torch.sqrt(q22 + s02)[None, :]
           + 1e-7)
    r = torch.rand(m, n, generator=gen) * 2.6 - 1.3
    pick = torch.rand(m, n, generator=gen)
    r = torch.where(pick < 0.15, 1.0, torch.where(pick < 0.3, -1.0, r))
    q12 = r * den - s02
    ratio = (q12 + s02) / den
    assert int((ratio.abs() == 1).sum()) >= 50
    assert int((ratio.abs() > 1).sum()) >= 50
    q12[3, 4] = float("nan")
    g = torch.randn(m, n, generator=gen)
    args = [t.to(dev) for t in (g, q12, q11, q22, s0)]
    planes, _, dq11, dq22, ds0 = gram_cuda._bwd_launch(
        gram_cuda.load_library(), g.reshape(1, m, n).to(dev),
        q12.reshape(1, m, n).to(dev), q11.reshape(1, m).to(dev),
        q22.reshape(1, n).to(dev), s0.reshape(1).to(dev), _stream(dev))
    dq12 = planes[0, :, :, :n] + planes[1, :, :, :n]
    got = dq12[0], dq11[0], dq22[0], ds0[0]
    want = gram_cuda.acos_gram_bwd_torch(*args)
    assert torch.isnan(got[0][3, 4]) and torch.isnan(want[0][3, 4])
    assert bool(torch.isnan(got[1][3]) & torch.isnan(got[2][4]))
    assert bool(torch.isnan(got[3]))
    mask = torch.ones(m, n, dtype=torch.bool, device=dev)
    mask[3, 4] = False
    assert torch.equal(got[0][~mask].isnan(), want[0][~mask].isnan())
    assert torch.equal(got[0][mask] == 0, want[0][mask] == 0)
    a, b = got[0][mask], want[0][mask]
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    keep = torch.arange(m, device=dev) != 3
    a, b = got[1][keep], want[1][keep]
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 13), (37, 256), (3, 130, 1001),
                                   (1, 1), (2100, 96)])
def test_transposing_split_matches_plain_bit_for_bit(dev, shape):
    a = torch.randn(shape, generator=torch.Generator().manual_seed(
        shape[-1]))
    a3 = a.reshape(-1, *shape[-2:]).to(dev)
    got = gram_cuda._split_t_into(gram_cuda.load_library(), a3, _stream(dev))
    assert torch.equal(got.cpu(), gram_cuda.tf32_split_t_torch(a3.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,k", [(None, 37, 45, 1002), (None, 300, 700, 64),
                                     (2, 129, 130, 333)])
def test_product_kernel_matches_plain(dev, B, m, n, k):
    """The product on the operands the backward hands it (the transposing
    split of a^T and b^T): a @ b^T within 1e-5; the first shape splits k."""
    gen = torch.Generator().manual_seed(m)
    a = torch.randn((B or 1, m, k), generator=gen).to(dev)
    b = torch.randn((B or 1, n, k), generator=gen).to(dev)
    lib = gram_cuda.load_library()
    got = gram_cuda._product(
        lib, gram_cuda._split_t_into(lib, a.mT.contiguous(), _stream(dev)),
        gram_cuda._split_t_into(lib, b.mT.contiguous(), _stream(dev)), m, n,
        k, _stream(dev))
    want = gram_cuda.nt_product_torch(a, b)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    if (B, m, n, k) == (None, 37, 45, 1002):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert gram_cuda.plan_gram(m, n, k, sms).splits > 1


@pytest.mark.cuda
def test_backward_raises_instead_of_falling_back(dev):
    u1, s2, q11, q22, s0 = _operands(dev, 8, 4, 32, 3)
    g = torch.randn(8, 4, device=dev)
    q12 = u1 @ s2.mT
    with pytest.raises(TypeError):
        gram_cuda.gram_backward(g.double(), u1, s2, q11, q22, s0, q12)
    with pytest.raises(ValueError):
        gram_cuda.gram_backward(g, u1, s2, q11, q22, s0, q12[:, :3])
    before = gram_cuda.read_counts()["plain_bwd_cuda"]
    with pytest.raises(ValueError):
        gram_cuda.gram_backward(g, u1, s2[:3], q11, q22, s0, q12)
    assert gram_cuda.read_counts()["plain_bwd_cuda"] == before


# The redesigned product (128-byte rows, tiles in groups of 4 rows) and
# epilogue (one launch: dq12's planes and dq12^T's, the sums by the last
# tiles to finish)

def _epilogue_inputs(dev, B, m, n, seed):
    gen = torch.Generator().manual_seed(seed)
    q11 = torch.rand(B, m, generator=gen) * 3 + 0.5
    q22 = torch.rand(B, n, generator=gen) * 3 + 0.5
    s0 = 0.3 + torch.rand(B, generator=gen)
    s02 = (s0 * s0)[:, None, None]
    den = (torch.sqrt(q11[:, :, None] + s02)
           * torch.sqrt(q22[:, None, :] + s02))
    q12 = (torch.rand(B, m, n, generator=gen) * 2.2 - 1.1) * den - s02
    g = torch.randn(B, m, n, generator=gen)
    return [t.to(dev) for t in (g, q12, q11, q22, s0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n", [(1, 33, 129), (2, 300, 257), (8, 97, 31),
                                   (30, 161, 385), (1, 1, 1)])
def test_backward_epilogue_matches_plain_across_tiles(dev, B, m, n):
    """m and n off the 32 x 128 tile; the planes of dq12 and of dq12^T
    from one launch: big + small is the plain dq12, both are its split
    (zero past n and m), dq11, dq22 and dsigma0 within 1e-5, two runs bit
    for bit (the last tile to finish changes, the order of the sums does
    not)."""
    g, q12, q11, q22, s0 = _epilogue_inputs(dev, B, m, n, B * m + n)
    lib = gram_cuda.load_library()
    got = gram_cuda._bwd_launch(lib, g, q12, q11, q22, s0, _stream(dev))
    again = gram_cuda._bwd_launch(lib, g, q12, q11, q22, s0, _stream(dev))
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    planes, planes_t, dq11, dq22, ds0 = got
    assert planes.shape == (2, B, m, gram_cuda._pitch(n))
    assert planes_t.shape == (2, B, n, gram_cuda._pitch(m))
    dq12 = planes[0, :, :, :n] + planes[1, :, :, :n]
    assert torch.equal(planes, torch.stack(gram_cuda.tf32_split_torch(
        torch.nn.functional.pad(dq12, (0, planes.shape[-1] - n)))))
    assert torch.equal(planes_t, gram_cuda.tf32_split_t_torch(dq12))
    want = gram_cuda.acos_gram_bwd_torch(g, q12, q11, q22, s0)
    _close((dq12, dq11, dq22, ds0), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,n,k", [(1, 129, 257, 1001), (2, 300, 700, 63),
                                     (8, 385, 130, 333), (30, 200, 64, 1002),
                                     (1, 3160, 6400, 2100)])
def test_product_kernel_across_tile_groups(dev, B, m, n, k):
    """Tile rows past the last whole group of 4 (2, 3 and 25 tiles of
    128), k off multiples of 4 and of 32, batches of 1, 2, 8 and 30 in one
    launch: within 1e-5 of a @ b^T, two runs bit for bit."""
    gen = torch.Generator().manual_seed(m + k)
    a = torch.randn((B, m, k), generator=gen).to(dev)
    b = torch.randn((B, n, k), generator=gen).to(dev)
    lib = gram_cuda.load_library()
    pa = gram_cuda._split_t_into(lib, a.mT.contiguous(), _stream(dev))
    pb = gram_cuda._split_t_into(lib, b.mT.contiguous(), _stream(dev))
    got = gram_cuda._product(lib, pa, pb, m, n, k, _stream(dev))
    again = gram_cuda._product(lib, pa, pb, m, n, k, _stream(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = gram_cuda.nt_product_torch(a, b)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_nan_in_one_row_poisons_exactly_that_rows_gradients(dev):
    """A NaN in row i of dq12's operand A poisons row i of the product and
    nothing else (the other rows keep their bits); a NaN in g's row i
    poisons dq12's row i and dq11[i] (and the column sums through it), the
    other rows of dq12 and entries of dq11 keep their bits."""
    lib = gram_cuda.load_library()
    m, n, k = 300, 700, 333
    gen = torch.Generator().manual_seed(5)
    a = torch.randn((1, m, k), generator=gen).to(dev)
    b = torch.randn((1, n, k), generator=gen).to(dev)

    def product(a):
        return gram_cuda._product(
            lib, gram_cuda._split_t_into(lib, a.mT.contiguous(), _stream(dev)),
            gram_cuda._split_t_into(lib, b.mT.contiguous(), _stream(dev)), m,
            n, k, _stream(dev))

    clean = product(a)
    a[0, 137, 200] = float("nan")
    got = product(a)
    assert bool(torch.isnan(got[0, 137]).all())
    rows = torch.arange(m, device=dev) != 137
    assert torch.equal(got[0, rows], clean[0, rows])

    g, q12, q11, q22, s0 = _epilogue_inputs(dev, 1, m, n, 9)
    clean = gram_cuda._bwd_launch(lib, g, q12, q11, q22, s0, _stream(dev))
    g[0, 37, 11] = float("nan")
    got = gram_cuda._bwd_launch(lib, g, q12, q11, q22, s0, _stream(dev))
    dq12 = got[0][0, 0, :, :n] + got[0][1, 0, :, :n]
    dq12_clean = clean[0][0, 0, :, :n] + clean[0][1, 0, :, :n]
    assert bool(torch.isnan(dq12[37, 11])) and bool(torch.isnan(got[2][0, 37]))
    rows = torch.arange(m, device=dev) != 37
    assert torch.equal(dq12[rows], dq12_clean[rows])
    assert torch.equal(got[2][0, rows], clean[2][0, rows])


def _first_mstep_call(x, r, xtilde, theta, n_px):
    """Copies of the arguments of the first M-step objective call of a
    3-iteration fit on the card (float32): the graphed M-step's state
    lives in buffers that later EM iterations overwrite."""
    import numpy as np
    from torch.utils._pytree import tree_map
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as F

    calls = []
    real = F._mstep_objective

    def record(th, *args, **kwargs):
        if not calls:
            calls.append(tree_map(_copy, (th, args, kwargs)))
        return real(th, *args, **kwargs)

    def _copy(v):
        return v.detach().clone() if isinstance(v, torch.Tensor) else v

    cfg = FitConfig(ntilde=xtilde.shape[0], maxiter=3, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=n_px)
    F._mstep_objective = record
    try:
        res = F.fit(x, r, cfg, xtilde=xtilde, theta=theta,
                    f_params={"logA": float(np.log(0.01)), "lambda0": 1.0})
    finally:
        F._mstep_objective = real
    return res, calls[0]


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["duplicated_inducing_rows",
                                    "rf_at_the_border"])
def test_mstep_gradient_through_backward_kernels_in_the_fits_regimes(dev,
                                                                     regime):
    """The fit's M-step value and theta-gradient in float32 through the
    backward kernels against the plain backward (at a cuBLAS q12), in two
    of the reference's failure regimes: duplicated inducing rows (K_tilde
    exactly singular in float32) and a receptive field at the image
    border.  The fit stays finite, and the gradients agree within 1e-3 of
    their largest entry (the M-step's float32 gate, chip_smoke.py)."""
    import numpy as np
    from gaussian_processes_tpu_torch.benchmarks.fparam_route import (
        plain_gram_backward)
    from gaussian_processes_tpu_torch.models import fit as F

    n_px, nt, ntilde = 24, 256, 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((nt, n_px * n_px))
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    center = (0.9, 0.9) if regime == "rf_at_the_border" else (0.1, -0.2)
    w = np.exp(-((xx - center[0]) ** 2 + (yy - center[1]) ** 2)
               / (2 * 0.3 ** 2)).ravel()
    r = rng.poisson(np.exp(0.8 * x @ (w / np.linalg.norm(w)))).astype(float)
    if regime == "duplicated_inducing_rows":
        idx = np.concatenate([np.arange(48), np.arange(16)])
        eps = (0.0, 0.0)
    else:
        idx = np.arange(ntilde)
        eps = (0.9, 0.9)
    theta = {"sigma_0": 1.0, "eps_0x": eps[0], "eps_0y": eps[1],
             "-2log2beta": float(-2 * np.log(2 * 0.3)),
             "-log2rho2": float(-np.log(2 * 0.15 ** 2)), "Amp": 1.0}
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rt = torch.as_tensor(r, dtype=torch.float32, device=dev)
    res, (theta0, args, kwargs) = _first_mstep_call(
        xt, rt, xt[torch.as_tensor(idx, device=dev)], theta, n_px)
    assert not res.failed
    assert bool(torch.isfinite(res.track.logmarginal).all())
    if regime == "duplicated_inducing_rows":
        assert int(res.track.n_eigen[-1]) <= 48
    keys = sorted(theta0)

    def evaluation():
        flat = torch.stack([theta0[k_] for k_ in keys]).requires_grad_(True)
        with torch.enable_grad():
            v = F._mstep_objective({k_: flat[i] for i, k_ in enumerate(keys)},
                                   *args, **kwargs)
            (gr,) = torch.autograd.grad(v, flat)
        return v.detach(), gr

    counts = gram_cuda.read_counts()
    v_kernel, g_kernel = evaluation()
    after = gram_cuda.read_counts()
    assert after["bwd"] > counts["bwd"] and after["product"] > counts["product"]
    assert after["plain_bwd_cuda"] == counts["plain_bwd_cuda"]
    with plain_gram_backward():
        v_plain, g_plain = evaluation()
    assert bool(torch.isfinite(g_kernel).all())
    assert float(v_kernel) == float(v_plain)   # the same forward
    scale = float(g_plain.abs().max())
    assert float((g_kernel - g_plain).abs().max()) <= 1e-3 * scale


def _windowed_problem(dev, n_px=24, nt=256, ntilde=64):
    import numpy as np
    rng = np.random.default_rng(3)
    x = rng.standard_normal((nt, n_px * n_px))
    lin = np.linspace(-1, 1, n_px)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2)).ravel()
    r = rng.poisson(np.exp(0.8 * x @ (w / np.linalg.norm(w)))).astype(float)
    theta = {"sigma_0": 1.0, "eps_0x": 0.2, "eps_0y": -0.1,
             "-2log2beta": float(-2 * np.log(2 * 0.1)),
             "-log2rho2": float(-np.log(2 * 0.15 ** 2)), "Amp": 1.0}
    xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
    rt = torch.as_tensor(r, dtype=torch.float32, device=dev)
    return xt, rt, xt[:ntilde], theta, n_px


@pytest.mark.cuda
def test_graphed_mstep_evaluation_is_the_eager_routes(dev):
    """The M-step evaluation at a fit's first M-step state (its crop
    window's corner in the graph's buffers) as CUDA graph replays: the warm-up
    and every replay equal the eager route's value and gradient bit for
    bit, and 10 replays run under set_sync_debug_mode("error")."""
    from gaussian_processes_tpu_torch.models import fit as F
    from gaussian_processes_tpu_torch.optim import graphed, lbfgs

    x, r, xtilde, theta, n_px = _windowed_problem(dev)
    before = graphed.read_counts()
    res, (theta0, args, kwargs) = _first_mstep_call(x, r, xtilde, theta,
                                                    n_px)
    assert not res.failed
    # the fit took the graph route
    assert graphed.read_counts()["replays"] > before["replays"]
    names = ("es", "m_b", "V_b", "f_params", "win", "xcrop")
    state = {k: kwargs[k] for k in names}
    const = {k: v for k, v in kwargs.items() if k not in names}
    win = kwargs["win"]
    int_win = None if win is None else (int(win[0]), int(win[1]), win[2])
    flat, unflatten, device = lbfgs._flatten(theta0)
    eager = lbfgs._value_and_grad_fn(
        lambda th: F._mstep_objective(th, *args, **dict(kwargs, win=int_win)),
        unflatten, device, flat.dtype)
    v, g = eager(flat)
    before = graphed.read_counts()
    with graphed.GraphedValueAndGrad(
            lambda th, st: F._mstep_objective(th, *args, **const, **st),
            theta0) as gv:
        vg = gv.bind(state)
        outs = [vg(flat)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs += [vg(flat) for _ in range(10)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    after = graphed.read_counts()
    assert after["captures"] == before["captures"] + 1
    assert after["replays"] == before["replays"] + 10
    for v_g, g_g in outs:
        assert torch.equal(v_g, v) and torch.equal(g_g, g)


@pytest.mark.cuda
def test_fit_on_the_graph_route_is_the_eager_fit(dev):
    """The fit on the card through the graphed M-step and through the
    eager one (the route forced off): the same track and theta, bit for
    bit, the same guard decisions under the warm solvers, and the same
    kernel launch counts (a replay's launches counted, a capture's not)."""
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as F
    from gaussian_processes_tpu_torch.optim import graphed
    from gaussian_processes_tpu_torch.utils.tracing import (
        decisions, read_launch_counts, reset_launch_counts)

    x, r, xtilde, theta, n_px = _windowed_problem(dev)
    cfg = FitConfig(ntilde=xtilde.shape[0], maxiter=4, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=n_px, mstep_inverse="schulz",
                    mstep_logdet="series")

    def run():
        decisions.clear()
        reset_launch_counts()
        res = F.fit(x, r, cfg, xtilde=xtilde, theta=theta,
                    f_params={"logA": -4.6, "lambda0": 1.0})
        return res, dict(decisions), read_launch_counts()
    before = graphed.read_counts()
    on_graph, dec_graph, launches_graph = run()
    assert graphed.read_counts()["replays"] > before["replays"]
    real = F._mstep_graph_route
    F._mstep_graph_route = lambda *a: False
    try:
        eager, dec_eager, launches_eager = run()
    finally:
        F._mstep_graph_route = real
    assert torch.equal(on_graph.track.logmarginal, eager.track.logmarginal)
    assert all(torch.equal(on_graph.theta[k], eager.theta[k])
               for k in eager.theta)
    assert dec_graph == dec_eager
    assert launches_graph == launches_eager and launches_eager["bwd"] > 0
    assert dec_graph["mstep.series"] + dec_graph["mstep.chol"] > 0


@pytest.mark.cuda
def test_graph_pools_do_not_pile_up_across_fits(dev):
    """Fits on the graph route one after another: each first capture joins
    the pool of the graph the last fit parked, so the device memory the
    process holds stops growing after the first fit, and ``release`` frees
    the parked graph."""
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as F
    from gaussian_processes_tpu_torch.optim import graphed

    x, r, xtilde, theta, n_px = _windowed_problem(dev)
    cfg = FitConfig(ntilde=xtilde.shape[0], maxiter=4, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=n_px)
    reserved = []
    for _ in range(3):
        F.fit(x, r, cfg, xtilde=xtilde, theta=theta,
              f_params={"logA": -4.6, "lambda0": 1.0})
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    assert graphed._parked
    assert reserved[2] <= reserved[1]
    graphed.release()
    assert not graphed._parked


@pytest.mark.cuda
def test_replay_device_time_is_recorded_only_inside_collect_spans(
        dev, monkeypatch):
    """A fit on the graph route inside ``collect_spans``: ``mstep.replays``
    is the replays the fit made, each timed by a CUDA event pair, and their
    device time lies between 0 and the ``fit.mstep.eval`` spans' host time;
    the same fit outside it makes no timing event and adds to no timer."""
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as F
    from gaussian_processes_tpu_torch.optim import graphed
    from gaussian_processes_tpu_torch.utils import tracing

    x, r, xtilde, theta, n_px = _windowed_problem(dev)
    cfg = FitConfig(ntilde=xtilde.shape[0], maxiter=4, n_estep=3, n_mstep=3,
                    n_fparamstep=3, n_px_side=n_px)
    timed, added = [], []
    real_event, real_add = torch.cuda.Event, tracing.PhaseTimer.add

    def event(*args, **kwargs):
        if kwargs.get("enable_timing"):
            timed.append(1)
        return real_event(*args, **kwargs)

    def add(self, name, amount=1):
        added.append(name)
        real_add(self, name, amount)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(tracing.PhaseTimer, "add", add)

    def run():
        return F.fit(x, r, cfg, xtilde=xtilde, theta=theta,
                     f_params={"logA": -4.6, "lambda0": 1.0})
    before = graphed.read_counts()["replays"]
    run()
    assert graphed.read_counts()["replays"] > before
    assert timed == [] and added == []
    before = graphed.read_counts()["replays"]
    with tracing.collect_spans() as spans:
        run()
    replays = graphed.read_counts()["replays"] - before
    t = spans.totals
    assert replays > 0 and t["mstep.replays"] == replays
    assert 0 < t["mstep.replay_device"] <= t["fit.mstep.eval"]
    assert len(timed) == 2       # one pair for the fit's evaluator
