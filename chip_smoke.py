"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):

1. Set-up: requires a CUDA device, prints the card's name and power limit
   (nvidia-smi), builds the hand-written kernels
   (gaussian_processes_tpu_torch/csrc/acos_gram.cu) from the checkout and
   prints ptxas's register, spill and shared-memory lines for each.
2. Kernels: at the main path's operands -- K_tilde 2100 x 2100 and
   K 3160 x 2100 at contraction 6400 (the 80 x 80 crop window) and 11664
   (the full 108 x 108 grid), and the prediction's K* 30 x 2100 at 11664 --
   the Gram kernel's output against its plain PyTorch version on the same
   operands (max relative error <= 1e-5: the two sum up to 11664 float32
   products in different orders, the kernel in 3xTF32), the same bound on
   K_tilde's diagonal alone (c -> 1, where the tensor cores' accumulation
   is most at risk), the split pass bit for bit against its plain version,
   with the planner's decomposition and median CUDA-event times of each;
   and the theta-gradient through the kernel-forward autograd Function
   against the plain autograd composite at a small shape.
3. Reference: a small fit through the kernel (float32, on the card) against
   the same fit on the CPU in float64 through the plain path.
4. Main path: the single-cell EM fit at bench.py's data and shape (nt 3160
   images of 108 x 108 px, ntilde 2100, 3 EM iterations of 10 E-, 10 M- and
   10 f-param steps), then the r^2 evaluation on 30 test images x 30
   repeats with 200 bootstrap draws.  Kernel launch counts are reset just
   before and read just after.  Then the same fit through the plain Gram
   (backend="torch") on the card: the kernel fit's log-marginal must stay
   within 1e-3 relative of it at every iteration.
5. Kernel at the active loop's shapes: the operands the loop hands the
   kernel at its 258-point capacity buffer (the first 250 pool images and 8
   padded zero rows) -- the refit's K_tilde 258 x 258 at contraction 6400,
   the pool's K* 3160 x 258 at 6400 (the host loop's crop window) and 11664
   (the pipelined loop's full frame), and the per-round test K* 30 x 258 at
   11664 -- against the plain version, with the same bounds as phase 2 and
   finite padded rows.
6. The closed loop at full width: pool = the main path's 3160 images and
   responses, start set the first 250, 8 acquisitions, 4 EM iterations of
   5 E-, 5 M- and 5 f-param steps per refit (benchmarks/
   bench_active_pipelined.py's configuration with depth cut from 24
   acquisitions and 10 EM iterations).  Four arms, kernel launch counts
   reset before and read after each: (a) active_loop, utility, with r^2 and
   the held-out log-likelihood every round; (b) active_loop_pipelined,
   utility; (c) active_loop_pipelined, random; (d) active_loop, random.
   Then the scorer on (a)'s round-0 fit through the kernel against the
   plain Gram (backend="torch") on the card.

The last two lines of standard output are one JSON object with the kernel
table and one with the device.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# bench.py's shape and data (bench.py:56-65, 261-270, 399-404, 464-474)
NT, N_PX, NTILDE = 3160, 108, 2100
THETA0 = {"sigma_0": 1.0, "eps_0x": 0.0001, "eps_0y": 0.0001,
          "-2log2beta": -2 * math.log(2 * 0.1),
          "-log2rho2": -math.log(2 * 0.1 ** 2), "Amp": 1.0}
F_PARAMS0 = {"logA": math.log(0.01), "lambda0": 1.0}
KERNEL_RTOL = 1e-5
# the active loop (benchmarks/bench_active_pipelined.py:31-32, 54-65)
N_START, N_ADD = 250, 8
CAPACITY = N_START + N_ADD
SCORER_RTOL = 1e-4     # pool utilities, kernel vs plain Gram, of max|u|
TIE_RTOL = 1e-5        # two picks whose utilities agree this well tie
GRAD_RTOL = 1e-3       # float32 gradients, two summation orders
REFERENCE_RTOL = 1e-3  # float32 fit on the card vs float64 fit on the CPU
PTXAS_KEYS = ("entry function", "registers", "spill", "smem")


def bench_data(np, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((NT, N_PX * N_PX)).astype(np.float32)
    lin = np.linspace(-1, 1, N_PX)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    w = np.exp(-((xx - 0.1) ** 2 + (yy + 0.2) ** 2) / (2 * 0.1 ** 2)).ravel()
    w = (w / np.linalg.norm(w)).astype(np.float32)
    R = rng.poisson(np.exp(0.8 * X @ w)).astype(np.float32)
    rng_t = np.random.default_rng(1)
    Xt = rng_t.standard_normal((30, N_PX * N_PX)).astype(np.float32)
    Rt = rng_t.poisson(np.exp(0.8 * Xt @ w)[None, :].repeat(30, 0))
    return X, R, Xt, Rt.astype(np.float32)


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Median milliseconds of fn() by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main():
    if not (HERE / "gaussian_processes_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: gaussian_processes_tpu_torch/ not "
                         "found beside this script; run it from a checkout")
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")

    from gaussian_processes_tpu_torch.config import FitConfig, use_full_fp32
    from gaussian_processes_tpu_torch.models.acquisition import (
        score_candidates)
    from gaussian_processes_tpu_torch.models.active import (
        active_loop, active_loop_pipelined)
    from gaussian_processes_tpu_torch.models.fit import fit
    from gaussian_processes_tpu_torch.models.inference import evaluate
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.ops.kernels import (
        crop_window_for_theta, crop_window_from_scalars, gram_matrices,
        gram_matrices_windowed)

    # ---- 1. set-up -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f" (CUDA {torch.version.cuda})")
    use_full_fp32()
    lib = gram_cuda.load_library()
    print(f"kernel build: {gram_cuda.build_seconds:.2f} s; Gram block "
          f"dynamic shared memory {lib.acos_gram_smem_bytes()} B")
    for line in gram_cuda.build_log.splitlines():
        if any(key in line for key in PTXAS_KEYS):
            print("  ptxas:", line.strip())

    X, R, Xt, Rt = bench_data(np)
    x = torch.as_tensor(X, device=device)
    r = torch.as_tensor(R, device=device)
    idx = np.random.default_rng(0).permutation(NT)[:NTILDE]
    xtilde = x[torch.as_tensor(idx, device=device)]
    theta = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in THETA0.items()}

    # ---- 2. kernels vs plain at the main path's operands ----------------
    xt_test = torch.as_tensor(Xt, device=device)

    def recorded_operands(build):
        """The (u1, s2, q11, q22, sigma0) of every Gram that ``build()``
        hands the kernel wrapper, in call order."""
        calls = []
        real = gram_cuda.acos_gram

        def record(*args):
            calls.append([a.detach() for a in args])
            return real(*args)

        gram_cuda.acos_gram = record
        try:
            with torch.no_grad():
                build()
        finally:
            gram_cuda.acos_gram = real
        return calls

    crop = crop_window_from_scalars(THETA0["-2log2beta"], THETA0["eps_0x"],
                                    THETA0["eps_0y"], N_PX)

    def main_path_operands(where: str):
        """K_tilde and K at the crop window of the start theta ("crop") or
        on the full grid ("full"), or K* of the prediction that evaluate
        makes (inference.py:37) at the start theta ("predict"; its K_tilde
        is the full grid's)."""
        if where == "crop":
            calls = recorded_operands(lambda: gram_matrices_windowed(
                theta, x, xtilde, N_PX, False, *crop))
        else:
            calls = recorded_operands(lambda: gram_matrices(
                theta, xt_test if where == "predict" else x, xtilde, N_PX,
                shared=False))
        if where == "predict":
            return [("K*", calls[1])]
        return list(zip(("K_tilde", "K"), calls))

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    results = {}
    split = {"err": 0.0, "checked": 0}

    def check_kernel(name, ops):
        """The kernel against its plain version on one Gram's operands
        (relative error, K_tilde's diagonal, finite output, CUDA-event
        times) and the split pass bit for bit on both operands."""
        m, n, k = ops[0].shape[0], ops[1].shape[0], ops[0].shape[1]
        plan = gram_cuda.plan_gram(m, n, k, sms)
        with torch.no_grad():
            K_kernel = gram_cuda.acos_gram(*ops)
            K_plain = gram_cuda.acos_gram_torch(*ops)
            torch.cuda.synchronize()
            max_abs = float(torch.max(torch.abs(K_kernel - K_plain)))
            rel = max_abs / float(torch.max(torch.abs(K_plain)))
            ms = cuda_ms(torch, lambda: gram_cuda.acos_gram(*ops))
            plain_ms = cuda_ms(torch, lambda: gram_cuda.acos_gram_torch(*ops))
        finite = bool(torch.all(torch.isfinite(K_kernel)))
        print(f"kernel {name} {m}x{n} k={k}: max|dK|/max|K| = {rel:.3e} "
              f"(max|dK| {max_abs:.3e}), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms  [{smi}]")
        print(f"  plan: {plan}")
        if not (finite and rel <= KERNEL_RTOL):
            raise RuntimeError(f"kernel disagrees with its plain version "
                               f"at {m}x{n} k={k}: {rel:.3e}")
        if name.startswith("K_tilde"):
            d_plain = K_plain.diagonal()
            diag = float(torch.max(torch.abs(K_kernel.diagonal() - d_plain)
                                   / torch.abs(d_plain)))
            print(f"  K_tilde diagonal: max relative error {diag:.3e}")
            if not diag <= KERNEL_RTOL:
                raise RuntimeError(f"K_tilde's diagonal disagrees at "
                                   f"k={k}: {diag:.3e}")
        results[(name, k)] = (max_abs, ms, plain_ms)
        # the split pass, bit for bit, on both operands
        for a in ops[:2]:
            split["checked"] += 1
            with torch.no_grad():
                got = gram_cuda.tf32_split(a)
                want = gram_cuda.tf32_split_torch(a)
            for g_, w_ in zip(got, want):
                split["err"] = max(split["err"],
                                   float(torch.max(torch.abs(g_ - w_))))
                if not torch.equal(g_, w_):
                    raise RuntimeError(f"split pass disagrees with its "
                                       f"plain version at "
                                       f"{tuple(a.shape)}")
        return K_kernel

    for where in ("crop", "full", "predict"):
        for name, ops in main_path_operands(where):
            check_kernel(name, ops)
            m, k = ops[0].shape
            if (name, k) == ("K", 6400):
                split_ms = cuda_ms(torch, lambda: gram_cuda.tf32_split(ops[0]))
                split_plain_ms = cuda_ms(
                    torch, lambda: gram_cuda.tf32_split_torch(ops[0]))
                print(f"split pass {m}x{k}: bit-exact, kernel {split_ms:.3f} "
                      f"ms, plain {split_plain_ms:.3f} ms  [{smi}]")
    print(f"split pass bit-exact on {split['checked']} operands")

    # theta-gradient through the kernel-forward Function vs the composite
    gx = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (96, 24 * 24)).astype(np.float32), device=device)

    def theta_grad(backend):
        th = {k: torch.tensor(v, dtype=torch.float32, device=device,
                              requires_grad=True)
              for k, v in {**THETA0, "-2log2beta": 1.0,
                           "-log2rho2": 2.0}.items()}
        Kt, K, _ = gram_matrices(th, gx, gx[:40], 24, shared=False,
                                 backend=backend)
        weights = torch.linspace(-1.0, 1.0, K.numel(), device=device)
        loss = Kt.sum() + (K.reshape(-1) * weights).sum()
        grads = torch.autograd.grad(loss, list(th.values()))
        return torch.stack(grads)

    g_kernel, g_plain = theta_grad("cuda"), theta_grad("torch")
    grad_err = float(torch.max(torch.abs(g_kernel - g_plain))
                     / torch.max(torch.abs(g_plain)))
    print(f"theta-gradient, kernel forward vs plain composite: "
          f"max rel err {grad_err:.3e}")
    if not grad_err <= GRAD_RTOL:
        raise RuntimeError(f"kernel gradient disagrees: {grad_err:.3e}")

    # ---- 3. small fit through the kernel vs float64 on the CPU -----------
    srng = np.random.default_rng(3)
    sx = srng.standard_normal((256, 24 * 24))
    lin = np.linspace(-1, 1, 24)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    sw = np.exp(-((xx - 0.2) ** 2 + (yy + 0.1) ** 2) / (2 * 0.15 ** 2))
    sw = sw.ravel() / np.linalg.norm(sw)
    sr = srng.poisson(np.exp(0.6 * sx @ sw)).astype(np.float64)
    sidx = torch.as_tensor(srng.permutation(256)[:64])
    scfg = FitConfig(ntilde=64, maxiter=3, n_estep=3, n_mstep=3,
                     n_fparamstep=3, n_px_side=24, crop_bucket=4)
    small = {}
    for dev, dt, backend in ((device, torch.float32, "cuda"),
                             ("cpu", torch.float64, "torch")):
        sxt = torch.as_tensor(sx, dtype=dt, device=dev)
        res = fit(sxt, torch.as_tensor(sr, dtype=dt, device=dev), scfg,
                  xtilde=sxt[sidx.to(dev)], theta=THETA0,
                  f_params=F_PARAMS0, backend=backend)
        small[backend] = res.track.logmarginal.double().cpu().numpy()
    ref_err = float(np.max(np.abs(small["cuda"] - small["torch"])
                           / np.abs(small["torch"])))
    print(f"small fit, kernel float32 on the card vs plain float64 on the "
          f"CPU: loss {small['cuda']} vs {small['torch']}, max rel "
          f"{ref_err:.3e}")
    if not ref_err <= REFERENCE_RTOL:
        raise RuntimeError(f"small fit disagrees with the float64 "
                           f"reference: {ref_err:.3e}")

    # ---- 4. the main path ------------------------------------------------
    cfg = FitConfig(ntilde=NTILDE, maxiter=3, n_estep=10, n_mstep=10,
                    n_fparamstep=10, n_px_side=N_PX, track_variational=False)
    torch.cuda.synchronize()
    gram_cuda.launches = 0
    gram_cuda.split_launches = 0
    t0 = time.perf_counter()
    res = fit(x, r, cfg, xtilde=xtilde, theta=THETA0, f_params=F_PARAMS0,
              profile=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = gram_cuda.launches
    _, rates, r2, sigma_r2 = evaluate(
        res, torch.as_tensor(Xt, device=device),
        torch.as_tensor(Rt, device=device), nbootstrap=200)
    r2, sigma_r2 = float(r2), float(sigma_r2)
    torch.cuda.synchronize()
    launches_main = gram_cuda.launches
    split_launches_main = gram_cuda.split_launches

    loss = res.track.logmarginal.double().cpu().numpy()
    print(f"fit init {res.timing['init']:.3f} s; per-iteration s "
          f"{[round(t, 3) for t in res.timing['per_iteration']]}; total "
          f"{fit_s:.3f} s  [{smi}]")
    print(f"logmarginal per iteration: {loss.tolist()}")
    print(f"final theta: { {k: float(v) for k, v in res.theta.items()} }")
    print(f"r2 = {r2:.4f} +/- {sigma_r2:.4f}; rates finite: "
          f"{bool(torch.all(torch.isfinite(rates)))}, shape "
          f"{tuple(rates.shape)}")
    print(f"acos_gram launches: fit {launches_fit}, fit + evaluate "
          f"{launches_main}; split-pass launches {split_launches_main}")

    # the same fit through the plain Gram, on the card
    res_plain = fit(x, r, cfg, xtilde=xtilde, theta=THETA0,
                    f_params=F_PARAMS0, backend="torch")
    loss_plain = res_plain.track.logmarginal.double().cpu().numpy()
    plain_err = float(np.max(np.abs(loss - loss_plain) / np.abs(loss_plain)))
    print(f"logmarginal through the plain Gram: {loss_plain.tolist()}; max "
          f"rel difference {plain_err:.3e}")
    checks = {
        "fit not failed": not res.failed,
        "losses finite": bool(np.all(np.isfinite(loss))),
        "log-marginal improved": bool(loss[-1] > loss[0]),
        "rates finite, shape (30,)": (bool(torch.all(torch.isfinite(rates)))
                                      and tuple(rates.shape) == (30,)),
        "r2 finite": math.isfinite(r2) and math.isfinite(sigma_r2),
        "kernel launched on the main path": launches_main > 0,
        "split pass launched on the main path": split_launches_main > 0,
        "log-marginal within 1e-3 of the plain-Gram fit":
            len(loss) == len(loss_plain) and plain_err <= REFERENCE_RTOL,
    }
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"main path check failed: {what}")

    # ---- 5. the kernel at the active loop's shapes -----------------------
    x_cap = torch.zeros((CAPACITY, N_PX * N_PX), device=device)
    x_cap[:N_START] = x[:N_START]
    loop_operands = [
        ("K_tilde cap", recorded_operands(lambda: gram_matrices_windowed(
            theta, x_cap, x_cap, N_PX, True, *crop))[0]),
        ("K* pool", recorded_operands(lambda: gram_matrices_windowed(
            theta, x, x_cap, N_PX, False, *crop))[1]),
        ("K* pool", recorded_operands(lambda: gram_matrices(
            theta, x, x_cap, N_PX, shared=False))[1]),
        ("K* test", recorded_operands(lambda: gram_matrices(
            theta, xt_test, x_cap, N_PX, shared=False))[1]),
    ]
    for name, ops in loop_operands:
        K_kernel = check_kernel(name, ops)
        padded = K_kernel[N_START:] if name == "K_tilde cap" else K_kernel[
            :, N_START:]
        if not bool(torch.all(torch.isfinite(padded))):
            raise RuntimeError(f"{name}: the padded rows are not finite")
    print(f"split pass bit-exact on {split['checked']} operands")

    # ---- 6. the closed loop at full width --------------------------------
    loop_cfg = FitConfig(maxiter=4, n_estep=5, n_mstep=5, n_fparamstep=5,
                         n_px_side=N_PX, track_variational=False)
    start = np.arange(N_START)
    loop_kw = dict(start_idx=start, n_add=N_ADD, cfg=loop_cfg, theta=THETA0,
                   f_params=F_PARAMS0, seed=0)
    history_a, times_a = [], []
    arms = {
        "a": (active_loop, "utility", dict(
            X_test=Xt, R_test=Rt, X_test_ll=Xt, R_test_ll=Rt[0],
            round_times=times_a, utility_history=history_a)),
        "b": (active_loop_pipelined, "utility", {}),
        "c": (active_loop_pipelined, "random", {}),
        "d": (active_loop, "random", {}),
    }
    out, launches_loop, split_launches_loop = {}, {}, {}
    for arm, (loop, select, extra) in arms.items():
        torch.cuda.synchronize()
        gram_cuda.launches = 0
        gram_cuda.split_launches = 0
        t0 = time.perf_counter()
        o = loop(x, r, select=select, **loop_kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_loop[arm] = gram_cuda.launches
        split_launches_loop[arm] = gram_cuda.split_launches
        out[arm] = o
        print(f"loop ({arm}) {loop.__name__}, {select}: {wall:.3f} s, "
              f"{wall / (N_ADD + 1):.3f} s per round over {N_ADD + 1} refits"
              f"  [{smi}]")
        print(f"  picks {o.selected_idx}; utilities {o.utilities}")
        print(f"  final log-marginal "
              f"{float(o.final_fit.track.logmarginal[-1]):.4f}, logA "
              f"{float(o.final_fit.f_params['logA']):.4f}; acos_gram "
              f"launches {launches_loop[arm]}, split-pass launches "
              f"{split_launches_loop[arm]}")
        picks = o.selected_idx
        checks = {
            f"{N_ADD} distinct picks": (len(picks) == N_ADD
                                        and len(set(picks)) == N_ADD),
            "no pick in the start set": not set(picks) & set(start.tolist()),
            "final fit not failed": not o.final_fit.failed,
            "kernel launched": launches_loop[arm] > 0,
        }
        if select == "utility":
            checks["utilities finite"] = bool(np.all(np.isfinite(
                o.utilities)))
        for what, ok in checks.items():
            if not ok:
                raise RuntimeError(f"loop ({arm}) check failed: {what}")
    a = out["a"]
    print(f"loop (a) r2 per round {a.r2_history}; held-out "
          f"log-likelihood per round {a.test_ll_history}")
    for what, vals in (("r2", a.r2_history + a.r2_sigma_history),
                       ("held-out log-likelihood", a.test_ll_history)):
        if not (len(vals) >= N_ADD + 1 and np.all(np.isfinite(vals))):
            raise RuntimeError(f"loop (a): {what} not finite every round")
    mean = {key: float(np.mean([t[key] for t in times_a if key in t]))
            for key in ("refit", "evaluate", "select")}
    print(f"loop (a) mean s per round: refit {mean['refit']:.3f}, evaluate "
          f"{mean['evaluate']:.3f}, score + pick + grow "
          f"{mean['select']:.3f}  [{smi}]")
    if out["c"].selected_idx != out["d"].selected_idx:
        raise RuntimeError("the random arms picked differently: "
                           f"{out['c'].selected_idx} vs "
                           f"{out['d'].selected_idx}")
    for j, (pa, pb) in enumerate(zip(a.selected_idx,
                                     out["b"].selected_idx)):
        if pa != pb:
            u = history_a[j]
            tie = abs(u[pa] - u[pb]) / abs(u[pa])
            print(f"loops (a) and (b) part at round {j}: picks {pa} and "
                  f"{pb}, (a)'s utilities {u[pa]} and {u[pb]} (relative "
                  f"{tie:.3e}); not compared after it")
            if not tie <= TIE_RTOL:
                raise RuntimeError(f"loops (a) and (b) picked differently at "
                                   f"round {j} without a float32 tie")
            break
    else:
        print("loops (a) and (b) picked the same images")

    # the scorer on (a)'s round-0 fit, through the kernel and the plain Gram
    r_cap = torch.zeros(CAPACITY, device=device)
    r_cap[:N_START] = r[:N_START]
    res0 = fit(x_cap, r_cap, dataclasses.replace(loop_cfg, ntilde=CAPACITY),
               xtilde=x_cap, theta=THETA0, f_params=F_PARAMS0,
               sample_weight=(torch.arange(CAPACITY, device=device)
                              < N_START).float())
    win = crop_window_for_theta(res0.theta, N_PX, loop_cfg.alpha_threshold,
                                loop_cfg.crop_margin, loop_cfg.crop_bucket)
    win = {} if win[2] >= N_PX else dict(zip(("win_i0", "win_j0", "win_w"),
                                            win))
    u_by = {}
    for backend in ("cuda", "torch"):
        u, _ = score_candidates(x, x_cap, res0.theta, res0.f_params,
                                res0.m_b, res0.V_b, res0.B,
                                res0.k_tilde_inv_diag, n_px_side=N_PX,
                                backend=backend, **win)
        u = u.double().cpu().numpy()
        u[start] = -np.inf
        u_by[backend] = u
    free = np.isfinite(u_by["torch"])
    scale = np.max(np.abs(u_by["torch"][free]))
    score_err = float(np.max(np.abs(u_by["cuda"][free]
                                    - u_by["torch"][free])) / scale)
    pick = int(np.argmax(u_by["cuda"]))
    u_plain_max = float(np.max(u_by["torch"]))
    pick_gap = (u_plain_max - u_by["torch"][pick]) / abs(u_plain_max)
    print(f"scorer on (a)'s round-0 fit (window {win or 'full frame'}): "
          f"kernel vs plain Gram max|du|/max|u| {score_err:.3e}; kernel's "
          f"pick {pick} (loop (a) picked {a.selected_idx[0]}), the plain "
          f"scorer's utility there {u_by['torch'][pick]} vs its maximum "
          f"{u_plain_max} (relative gap {pick_gap:.3e})")
    if not (bool(np.all(np.isfinite(u_by["cuda"][free])))
            and score_err <= SCORER_RTOL and pick_gap <= SCORER_RTOL):
        raise RuntimeError("the scorer through the kernel disagrees with the "
                           "scorer through the plain Gram")

    launches_total = launches_main + sum(launches_loop.values())
    split_launches_total = (split_launches_main
                            + sum(split_launches_loop.values()))
    max_abs, ms, plain_ms = results[("K", 6400)]
    source = "gaussian_processes_tpu_torch/csrc/acos_gram.cu"
    replaces = "gaussian_processes_tpu/ops/gram_pallas.py:80"
    print(json.dumps({"kernels": [{
        "name": "acos_gram",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches_total,
        "max_abs_err": max(v[0] for v in results.values()),
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "tf32_split",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": split_launches_total,
        "max_abs_err": split["err"],
        "ms": split_ms,
        "plain_ms": split_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
