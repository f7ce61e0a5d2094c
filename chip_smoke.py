"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):

1. Set-up: requires a CUDA device, prints the card's name and power limit
   (nvidia-smi), builds the hand-written kernels
   (gaussian_processes_tpu_torch/csrc/acos_gram.cu and fparam_lbfgs.cu,
   one nvcc each, started together) from the checkout and prints ptxas's
   register, spill and shared-memory lines for each; fails when the
   f-param kernel spills or keeps a stack frame.
2. Kernels: at the main path's operands -- K_tilde 2100 x 2100 and
   K 3160 x 2100 at contraction 6400 (the 80 x 80 crop window) and 11664
   (the full 108 x 108 grid), and the prediction's K* 30 x 2100 at 11664 --
   the Gram kernel's output against its plain PyTorch version on the same
   operands (max relative error <= 1e-5: the two sum up to 11664 float32
   products in different orders, the kernel in 3xTF32), the same bound on
   K_tilde's diagonal alone (c -> 1, where the tensor cores' accumulation
   is most at risk), the split pass bit for bit against its plain version,
   with the planner's decomposition and median CUDA-event times of each;
   the theta-gradient through the kernel-forward autograd Function (the
   backward kernels) against the plain autograd composite at a small
   shape.  Then the Gram's backward kernels at the M-step's operands
   (K_tilde 2100 x 2100 and K 3160 x 2100 at contraction 6400 and 9216,
   the 80- and 96-px crop windows): K bit for bit with and without the
   forward's q12 output; on a seeded g and the forward's q12, every output
   of the kernel backward (du1, ds2, dq11, dq22, dsigma0) within 1e-5 of
   the plain backward's largest magnitude (``gram_backward_torch``: the
   plain epilogue and two FP32 matmuls on the same g and q12), two runs
   bit for bit, the
   epilogue's dq12 (the sum of its two planes) against the plain one, the
   transposing split bit for bit on s2 and u1 and dq12^T's planes against
   the split of dq12, each product against the FP32 matmul on the
   kernel's dq12; median CUDA-event ms of each kernel launched alone, its
   plain version and (products, dU1 and dS2) the FP32 ``torch.matmul``,
   beside each bound, and each kernel's device time a call over 5 calls
   back to back.
3. Reference: a small fit through the kernel (float32, on the card) against
   the same fit on the CPU in float64 through the plain path.
4. Main path: the single-cell EM fit at bench.py's data and shape (nt 3160
   images of 108 x 108 px, ntilde 2100, 3 EM iterations of 10 E-, 10 M- and
   10 f-param steps), then the r^2 evaluation on 30 test images x 30
   repeats with 200 bootstrap draws.  Kernel launch counts are reset just
   before and read just after; the f-param search kernel launches once a
   search; the Gram's backward kernels launched, and the plain backward
   called on CUDA tensors 0 times.  Then the same fit through the plain
   Gram and the plain f-param search (backend="torch") on the card: the
   kernel fit's log-marginal must stay within 1e-3 relative of it at every
   iteration.
5. Kernel at the active loop's shapes: the operands the loop hands the
   kernel at its 254-point capacity buffer (the first 250 pool images and 4
   padded zero rows) -- the refit's K_tilde 254 x 254 at contraction 6400,
   the pool's K* 3160 x 254 at 6400 (the host loop's crop window) and 11664
   (the pipelined loop's full frame), and the per-round test K* 30 x 254 at
   11664 -- against the plain version, with the same bounds as phase 2 and
   finite padded rows.
6. The closed loop at full width: pool = the main path's 3160 images and
   responses, start set the first 250, 4 acquisitions, 4 EM iterations of
   5 E-, 5 M- and 5 f-param steps per refit (benchmarks/
   bench_active_pipelined.py's configuration with depth cut from 24
   acquisitions and 10 EM iterations).  Four arms, kernel launch counts
   reset before and read after each: (a) active_loop, utility, with r^2 and
   the held-out log-likelihood every round; (b) active_loop_pipelined,
   utility; (c) active_loop_pipelined, random; (d) active_loop, random.
   Then the scorer on (a)'s round-0 fit through the kernel against the
   plain Gram (backend="torch") on the card.
6b. The f-param search kernel (csrc/fparam_lbfgs.cu) against its plain
   version (the host-driven zoom L-BFGS through autograd) at the main
   paths' operands: the r, lambda_m, lambda_var and logA that phase 4's
   fit handed its first and its last search (nt 3160), and loop (a)'s
   first search (the 254-row buffer with 4 weight-0 rows), each in
   float64 and float32 at 15 and 4 line-search trials, with the bounds
   stated beside FPARAM_TRIALS; CUDA-event medians per search and per
   evaluation of the kernel, the plain route's per search, the kernel's
   device time a search with searches back to back, and the bound.
   The same at nt 32 on the card tests' seeded moments (one row a lane:
   the fixed cost of an evaluation's reductions and state machine).  Then
   the f-param device time inside phase 4's fit: every search it handed
   the kernel, replayed back to back between two CUDA events.

7. The batched kernel at the population's shapes: one chunk of (cell,
   line-search trial) items of the M-step's ladder (as many as
   ``parallel/population.ladder_items`` gives the card's memory, at most
   16 cells x 6 trials), K_tilde 512 x 512 and K 3160 x 512 at contraction
   11664 (the full frame), one launch each, against the plain batched
   version (max relative error <= 1e-5, the same on every item's K_tilde
   diagonal) and each item against the 2-D kernel call on its operands;
   ``out=`` writes a row block and nothing around it.  Plan, CUDA-event
   medians of kernel, plain and the cuBLAS product alone.  The backward
   kernels on both batched Grams, as phase 2 holds them; and the device
   memory a (cell, trial) item of the M-step's gradient call and of its
   value call takes at this shape, against the shares ``ladder_items``
   and ``GRAD_CHUNK_DIVISOR`` give them.
8. Population at full width: benchmarks/bench_population.py's data and
   shape (nt 3160 images of 108 x 108 px, 16 cells with receptive fields
   of sigma 0.1 at centres uniform in +-0.3, ntilde 512 drawn by a numpy
   permutation, 6 EM iterations of 10/10/10 steps).  ``fit_population``
   through the kernel, launch counts reset before and read after; every
   lane finite and not failed; lanes 0 and 1 against the single-cell
   ``fit`` with the Armijo search on the full frame, and the whole
   population against the same population through the plain Gram, each
   log-marginal within 1e-3 relative at every iteration; then
   ``fit_cells_sequential`` on 2 cells with the zoom search.  Seconds per
   cell of both routes beside their final log-marginals, and the stream
   synchronizations of one population EM iteration (torch.profiler).  Then
   the bench's 41-cell recording in one population (3 EM iterations):
   every lane finite and not failed, and the peak device memory of both
   populations, which the chunks of Grams keep from growing with the
   cells.
9. The large-ntilde path: benchmarks/bench_large_ntilde.py's shape (n =
   50,000 images of 48 x 48 px, its theta, jitter 1.0).  ``large_gram``
   (row blocks of 8192 through the kernel's ``out=``) with 3 sampled row
   blocks against the plain version (<= 1e-5), ``large_cholesky``, each
   timed by CUDA events closed by a value readback; the same again, warm,
   through the benchmark module's ``large_ntilde.run`` (its record, which
   phase 16 holds to n = 50,000); then
   ``large_posterior_mean`` with y and 8 test images from the seed, its
   residual ||(K + I) alpha - y|| / ||y|| accumulated by row blocks in
   float64 (bound LARGE_RESIDUAL) and its normwise backward error
   (bound LARGE_BACKWARD).
10. The entry points.  (a) The reduced-rank fit (``reduced_rank=True``,
   ``track_basis=True``) at phase 4's data, shape and steps through the
   kernel: per iteration its rank budget, kept rank and seconds beside
   phase 4's full-rank seconds; the budget never saturates and the
   log-marginal stays within 1e-3 relative of phase 4's at every
   iteration; both fits' inner-objective evaluations (the host-bound
   work) and their ``fit.*`` spans' host seconds (``collect_spans``); then
   one more fit of each, back to back (full, reduced).
   (b) ``state_at_iteration`` and ``evaluate(at_iteration=)`` on that fit:
   finite rates at iteration 1, and the last iteration's reconstruction
   within RECON_RTOL (3e-5) relative of ``predict``, then rebuilt with the
   fit's own eigenvalues and final V_b swapped in, alone and together, to
   show which one the gap comes from: with both, within RECON_EIG_RTOL
   (1e-5).  (c) The CLI's fit
   (``examples.one_cell_fit.main``) at its own defaults, in-process, with
   ``--out`` under build/; its loaded checkpoint predicts bit for bit what
   the fit in memory predicts.  (d) ``entry()`` and its forward through
   the kernel; ``gram_matrices`` through the kernel against the plain Gram
   (1e-5) for K_tilde and K* on entry()'s operands.  Then the kernel
   against its plain version (as in phase 2) at every 2-D shape that
   (a)-(d) launched and phases 2 and 5 had not held.  (e) The large path's
   Grams alone (n 50,000, k 2304): its first 8192-row block and its last
   848-row block (``out=``) and its K* 8 x 50,000, each against the plain
   version, with CUDA-event times of kernel, plain and the cuBLAS product.
   Each path's launches are counted from 0 and added to the kernel
   table's.
11. The other line searches and the convergence gates at phase 4's data,
   shape and steps, each fit through the kernel with its launches counted
   from 0: (a) ``linesearch="speculative"`` with ``mstep_memory``, then
   the same fit through the plain Gram (log-marginal within 1e-3 relative
   at every iteration); (b) "zoom_carry"; (c) "backtracking"; (d) "zoom"
   with ``mstep_ftol_rel=1e-4, estep_tol=1e-3``.  Each fit finite, not
   failed and improving, with its seconds, objective evaluations (the
   batched ladder calls and their trials apart), Newton steps and final
   log-marginal beside phase 4's.  Then the batched kernel at the
   ladder's shapes (armijo_trials x K_tilde 2100 x 2100 and K 3160 x 2100
   at the window's k): on the M-step's batched evaluator at trials along a
   seeded direction from the start theta, against the plain batched Gram
   as phase 7 holds it (1e-5, every item's K_tilde diagonal too, each item
   against the 2-D call); and on (a)'s first M-step ladder, whose trials
   lie far along the cold search's unscaled -g where the float32 Grams
   are ill-conditioned: kernel vs plain within 1e-5, and both against a
   float64 plain Gram, the kernel no further from it than 1e-5 or the
   plain float32 version (the K_tilde diagonals item by item).
12. The JAX package's default solvers and the projected M-step Gram at
   phase 4's data, shape and steps, each fit through the kernel with its
   launches counted from 0: (a) the reduced-rank fit under the subspace
   eigensolver (refresh every 2nd iteration), Newton-Schulz E-step and
   M-step inverses and the series log-determinant, within 1e-3 relative of
   phase 10(a)'s reduced eigh fit at every iteration, with each
   iteration's route (warm, refresh, fallback), budget and kept rank, the
   solvers' host decisions, seconds and ``fit.*`` spans beside phase
   10(a)'s, and the host synchronizations of each EM iteration by op
   (torch.profiler) for both fits; (b) (a) with ``mstep_gram="projected"``
   (rank from ``suggest_proj_rank``): the projection guard's passes and
   fallbacks, Gram launches by shape, within 1e-3 of (a), and the same fit
   through the plain Gram within 1e-3; (c) the kernel against its plain
   version (phase 2's ``check_kernel``) at the projected shapes, K_tilde
   2100 x 2100 and K 3160 x 2100 at k = R^2 for (b)'s rank and the bench's
   pinned rank 40; (d) ``masked_inverse_warm`` at (a)'s rank budget on a
   trial K_tilde_b near (a)'s final state against a float64 inverse, timed
   beside ``masked_inverse_spd``; (e) the kernel alone at the 2-D shapes
   that launch >= 20 times on the main paths and no phase held: K_tilde
   254 x 254 at 11664, and 512 x 512 and 3160 x 512 at 6400 and 11664.
13. The mesh at world 1 (one card holds one NCCL rank): (a) a world-1 NCCL
   process group of this process and ``make_mesh(1, 1)`` on "cuda", with
   NCCL's version; (b) ``sharded_gram`` at bench.py's shape (x 3160 rows,
   xtilde 2100, k 11664) through the kernel against ``gram_matrices``
   with the plain backend (1e-5); (c) ``fit(mesh=)`` at phase 4's data,
   shape and depth: log-marginal within 1e-5 relative at every iteration
   of phase 4's fit run on the mesh's own f-param route, the host-driven
   search (the mesh does not take the f-param kernel), and within
   MESH_KERNEL_RTOL of phase 4's fit (the kernel), beside phase 4's fit
   against its float64 twin on the plain routes; with its seconds, its
   collectives per EM iteration
   (``parallel/collectives.calls``) and its ``fit.*`` spans, then one
   f-param value+grad evaluation at its final moments timed plain and
   through the collectives (in turns) and one world-1 all-reduce; (d)
   ``fit_population(mesh=)`` at phase 8's 16 cells cut to 2 EM iterations
   after init, against ``mesh=None`` at the same depth (1e-5); (e)
   ``distributed_cholesky`` at n 16384 (K + I of 48 px images) against
   ``torch.linalg.cholesky``, with ||L L^T - A||_F / ||A||_F and the
   CUDA-event times of both; (f) ``dryrun_multichip(1)`` on the card, then
   ``dryrun_multichip(4, device="cpu")`` in a gloo world of four CPU
   processes.  The kernel launches of (b)-(d) are counted from 0 and added
   to the kernel table's.
14. The functions no fit calls, at phase 4's data and shape, float64 on
   the card unless said otherwise: (a) at THETA0 with the eigenspace of
   K_tilde there and a generic kept-subspace (m_b, V_b) from a numpy seed
   (tests/test_gradients.py's), the M-step gradient composed from the
   analytic chain (``ops/analytic_grads.analytic_mstep_grad``, dense C and
   its five derivatives on the full 108 x 108 grid) against autograd of
   ``_mstep_objective`` called as the fit calls it, on the crop window:
   (i) float64 plain, within 1e-6; (ii) float32 plain; (iii) float32
   through the Gram kernel, within max(1e-3, 2 x (ii)), its launches
   counted from 0 and added to the kernel table's; error max_k |g_k -
   g_an,k| / max_k |g_an,k|, with the chain's seconds and peak memory.
   (b) ``update_f_params_newton`` from F_PARAMS0 at the moments of phase
   4's final state: iterations (one host read each), each component of
   ``ell_grad_f_params`` at the result below 1e-3, and its ELL no lower
   than that of phase 4's final f-params.  (c) On phase 4's final state
   sliced to its kept coordinates, ``estep_update_damped(alpha=1)`` within
   1e-8 and ``estep_update_V_inv`` within 1e-6 of ``estep_update``,
   relative to the norm of the result.
15. The port's bench (``gaussian_processes_tpu_torch/bench.py``, the
   counterpart of bench.py) at full shape and depth, once: the kernel
   against its plain version at the bench's five Gram operands (1e-5, and
   each K_tilde diagonal); bench.py's data with the JAX package's inducing
   rows, 30 EM iterations of 10/10/10 steps under the JAX bench's knobs,
   timed on the host clock; the easy gate (final loss within 25 of
   1604.0) with the easy r^2 beside it; the hard gate (synthetic_retina_hard
   seed 0, STA init, r^2 >= 0.565), both r^2 with the JAX bootstrap's
   permutations.  Prints the bench's JSON record, the launches by shape,
   the objective evaluations and the ``fit.*`` spans; fails when a fit
   fails or goes non-finite, the kernel check misses, the fit or the hard
   fit launches the kernel zero times, or a gate fails.  Both fits'
   launches are added to the kernel table's.  Then the kernel against its
   plain version (as in phase 2) at every 2-D shape the bench launched
   and no earlier phase held (the crop windows its fits move through).
   Then the f-param device time of the timed fit: its 290 searches,
   recorded from one more, untimed fit of the same data and
   configuration, replayed as in phase 6b.  The timed fit must have
   launched the Gram's backward kernels and called the plain backward on
   CUDA tensors 0 times.  And one M-step evaluation (value and gradient,
   as the optimizer takes them) at the untimed fit's first M-step state:
   its host ms, then under torch.profiler its device time by kernel name,
   split into the Gram forward, the Gram backward and the rest; the same
   evaluation with the plain backward (``gram_backward_torch`` at a q12
   recomputed by an FP32 matmul) beside it.
16. The JAX bench's five secondaries and its parity script, through the
   port's ``gaussian_processes_tpu_torch/benchmarks/`` modules, in process,
   each ``run()`` at its script's full shape and defaults but three depths:
   the pipelined loop at 1 acquisition (the script: 24; the CLI's ``bench
   --secondary`` runs the bench's 16; phase 6 drives both pipelined arms
   at 4), the refit timed twice (the script: 6) and the population at 8
   cells (the script: 16, 8 and 4; the bench's secondary: 8; phase 8 runs
   16 and 41): the acquisition scorer, the active refit and its reduced
   arm, the pipelined loop's three arms, the population batched and
   sequential, and the posterior's float32 arms against float64.  The 50k
   Gram and Cholesky ran in phase 9 (its warm pass is
   ``large_ntilde.run``); its record is held here.  Each module's
   launches are counted from 0 and added to the kernel table's; then the
   kernel against its plain version (as in phase 2) at every 2-D shape it
   launched that no earlier phase held, and the batched kernel (as in
   phase 7) on its first two batched Grams.  Prints each record; fails
   when a module raises or its own check fails, a kernel check misses 1e-5
   (entries or a K_tilde diagonal), the large path did not run at n =
   50,000, or the parity module's kernel arm misses 1e-5.
17. The quality benchmarks, through the port's modules in process at full
   width, their depth cut, each counted and held as in phase 16: (a)
   ``hard_quality.run`` on the hard data of seed 0 (the bench's shape, JAX's
   inducing rows, the STA init), rungs exact, mid, gated and rel_1e-4 (every
   knob value the ladder sets: absolute ftol 0.3 and 1.0, relative ftol,
   estep_tol, zoom budgets 15, 8 and 4) at 3 EM iterations, no warm fit,
   with the oracle's r^2; (b) ``bad_init.run`` at 3 EM iterations, with
   the coverage re-runs that fired and the eps; (c)
   ``ab_active_vs_random_hard.run`` for seed 0 at 2 acquisitions from its 50
   start images (the script: 150), at the script's refit depth.  Fails
   when a module raises or its own check fails, a kernel check misses
   1e-5, an A/B arm's picks repeat or fall in the start set, an r^2 is not
   finite, or the one-seed summary's SEM is not null.

From phase 4 to the end the Gram's backward is watched: the first forward
operands it is handed at each (batch, m, n, k) that phases 2 and 7 do not
hold are copied to the host, and after phase 17 the backward kernels are
held at each such shape as phase 2 holds them (3 timed repeats): the
active loop's buffers, the crop windows the bench's fits move through, the
batched population's chunks, the products whose contraction splits.

The last two lines of standard output are one JSON object with the kernel
table (acos_gram, acos_gram_batched, tf32_split, fparam_lbfgs,
acos_gram_bwd, tf32_split_t, nt_product; launches over the main paths,
the f-param search's times from phase 6b at phase 4's last search in
float32, the backward kernels' from phase 2 at K 3160 x 2100, k 6400,
each with its device time a call back to back, the product's dU1 with
dS2's times, library ms and bound beside it) and one with the device.
"""

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# bench.py's shape and init (bench.py:56-65, 399-404); its data comes from
# the port's bench (make_data, make_test_data)
NT, N_PX, NTILDE = 3160, 108, 2100
THETA0 = {"sigma_0": 1.0, "eps_0x": 0.0001, "eps_0y": 0.0001,
          "-2log2beta": -2 * math.log(2 * 0.1),
          "-log2rho2": -math.log(2 * 0.1 ** 2), "Amp": 1.0}
F_PARAMS0 = {"logA": math.log(0.01), "lambda0": 1.0}
KERNEL_RTOL = 1e-5
# the active loop (benchmarks/bench_active_pipelined.py:31-32, 54-65)
N_START, N_ADD = 250, 4
CAPACITY = N_START + N_ADD
SCORER_RTOL = 1e-4     # pool utilities, kernel vs plain Gram, of max|u|
TIE_RTOL = 1e-5        # two picks whose utilities agree this well tie
GRAD_RTOL = 1e-3       # float32 gradients, two summation orders
# the backward kernels against the plain backward on the same g and q12,
# of the plain value's largest magnitude: the products sum up to 11664
# float32 terms in other orders, in 3xTF32
BWD_RTOL = 1e-5
MSTEP_SPLIT_EVALS = 5  # M-step evaluations profiled in phase 15
REFERENCE_RTOL = 1e-3  # float32 fit on the card vs float64 fit on the CPU
# the last tracked iteration rebuilt by state_at_iteration against predict:
# the rebuild takes k_tilde_b_diag as the Rayleigh quotients diag(B^T K B),
# which in float32 sit up to 1.53e-3 from the fit's eigenvalues on the
# smallest kept ones (~n eps lambda_max).  On the H100 the rates read
# 1.159e-5 in every run; with the fit's eigenvalues swapped in, 3.99e-6
# (basis, m_b and V_b read equal; what remains is the products' width,
# 2100 against the fit's 384); with its final V_b, no change.  Bounds:
# about 2.5x each reading.
RECON_RTOL = 3e-5
RECON_EIG_RTOL = 1e-5
PTXAS_KEYS = ("entry function", "registers", "spill", "smem")
# the population (benchmarks/bench_population.py:33-37, 53-73)
POP_NTILDE, POP_CELLS, POP_TRIALS = 512, 16, 6
POP_STEPS = dict(maxiter=6, n_estep=10, n_mstep=10, n_fparamstep=10)
POP_THETA = {"sigma_0": 1.0, "eps_0x": 1e-4, "eps_0y": 1e-4,
             "-2log2beta": -2 * math.log(0.2), "-log2rho2": -math.log(0.02),
             "Amp": 1.0}
POP_RTOL = 1e-3        # float32 lanes: batched vs single-cell, kernel vs plain
POP_SEQ_CELLS = 2
# the lab's recording (benchmarks/bench_population.py:3-5, 57-59): its 41
# cells in one population, depth cut to 3 EM iterations
POP_RECORDING_CELLS, POP_RECORDING_ITERS = 41, 3
# the large-ntilde path (benchmarks/bench_large_ntilde.py:33, 52-60, 79)
LARGE_N, LARGE_PX, LARGE_NB, LARGE_JITTER = 50_000, 48, 8192, 1.0
LARGE_THETA = {"sigma_0": 1.0, "eps_0x": 0.0, "eps_0y": 0.0,
               "-2log2beta": -2 * math.log(2 * 0.25),
               "-log2rho2": -math.log(2 * 0.1 ** 2), "Amp": 1.0}
# ||(K + I) alpha - y|| / ||y|| of the float32 factor and solves: 3.4e-3 on
# the first card run (K's entries average ~70, so lambda_max ~ 3e6 against
# lambda_min >= 1); the bound is 3x that.  The normwise backward error,
# ||r|| / (||K + I||_F ||alpha|| + ||y||), was 4.9e-9: a backward-stable
# float32 solve stays within a few float32 epsilons (1.2e-7), bound 1e-6.
LARGE_RESIDUAL = 1e-2
LARGE_BACKWARD = 1e-6
# phase 11: phase 4's fit under the other line searches and the gates
LS_FITS = {
    "a": ("speculative, mstep_memory",
          dict(linesearch="speculative", mstep_memory=True)),
    "b": ("zoom_carry", dict(linesearch="zoom_carry")),
    "c": ("backtracking", dict(linesearch="backtracking")),
    "d": ("zoom, mstep_ftol_rel 1e-4, estep_tol 1e-3",
          dict(mstep_ftol_rel=1e-4, estep_tol=1e-3)),
}
# phase 12: the JAX FitConfig defaults' solvers (JAX config.py:160-162,
# 240-257), with a refresh of the subspace eigensolver every 2nd iteration,
# and bench.py's pinned projection rank (bench.py:215)
WARM_KNOBS = dict(reduced_rank=True, eigensolver="subspace",
                  eigh_refresh_every=2, estep_solver="schulz",
                  mstep_inverse="schulz", mstep_logdet="series")
PINNED_PROJ_RANK = 40
# the warm M-step inverse in float32 against a float64 inverse: no further
# from it than this, or than twice the float32 Cholesky inverse
WARM_INVERSE_RTOL = 1e-4
# phase 13: the distributed Cholesky at world 1 against cuSOLVER's, and its
# ||L L^T - A||_F / ||A||_F bound (a float32 factor's is ~n eps ||A||)
MESH_CHOL_N, MESH_CHOL_RESID = 16384, 1e-5
# phase 13(c): fit(mesh=) (the host-driven f-param search) against phase 4's
# fit (the f-param kernel).  The two differ only in the search's float32
# path, which stops within the minimum's float32 flat width (phase 6b), so
# they agree to float32 rounding, not to 1e-5: 1.724e-5 in every reading on
# the H100.  The bound sits above that and below phase 4's own float32
# rounding, which its float64 twin on the plain routes shows in the same
# phase (2.786e-4 on the H100).
MESH_KERNEL_RTOL = 5e-5
# phase 14: autograd of the float64 M-step objective against the analytic
# chain, the legacy f-param Newton's ELL gradient at its result, and the
# alpha-1 E-step variants against estep_update (relative to the norm)
ANALYTIC_F64_RTOL = 1e-6
FPARAM_GRAD_ATOL = 1e-3
DAMPED_RTOL, V_INV_RTOL = 1e-8, 1e-6
# phase 16: the pipelined loop's acquisitions (the script's 24, the
# bench's 16; phase 6 drives both pipelined arms at full width), the
# refit's timed fits (the script's 6) and the population's cells (the
# script's 16, 8 and 4; the bench's secondary sets 8)
PIPE_N_ADD = 1
REFIT_REPS = 2
POP_CELLS = 8
# phase 17: four rungs that set every knob value the ladder sets (absolute
# ftol 0.3 and 1.0, relative ftol, estep_tol, zoom budgets 15, 8 and 4),
# the fits' depth (3 EM iterations hold one M-step, where the gates and
# budgets act), and the A/B's acquisitions (the script's 150)
QUALITY_RUNGS = ("exact", "mid", "gated", "rel_1e-4")
QUALITY_MAXITER = 3
BAD_INIT_MAXITER = 3
AB_N_ADD = 2
# phase 6b: the f-param search kernel against its plain version, at each
# trial budget the fits use (FitConfig's 15, the quality ladder's 4).
# float64 is held step by step: run for k = 1, 2, ... steps, the kernel
# takes as many evaluations as the plain search and lands within
# FPARAM_F64_ATOL of it, until the plain search sits at its minimum (value
# within FPARAM_CONVERGED of its final one); past that point the trials are
# decided by last-ulp differences of the two evaluations.  At the full step
# count both values within FPARAM_CONVERGED and both logA within
# FPARAM_F64_ATOL (a float64 minimum is flat over sqrt(2 * 2^-52 |f| / f''),
# about 2e-8 at these operands, so the bound holds the two searches to one
# point, not to the flat width), and float32 by outcome: the profiled objective
# (float64, on the same inputs) at the two results within
# FPARAM_F32_VALUE_RTOL, and logA within FPARAM_F32_ATOL or, where the
# objective is flatter, within the distance over which it rises by one
# float32 rounding of its value, sqrt(2 * 2^-23 |f| / f''): two float32
# searches cannot tell such points apart (phase 4's first E-step on the
# H100: 1.2e-4 apart, the objective 9e-9 relative, the width 4e-4).
FPARAM_TRIALS = (15, 4)
FPARAM_F64_ATOL, FPARAM_CONVERGED = 1e-9, 1e-12
FPARAM_F32_ATOL, FPARAM_F32_VALUE_RTOL = 1e-4, 1e-5
# operations the function needs a row of one evaluation, each row's work
# counted once (the kernel's three passes recompute z; the bound does not):
# z = A lambda_m + (A^2 / 2) lambda_var 3 (two products, a sum), its max 1,
# exp(z - max) 2 and its sum 1, g = A lambda_m + 2 (A^2 / 2) lambda_var from
# z's two products 2, f = exp(z - max) exp(max + lambda0) 1 and its sum 1, f g
# and its sum 2: 13, and 1 more where a weight selects the rows.
# sum(p g) = sum(w f g) / sum(w r) takes no work a row.  Once a search:
# sum(w r lambda_m) and sum(w r), 3 a row (4 with a weight).
FPARAM_ROW_FLOPS, FPARAM_ROW_FLOPS_ONCE = 13, 3
# peaks of one H100 SXM (NVIDIA's data sheet, dense): the bounds' rates
TF32_FLOPS, HBM_BYTES = 495e12, 3.35e12
FP32_FLOPS, FP64_FLOPS = 67e12, 34e12


def cuda_ms(torch, fn, reps=20, warmup=3, inner=1):
    """Median milliseconds of fn() by CUDA events, around one call (which
    then includes the host's launch where the card waits for it) or
    ``inner`` calls back to back (the device's time a call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def gram_bound(batch, m, n, k):
    """(ms, "operations" or "bytes"): the least time the card could take
    for a Gram -- the three TF32 products (2 m n k FLOPs each, per item) at
    the dense TF32 peak, or reading u1, s2, q11, q22, sigma0 once and
    writing K once (float32) at the HBM rate, whichever is larger."""
    ops_ms = 3 * 2 * batch * m * n * k / TF32_FLOPS * 1e3
    bytes_ms = 4 * batch * (m * k + n * k + m + n + 1 + m * n) / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                             "bytes")


def split_bound(rows, k):
    """The split pass: read a (rows, k) float32 operand once, write its two
    planes once (bytes-bound: one subtraction and one rounding a float)."""
    return 4 * rows * k * 3 / HBM_BYTES * 1e3, "bytes"


def product_bound(batch, m, n, k):
    """The product kernel, out (m, n) = A B^T over k per item: its three
    TF32 products (2 m n k FLOPs each) at the dense TF32 peak, or reading
    A and B once and writing out once at the HBM rate, the larger."""
    ops_ms = 3 * 2 * batch * m * n * k / TF32_FLOPS * 1e3
    bytes_ms = 4 * batch * (m * k + n * k + m * n) / HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                             "bytes")


def bwd_bound(batch, m, n):
    """The backward epilogue's function: read g, q12 (m, n), q11, q22 and
    sigma0 once, write dq12, dq11, dq22 and dsigma0 once (float32;
    bytes-bound: about 40 operations an element against 12 bytes).  The
    kernel writes dq12 as the four TF32 planes that the products read, 24
    bytes an element (``bwd_design_ms``), and so saves the products'
    transposing split of dq12."""
    return 4 * batch * (3 * m * n + 2 * (m + n) + 2) / HBM_BYTES * 1e3, "bytes"


def bwd_design_ms(batch, m, n):
    """The epilogue kernel's own traffic at the memory rate: g and q12 in,
    the four TF32 planes of dq12 and dq12^T out (24 bytes an element)."""
    return 4 * batch * (6 * m * n + 2 * (m + n) + 2) / HBM_BYTES * 1e3


# the (batch or None, m, n, k) at which check_backward has held the
# backward kernels
BWD_CHECKED = set()


def backward_key(u1, s2):
    """A Gram's (batch or None for a 2-D Gram, m, n, k)."""
    return (u1.shape[0] if u1.dim() == 3 else None, u1.shape[-2],
            s2.shape[-2], u1.shape[-1])


@contextlib.contextmanager
def backward_operands(gram_cuda, seen, where):
    """Keeps in ``seen[backward_key] = (phase, operands)`` a host copy of
    the forward operands (u1, s2, q11, q22, sigma0) of the first Gram
    whose backward runs at each shape that no ``check_backward`` has held,
    while the block runs; ``where["phase"]`` names the phase."""
    real = gram_cuda.gram_backward

    def record(g, u1, s2, q11, q22, sigma0, *rest, **kwargs):
        key = backward_key(u1, s2)
        if key not in seen and key not in BWD_CHECKED:
            seen[key] = (where["phase"], [t.detach().cpu() for t in
                                          (u1, s2, q11, q22, sigma0)])
        return real(g, u1, s2, q11, q22, sigma0, *rest, **kwargs)

    gram_cuda.gram_backward = record
    try:
        yield seen
    finally:
        gram_cuda.gram_backward = real


def check_backward(torch, smi, name, ops, reps=20):
    """The Gram's backward kernels against their plain versions on one
    Gram's operands, 2-D or batched (see the module docstring, phase 2),
    on a seeded g (symmetric for K_tilde, as the M-step hands it) and the
    forward's own q12.  Returns {kernel: (max_abs, ms, plain_ms, lib_ms,
    bound_ms, bound_by, shape, extra)} for acos_gram_bwd, tf32_split_t
    (U1^T, the largest) and nt_product (dU1), ms of one launch; extra holds
    the device time a call over 5 calls back to back (device_ms) and, for
    nt_product, dS2's times, library ms and bound."""
    from gaussian_processes_tpu_torch.ops import gram_cuda as G

    u1, s2, q11, q22, s0 = ops
    BWD_CHECKED.add(backward_key(u1, s2))
    B = u1.shape[0] if u1.dim() == 3 else 1
    m, k = u1.shape[-2:]
    n = s2.shape[-2]
    lib = G.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def b3(t):
        return t.contiguous().reshape(B, *t.shape[-2:])

    def rel(a, b):
        diff = float((a - b).abs().max())
        return diff, diff / max(float(b.abs().max()), 1e-30)

    def worst(pairs):
        errs_ = [rel(a, b) for a, b in pairs]
        return max(e[0] for e in errs_), max(e[1] for e in errs_)

    def ms(fn, inner=1):
        return cuda_ms(torch, fn, reps, inner=inner)

    with torch.no_grad():
        K0 = G._forward(*ops)
        K, q12 = G._forward(*ops, keep_q12=True)
        same_K = torch.equal(K0, K)
        del K0
        gen = torch.Generator(device=u1.device).manual_seed(m * n + k)
        g = torch.randn(K.shape, generator=gen, device=u1.device)
        if name.startswith("K_tilde"):
            g = 0.5 * (g + g.mT)
        got = G.gram_backward(g, u1, s2, q11, q22, s0, q12)
        again = G.gram_backward(g, u1, s2, q11, q22, s0, q12)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = G.gram_backward_torch(g, u1, s2, q11, q22, s0, q12)
        errs = {what: rel(a, b) for what, a, b in zip(
            ("du1", "ds2", "dq11", "dq22", "dsigma0"), got, want)}
        del got, want
        dq12p, dq11p, dq22p, dsp = G.acos_gram_bwd_torch(g, q12, q11, q22, s0)
        # each kernel alone, on what the backward hands it
        args = (b3(g), b3(q12), q11.contiguous().reshape(B, m),
                q22.contiguous().reshape(B, n), s0.reshape(B).contiguous())
        planes, planes_t, dq11k, dq22k, dsk = G._bwd_launch(lib, *args, stream)
        # dq12 is its two planes' sum, exactly
        dq12k = planes[0, :, :, :n] + planes[1, :, :, :n]
        epi = worst(zip(
            (dq12k, dq11k, dq22k, dsk),
            (b3(dq12p), dq11p.reshape(B, m), dq22p.reshape(B, n),
             dsp.reshape(B))))
        del dq12p
        split_eq = (all(torch.equal(G._split_t_into(lib, t, stream),
                                    G.tf32_split_t_torch(t))
                        for t in (b3(s2), b3(u1)))
                    and torch.equal(planes_t, G.tf32_split_t_torch(dq12k)))
        s2t = G._split_t_into(lib, b3(s2), stream)
        u1t = G._split_t_into(lib, b3(u1), stream)
        du1 = G._product(lib, planes, s2t, m, k, n, stream)
        ds2 = G._product(lib, planes_t, u1t, n, k, m, stream)
        prod = worst([(du1, dq12k @ b3(s2)), (ds2, dq12k.mT @ b3(u1))])
        del du1, ds2
        kernels = dict(
            bwd=lambda: G._bwd_launch(lib, *args, stream),
            split_t=lambda: G._split_t_into(lib, b3(u1), stream),
            du1=lambda: G._product(lib, planes, s2t, m, k, n, stream),
            ds2=lambda: G._product(lib, planes_t, u1t, n, k, m, stream))
        t = {key: ms(fn) for key, fn in kernels.items()}
        t.update(
            bwd_plain=ms(lambda: G.acos_gram_bwd_torch(g, q12, q11, q22,
                                                       s0)),
            split_t_plain=ms(lambda: G.tf32_split_t_torch(b3(u1))),
            du1_plain=ms(lambda: G.nt_product_torch(dq12k, b3(s2).mT)),
            du1_matmul=ms(lambda: torch.matmul(dq12k, b3(s2))),
            ds2_matmul=ms(lambda: torch.matmul(dq12k.mT, b3(u1))),
            backward=ms(lambda: G.gram_backward(g, u1, s2, q11, q22, s0,
                                                q12)),
            backward_plain=ms(lambda: G.gram_backward_torch(
                g, u1, s2, q11, q22, s0, u1 @ s2.mT)))
        # the device's time a call, 5 calls back to back
        b2b = {key: ms(fn, 5) for key, fn in kernels.items()}
        del planes, planes_t, s2t, u1t, dq12k
    each = f"{B} x " if u1.dim() == 3 else ""
    print(f"backward {name} {each}{m}x{n} k={k}: max|d|/max|plain| "
          + ", ".join(f"{w} {e[1]:.3e}" for w, e in errs.items())
          + f"; epilogue {epi[1]:.3e}, products on its dq12 {prod[1]:.3e}; "
          f"K bit for bit with/without q12 {same_K}; two runs bit for bit "
          f"{repeat}; transposing split and dq12^T's planes bit for bit "
          f"{split_eq}  [{smi}]")
    print("  ms: " + ", ".join(f"{key} {v:.4f}" for key, v in t.items())
          + "; back to back: " + ", ".join(f"{key} {v:.4f}"
                                           for key, v in b2b.items())
          + f"; bounds: epilogue {bwd_bound(B, m, n)[0]:.4f}"
          f" (bytes; its planes' {bwd_design_ms(B, m, n):.4f}), split_t "
          f"U1^T {split_bound(B * m, k)[0]:.4f} (bytes), "
          f"dU1 {product_bound(B, m, k, n)[0]:.4f}, dS2 "
          f"{product_bound(B, n, k, m)[0]:.4f}  [{smi}]")
    most = max(max(e[1] for e in errs.values()), epi[1], prod[1])
    if not (same_K and repeat and split_eq and most <= BWD_RTOL):
        raise RuntimeError(f"the backward kernels disagree at {name} "
                           f"{each}{m}x{n} k={k}: worst {most:.3e}, K "
                           f"{same_K}, repeat {repeat}, split {split_eq}")
    shape = f"{each}{m}x{n} k {k}"
    return {
        "acos_gram_bwd": (epi[0], t["bwd"], t["bwd_plain"], None,
                          *bwd_bound(B, m, n), shape,
                          {"device_ms": b2b["bwd"]}),
        "tf32_split_t": (0.0, t["split_t"], t["split_t_plain"], None,
                         *split_bound(B * m, k), f"U1^T of {shape}",
                         {"device_ms": b2b["split_t"]}),
        "nt_product": (prod[0], t["du1"], t["du1_plain"], t["du1_matmul"],
                       *product_bound(B, m, k, n), f"dU1 of {shape}",
                       {"device_ms": b2b["du1"], "ds2_ms": t["ds2"],
                        "ds2_device_ms": b2b["ds2"],
                        "ds2_library_ms": t["ds2_matmul"],
                        "ds2_bound_ms": product_bound(B, n, k, m)[0]})}


@contextlib.contextmanager
def first_mstep_call(store):
    """Keeps in ``store`` the theta (detached) and the other arguments of
    the first M-step objective call while the block runs."""
    from gaussian_processes_tpu_torch.models import fit as F
    real = F._mstep_objective

    def record(theta, *args, **kwargs):
        if not store:
            store.append(({k: v.detach().clone() for k, v in theta.items()},
                          args, kwargs))
        return real(theta, *args, **kwargs)

    F._mstep_objective = record
    try:
        yield store
    finally:
        F._mstep_objective = real


FWD_KERNELS = ("acos_gram_tf32x3_kernel", "acos_gram_reduce_kernel",
               "tf32_split_kernel", "tf32_split_vec_kernel")
BWD_KERNELS = ("acos_gram_bwd_kernel", "tf32_split_t_kernel",
               "nt_product_kernel", "nt_product_reduce_kernel")


def kernel_name(name):
    """A profiler event's kernel name without namespace, template and
    arguments ("(anonymous namespace)::nt_product_kernel(...)")."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def mstep_split(torch, smi, call):
    """One M-step evaluation at a recorded ``first_mstep_call``: value and
    gradient as the optimizer takes them (theta as one leaf, the gradient
    and value read back to the host).  Host ms of an evaluation
    (unprofiled, the median of 10), then the device time of
    MSTEP_SPLIT_EVALS evaluations under torch.profiler by kernel name,
    split into the Gram forward, the Gram backward and the rest; then the
    same with the plain backward in place of the kernels.  Returns the
    split (ms an evaluation)."""
    from torch.profiler import ProfilerActivity, profile
    from gaussian_processes_tpu_torch.benchmarks.fparam_route import (
        plain_gram_backward)
    from gaussian_processes_tpu_torch.models import fit as F

    theta0, args, kwargs = call
    keys = sorted(theta0)

    def evaluation():
        flat = torch.stack([theta0[k] for k in keys]).requires_grad_(True)
        with torch.enable_grad():
            v = F._mstep_objective({k: flat[i] for i, k in enumerate(keys)},
                                   *args, **kwargs)
            (gr,) = torch.autograd.grad(v, flat)
        return torch.cat([v.detach().reshape(1), gr]).cpu()

    out = {}
    for route in ("kernel", "plain"):
        with (plain_gram_backward() if route == "plain"
              else contextlib.nullcontext()):
            first = evaluation()
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                evaluation()
                host.append((time.perf_counter() - t0) * 1e3)
            host.sort()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(MSTEP_SPLIT_EVALS):
                    evaluation()
        parts = {"forward": 0.0, "backward": 0.0, "rest": 0.0}
        by_kernel, launches = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = kernel_name(e.name)
            ms = e.time_range.elapsed_us() / 1e3 / MSTEP_SPLIT_EVALS
            part = ("forward" if name in FWD_KERNELS else "backward"
                    if name in BWD_KERNELS else "rest")
            parts[part] += ms
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
            launches[part] = launches.get(part, 0) + 1
        device = sum(parts.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        per = {k: v // MSTEP_SPLIT_EVALS for k, v in launches.items()}
        print(f"M-step evaluation at the bench fit's first M-step state, "
              f"{route} backward: host {host[5]:.3f} ms an evaluation "
              f"(value {float(first[0]):.6f}); device {device:.3f} ms: Gram "
              f"forward {parts['forward']:.3f}, Gram backward "
              f"{parts['backward']:.3f}, rest {parts['rest']:.3f} (device "
              f"events an evaluation {per}); top kernels ms " + "; ".join(
                  f"{n[:48]} {v:.3f}" for n, v in top) + f"  [{smi}]")
        out[route] = dict(host_ms=host[5], device_ms=device, **parts,
                          value=float(first[0]),
                          grad=first[1:].tolist())
    diff = max(abs(a - b) for a, b in zip(out["kernel"]["grad"],
                                          out["plain"]["grad"]))
    scale = max(abs(b) for b in out["plain"]["grad"])
    print(f"  its gradient, kernel vs plain backward: max|d|/max|plain| "
          f"{diff / scale:.3e}")
    if not diff <= GRAD_RTOL * scale:
        raise RuntimeError("the M-step gradient through the backward "
                           "kernels disagrees with the plain backward's")
    return out


def fparam_bound(nt, weighted, itemsize, evals):
    """(ms, "operations" or "bytes"): the least time the card could take
    for one f-param search -- reading r, lambda_m, lambda_var (and the
    weight) once at the HBM rate, or FPARAM_ROW_FLOPS a row for each of
    this search's evaluations and FPARAM_ROW_FLOPS_ONCE a row once (one
    more each with a weight) at the non-tensor peak of its type."""
    bytes_ms = itemsize * (nt * (4 if weighted else 3) + 3) / HBM_BYTES * 1e3
    peak = FP32_FLOPS if itemsize == 4 else FP64_FLOPS
    w = int(weighted)
    ops = nt * ((FPARAM_ROW_FLOPS + w) * evals + FPARAM_ROW_FLOPS_ONCE + w)
    ops_ms = ops / peak * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                             "bytes")


@contextlib.contextmanager
def fparam_operands(store):
    """Keeps in ``store`` a copy of the (logA0, r, lambda_m, lambda_var,
    wt, num_steps, max_linesearch_steps) of every search that the fit
    hands ``fparam_search`` while the block runs."""
    from gaussian_processes_tpu_torch.models import fit as fit_module
    real = fit_module.fparam_search

    def record(logA0, r, lambda_m, lambda_var, wt, num_steps, max_ls,
               *args, **kwargs):
        store.append([None if t is None else t.detach().clone()
                      for t in (logA0, r, lambda_m, lambda_var, wt)]
                     + [num_steps, max_ls])
        return real(logA0, r, lambda_m, lambda_var, wt, num_steps, max_ls,
                    *args, **kwargs)

    fit_module.fparam_search = record
    try:
        yield store
    finally:
        fit_module.fparam_search = real


def check_fparam(torch, smi, name, ops, found):
    """The f-param search kernel against its plain version (the host-driven
    zoom L-BFGS through autograd) on one search's operands, in float64 and
    float32 at each of FPARAM_TRIALS, with the bounds stated beside those
    constants; CUDA-event medians per search and per evaluation of the
    kernel launched alone and of the plain route, and the kernel's device
    time per search with searches back to back (``chained_ms``).
    Appends one dict a case to ``found``; raises past a bound."""
    from gaussian_processes_tpu_torch.ops import fparam_search as fs
    from gaussian_processes_tpu_torch.utils.tracing import objective_counts

    logA0, r, lm, lv, wt, steps = ops[:6]
    nt = r.shape[0]
    pad = 0 if wt is None else int((wt <= 0).sum())

    def objective64(x, args):
        """The profiled objective and its derivative at logA x, float64,
        on ``args``."""
        a64 = [None if t is None else t.double() for t in args]
        v, g = fs.fparam_value_and_grad_torch(
            torch.tensor(x, dtype=torch.float64, device=r.device), *a64)
        return float(v), float(g)

    def flat_width(x, args, rel):
        """How far logA may move from x (a minimum) before the objective
        rises by ``rel`` of its value: sqrt(2 rel |f| / f''), f'' by a
        central difference of the closed-form derivative; 0 where f'' is
        not positive (x is no minimum: FPARAM_F32_ATOL alone bounds it)."""
        h = 1e-4
        f = objective64(x, args)[0]
        curv = (objective64(x + h, args)[1] - objective64(x - h, args)[1]) / (
            2 * h)
        return math.sqrt(2 * rel * abs(f) / curv) if curv > 0 else 0.0

    for dtype in (torch.float64, torch.float32):
        args = [None if t is None else t.to(dtype) for t in (r, lm, lv, wt)]
        x0 = logA0.to(dtype)
        for max_ls in FPARAM_TRIALS:
            def search(k, backend=None):
                with objective_counts() as ev:
                    x, f = fs.fparam_search(x0, *args, k, max_ls,
                                            backend=backend)
                    x, f = float(x), float(f)
                return x, f, ev["fparam"]

            xk, fk, nk = search(steps)
            xp, fp, npl = search(steps, "torch")
            # float64: the kernel's path, step count by step count, until
            # it leaves the plain search's at its minimum
            path = []
            if dtype == torch.float64:
                for k in range(1, steps + 1):
                    xpk, fpk, npk = search(k, "torch")
                    xkk, _, nkk = search(k)
                    off = abs(xkk - xpk) > FPARAM_F64_ATOL or nkk != npk
                    if off and abs(fpk - fp) <= FPARAM_CONVERGED * abs(fp):
                        break
                    path.append((k, abs(xkk - xpk), nkk, npk))
            # one search launched alone (the host's launch in it), and the
            # device's time a search back to back
            ms = cuda_ms(torch, lambda: fs.fparam_search(x0, *args, steps,
                                                         max_ls))
            device_ms = chained_ms(torch, lambda: fs.fparam_search(
                x0, *args, steps, max_ls))
            plain_ms = cuda_ms(torch, lambda: fs.fparam_search(
                x0, *args, steps, max_ls, backend="torch"), reps=3, warmup=1)
            bound_ms, bound_by = fparam_bound(nt, wt is not None,
                                              args[0].element_size(), nk)
            dx = abs(xk - xp)
            v_k, v_p = objective64(xk, args)[0], objective64(xp, args)[0]
            dv = abs(v_k - v_p) / abs(v_p)
            # float32 tells logA apart no better than its rounding of the
            # value does
            x_tol = (FPARAM_F64_ATOL if dtype == torch.float64 else max(
                FPARAM_F32_ATOL, flat_width(xp, args, 2.0 ** -23)))
            tag = "float64" if dtype == torch.float64 else "float32"
            print(f"fparam_lbfgs {name}: nt {nt} ({pad} weight-0 rows), "
                  f"{tag}, {steps} steps, {max_ls} trials: kernel logA "
                  f"{xk!r} value {fk!r} ({nk} evaluations), plain logA "
                  f"{xp!r} value {fp!r} ({npl}); |dlogA| {dx:.3e} (bound "
                  f"{x_tol:.3e}), "
                  f"objective at the two results rel {dv:.3e}; kernel "
                  f"{ms:.4f} ms a search ({ms / max(nk, 1) * 1e3:.2f} us an "
                  f"evaluation; back to back {device_ms:.4f} ms, "
                  f"{device_ms / max(nk, 1) * 1e3:.2f} us), plain "
                  f"{plain_ms:.2f} ms a search, bound "
                  f"{bound_ms:.4f} ms ({bound_by})  [{smi}]")
            if path:
                print("  on the plain search's path (steps, |dlogA|, kernel "
                      "/ plain evaluations): "
                      + ", ".join(f"{k}: {d:.1e} {a}/{b}"
                                  for k, d, a, b in path))
            found.append(dict(name=name, dtype=tag, nt=nt, pad=pad,
                              trials=max_ls, dlogA=dx, dvalue=dv, ms=ms,
                              us_per_eval=ms / max(nk, 1) * 1e3,
                              device_ms=device_ms,
                              device_us_per_eval=device_ms / max(nk, 1) * 1e3,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, evals=nk, plain_evals=npl))
            if dtype == torch.float64:
                bad = [p for p in path
                       if p[1] > FPARAM_F64_ATOL or p[2] != p[3]]
                ok = (not bad and abs(fk - fp) <= FPARAM_CONVERGED * abs(fp)
                      and dv <= FPARAM_CONVERGED and dx <= FPARAM_F64_ATOL)
            else:
                bad = []
                ok = dx <= x_tol and dv <= FPARAM_F32_VALUE_RTOL
            if not (ok and math.isfinite(fk)):
                raise RuntimeError(
                    f"the f-param search kernel disagrees with its plain "
                    f"version ({name}, {tag}, {max_ls} trials): |dlogA| "
                    f"{dx:.3e}, objective rel {dv:.3e}, steps off the "
                    f"plain path {bad}")


def chained_ms(torch, fn, reps=20, rounds=5):
    """Device milliseconds a call: ``reps`` calls back to back between two
    CUDA events, after one untimed call that keeps the card busy while the
    host enqueues the rest (the median of ``rounds``)."""
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    per.sort()
    return per[len(per) // 2]


def seeded_fparam_operands(torch, device, nt, num_steps):
    """(logA0, r, lambda_m, lambda_var, None, num_steps) of the card tests'
    seeded moments (tests/test_torch_cuda.py's ``fparam_moments``:
    numpy's default_rng(3)) at ``nt`` rows, float32, from log(0.01): at nt
    32, one row a lane of the kernel's first warp, which prices the
    reductions and the state machine of an evaluation."""
    import numpy as np
    rng = np.random.default_rng(3)
    lm = rng.standard_normal(nt)
    lv = rng.uniform(0.1, 0.5, nt)
    r = rng.poisson(np.exp(0.4 * lm + 0.08 * lv + 0.2)).astype(float)
    return [torch.tensor(math.log(0.01), device=device)] + [
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (r, lm, lv)] + [None, num_steps]


def fparam_fit_ms(torch, smi, name, searches):
    """The f-param device time of a fit: every search that
    ``fparam_operands`` kept, replayed back to back on the fit's operands
    between two CUDA events, after one untimed search (the median of three
    passes; these launches are not the main path's)."""
    from gaussian_processes_tpu_torch.ops import fparam_search as fs

    totals = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fs.fparam_search(*searches[0])
        start.record()
        for ops in searches:
            fs.fparam_search(*ops)
        end.record()
        torch.cuda.synchronize()
        totals.append(start.elapsed_time(end))
    totals.sort()
    ms = totals[1]
    print(f"fparam_lbfgs inside {name}: {len(searches)} searches, "
          f"{ms:.3f} ms of device time  [{smi}]")
    return dict(searches=len(searches), ms=ms)


def bench_fit_searches(torch, device, **shape):
    """The operands of every search that the bench's timed fit hands the
    f-param kernel, from one more, untimed fit of ``run_bench``'s data,
    inducing rows and configuration (``shape`` overrides them as it does
    ``run_bench``'s); the fit repeats itself bit for bit."""
    from gaussian_processes_tpu_torch import bench
    kw = {k: shape.get(k, getattr(bench, k.upper())) for k in (
        "nt", "n_px", "ntilde", "maxiter", "n_estep", "n_mstep",
        "n_fparamstep")}
    idx, _ = bench.load_draws()
    X, R = bench.make_data(0, kw["nt"], kw["n_px"])
    x = torch.as_tensor(X, dtype=torch.float32, device=device)
    r = torch.as_tensor(R, dtype=torch.float32, device=device)
    cfg = bench.make_config(kw["maxiter"], kw["ntilde"], kw["n_px"],
                            kw["n_estep"], kw["n_mstep"], kw["n_fparamstep"])
    store = []
    with fparam_operands(store):
        bench.fit(x, r, cfg, xtilde=x[torch.as_tensor(
            idx[:kw["ntilde"]], device=device)], theta=bench.THETA0,
            f_params=bench.F_PARAMS0)
    return store


def span_line(timer):
    """A PhaseTimer's totals on one line, largest first."""
    return ", ".join(f"{name} {sec:.3f} ({timer.counts[name]})"
                     for name, sec in sorted(timer.totals.items(),
                                             key=lambda kv: -kv[1]))


def reset_counts():
    """Set every kernel's launch counts to 0."""
    from gaussian_processes_tpu_torch.utils import tracing
    tracing.reset_launch_counts()


def read_counts():
    """Every kernel's launch counts (the f-param search's as "fparam")."""
    from gaussian_processes_tpu_torch.utils import tracing
    return tracing.read_launch_counts()


def add_counts(total, counts):
    for key, v in counts.items():
        if isinstance(v, dict):         # launches by shape
            shapes = total.setdefault(key, {})
            for shape, c in v.items():
                shapes[shape] = shapes.get(shape, 0) + c
        else:
            total[key] = total.get(key, 0) + v


@contextlib.contextmanager
def operands_by_shape(gram_cuda, seen, path):
    """Keeps in ``seen[(m, n, k)] = (path, operands)`` a copy of the first
    (u1, s2, q11, q22, sigma0) that the kernel wrapper is handed at each
    2-D shape while the block runs (shapes already in ``seen`` stay)."""
    real = gram_cuda.acos_gram

    def record(*args, **kwargs):
        if args[0].dim() == 2:
            shape = (args[0].shape[0], args[1].shape[0], args[0].shape[1])
            if shape not in seen:
                seen[shape] = (path, [a.detach().clone() for a in args])
        return real(*args, **kwargs)

    gram_cuda.acos_gram = record
    try:
        yield seen
    finally:
        gram_cuda.acos_gram = real


def _sync_key(e):
    """A synchronizing call and the ATen op under which it ran."""
    op = e.cpu_parent
    while op is not None and op.cpu_parent is not None and not (
            op.name.startswith("aten::linalg")):
        op = op.cpu_parent
    return f"{e.name} <- {op.name if op is not None else '(top)'}"


def syncs_by_op(prof):
    """Host-synchronizing CUDA runtime calls in a torch.profiler run, by the
    call and the ATen op under which it ran."""
    out = {}
    for e in prof.events():
        if "Synchronize" in e.name:
            key = _sync_key(e)
            out[key] = out.get(key, 0) + 1
    return out


def syncs_by_iteration(torch, prof):
    """``syncs_by_op`` of a profiled fit, one dict per EM iteration (the
    host's ``fit.iteration`` spans, in order)."""
    spans = sorted((e for e in prof.events() if e.name == "fit.iteration"
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    out = [{} for _ in spans]
    for e in prof.events():
        if "Synchronize" not in e.name:
            continue
        for i, span in enumerate(spans):
            if span.time_range.start <= e.time_range.start <= (
                    span.time_range.end):
                key = _sync_key(e)
                out[i][key] = out[i].get(key, 0) + 1
    return out


def population_data(np):
    """benchmarks/bench_population.py's stimuli, the 41 cells' responses
    of its recording and ntilde rows (a numpy permutation: no stream
    reproduces jax.random.permutation)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((NT, N_PX * N_PX)).astype(np.float32)
    lin = np.linspace(-1, 1, N_PX)
    yy, xx = np.meshgrid(lin, lin, indexing="ij")
    R = np.zeros((POP_RECORDING_CELLS, NT), np.float32)
    for c in range(POP_RECORDING_CELLS):
        cx, cy = rng.uniform(-0.3, 0.3, 2)
        w = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 0.1 ** 2)).ravel()
        w /= np.linalg.norm(w)
        R[c] = rng.poisson(np.exp(0.8 * X @ w))
    idx = np.random.default_rng(0).permutation(NT)[:POP_NTILDE]
    return X, R, idx


def check_batched(torch, gram_cuda, sms, smi, name, ops):
    """The batched kernel against its plain version on one batched Gram's
    operands (max relative error and finite output, every item's K_tilde
    diagonal, each item against the 2-D kernel call on its operands), with
    CUDA-event times of kernel, plain and the cuBLAS product alone; returns
    (max_abs, ms, plain_ms, lib_ms, bound_ms, bound_by, batch)."""
    b, m, kk = ops[0].shape
    n = ops[1].shape[1]
    plan = gram_cuda.plan_gram(m, n, kk, sms, b)
    with torch.no_grad():
        K_kernel = gram_cuda.acos_gram(*ops)
        K_plain = gram_cuda.acos_gram_torch(*ops)
        torch.cuda.synchronize()
        max_abs = float(torch.max(torch.abs(K_kernel - K_plain)))
        rel = max_abs / float(torch.max(torch.abs(K_plain)))
        ms = cuda_ms(torch, lambda: gram_cuda.acos_gram(*ops), reps=10)
        plain_ms = cuda_ms(torch, lambda: gram_cuda.acos_gram_torch(*ops),
                           reps=10)
        lib_ms = cuda_ms(torch, lambda: torch.matmul(ops[0], ops[1].mT),
                         reps=10)
    bound_ms, bound_by = gram_bound(b, m, n, kk)
    print(f"batched kernel {name} {b} x {m}x{n} k={kk}: max|dK|/max|K| = "
          f"{rel:.3e} (max|dK| {max_abs:.3e}), kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, cuBLAS FP32 product alone {lib_ms:.3f} ms,"
          f" bound {bound_ms:.3f} ms ({bound_by})  [{smi}]")
    print(f"  plan: {plan}")
    if not (bool(torch.all(torch.isfinite(K_kernel)))
            and rel <= KERNEL_RTOL):
        raise RuntimeError(f"batched kernel disagrees with its plain "
                           f"version at {name}: {rel:.3e}")
    if name.startswith("K_tilde"):
        d_plain = K_plain.diagonal(dim1=-2, dim2=-1)
        diag = float(torch.max(torch.abs(K_kernel.diagonal(
            dim1=-2, dim2=-1) - d_plain) / torch.abs(d_plain)))
        print(f"  every item's K_tilde diagonal: max relative error "
              f"{diag:.3e}")
        if not diag <= KERNEL_RTOL:
            raise RuntimeError(f"a batched K_tilde diagonal disagrees: "
                               f"{diag:.3e}")
    # each item against the 2-D kernel on its operands
    one_plan = gram_cuda.plan_gram(m, n, kk, sms)
    worst, equal = 0.0, 0
    with torch.no_grad():
        for i in range(b):
            K_one = gram_cuda.acos_gram(*(t[i] for t in ops))
            worst = max(worst, float(torch.max(torch.abs(
                K_one - K_kernel[i])) / torch.max(torch.abs(K_one))))
            equal += bool(torch.equal(K_one, K_kernel[i]))
    print(f"  items vs the 2-D kernel call: {equal} of {b} bit for bit "
          f"(2-D plan: {one_plan.splits} split(s), batched "
          f"{plan.splits}), max relative difference {worst:.3e}")
    if not worst <= KERNEL_RTOL or (one_plan.splits == plan.splits
                                     and equal != b):
        raise RuntimeError(f"batched {name} disagrees with its items' "
                           f"2-D calls")
    return max_abs, ms, plain_ms, lib_ms, bound_ms, bound_by, b


def phase7_batched(torch, np, device, smi, x, xtilde):
    """The batched kernel at the population ladder's shapes (see the module
    docstring); returns K's (max_abs, ms, plain_ms, batch) for the JSON."""
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.ops.kernels import gram_matrices
    from gaussian_processes_tpu_torch.parallel.population import ladder_items
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k = N_PX * N_PX
    batch = min(POP_CELLS * POP_TRIALS,
                ladder_items(NT, POP_NTILDE, k, device))
    # each item a ladder trial: the start theta moved by step 0.5**t along
    # a seeded direction
    rng = np.random.default_rng(7)
    dirs = rng.standard_normal((batch, len(POP_THETA))) * 0.05
    steps = 0.5 ** (np.arange(batch) % POP_TRIALS)
    theta = {key: torch.tensor(v + steps * dirs[:, i], dtype=torch.float32,
                               device=device)
             for i, (key, v) in enumerate(POP_THETA.items())}
    calls = gram_cuda.recorded_operands(lambda: gram_matrices(
        theta, x, xtilde, N_PX, shared=False))
    print(f"batched kernel: {batch} (cell, trial) items in one chunk "
          f"(ladder_items on this card)")
    out = {name: check_batched(torch, gram_cuda, sms, smi, name, ops)
           for name, ops in zip(("K_tilde", "K"), calls)}
    bwd = {name: check_backward(torch, smi, name, ops, reps=10)
           for name, ops in zip(("K_tilde", "K"), calls)}
    grad_call_memory(torch, device, smi, x, xtilde, theta, batch, k)
    # out=: item 0's K written as rows 128..128+m of a larger buffer
    ops = [t[0] for t in calls[1]]
    m, n = ops[0].shape[0], ops[1].shape[0]
    sentinel = -12345.0
    buf = torch.full((m + 256, n), sentinel, device=device)
    with torch.no_grad():
        gram_cuda.acos_gram(*ops, out=buf[128:128 + m])
        K_one = gram_cuda.acos_gram(*ops)
    torch.cuda.synchronize()
    untouched = bool((buf[:128] == sentinel).all()
                     and (buf[128 + m:] == sentinel).all())
    same = bool(torch.equal(buf[128:128 + m], K_one))
    print(f"out= row block {m}x{n} inside a ({m + 256}, {n}) buffer: rows "
          f"outside untouched {untouched}, block equal to the 2-D call "
          f"{same}")
    if not (untouched and same):
        raise RuntimeError("acos_gram(out=) wrote outside its rows or "
                           "differs from the 2-D call")
    return out, bwd


def grad_call_memory(torch, device, smi, x, xtilde, theta, batch, k):
    """Device bytes a (cell, trial) item of the M-step's Grams takes: the
    value call on ``batch`` items (no gradient) against
    LADDER_BYTES_PER_ELEMENT, and the gradient call on
    ``batch // GRAD_CHUNK_DIVISOR`` items (the Grams with autograd, a
    weighted sum of both, its theta-gradient through the backward kernels)
    against GRAD_CHUNK_DIVISOR x LADDER_BYTES_PER_ELEMENT, each per
    element of (nt + ntilde) k."""
    from gaussian_processes_tpu_torch.models.fit import GRAD_CHUNK_DIVISOR
    from gaussian_processes_tpu_torch.ops.kernels import gram_matrices
    from gaussian_processes_tpu_torch.parallel import population as P

    elems = (x.shape[0] + xtilde.shape[0]) * k

    def peak(items, grad):
        th = {key: v[:items].detach().clone().requires_grad_(grad)
              for key, v in theta.items()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        with torch.set_grad_enabled(grad):
            Kt, K, _ = gram_matrices(th, x, xtilde, N_PX, shared=False)
            if grad:
                loss = (Kt * Kt.detach()).sum() + (K * K.detach()).sum()
                torch.autograd.grad(loss, list(th.values()))
        del Kt, K
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(device) - base) / items

    items_g = max(1, batch // GRAD_CHUNK_DIVISOR)
    value, gradient = peak(batch, False), peak(items_g, True)
    print(f"device memory a (cell, trial) item takes, bytes per element of "
          f"(nt + ntilde) k: value call ({batch} items) "
          f"{value / elems:.2f} against LADDER_BYTES_PER_ELEMENT "
          f"{P.LADDER_BYTES_PER_ELEMENT}; gradient call ({items_g} items) "
          f"{gradient / elems:.2f} against GRAD_CHUNK_DIVISOR x "
          f"LADDER_BYTES_PER_ELEMENT "
          f"{GRAD_CHUNK_DIVISOR * P.LADDER_BYTES_PER_ELEMENT}  [{smi}]")
    if not (value <= P.LADDER_BYTES_PER_ELEMENT * elems
            and gradient <= GRAD_CHUNK_DIVISOR * P.LADDER_BYTES_PER_ELEMENT
            * elems):
        raise RuntimeError("an item of the M-step's Grams takes more device "
                           "memory than ladder_items gives it")


def phase8_population(torch, np, device, smi, totals):
    """The population at full width (see the module docstring); adds the
    counted paths' launches to ``totals``."""
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.models import fit as F
    from gaussian_processes_tpu_torch.ops.kernels import crop_window_for_theta
    from gaussian_processes_tpu_torch.params import theta_bounds
    from gaussian_processes_tpu_torch.parallel import population as P

    X, R, idx = population_data(np)
    x = torch.as_tensor(X, device=device)
    r_all = torch.as_tensor(R, device=device)
    r = r_all[:POP_CELLS]
    xtilde = x[torch.as_tensor(idx, device=device)]
    cfg = FitConfig(ntilde=POP_NTILDE, n_px_side=N_PX,
                    track_variational=False, **POP_STEPS)
    th0 = {k: torch.tensor(v, device=device) for k, v in POP_THETA.items()}
    win = crop_window_for_theta(th0, N_PX, cfg.alpha_threshold,
                                cfg.crop_margin * 1.5, cfg.crop_bucket)
    print(f"population: {POP_CELLS} cells, nt {NT}, ntilde {POP_NTILDE}, "
          f"{cfg.maxiter} EM iterations of {cfg.n_estep}/{cfg.n_mstep}/"
          f"{cfg.n_fparamstep}; window at margin {cfg.crop_margin * 1.5} "
          f"(i0, j0, w) = {win}")
    if win[2] < N_PX:
        raise RuntimeError("the population window is not the full frame: "
                           "the single-cell comparison below assumes it")
    out, bwd = phase7_batched(torch, np, device, smi, x, xtilde)

    def population(rs, pcfg, **kw):
        """fit_population's carry, seconds and peak device memory above
        what was allocated before it (GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        c, _ = P.fit_population(x, rs, pcfg, xtilde=xtilde, thetas=POP_THETA,
                                f_params=F_PARAMS0, **kw)
        torch.cuda.synchronize()
        return (c, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30)

    chunk = P.ladder_items(NT, POP_NTILDE, N_PX * N_PX, device)
    reset_counts()
    carry, pop_s, pop_gib = population(r, cfg)
    counts = read_counts()
    add_counts(totals, counts)
    lm = carry.track.logmarginal.double().cpu().numpy()
    print(f"fit_population (kernel): {pop_s:.3f} s, {pop_s / POP_CELLS:.3f} "
          f"s/cell; final log-marginal of cells 0-1 {lm[:2, -1].tolist()}, "
          f"mean over the {POP_CELLS} cells {lm[:, -1].mean():.4f}; peak "
          f"device memory {pop_gib:.2f} GiB (chunks of Grams: {chunk} items,"
          f" the gradient call {chunk // F.GRAD_CHUNK_DIVISOR})  [{smi}]")
    print(f"  Gram launches: batched {counts['batched']} ({counts['items']} "
          f"items), 2-D {counts['gram']}; split-pass launches "
          f"{counts['split']}")
    print(f"  log-marginal, first and last iteration per cell: "
          f"{[(round(a, 3), round(b, 3)) for a, b in lm[:, [0, -1]]]}")
    finite = (np.all(np.isfinite(lm))
              and bool(torch.isfinite(carry.m_b).all())
              and all(bool(torch.isfinite(v).all())
                      for v in carry.theta.values()))
    checks = {"every lane finite": finite,
              "no lane failed": not bool(carry.failed.any()),
              "every lane's log-marginal improved": bool(np.all(
                  lm[:, -1] > lm[:, 0])),
              "batched kernel launched": counts["batched"] > 0}

    # lanes 0 and 1 against the single-cell fit with the Armijo search
    one = dataclasses.replace(cfg, linesearch="armijo", crop_window=False)
    lane_err = 0.0
    for c in range(2):
        res = F.fit(x, r[c], one, xtilde=xtilde, theta=POP_THETA,
                    f_params=F_PARAMS0)
        ref = res.track.logmarginal.double().cpu().numpy()
        err = float(np.max(np.abs(lm[c] - ref) / np.abs(ref)))
        lane_err = max(lane_err, err)
        print(f"  lane {c} vs single-cell Armijo fit: {lm[c].tolist()} vs "
              f"{ref.tolist()}, max rel {err:.3e}")
    checks[f"lanes 0-1 within {POP_RTOL} of single-cell fits"] = (
        lane_err <= POP_RTOL)

    # the same population through the plain Gram
    t0 = time.perf_counter()
    carry_p, _ = P.fit_population(x, r, cfg, xtilde=xtilde,
                                  thetas=POP_THETA, f_params=F_PARAMS0,
                                  backend="torch")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    lm_p = carry_p.track.logmarginal.double().cpu().numpy()
    plain_err = float(np.max(np.abs(lm - lm_p) / np.abs(lm_p)))
    print(f"fit_population (plain Gram): {plain_s:.3f} s; log-marginal max "
          f"rel difference from the kernel's {plain_err:.3e}  [{smi}]")
    checks[f"population within {POP_RTOL} of the plain-Gram population"] = (
        plain_err <= POP_RTOL)

    # sequential, the zoom search
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    seq = P.fit_cells_sequential(x, r[:POP_SEQ_CELLS], cfg, xtilde=xtilde,
                                 thetas=POP_THETA, f_params=F_PARAMS0)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    counts = read_counts()
    add_counts(totals, counts)
    seq_final = [float(res.track.logmarginal[-1]) for res in seq]
    print(f"fit_cells_sequential ({POP_SEQ_CELLS} cells, zoom): {seq_s:.3f} "
          f"s, {seq_s / POP_SEQ_CELLS:.3f} s/cell; final log-marginal of "
          f"cells 0-1 {seq_final} (the population's {lm[:2, -1].tolist()}: "
          f"the two searches stop at different optima); Gram launches "
          f"{counts['gram']}  [{smi}]")
    for c, res in enumerate(seq):
        lm_s = res.track.logmarginal.double().cpu().numpy()
        print(f"  cell {c}: log-marginal {lm_s.tolist()}")
        checks[f"sequential cell {c} finite, not failed, improved"] = (
            not res.failed and bool(np.all(np.isfinite(lm_s)))
            and bool(lm_s[-1] > lm_s[0]))

    # the lab's 41-cell recording in one population
    rec_cfg = dataclasses.replace(cfg, maxiter=POP_RECORDING_ITERS)
    reset_counts()
    rec, rec_s, rec_gib = population(r_all, rec_cfg)
    add_counts(totals, read_counts())
    lm_r = rec.track.logmarginal.double().cpu().numpy()
    print(f"fit_population, the {POP_RECORDING_CELLS}-cell recording, "
          f"{POP_RECORDING_ITERS} EM iterations: {rec_s:.3f} s, "
          f"{rec_s / POP_RECORDING_CELLS:.3f} s/cell; mean final "
          f"log-marginal {lm_r[:, -1].mean():.4f}; peak device memory "
          f"{rec_gib:.2f} GiB (the {POP_CELLS}-cell population's "
          f"{pop_gib:.2f})  [{smi}]")
    checks[f"the {POP_RECORDING_CELLS}-cell recording finite, not failed, "
           f"improved"] = (
        bool(np.all(np.isfinite(lm_r))) and not bool(rec.failed.any())
        and bool(np.all(lm_r[:, -1] > lm_r[:, 0])))

    # stream synchronizations in one population EM iteration
    from torch.profiler import ProfilerActivity, profile
    pcfg = P._vmap_safe_config(cfg)
    thetas = P._per_cell(POP_THETA, POP_CELLS, torch.float32, device)
    fps = P._per_cell(F_PARAMS0, POP_CELLS, torch.float32, device)
    stim = F.cell_stimuli(x, xtilde, False, pcfg)
    max_items = P.ladder_items(NT, POP_NTILDE, N_PX * N_PX, device)
    with torch.no_grad():
        c0 = F._fit_init_cells(stim, r, thetas, fps, False, pcfg,
                               max_items=max_items)

    def iteration():
        with torch.no_grad():
            F._fit_iteration_cells(1, c0, stim, r, False, pcfg,
                                   theta_bounds(), max_items=max_items)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iteration()
    it_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        iteration()
    syncs = syncs_by_op(prof)
    n_sync = sum(syncs.values()) - 1     # less the closing synchronize
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = (by_kernel.get(e.name, 0)
                                 + e.time_range.elapsed_us() / 1e6)
    device_s = sum(by_kernel.values())
    print(f"one population EM iteration: {it_s:.3f} s unprofiled, ladder "
          f"chunk {max_items} items; under torch.profiler {device_s:.3f} s "
          f"of device time (busy {device_s / it_s:.2f} of the unprofiled "
          f"wall), host synchronizations {n_sync}, by call and op (the "
          f"closing one included): {syncs}  [{smi}]")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    print("  device time by kernel: " + "; ".join(
        f"{name[:70]} {sec:.3f} s" for name, sec in top))
    # why the M-step and E-step invert through cholesky_ex and
    # solve_triangular: host syncs of one call of each batched op at the
    # ladder's shape
    g = torch.Generator(device=device).manual_seed(0)
    A = torch.randn(30, POP_NTILDE, POP_NTILDE, device=device, generator=g)
    S = A @ A.mT + POP_NTILDE * torch.eye(POP_NTILDE, device=device)
    L = torch.linalg.cholesky_ex(S)[0]
    ops = {"cholesky_ex": lambda: torch.linalg.cholesky_ex(S),
           "solve_triangular": lambda: torch.linalg.solve_triangular(
               L, S, upper=False),
           "cholesky_solve": lambda: torch.cholesky_solve(S, L),
           "inv_ex": lambda: torch.linalg.inv_ex(S),
           "eigh": lambda: torch.linalg.eigh(S)}
    per_op = {}
    for name, fn in ops.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as op_prof:
            fn()
        per_op[name] = sum(1 for e in op_prof.events()
                           if "Synchronize" in e.name)
    print(f"host synchronizations of one batched call at 30 x "
          f"{POP_NTILDE} x {POP_NTILDE}: {per_op}")
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"population check failed: {what}")
    return out, bwd


def phase9_large(torch, np, device, smi, totals):
    """The large-ntilde path (see the module docstring); adds its launches
    to ``totals`` and returns its Grams' operands for phase 10(e) and the
    record of ``benchmarks/large_ntilde.run`` for phase 16."""
    from gaussian_processes_tpu_torch.benchmarks import large_ntilde
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.parallel import large as L

    n, k = LARGE_N, LARGE_PX * LARGE_PX
    xt = torch.as_tensor(large_ntilde.make_data(n, LARGE_PX), device=device)
    theta = {key: torch.tensor(v, device=device)
             for key, v in LARGE_THETA.items()}

    def timed(fn, readback):
        """fn()'s result and its CUDA-event seconds, the end event read
        after a value readback of the result."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        res = fn()
        end.record()
        float(readback(res))
        return res, start.elapsed_time(end) / 1e3

    def diag_sample(A):
        return A.diagonal()[::max(n // 64, 1)].sum()

    ut_amp, st, qd = L._gram_prep(theta, xt, LARGE_PX)
    s0 = theta["sigma_0"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    # cold: the first run also pays the 10 GB allocation and the solver's
    # set-up
    reset_counts()
    K, gram_s = timed(lambda: L.large_gram(theta, xt, LARGE_PX,
                                           nb=LARGE_NB), diag_sample)
    counts = read_counts()
    print(f"large_gram n={n} ({LARGE_PX}x{LARGE_PX} px, k {k}), row "
          f"blocks of {LARGE_NB}, cold: {gram_s:.3f} s, "
          f"{counts['gram']} Gram launches  [{smi}]")
    worst = 0.0
    with torch.no_grad():
        last = (n - 1) // LARGE_NB
        for r0 in (0, last // 2 * LARGE_NB, last * LARGE_NB):
            r1 = min(r0 + LARGE_NB, n)
            ref = gram_cuda.acos_gram_torch(ut_amp[r0:r1], st,
                                            qd[r0:r1], qd, s0)
            rel = float(torch.max(torch.abs(K[r0:r1] - ref))
                        / torch.max(torch.abs(ref)))
            worst = max(worst, rel)
            print(f"  row block [{r0}, {r1}) vs plain: max rel "
                  f"{rel:.3e}")
            del ref
    if not worst <= KERNEL_RTOL:
        raise RuntimeError(f"large_gram disagrees with the plain "
                           f"Gram: {worst:.3e}")
    Lf, chol_s = timed(lambda: L.large_cholesky(K, jitter=LARGE_JITTER),
                       diag_sample)
    d = Lf.diagonal()
    if not bool(torch.isfinite(d).all() & (d > 0).all()):
        raise RuntimeError("large_cholesky: non-finite or non-positive "
                           "diagonal")
    print(f"large_cholesky n={n}, cold: {chol_s:.3f} s, "
          f"{n ** 3 / 3 / chol_s / 1e12:.2f} TFLOP/s (n^3/3)  [{smi}]")
    del K, Lf, d
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"peak device memory of the Gram and the Cholesky: {peak:.2f} GiB")
    # warm: the same work through the benchmark module, its launches counted
    torch.cuda.synchronize()
    reset_counts()
    large_rec, _ = large_ntilde.run(device=device)
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(totals, counts)
    print(json.dumps(large_rec))
    detail = large_rec["detail"] or {}
    print(f"large_ntilde.run, warm: n {detail.get('n')}, large_gram "
          f"{detail.get('gram_s', float('nan')):.3f} s, large_cholesky "
          f"{detail.get('cholesky_s', float('nan')):.3f} s "
          f"({large_rec['value']} TFLOP/s), peak {detail.get('peak_gib')} "
          f"GiB; Gram launches {counts['gram']}  [{smi}]")
    if not large_rec["ok"]:
        raise RuntimeError("large_ntilde.run: no size ran")

    y = torch.as_tensor(np.random.default_rng(1).standard_normal(n)
                        .astype(np.float32), device=device)
    xstar = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (8, k)).astype(np.float32), device=device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mu, alpha = L.large_posterior_mean(theta, xt, y, xstar, LARGE_PX,
                                       noise_var=LARGE_JITTER)
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    counts = read_counts()
    add_counts(totals, counts)
    # (K + I) alpha - y and ||K + I||_F, by row blocks, in float64
    a64, y64 = alpha.double(), y.double()
    res2 = fro2 = 0.0
    with torch.no_grad():
        for r0 in range(0, n, LARGE_NB):
            r1 = min(r0 + LARGE_NB, n)
            Kb = gram_cuda.acos_gram(ut_amp[r0:r1], st, qd[r0:r1], qd,
                                     s0).double()
            Kb.diagonal(offset=r0).add_(LARGE_JITTER)
            res2 += float(torch.sum((Kb @ a64 - y64[r0:r1]) ** 2))
            fro2 += float(torch.sum(Kb * Kb))
            del Kb
    residual = math.sqrt(res2) / float(torch.linalg.norm(y64))
    backward = math.sqrt(res2) / (math.sqrt(fro2) * float(
        torch.linalg.norm(a64)) + float(torch.linalg.norm(y64)))
    print(f"large_posterior_mean: {post_s:.3f} s; mu* {mu.tolist()}; "
          f"||(K + I) alpha - y|| / ||y|| = {residual:.3e} (bound "
          f"{LARGE_RESIDUAL}), normwise backward error {backward:.3e} (bound "
          f"{LARGE_BACKWARD}); Gram launches {counts['gram']}  [{smi}]")
    ok = (bool(torch.isfinite(mu).all()) and bool(torch.isfinite(alpha).all())
          and (LARGE_RESIDUAL is None or residual <= LARGE_RESIDUAL)
          and (LARGE_BACKWARD is None or backward <= LARGE_BACKWARD)
          and counts["gram"] > 0)
    if not ok:
        raise RuntimeError("the large path's posterior mean failed its "
                           "checks")
    # the operands of the first and the last row block and of K*, for
    # phase 10's timing of each alone: (name, operands, written by out=)
    last = (n - 1) // LARGE_NB * LARGE_NB
    us_amp, _, qs = L._gram_prep(theta, xstar, LARGE_PX)
    return [("row block", (ut_amp[:LARGE_NB], st, qd[:LARGE_NB], qd, s0),
             True),
            ("last row block", (ut_amp[last:], st, qd[last:], qd, s0), True),
            ("K*", (us_amp, st, qs, qd, s0), False)], large_rec


def phase10_entry_points(torch, np, device, smi, totals, x, r, xtilde, Xt,
                         Rt, cfg, res_full, stats_full, block_ops,
                         check_kernel, checked):
    """The entry points (see the module docstring): the reduced-rank fit
    beside phase 4's full-rank fit ``res_full`` (same data, shape and
    steps; ``stats_full`` its objective evaluations and spans),
    state_at_iteration,
    the CLI's fit and its checkpoint, entry(), and the large path's Grams
    alone (``block_ops``, from phase 9).  Adds each path's launches to
    ``totals``, and holds the kernel against its plain version
    (``check_kernel``) at every 2-D shape these paths launched that phases
    2 and 5 did not (``checked``); returns the large Grams' max |dK| for
    the kernel table and (a)'s fit, seconds, spans and config for phase
    12."""
    import shutil
    import tempfile

    from gaussian_processes_tpu_torch import entry as entry_module
    from gaussian_processes_tpu_torch.examples import one_cell_fit
    from gaussian_processes_tpu_torch.models.fit import fit
    from gaussian_processes_tpu_torch.models.inference import (
        evaluate, predict, predict_rates, state_at_iteration)
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.ops.kernels import gram_matrices
    from gaussian_processes_tpu_torch.utils.io import load_model
    from gaussian_processes_tpu_torch.utils.tracing import (
        collect_spans, objective_counts)

    checks = {}
    xt = torch.as_tensor(Xt, device=device)
    rt = torch.as_tensor(Rt, device=device)

    seen = {}

    def counted(fn, path):
        """fn()'s result, host seconds to a synchronize, and the launch
        counts of that run alone (added to ``totals``); the operands of
        each new Gram shape it launches go to ``seen``."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with operands_by_shape(gram_cuda, seen, path):
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        add_counts(totals, counts)
        return out, sec, counts

    # (a) the reduced-rank fit at phase 4's data and shape
    cfg_r = dataclasses.replace(cfg, reduced_rank=True, track_basis=True,
                                track_variational=True)

    def reduced_fit():
        return fit(x, r, cfg_r, xtilde=xtilde, theta=THETA0,
                   f_params=F_PARAMS0, profile=True)

    evals_full, spans_full = stats_full
    with objective_counts() as evals, collect_spans() as spans:
        res, red_s, counts = counted(reduced_fit, "reduced fit")
    loss = res.track.logmarginal.double().cpu().numpy()
    loss_full = res_full.track.logmarginal.double().cpu().numpy()
    n_eigen = res.track.n_eigen.tolist()
    budgets = res.timing["rank"]
    err = float(np.max(np.abs(loss - loss_full) / np.abs(loss_full)))
    print(f"reduced-rank fit (nt {NT}, ntilde {NTILDE}, {cfg.maxiter} EM "
          f"iterations of {cfg.n_estep}/{cfg.n_mstep}/{cfg.n_fparamstep}): "
          f"{red_s:.3f} s (init {res.timing['init']:.3f} s), phase 4's "
          f"full-rank fit {res_full.timing['total']:.3f} s (init "
          f"{res_full.timing['init']:.3f} s); objective evaluations "
          f"{evals} (full rank {evals_full}); Gram launches "
          f"{counts['gram']}  [{smi}]")
    for i, (b, sec, sec_full) in enumerate(zip(
            budgets, res.timing["per_iteration"],
            res_full.timing["per_iteration"]), start=1):
        print(f"  iteration {i}: rank budget {b}, n_eigen {n_eigen[i]}, "
              f"{sec:.3f} s (full rank {sec_full:.3f} s)")
    print(f"  log-marginal {loss.tolist()} vs full rank "
          f"{loss_full.tolist()}: max rel {err:.3e}")
    checks["reduced fit not failed, finite"] = (
        not res.failed and bool(np.all(np.isfinite(loss))))
    checks["reduced fit launched the kernel"] = counts["gram"] > 0
    checks["the budget never saturated"] = all(
        n_eigen[i] < b for i, b in enumerate(budgets, start=1))
    checks[f"log-marginal within {REFERENCE_RTOL} of the full-rank fit"] = (
        err <= REFERENCE_RTOL)

    print(f"  spans (host s): {span_line(spans)}; full rank "
          f"{span_line(spans_full)}")
    # one more fit of each, back to back on this card (phase 4 ran minutes
    # earlier, and these host-bound fits move with the host's speed)
    turns = []
    for name, c in (("full", cfg), ("reduced", cfg_r)):
        with objective_counts() as ev:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(x, r, c, xtilde=xtilde, theta=THETA0, f_params=F_PARAMS0)
            torch.cuda.synchronize()
        turns.append(f"{name} {time.perf_counter() - t0:.3f} s "
                     f"({ev['fparam']} f-param evaluations)")
    print(f"  back to back: {', '.join(turns)}  [{smi}]")

    # (b) state_at_iteration and evaluate(at_iteration=)
    def reconstruct():
        st = state_at_iteration(res, 1)
        _, rates1, r2_1, _ = evaluate(res, xt, rt, at_iteration=1,
                                      nbootstrap=200)
        _, rates_last, _, _ = evaluate(res, xt, rt,
                                       at_iteration=cfg.maxiter - 1,
                                       nbootstrap=200)
        return st, rates1, float(r2_1), rates_last, predict(res, xt)[0]

    (st, rates1, r2_1, rates_last, rates_pred), _, counts = counted(
        reconstruct, "state_at_iteration")
    rec_err = float(torch.max(torch.abs(rates_last - rates_pred)
                              / torch.abs(rates_pred)))
    print(f"state_at_iteration(1): kept {int(st[4].keep.sum())} of "
          f"{st[4].keep.numel()}, r2 at iteration 1 {r2_1:.4f}; iteration "
          f"{cfg.maxiter - 1} reconstructed vs predict: max rel "
          f"{rec_err:.3e}; Gram launches {counts['gram']}")
    # what the last iteration's reconstruction differs from predict by:
    # its k_tilde_b_diag, the Rayleigh quotients diag(B^T K_tilde B) of the
    # full-grid K_tilde, in place of the fit's eigenvalues, and the tracked
    # V_b in place of the one _fit_finalize symmetrised (and jittered if
    # it was not positive definite); each swapped in alone and both
    last = cfg.maxiter - 1
    theta_l, fp_l, m_l, V_l, es_l = state_at_iteration(res, last)
    rk = res.m_b.shape[0]
    keep_fit = torch.zeros_like(es_l.keep)
    keep_fit[-rk:] = res.keep
    keepf = keep_fit.to(res.eigvals.dtype)
    ev_fit = torch.zeros_like(es_l.k_tilde_b_diag)
    ev_fit[-rk:] = res.eigvals
    ev_fit = ev_fit * keepf
    inv_fit = keepf / torch.where(keep_fit, ev_fit, torch.ones_like(ev_fit))
    V_fin = torch.zeros_like(V_l)
    V_fin[-rk:, -rk:] = res.V_b
    kept = keep_fit & es_l.keep
    kb_gap = float(torch.max(torch.abs(es_l.k_tilde_b_diag - ev_fit)[kept]
                             / ev_fit[kept]))
    v_gap = float(torch.max(torch.abs(V_l - V_fin)) / torch.max(
        torch.abs(V_fin)))
    rec = {}
    for name, (kb_, inv_, V_) in {
            "Rayleigh quotients + tracked V_b": (
                es_l.k_tilde_b_diag, es_l.k_tilde_inv_diag, V_l),
            "fit's eigenvalues + tracked V_b": (ev_fit, inv_fit, V_l),
            "Rayleigh quotients + final V_b": (
                es_l.k_tilde_b_diag, es_l.k_tilde_inv_diag, V_fin),
            "fit's eigenvalues + final V_b": (ev_fit, inv_fit, V_fin)}.items():
        rates_v = predict_rates(xt, res.xtilde, theta_l, fp_l, m_l, V_, es_l.B,
                                kb_, inv_, n_px_side=cfg.n_px_side,
                                alpha_threshold=cfg.alpha_threshold)[0]
        rec[name] = float(torch.max(torch.abs(rates_v - rates_pred)
                                    / torch.abs(rates_pred)))
    print(f"  iteration {last} vs the fit: keep masks equal "
          f"{torch.equal(keep_fit, es_l.keep)}, basis max|dB| "
          f"{float(torch.max(torch.abs(es_l.B[:, -rk:] - res.B))):.3e}, "
          f"max|dm_b| {float(torch.max(torch.abs(m_l[-rk:] - res.m_b))):.3e}"
          f", V_b max rel {v_gap:.3e}, Rayleigh quotients vs eigenvalues "
          f"max rel {kb_gap:.3e}")
    print("  rates vs predict, max rel, with " + "; ".join(
        f"{name} {err:.3e}" for name, err in rec.items()))
    checks[f"iteration {last} with the fit's eigenvalues and V_b within "
           f"{RECON_EIG_RTOL} of predict"] = (
        rec["fit's eigenvalues + final V_b"] <= RECON_EIG_RTOL)
    checks["iteration-1 rates finite"] = bool(torch.isfinite(rates1).all())
    checks[f"final iteration within {RECON_RTOL} of predict"] = (
        rec_err <= RECON_RTOL)

    # (c) the CLI's fit at its own defaults, in-process, and its checkpoint
    (HERE / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE / "build")
    try:
        out_dir = str(Path(tmp) / "model")
        cli, cli_s, counts = counted(lambda: one_cell_fit.main(
            ["--out", out_dir]), "CLI fit")
        loaded = load_model(out_dir)
    finally:
        shutil.rmtree(tmp)
    cres = cli["result"]
    got = predict(loaded, xt)
    want = predict(cres, xt)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"CLI fit (defaults: synthetic retina {cres.config.n_px_side} px, "
          f"nt {cres.K.shape[0]}, ntilde {cres.config.ntilde}, "
          f"{cres.config.maxiter} EM iterations of {cres.config.n_estep}/"
          f"{cres.config.n_mstep}/{cres.config.n_fparamstep}, solvers "
          f"{cres.config.eigensolver}/{cres.config.estep_solver}/"
          f"{cres.config.mstep_inverse}/{cres.config.mstep_logdet}, rank "
          f"budget {cres.m_b.shape[0]}, n_eigen "
          f"{cres.track.n_eigen.tolist()}): fit "
          f"{cli['seconds']:.3f} s, with data, r2 and saving {cli_s:.3f} s; "
          f"r2 {cli['r2']:.4f} +/- {cli['sigma_r2']:.4f}; loaded model "
          f"predicts bit for bit: {same}; Gram launches {counts['gram']}  "
          f"[{smi}]")
    checks["CLI fit launched the kernel"] = counts["gram"] > 0
    checks["CLI fit not failed, r2 finite"] = (
        not cres.failed and math.isfinite(cli["r2"]))
    checks["loaded checkpoint predicts bit for bit"] = same

    # (d) entry(): its prior state's K_tilde and its forward's K* through
    # the kernel; then both Grams through the kernel against the plain Gram
    # on entry()'s operands (at the prior state, m = 0 and V = diag of the
    # eigenvalues, the rates read K* only through its diagonal, which both
    # backends compute plainly: the rates could not tell a wrong kernel)
    (fn, args), _, counts_state = counted(entry_module.entry, "entry()")
    rates_k, _, counts = counted(lambda: fn(*args), "entry forward")
    rng = np.random.default_rng(0)          # entry()'s draws: xtilde first
    xtilde_e = torch.as_tensor(
        rng.standard_normal((entry_module.NTILDE, entry_module.N_PX ** 2)),
        dtype=torch.float32, device=device)
    with torch.no_grad():
        grams = {b: gram_matrices(args[1], args[0], xtilde_e,
                                  entry_module.N_PX, shared=False,
                                  backend=b)[:2] for b in ("cuda", "torch")}
    ent_err = {name: float(torch.max(torch.abs(grams["cuda"][i]
                                               - grams["torch"][i]))
                           / torch.max(torch.abs(grams["torch"][i])))
               for i, name in enumerate(("K_tilde", "K*"))}
    print(f"entry(): forward {tuple(rates_k.shape)} on {rates_k.device}; "
          f"gram_matrices through the kernel vs the plain Gram, max|dK|/"
          f"max|K|: " + ", ".join(
              f"{name} {tuple(grams['torch'][i].shape)} {ent_err[name]:.3e}"
              for i, name in enumerate(ent_err))
          + f"; Gram launches: entry() {counts_state['gram']}, forward "
          f"{counts['gram']}")
    checks["entry() and its forward launched the kernel"] = (
        counts_state["gram"] > 0 and counts["gram"] > 0)
    checks["entry forward finite, (32,)"] = (
        bool(torch.isfinite(rates_k).all()) and rates_k.shape == (32,))
    checks[f"entry's K_tilde and K* within {KERNEL_RTOL} of the plain "
           f"Gram"] = all(e <= KERNEL_RTOL for e in ent_err.values())

    # the kernel against its plain version at each shape that (a)-(d)
    # launched and phases 2 and 5 had not held
    new = sorted(shape for shape in seen if shape not in checked)
    print(f"phase 10's paths launched the 2-D Gram at {len(seen)} shapes, "
          f"{len(new)} of them new: {new}")
    for shape in new:
        path, ops = seen.pop(shape)
        kind = ("K_tilde" if shape[0] == shape[1]
                and torch.equal(ops[2], ops[3]) else "K")
        check_kernel(f"{kind} ({path})", ops)
    seen.clear()

    # (e) the large path's Grams alone: its first and last row blocks and
    # its K*, each called as the path calls it
    blk_abs = 0.0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name, ops, use_out in block_ops:
        m, n, k = ops[0].shape[0], ops[1].shape[0], ops[0].shape[1]
        buf = torch.empty((m, n), device=device) if use_out else None
        with torch.no_grad():
            got = gram_cuda.acos_gram(*ops, out=buf)
            ref = gram_cuda.acos_gram_torch(*ops)
            abs_err = float(torch.max(torch.abs(got - ref)))
            rel = abs_err / float(torch.max(torch.abs(ref)))
            del ref, got
            blk_ms = cuda_ms(torch, lambda: gram_cuda.acos_gram(*ops,
                                                                out=buf),
                             reps=10)
            blk_plain = cuda_ms(torch, lambda: gram_cuda.acos_gram_torch(
                *ops), reps=10)
            blk_lib = cuda_ms(torch, lambda: torch.matmul(ops[0], ops[1].T),
                              reps=10)
        del buf
        blk_abs = max(blk_abs, abs_err)
        blk_bound, blk_by = gram_bound(1, m, n, k)
        print(f"large {name} {m}x{n} k={k}{' (out=)' if use_out else ''}: "
              f"max rel {rel:.3e}, kernel {blk_ms:.3f} ms, plain "
              f"{blk_plain:.3f} ms, cuBLAS FP32 product alone {blk_lib:.3f} "
              f"ms, bound {blk_bound:.3f} ms ({blk_by})  [{smi}]")
        print(f"  plan: {gram_cuda.plan_gram(m, n, k, sms)}")
        checks[f"large {name} within {KERNEL_RTOL} of plain"] = (
            rel <= KERNEL_RTOL)
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"entry-point check failed: {what}")
    return blk_abs, (res, red_s, spans, cfg_r)


@contextlib.contextmanager
def first_batched_operands(gram_cuda, store):
    """Keeps in ``store`` copies of the operands of the first two batched
    Grams (a ladder's K_tilde and K) that the kernel wrapper is handed
    while the block runs."""
    real = gram_cuda.acos_gram

    def record(*args, **kwargs):
        if args[0].dim() == 3 and len(store) < 2:
            store.append([a.detach().clone() for a in args])
        return real(*args, **kwargs)

    gram_cuda.acos_gram = record
    try:
        yield store
    finally:
        gram_cuda.acos_gram = real


def phase11_linesearches(torch, np, device, smi, totals, x, r, xtilde, cfg,
                         res_full, evals_full):
    """The other line searches and the convergence gates at phase 4's data,
    shape and steps (see the module docstring).  Adds each fit's launches
    to ``totals``; returns the batched kernel's readings on the speculative
    ladder's K_tilde and K for the kernel table."""
    from gaussian_processes_tpu_torch.models import fit as fit_module
    from gaussian_processes_tpu_torch.models.fit import fit
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.ops.kernels import crop_window_for_theta
    from gaussian_processes_tpu_torch.params import theta_bounds
    from gaussian_processes_tpu_torch.utils.tracing import objective_counts

    loss_full = res_full.track.logmarginal.double().cpu().numpy()
    print(f"phase 4's fit (zoom): objective evaluations {evals_full}, final "
          f"log-marginal {loss_full[-1]:.4f}")
    checks, ladder_ops, ladder_thetas = {}, [], []
    for arm, (what, knobs) in LS_FITS.items():
        c = dataclasses.replace(cfg, **knobs)
        with objective_counts(ladder_thetas if arm == "a"
                              else None) as ev, first_batched_operands(
                gram_cuda, ladder_ops if arm == "a" else []):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = fit(x, r, c, xtilde=xtilde, theta=THETA0,
                      f_params=F_PARAMS0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        counts = read_counts()
        add_counts(totals, counts)
        loss = res.track.logmarginal.double().cpu().numpy()
        print(f"({arm}) {what}: {sec:.3f} s; objective evaluations {ev}; "
              f"Gram launches 2-D {counts['gram']}, batched "
              f"{counts['batched']} ({counts['items']} items); final "
              f"log-marginal {loss[-1]:.4f} (phase 4's {loss_full[-1]:.4f}); "
              f"per iteration {loss.tolist()}  [{smi}]")
        checks[f"({arm}) finite, not failed, improved"] = (
            not res.failed and bool(np.all(np.isfinite(loss)))
            and bool(loss[-1] > loss[0]))
        checks[f"({arm}) launched the kernel"] = counts["gram"] > 0
        if arm != "a":
            continue
        print(f"  final theta {[round(float(v), 4) for v in res.theta.values()]}"
              f" (phase 4's "
              f"{[round(float(v), 4) for v in res_full.theta.values()]})")
        checks["(a)'s M-step ladders launched the batched kernel"] = (
            ev["mstep_ladder"] == 0 or counts["batched"] > 0)
        res_p = fit(x, r, c, xtilde=xtilde, theta=THETA0, f_params=F_PARAMS0,
                    backend="torch")
        loss_p = res_p.track.logmarginal.double().cpu().numpy()
        err = float(np.max(np.abs(loss - loss_p) / np.abs(loss_p)))
        print(f"  the same fit through the plain Gram: {loss_p.tolist()}, "
              f"max rel difference {err:.3e}")
        checks[f"(a) within {REFERENCE_RTOL} of the plain-Gram fit"] = (
            not res_p.failed and err <= REFERENCE_RTOL)

    # the batched kernel at the ladder's shapes: on armijo_trials points of
    # a ladder along a seeded direction from the start theta, through the
    # M-step's batched evaluator, as phase 7 holds it
    th0 = {k: torch.tensor(v, device=device) for k, v in THETA0.items()}
    fp0 = {k: torch.tensor(v, device=device) for k, v in F_PARAMS0.items()}
    win = crop_window_for_theta(th0, N_PX, cfg.alpha_threshold,
                                cfg.crop_margin, cfg.crop_bucket)
    win = None if win[2] >= N_PX else win
    lower, upper = theta_bounds()
    start_ops = []
    with torch.no_grad():
        c0 = fit_module._fit_init(x, r, xtilde, th0, fp0,
                                  torch.zeros(NTILDE, device=device), None,
                                  False, False, cfg, win)
        ladder = fit_module._mstep_ladder(
            x, xtilde, r, c0.kern.es, c0.m_b, c0.V_b, c0.f_params, False, cfg,
            lower, upper, win)
        steps = 0.5 ** np.arange(1, cfg.armijo_trials + 1)
        d = np.random.default_rng(11).standard_normal(len(THETA0)) * 0.05
        with first_batched_operands(gram_cuda, start_ops):
            ladder({k: torch.tensor(v + steps * d[i], dtype=torch.float32,
                                    device=device)
                    for i, (k, v) in enumerate(THETA0.items())})
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {name: check_batched(torch, gram_cuda, sms, smi,
                               f"{name} (speculative ladder)", ops)
           for name, ops in zip(("K_tilde", "K"), start_ops)}
    del start_ops, c0, ladder

    # ... and on (a)'s first M-step ladder, whose trials lie far out along
    # the cold search's unscaled -g: there the float32 Grams themselves are
    # ill-conditioned, so both float32 versions are read against a float64
    # plain Gram, and the kernel must be no further from it than 1e-5 or
    # the plain float32 version, whichever is larger
    if ladder_thetas:
        print(f"(a)'s first M-step ladder, trial thetas (out of bounds: "
              f"+inf): " + "; ".join(
                  f"{k} {[float(f'{v:.4g}') for v in t.reshape(-1).tolist()]}"
                  for k, t in ladder_thetas[0].items()))
    for name, ops in zip(("K_tilde", "K"), ladder_ops):
        with torch.no_grad():
            K_kernel = gram_cuda.acos_gram(*ops)
            K_plain = gram_cuda.acos_gram_torch(*ops)
            K_64 = gram_cuda.acos_gram_torch(*(t.double() for t in ops))
        rel = float(torch.max(torch.abs(K_kernel - K_plain))
                    / torch.max(torch.abs(K_plain)))
        rel64 = [float(torch.max(torch.abs(K.double() - K_64))
                       / torch.max(torch.abs(K_64)))
                 for K in (K_kernel, K_plain)]
        line = (f"(a)'s ladder {name} {tuple(K_kernel.shape)}: kernel vs "
                f"plain max|dK|/max|K| {rel:.3e}; vs float64: kernel "
                f"{rel64[0]:.3e}, plain {rel64[1]:.3e}")
        ok = rel <= KERNEL_RTOL and rel64[0] <= max(KERNEL_RTOL, rel64[1])
        if name == "K_tilde":
            d64 = K_64.diagonal(dim1=-2, dim2=-1)
            diag = [torch.max(torch.abs(K.diagonal(dim1=-2, dim2=-1).double()
                                        - d64) / torch.abs(d64), dim=-1)[0]
                    for K in (K_kernel, K_plain)]
            line += (f"; per item, the K_tilde diagonal's max relative error "
                     f"vs float64: kernel {[f'{v:.2e}' for v in diag[0]]}, "
                     f"plain {[f'{v:.2e}' for v in diag[1]]}")
            ok = ok and float(diag[0].max()) <= max(KERNEL_RTOL,
                                                    float(diag[1].max()))
        print(line)
        checks[f"(a)'s ladder {name}: kernel within {KERNEL_RTOL} of plain, "
               f"no further from float64"] = ok
        del K_kernel, K_plain, K_64
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"line-search check failed: {what}")
    return out


def phase12_warm_solvers(torch, np, device, smi, totals, x, r, xtilde,
                         reduced, check_kernel):
    """The JAX package's default solvers and the projected M-step Gram at
    phase 4's data, shape and steps (see the module docstring), beside
    phase 10(a)'s reduced eigh fit ``reduced`` = (result, seconds, spans,
    config).  Adds each fit's launches to ``totals``."""
    from torch.profiler import ProfilerActivity, profile

    from gaussian_processes_tpu_torch.models.fit import fit
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.ops.kernels import (
        crop_images, crop_window_for_theta, gram_matrices,
        gram_matrices_projected, gram_matrices_windowed,
        smooth_projection_basis)
    from gaussian_processes_tpu_torch.ops.stabilize import (
        masked_inverse_spd, masked_inverse_warm)
    from gaussian_processes_tpu_torch.utils.tracing import (
        collect_spans, decisions)

    res_r, red_s, spans_r, cfg_r = reduced
    loss_r = res_r.track.logmarginal.double().cpu().numpy()
    checks = {}

    def run(c, backend=None, seen=None):
        """The fit under ``c``: result, seconds, spans, launch counts (added
        to ``totals``) and the solvers' host decisions; the first operands
        of each 2-D Gram shape go to ``seen``."""
        torch.cuda.synchronize()
        reset_counts()
        decisions.clear()
        t0 = time.perf_counter()
        with collect_spans() as spans, operands_by_shape(
                gram_cuda, {} if seen is None else seen, "phase 12"):
            res = fit(x, r, c, xtilde=xtilde, theta=THETA0,
                      f_params=F_PARAMS0, profile=True, backend=backend)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        add_counts(totals, counts)
        return res, sec, spans, counts, dict(decisions)

    def rel_err(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    # (a) the JAX defaults' solvers at phase 10(a)'s reduced rank
    cfg_a = dataclasses.replace(cfg_r, **WARM_KNOBS)
    res_a, sec_a, spans_a, counts_a, dec_a = run(cfg_a)
    loss_a = res_a.track.logmarginal.double().cpu().numpy()
    err_a = rel_err(loss_a, loss_r)
    n_eig = res_a.track.n_eigen.tolist()
    print(f"(a) subspace eigensolver (refresh every "
          f"{cfg_a.eigh_refresh_every}), Schulz E-step and M-step inverses, "
          f"series log-determinant: {sec_a:.3f} s (phase 10(a)'s reduced "
          f"eigh fit {red_s:.3f} s); Gram launches {counts_a['gram']}; host "
          f"decisions {dec_a}  [{smi}]")
    for i, (route, b, sec) in enumerate(zip(
            res_a.timing["eigensolver"], res_a.timing["rank"],
            res_a.timing["per_iteration"]), start=1):
        print(f"  iteration {i}: {route}, rank budget {b}, n_eigen "
              f"{n_eig[i]} (eigh fit {res_r.track.n_eigen.tolist()[i]}), "
              f"{sec:.3f} s (eigh fit {res_r.timing['per_iteration'][i - 1]:.3f}"
              f" s)")
    print(f"  log-marginal {loss_a.tolist()} vs the eigh fit "
          f"{loss_r.tolist()}: max rel {err_a:.3e}")
    print(f"  spans (host s): {span_line(spans_a)}; eigh fit "
          f"{span_line(spans_r)}")
    checks["(a) not failed, finite"] = (
        not res_a.failed and bool(np.all(np.isfinite(loss_a))))
    checks["(a) launched the kernel"] = counts_a["gram"] > 0
    checks["(a) ran the warm eigensolver"] = (
        res_a.used_warm_basis and dec_a.get("eigensolver.warm", 0) > 0)
    checks[f"(a) within {REFERENCE_RTOL} of the eigh fit"] = (
        err_a <= REFERENCE_RTOL)

    # host synchronizations of each EM iteration, both fits, with one
    # f-param L-BFGS step per Newton step: at 10 steps the f-param search's
    # host reads (over a thousand an iteration, alike in both) bury the
    # solvers' and take the profiler minutes to attribute
    for name, c in (("eigh fit", cfg_r), ("(a)", cfg_a)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fit(x, r, dataclasses.replace(c, n_fparamstep=1), xtilde=xtilde,
                theta=THETA0, f_params=F_PARAMS0)
            torch.cuda.synchronize()
        for i, syncs in enumerate(syncs_by_iteration(torch, prof), start=1):
            print(f"  host synchronizations at n_fparamstep 1, {name}, EM "
                  f"iteration {i}: {sum(syncs.values())}, by call and op: "
                  f"{syncs}")

    # (b) (a) with the projected Gram, the rank sized by fit
    cfg_b = dataclasses.replace(cfg_a, mstep_gram="projected")
    seen = {}
    res_b, sec_b, spans_b, counts_b, dec_b = run(cfg_b, seen=seen)
    rank = res_b.config.mstep_proj_rank
    loss_b = res_b.track.logmarginal.double().cpu().numpy()
    err_b = rel_err(loss_b, loss_a)
    print(f"(b) (a) with the projected Gram, rank {rank} (contraction "
          f"{rank * rank}): {sec_b:.3f} s; guard passes "
          f"{dec_b.get('mstep.projected', 0)}, exact fallbacks "
          f"{dec_b.get('mstep.exact_gram', 0)}; host decisions {dec_b}; "
          f"Gram launches by (batch, m, n, k) {counts_b['shapes']}  [{smi}]")
    print(f"  log-marginal {loss_b.tolist()} vs (a): max rel {err_b:.3e}")
    print(f"  spans (host s): {span_line(spans_b)}")
    res_bt, sec_bt, _, _, _ = run(cfg_b, backend="torch")
    loss_bt = res_bt.track.logmarginal.double().cpu().numpy()
    err_bt = rel_err(loss_b, loss_bt)
    print(f"  the same fit through the plain Gram: {sec_bt:.3f} s, "
          f"log-marginal {loss_bt.tolist()}, max rel difference {err_bt:.3e}")
    checks["(b) not failed, finite"] = (
        not res_b.failed and bool(np.all(np.isfinite(loss_b))))
    checks["(b) launched the kernel at the projected contraction"] = any(
        k == rank * rank for (_, _, _, k) in counts_b["shapes"])
    checks[f"(b) within {REFERENCE_RTOL} of (a)"] = err_b <= REFERENCE_RTOL
    checks[f"(b) within {REFERENCE_RTOL} of its plain-Gram twin"] = (
        not res_bt.failed and err_bt <= REFERENCE_RTOL)
    del res_bt

    # (c) the kernel against its plain version at the projected shapes:
    # (b)'s operands at its rank, and at the pinned rank on the start
    # theta's crop window
    th0 = {k: torch.tensor(v, device=device) for k, v in THETA0.items()}
    i0, j0, w = crop_window_for_theta(th0, N_PX, cfg_b.alpha_threshold,
                                      cfg_b.crop_margin, cfg_b.crop_bucket)
    xc = crop_images(x, i0, j0, w, N_PX)
    xtc = crop_images(xtilde, i0, j0, w, N_PX)
    E = smooth_projection_basis(th0, w, N_PX, PINNED_PROJ_RANK,
                                dtype=torch.float64)
    pinned = gram_cuda.recorded_operands(lambda: (
        gram_matrices_projected(th0, xc, xtc, E, i0, j0, N_PX, False)))
    del xc, xtc
    for R, ops_pair in (
            (rank, [seen.pop((NTILDE, NTILDE, rank * rank))[1],
                    seen.pop((NT, NTILDE, rank * rank))[1]]),
            (PINNED_PROJ_RANK, pinned)):
        for name, ops in zip(("K_tilde", "K"), ops_pair):
            check_kernel(f"{name} (projected, rank {R})", ops)
    seen.clear()
    del pinned

    # (d) the warm M-step inverse at (a)'s rank budget, on the M-step's
    # K_tilde_b at a trial theta near (a)'s final one
    budget = res_a.m_b.shape[0]
    near = {k: v + (0.01 if k == "-log2rho2" else 0.0)
            for k, v in res_a.theta.items()}
    with torch.no_grad():
        K_near = gram_matrices(near, xtilde, xtilde, N_PX, shared=True)[0]
        M = res_a.B.mT @ K_near @ res_a.B
        M = 0.5 * (M + M.mT)
        keep, inv_diag = res_a.keep, res_a.k_tilde_inv_diag
        decisions.clear()
        X_warm = masked_inverse_warm(M, keep, inv_diag)
        route = dict(decisions)
        X_spd = masked_inverse_spd(M, keep)
        X_64 = masked_inverse_spd(M.double(), keep)
        scale = float(torch.max(torch.abs(X_64)))
        err_w = float(torch.max(torch.abs(X_warm.double() - X_64))) / scale
        err_s = float(torch.max(torch.abs(X_spd.double() - X_64))) / scale
        ms_warm = cuda_ms(torch, lambda: masked_inverse_warm(M, keep,
                                                             inv_diag))
        ms_poison = cuda_ms(torch, lambda: masked_inverse_warm(
            M, keep, inv_diag, fallback="poison"))
        ms_spd = cuda_ms(torch, lambda: masked_inverse_spd(M, keep))
    print(f"(d) masked_inverse_warm at (a)'s rank budget {budget} (kept "
          f"{int(keep.sum())}), K_tilde_b at -log2rho2 + 0.01 from (a)'s "
          f"final theta: route {route}; max|X - X64|/max|X64| warm "
          f"{err_w:.3e}, Cholesky float32 {err_s:.3e}; CUDA-event medians: "
          f"warm {ms_warm:.3f} ms (its guard read on the host), warm with "
          f"the poison fallback {ms_poison:.3f} ms, masked_inverse_spd "
          f"{ms_spd:.3f} ms  [{smi}]")
    checks["(d) the warm inverse finite"] = bool(torch.isfinite(X_warm).all())
    checks[f"(d) the warm inverse within {WARM_INVERSE_RTOL} (or twice the "
           f"Cholesky inverse's error) of float64"] = (
        err_w <= max(WARM_INVERSE_RTOL, 2 * err_s))
    del K_near, M, X_warm, X_spd, X_64

    # (e) the kernel alone at the 2-D shapes the main paths launch >= 20
    # times that no phase held: the pipelined loop's capacity buffer on the
    # full frame, and 512 inducing points at the crop window and the full
    # frame (the sequential and single-cell Armijo fits' shapes)
    theta = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in THETA0.items()}
    crop = crop_window_for_theta(theta, N_PX, cfg_b.alpha_threshold,
                                 cfg_b.crop_margin, cfg_b.crop_bucket)
    x_cap = torch.zeros((CAPACITY, N_PX * N_PX), device=device)
    x_cap[:N_START] = x[:N_START]
    x512 = xtilde[:POP_NTILDE]
    shapes = [
        ("K_tilde cap", gram_cuda.recorded_operands(lambda: (
            gram_matrices(theta, x_cap, x_cap, N_PX, shared=True)))[:1]),
        ("512", gram_cuda.recorded_operands(lambda: (
            gram_matrices_windowed(theta, x, x512, N_PX, False, *crop)))),
        ("512", gram_cuda.recorded_operands(lambda: gram_matrices(
            theta, x, x512, N_PX, shared=False))),
    ]
    for what, calls in shapes:
        for name, ops in zip(("K_tilde", "K"), calls):
            check_kernel(f"{name} ({what})", ops)
    del x_cap, shapes
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"phase 12 check failed: {what}")


@contextlib.contextmanager
def collectives_by_iteration(fit_module, collectives):
    """The collectives launched (``parallel/collectives.calls``) during
    each EM iteration (``_fit_iteration`` call) while the block runs."""
    per = []
    real = fit_module._fit_iteration

    def iteration(*args, **kwargs):
        before = dict(collectives.calls)
        out = real(*args, **kwargs)
        per.append({k: v - before.get(k, 0)
                    for k, v in collectives.calls.items()})
        return out

    fit_module._fit_iteration = iteration
    try:
        yield per
    finally:
        fit_module._fit_iteration = real


def phase13_mesh(torch, np, device, smi, totals, x, r, xtilde, cfg, res,
                 fit_s):
    """The mesh at world 1 on the card (see the module docstring), beside
    phase 4's fit ``res`` (``fit_s`` seconds).  Adds the launches of (b)-(d)
    to ``totals``."""
    import tempfile

    import torch.distributed as dist

    from gaussian_processes_tpu_torch.benchmarks.fparam_route import (
        plain_fparam_route)
    from gaussian_processes_tpu_torch.config import FitConfig
    from gaussian_processes_tpu_torch.entry import dryrun_multichip
    from gaussian_processes_tpu_torch.models import fit as F
    from gaussian_processes_tpu_torch.ops.kernels import gram_matrices
    from gaussian_processes_tpu_torch.parallel import collectives as C
    from gaussian_processes_tpu_torch.parallel import (
        fit_population, large_gram, make_mesh)
    from gaussian_processes_tpu_torch.parallel.sharded_linalg import (
        distributed_cholesky, sharded_gram)
    from gaussian_processes_tpu_torch.utils.tracing import collect_spans

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # (a) a world-1 process group of this process, and its mesh (the
    # rendezvous file is the group's store until it is destroyed)
    backend = "nccl" if device.type == "cuda" else "gloo"
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(backend,
                            init_method=f"file://{tmp.name}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        nccl = (".".join(map(str, torch.cuda.nccl.version()))
                if backend == "nccl" else "-")
        print(f"mesh: world 1, {backend} (NCCL {nccl}), {mesh.device_type}, "
              f"cells x data = {tuple(mesh.mesh.shape)}")
        checks = {}

        # (b) sharded_gram at bench.py's shape on the full grid
        theta = {k: torch.tensor(v, dtype=x.dtype, device=device)
                 for k, v in THETA0.items()}
        reset_counts()
        with torch.no_grad():
            grams = sharded_gram(THETA0, x, xtilde, N_PX, mesh)
            sync()
            counts = read_counts()
            add_counts(totals, counts)
            plain = gram_matrices(theta, x, xtilde, N_PX, shared=False,
                                  backend="torch")
        errs = [float(torch.max(torch.abs(g - p)) / torch.max(torch.abs(p)))
                for g, p in zip(grams, plain)]
        print(f"(b) sharded_gram x {tuple(x.shape)}, xtilde "
              f"{tuple(xtilde.shape)}: K_tilde, K, Kvec against the plain "
              f"Gram max rel {errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e}; "
              f"Gram launches {counts['gram']}")
        checks["(b) sharded Gram within 1e-5 of the plain Gram"] = (
            max(errs) <= KERNEL_RTOL)
        checks["(b) the Gram kernel ran on the sharded rows"] = (
            counts["gram"] > 0)
        del grams, plain

        # (c) phase 4's fit with its rows over the mesh's "data" axis,
        # beside phase 4's fit on the mesh's own f-param route: the
        # host-driven search (item 28)
        with plain_fparam_route():
            res_h = F.fit(x, r, cfg, xtilde=xtilde, theta=THETA0,
                          f_params=F_PARAMS0)
        C.calls.clear()
        sync()
        reset_counts()
        t0 = time.perf_counter()
        with collect_spans() as spans, collectives_by_iteration(
                F, C) as per_iteration:
            res_m = F.fit(x, r, cfg, xtilde=xtilde, theta=THETA0,
                          f_params=F_PARAMS0, profile=True, mesh=mesh)
        sync()
        mesh_s = time.perf_counter() - t0
        counts = read_counts()
        add_counts(totals, counts)
        # the control: phase 4's fit in float64 on the plain routes, against
        # which phase 4's float32 kernel fit shows its own rounding
        res_64 = F.fit(x.double(), r.double(), cfg, xtilde=xtilde.double(),
                       theta=THETA0, f_params=F_PARAMS0, backend="torch")
        loss = res_h.track.logmarginal.double().cpu().numpy()
        loss_4 = res.track.logmarginal.double().cpu().numpy()
        loss_m = res_m.track.logmarginal.double().cpu().numpy()
        loss_64 = res_64.track.logmarginal.double().cpu().numpy()
        err = float(np.max(np.abs(loss_m - loss) / np.abs(loss)))
        err_4 = float(np.max(np.abs(loss_m - loss_4) / np.abs(loss_4)))
        err_64 = float(np.max(np.abs(loss_4 - loss_64) / np.abs(loss_64)))
        print(f"(c) fit(mesh=) at phase 4's shape: {mesh_s:.3f} s (phase 4: "
              f"{fit_s:.3f} s); log-marginal {loss_m.tolist()}, max rel "
              f"{err:.3e} from phase 4's fit on the host-driven f-param "
              f"search, {err_4:.3e} from phase 4's (its kernel; bound "
              f"{MESH_KERNEL_RTOL:.0e}); phase 4's from its float64 plain "
              f"twin {loss_64.tolist()}: {err_64:.3e}; collectives "
              f"{dict(C.calls)}, per EM iteration {per_iteration}; Gram "
              f"launches {counts['gram']}  [{smi}]")
        print(f"  fit spans (host s): {span_line(spans)}")
        # what the mesh adds to the host-bound f-param search: one
        # value+grad evaluation at the fit's final moments (with the host
        # reads the search makes), plain and through the collectives, in
        # turns; and one world-1 all-reduce alone
        rows = C.data_rows(mesh, r.shape[0], r)
        lam_m, lam_v = F.lambda_moments(res.a, res.K_b, res.Kvec, res.m_b,
                                        res.V_b)

        def evaluation(rw):
            logA = res.f_params["logA"].detach().clone().requires_grad_()
            f = F._fparam_objective(logA, r, lam_m, lam_v, rows=rw)
            (g,) = torch.autograd.grad(f, [logA])
            return f.item(), g.item()

        def host_ms(fn, reps):
            for _ in range(10):
                fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            return (time.perf_counter() - t0) / reps * 1e3
        eval_ms = {"plain": [], "rows": []}
        for name in ("plain", "rows", "rows", "plain"):
            rw = rows if name == "rows" else None
            eval_ms[name].append(host_ms(lambda: evaluation(rw), 200))
        one = torch.zeros(3, device=device)
        ar_us = 1e3 * host_ms(lambda: C.all_reduce(one, rows.group), 500)
        print(f"  one f-param value+grad evaluation (host ms, in turns): "
              f"plain {eval_ms['plain']}, through the collectives "
              f"{eval_ms['rows']}; one world-1 all-reduce {ar_us:.1f} us of "
              f"host  [{smi}]")
        checks["(c) fit(mesh=) within 1e-5 of phase 4's on the host-driven "
               "f-param search at every iteration"] = (
            len(loss_m) == len(loss) and err <= 1e-5)
        checks[f"(c) fit(mesh=) within {MESH_KERNEL_RTOL:.0e} of phase 4's "
               f"fit (the f-param kernel) at every iteration"] = (
            len(loss_m) == len(loss_4) and err_4 <= MESH_KERNEL_RTOL)
        checks["(c) fit(mesh=) not failed"] = not res_m.failed
        checks["(c) the Gram kernel ran"] = counts["gram"] > 0

        # (d) phase 8's population on the 1 x 1 mesh, 2 EM iterations
        X, R, idx = population_data(np)
        xp = torch.as_tensor(X, device=device)
        rp = torch.as_tensor(R[:POP_CELLS], device=device)
        xtp = xp[torch.as_tensor(idx, device=device)]
        pcfg = FitConfig(ntilde=POP_NTILDE, n_px_side=N_PX,
                         track_variational=False,
                         **dict(POP_STEPS, maxiter=3))
        kw = dict(xtilde=xtp, thetas=POP_THETA, f_params=F_PARAMS0)
        sync()
        reset_counts()
        t0 = time.perf_counter()
        carry_m, _ = fit_population(xp, rp, pcfg, mesh=mesh, **kw)
        sync()
        pop_s = time.perf_counter() - t0
        counts = read_counts()
        add_counts(totals, counts)
        t0 = time.perf_counter()
        carry_n, _ = fit_population(xp, rp, pcfg, **kw)
        sync()
        pop_n_s = time.perf_counter() - t0
        lm_m = carry_m.track.logmarginal.double().cpu().numpy()
        lm_n = carry_n.track.logmarginal.double().cpu().numpy()
        err = float(np.max(np.abs(lm_m - lm_n) / np.abs(lm_n)))
        print(f"(d) fit_population(mesh=1x1), {POP_CELLS} cells, "
              f"{pcfg.maxiter - 1} EM iterations after init: {pop_s:.3f} s "
              f"(mesh=None {pop_n_s:.3f} s); log-marginal max rel {err:.3e}"
              f"; batched Gram launches {counts['batched']} "
              f"({counts['items']} items)  [{smi}]")
        checks["(d) population on the mesh within 1e-5 of mesh=None"] = (
            err <= 1e-5 and lm_m.shape == lm_n.shape)
        checks["(d) no lane failed"] = not bool(carry_m.failed.any())
        checks["(d) the batched Gram kernel ran"] = counts["batched"] > 0
        del xp, rp, xtp, carry_m, carry_n

        # (e) distributed_cholesky at n 16384 against torch.linalg.cholesky
        gen = np.random.default_rng(7)
        xc = torch.as_tensor(gen.standard_normal(
            (MESH_CHOL_N, LARGE_PX * LARGE_PX)).astype(np.float32),
            device=device)
        A0 = large_gram(LARGE_THETA, xc, LARGE_PX)
        A0.diagonal().add_(LARGE_JITTER)
        del xc
        A = A0.clone()
        L_d = distributed_cholesky(A, mesh)
        L_t = torch.linalg.cholesky(A0)
        sync()
        diff = float(torch.max(torch.abs(L_d - L_t)) / torch.max(
            torch.abs(L_t)))
        resid = float(torch.linalg.matrix_norm(L_d @ L_d.mT - A0)
                      / torch.linalg.matrix_norm(A0))
        del L_t

        def factor(fn):
            def run():
                A.copy_(A0)
                fn(A)
            return run
        ms_d = ms_t = float("nan")
        if device.type == "cuda":
            ms_d = cuda_ms(torch, factor(lambda a: distributed_cholesky(
                a, mesh)), reps=5, warmup=1)
            ms_t = cuda_ms(torch, factor(torch.linalg.cholesky), reps=5,
                           warmup=1)
        print(f"(e) distributed_cholesky n {MESH_CHOL_N} (K + I of "
              f"{LARGE_PX} px images): max|dL|/max|L| {diff:.3e} from "
              f"torch.linalg.cholesky, ||L L^T - A||_F / ||A||_F "
              f"{resid:.3e}; {ms_d:.3f} ms against {ms_t:.3f} ms (CUDA "
              f"events, each with the 1 GB copy of A)  [{smi}]")
        checks["(e) the distributed factor equals cuSOLVER's"] = (
            diff <= KERNEL_RTOL)
        checks["(e) residual within 1e-5"] = resid <= MESH_CHOL_RESID
        del A, A0, L_d

        # (f) the dry run on this world, then four CPU ranks
        t0 = time.perf_counter()
        dryrun_multichip(1)
        dry1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dryrun_multichip(4, device="cpu")
        print(f"(f) dryrun_multichip(1) on the card: passed in {dry1_s:.1f} "
              f"s; dryrun_multichip(4, device='cpu'): passed in "
              f"{time.perf_counter() - t0:.1f} s in a gloo world of 4 CPU "
              f"processes, float64 -- one card cannot hold four NCCL ranks")
        for what, ok in checks.items():
            if not ok:
                raise RuntimeError(f"mesh check failed: {what}")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()


def _rel_norm(torch, got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def phase14_unfitted(torch, np, device, smi, totals, x, r, xtilde, cfg, res):
    """The functions no fit calls, at phase 4's data and shape (see the
    module docstring), float64 unless said otherwise.  Adds (a)'s kernel
    launches to ``totals``."""
    from gaussian_processes_tpu_torch.models.estep import (
        estep_update, estep_update_V_inv, estep_update_damped,
        update_f_params_newton)
    from gaussian_processes_tpu_torch.models.fit import _mstep_objective
    from gaussian_processes_tpu_torch.models.moments import (
        ell_grad_f_params, lambda_moments, mean_f_given_lambda_moments,
        poisson_ell)
    from gaussian_processes_tpu_torch.ops import gram_cuda
    from gaussian_processes_tpu_torch.ops.analytic_grads import (
        analytic_mstep_grad)
    from gaussian_processes_tpu_torch.ops.kernels import (
        crop_images, crop_window_for_theta, gram_matrices)
    from gaussian_processes_tpu_torch.ops.stabilize import (
        Eigenspace, compute_eigenspace)
    from gaussian_processes_tpu_torch.params import THETA_KEYS, theta_bounds
    from gaussian_processes_tpu_torch.utils.tracing import decisions

    f64 = torch.float64
    x64, xt64, r64 = x.to(f64), xtilde.to(f64), r.to(f64)
    checks = {}

    # (a) the M-step gradient: the analytic chain on the full grid against
    # autograd of the objective on the crop window, as the fit calls it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    th64 = {k: torch.tensor(v, dtype=f64, device=device)
            for k, v in THETA0.items()}
    fp64 = {k: torch.tensor(v, dtype=f64, device=device)
            for k, v in F_PARAMS0.items()}
    K_tilde, _, _ = gram_matrices(th64, x64, xt64, N_PX, shared=False,
                                  backend="torch")
    es = compute_eigenspace(K_tilde)
    del K_tilde
    keep = es.keep.cpu().numpy()
    # tests/test_gradients.py's generic kept-subspace state
    rng = np.random.default_rng(3)
    W = rng.standard_normal((NTILDE, NTILDE)) * 0.05
    V_b = torch.as_tensor((W @ W.T + np.eye(NTILDE)) * np.outer(keep, keep),
                          device=device)
    m_b = torch.as_tensor(rng.standard_normal(NTILDE) * keep, device=device)
    g_an = analytic_mstep_grad(th64, x64, xt64, r64, es, m_b, V_b, fp64,
                               N_PX, cfg.alpha_threshold)
    g_an = torch.stack([g_an[k] for k in THETA_KEYS])
    torch.cuda.synchronize()
    an_s = time.perf_counter() - t0
    an_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lower, upper = theta_bounds()
    crop = crop_window_for_theta(th64, N_PX, cfg.alpha_threshold,
                                 cfg.crop_margin, cfg.crop_bucket)
    reset_counts()

    def autograd_grad(dtype, backend):
        xs, xts, rs = x.to(dtype), xtilde.to(dtype), r.to(dtype)
        xcrop = tuple(crop_images(v, *crop, N_PX) for v in (xs, xts))
        es_d = Eigenspace(*(t if t.dtype == torch.bool else t.to(dtype)
                            for t in es))
        leaf = {k: torch.tensor(v, dtype=dtype, device=device,
                                requires_grad=True)
                for k, v in THETA0.items()}
        loss = _mstep_objective(
            leaf, xs, xts, rs, es_d, m_b.to(dtype), V_b.to(dtype),
            {k: v.to(dtype) for k, v in fp64.items()}, False, cfg, lower,
            upper, win=crop, xcrop=xcrop, backend=backend)
        g = torch.autograd.grad(loss, [leaf[k] for k in THETA_KEYS])
        g = torch.stack(g).to(f64)
        err = float(torch.max(torch.abs(g - g_an)) / torch.max(
            torch.abs(g_an)))
        return err, float(loss.detach()), g

    t0 = time.perf_counter()
    runs = {"(i) float64, plain": autograd_grad(f64, "torch"),
            "(ii) float32, plain": autograd_grad(torch.float32, "torch")}
    launched = gram_cuda.launches
    runs["(iii) float32, kernel"] = autograd_grad(torch.float32, None)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    counts = read_counts()
    kernel_launches = gram_cuda.launches - launched
    add_counts(totals, counts)
    print(f"(a) M-step gradient at THETA0 ({int(keep.sum())} of {NTILDE} "
          f"eigendirections kept; crop window {crop}): analytic chain on the "
          f"full {N_PX} x {N_PX} grid {g_an.tolist()} in {an_s:.2f} s, peak "
          f"{an_peak:.2f} GiB allocated  [{smi}]")
    for name, (err, loss, g) in runs.items():
        print(f"  autograd {name}: loss {loss:.6f}, max_k|g - g_an| / "
              f"max_k|g_an| = {err:.3e}; g {g.tolist()}")
    print(f"  the three autograd gradients in {auto_s:.2f} s; Gram kernel "
          f"launches in (iii) {kernel_launches} (by shape "
          f"{counts['shapes']}); peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB allocated")
    err_i = runs["(i) float64, plain"][0]
    err_ii = runs["(ii) float32, plain"][0]
    err_iii = runs["(iii) float32, kernel"][0]
    checks["(a) float64 autograd within 1e-6 of the analytic chain"] = (
        err_i <= ANALYTIC_F64_RTOL)
    checks["(a) kernel autograd within max(1e-3, 2 x the plain float32's)"] = (
        err_iii <= max(GRAD_RTOL, 2.0 * err_ii))
    checks["(a) the Gram kernel launched in (iii)"] = kernel_launches > 0
    del es, V_b, m_b, runs

    # the final state of phase 4's fit, in float64
    fp_fit = {k: v.to(f64) for k, v in res.f_params.items()}
    a, m_fit, V_fit = res.a.to(f64), res.m_b.to(f64), res.V_b.to(f64)
    lam_m, lam_var = lambda_moments(a, res.K_b.to(f64), res.Kvec.to(f64),
                                    m_fit, V_fit)

    # (b) the legacy f-param Newton update from F_PARAMS0
    decisions.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, ell, f_new = update_f_params_newton(fp64, r64, lam_m, lam_var)
    torch.cuda.synchronize()
    newton_ms = (time.perf_counter() - t0) * 1e3
    stops = decisions["fparams_newton.stop"]
    iters = stops + decisions["fparams_newton.step"]
    g = ell_grad_f_params(r64, f_new, lam_m, lam_var, out)
    g = {k: float(v) for k, v in g.items()}
    f_fit = mean_f_given_lambda_moments(fp_fit, lam_m, lam_var)
    ell_fit = float(poisson_ell(r64, f_fit, lam_m, fp_fit))
    ell = float(ell)
    print(f"(b) update_f_params_newton from {F_PARAMS0}: {iters} iterations, "
          f"{'met tol 1e-6' if stops else 'stopped at nit 1000'}; "
          f"{newton_ms:.1f} ms with {iters} host reads  [{smi}]")
    print(f"  result { {k: float(v) for k, v in out.items()} }, "
          f"ell_grad_f_params {g}; ELL {ell:.6f} against {ell_fit:.6f} at "
          f"phase 4's final f-params "
          f"{ {k: float(v) for k, v in fp_fit.items()} }")
    checks["(b) each ELL gradient component below 1e-3"] = all(
        abs(v) < FPARAM_GRAD_ATOL for v in g.values())
    checks["(b) the Newton update's ELL is no lower than the fit's"] = (
        ell >= ell_fit - 1e-12 * abs(ell_fit))

    # (c) at alpha 1 the damped form and the explicit inverse are the
    # Newton E-step, on the kept coordinates
    k = res.keep
    kd = res.k_tilde_b_diag.to(f64)
    m_ref, V_ref = estep_update(r64, a, m_fit, f_fit, kd, fp_fit)
    m_ref, V_ref = m_ref[k], V_ref[k][:, k]
    m_d, V_d = estep_update_damped(r64, a[:, k], m_fit[k], V_fit[k][:, k],
                                   f_fit, kd[k], fp_fit, alpha=1.0)
    m_i, V_i = estep_update_V_inv(r64, a[:, k], m_fit[k], f_fit,
                                  res.k_tilde_inv_diag.to(f64)[k], fp_fit)
    err_d = max(_rel_norm(torch, m_d, m_ref), _rel_norm(torch, V_d, V_ref))
    err_v = max(_rel_norm(torch, m_i, m_ref), _rel_norm(torch, V_i, V_ref))
    print(f"(c) alpha 1 on phase 4's final state ({int(k.sum())} kept "
          f"coordinates) against estep_update, ||d|| / ||estep_update||: "
          f"estep_update_damped {err_d:.3e}, estep_update_V_inv {err_v:.3e}")
    checks["(c) the damped form within 1e-8"] = err_d <= DAMPED_RTOL
    checks["(c) the explicit inverse within 1e-6"] = err_v <= V_INV_RTOL
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"phase 14 check failed: {what}")


def _shape_key(text):
    """(batch, m, n, k) from the bench's "BxMxN kK" launch keys."""
    dims, k = text.split(" k")
    return tuple(int(v) for v in dims.split("x")) + (int(k),)


def phase15_bench(torch, np, device, smi, totals, check_kernel, checked,
                  **shape):
    """bench.py's headline through the port's bench at full shape and
    depth, once (the process is warm), with both quality gates (see the
    module docstring).  ``shape`` overrides ``run_bench``'s (a rehearsal on
    the CPU).  Adds the timed fit's and the gates' launches to ``totals``
    and holds the kernel against its plain version (``check_kernel``) at
    every 2-D shape the bench launched that no earlier phase held
    (``checked``)."""
    from gaussian_processes_tpu_torch import bench
    from gaussian_processes_tpu_torch.ops import gram_cuda

    t0 = time.perf_counter()
    seen = {}
    with operands_by_shape(gram_cuda, seen, "bench"):
        rec, ok = bench.run_bench(repeats=1, warmup=False, device=device,
                                  **shape)
    print(json.dumps(rec))
    q, prof = rec["quality"], rec["profile"]
    print(f"bench fit: {rec['value']} s against {bench.BASELINE_SECONDS} s; "
          f"final loss {q['easy_final_loss']} (golden "
          f"{bench.GOLDEN['easy_ungated_loss']} + "
          f"{bench.GOLDEN['easy_loss_budget']}); easy r2 "
          f"{q.get('easy_r2_saturated')}; hard r2 {q.get('hard_r2')} +/- "
          f"{q.get('hard_r2_sigma')} (min {bench.GOLDEN['hard_r2_min']}, "
          f"rung {q.get('hard_config')}), hard fit {q.get('hard_fit_s')} s"
          f"  [{smi}]")
    print(f"  kernel check (max rel err): {q.get('kernel_max_rel_err')}")
    print(f"  objective evaluations {prof['evaluations']}; kept rank per "
          f"iteration {prof['kept_rank']}")
    print("  fit spans (host s, calls): " + ", ".join(
        f"{k} {v[0]:.3f} ({v[1]})" for k, v in prof["spans_s"].items()))
    print(f"  Gram launches, the 30-iteration fit: {prof['launches']}; by "
          f"shape {prof['launches_by_shape']}; the gates' (both r2 "
          f"evaluations and the hard fit): {prof['gate_launches']}")
    fit_counts = prof["launches"]
    print(f"  the timed fit's backward launches: acos_gram_bwd "
          f"{fit_counts['bwd']}, tf32_split_t {fit_counts['split_t']}, "
          f"nt_product {fit_counts['product']}; plain backward calls on "
          f"CUDA tensors {fit_counts['plain_bwd_cuda']} (the gates': "
          f"{prof['gate_launches']['plain_bwd_cuda']})")
    for counts in (dict(prof["launches"], shapes=prof["launches_by_shape"]),
                   prof["gate_launches"]):
        add_counts(totals, dict(counts, shapes={
            _shape_key(k): c for k, c in counts["shapes"].items()}))
    errors = q.get("kernel_max_rel_err", {})
    checks = {
        "kernel within 1e-5 of its plain version at the bench's operands":
            len(errors) == 7 and max(errors.values()) <= KERNEL_RTOL,
        "the fit launched the kernel": prof["launches"]["gram"] > 0,
        "the hard fit launched the kernel":
            prof["gate_launches"]["gram"] > 0,
        "the fit launched the backward kernels": min(
            fit_counts[key] for key in ("bwd", "split_t", "product")) > 0,
        "the plain backward called on CUDA tensors 0 times":
            fit_counts["plain_bwd_cuda"] == 0
            and prof["gate_launches"]["plain_bwd_cuda"] == 0,
        "the fit neither failed nor went non-finite":
            math.isfinite(rec["value"]),
        "the easy gate passed": q["easy_gate_ok"],
        "the hard gate passed": q.get("hard_gate_ok", False),
    }
    new = sorted(shape for shape in seen if shape not in checked)
    print(f"the bench launched the 2-D Gram at {len(seen)} shapes, "
          f"{len(new)} of them new: {new}")
    for key in new:
        _, ops = seen.pop(key)
        kind = ("K_tilde" if key[0] == key[1]
                and torch.equal(ops[2], ops[3]) else "K")
        check_kernel(f"{kind} (bench)", ops)
    seen.clear()
    # the timed fit's searches and its first M-step state, from an untimed
    # fit of the same
    first = []
    with first_mstep_call(first):
        searches = bench_fit_searches(torch, device, **shape)
    fit_ms = fparam_fit_ms(torch, smi, "the bench fit", searches)
    del searches
    split = mstep_split(torch, smi, first[0])
    del first
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    for what, passed in checks.items():
        if not passed:
            raise RuntimeError(f"phase 15 check failed: {what} "
                               f"({rec.get('note')})")
    if not ok:
        raise RuntimeError(f"phase 15: {rec.get('note')}")
    return fit_ms, split


def drive_modules(torch, device, smi, totals, check_kernel, checked, plan,
                  phase):
    """Each ``(name, module, kwargs)`` of ``plan``: ``module.run(device=,
    **kwargs)`` in process with the kernel launches counted from 0 and added
    to ``totals``; the record printed with its seconds; then the kernel
    against its plain version (``check_kernel``) at every 2-D shape it
    launched that no earlier phase held (``checked``), and the batched
    kernel (as in phase 7) on its first two batched Grams.  Raises when a
    module's own check fails.  Returns the records and seconds by name."""
    from gaussian_processes_tpu_torch.ops import gram_cuda

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    records, seconds = {}, {}
    for name, module, kw in plan:
        seen, batched = {}, []
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        with operands_by_shape(gram_cuda, seen, name), \
                first_batched_operands(gram_cuda, batched):
            rec, values = module.run(device=device, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        del values
        counts = read_counts()
        add_counts(totals, counts)
        records[name] = rec
        print(json.dumps(rec))
        print(f"{name}: {seconds[name]:.1f} s; Gram launches 2-D "
              f"{counts['gram']}, batched {counts['batched']}, split pass "
              f"{counts['split']}; by (batch, m, n, k) "
              f"{dict(counts['shapes'])}  [{smi}]")
        if not rec.get("ok"):
            raise RuntimeError(f"phase {phase}: {name}'s own check failed")
        new = sorted(shape for shape in seen if shape not in checked)
        print(f"  {name} launched the 2-D Gram at {len(seen)} shapes, "
              f"{len(new)} of them new: {new}")
        for key in new:
            _, ops = seen.pop(key)
            kind = ("K_tilde" if key[0] == key[1]
                    and torch.equal(ops[2], ops[3]) else "K")
            check_kernel(f"{kind} ({name})", ops)
        for ops in batched:
            kind = ("K_tilde" if ops[0].shape[1] == ops[1].shape[1]
                    and torch.equal(ops[2], ops[3]) else "K")
            check_batched(torch, gram_cuda, sms, smi, f"{kind} ({name})",
                          ops)
        seen.clear()
        batched.clear()
        torch.cuda.empty_cache()
    return records, seconds


def phase16_benchmarks(torch, np, device, smi, totals, check_kernel,
                       checked, large_rec):
    """The port's ``benchmarks/`` secondaries and parity module in process
    (see the module docstring and ``drive_modules``); ``large_rec`` is
    phase 9's ``large_ntilde`` record."""
    from gaussian_processes_tpu_torch.benchmarks import (
        acquisition, active_pipelined, active_refit, parity_production,
        population)

    t0 = time.perf_counter()
    plan = [("acquisition", acquisition, {}),
            ("active_refit", active_refit, {"reps": REFIT_REPS}),
            ("active_pipelined", active_pipelined, {"n_add": PIPE_N_ADD}),
            ("population", population, {"cells": [POP_CELLS]}),
            ("parity_production", parity_production, {})]
    records, _ = drive_modules(torch, device, smi, totals, check_kernel,
                               checked, plan, 16)
    large = large_rec["rows"][0]
    parity = records["parity_production"]
    print("parity arms against float64 (rel_mu, rel_var): " + ", ".join(
        f"{arm} {a['rel_mu']:.3e} {a['rel_var']:.3e}"
        for arm, a in parity["arms"].items())
        + f"; n_keep {parity['detail']['n_keep']}  [{smi}]")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    checks = {
        "the large path ran at n = 50,000":
            large["n"] == LARGE_N and "error" not in large,
        "the parity module's kernel arm within 1e-5":
            parity["arms"]["kernel"]["pass"],
    }
    for what, passed in checks.items():
        if not passed:
            raise RuntimeError(f"phase 16 check failed: {what}")
    return records


def phase17_quality(torch, np, device, smi, totals, check_kernel, checked):
    """The port's three quality benchmarks in process (see the module
    docstring and ``drive_modules``), with the A/B's picks and its
    one-seed summary held."""
    from gaussian_processes_tpu_torch.benchmarks import (
        ab_active_vs_random_hard, bad_init, hard_quality)

    t0 = time.perf_counter()
    plan = [("hard_quality", hard_quality,
             dict(seed=0, names=QUALITY_RUNGS, maxiter=QUALITY_MAXITER,
                  warm=False, oracle=True)),
            ("bad_init", bad_init, dict(maxiter=BAD_INIT_MAXITER)),
            ("ab_active_vs_random_hard", ab_active_vs_random_hard,
             dict(seeds=(0,), n_add=AB_N_ADD))]
    records, seconds = drive_modules(torch, device, smi, totals,
                                     check_kernel, checked, plan, 17)
    ladder = records["hard_quality"]
    print(f"(a) hard data seed 0, {QUALITY_MAXITER} EM iterations: oracle "
          f"r2 {ladder['oracle_r2']:.4f} +/- {ladder['oracle_r2_sigma']:.4f};"
          + "; ".join(f" {r['name']} r2 {r['r2']:.4f} +/- "
                      f"{r['r2_sigma']:.4f}, loss {r['final_loss']:.2f}, "
                      f"{r['wallclock_s']:.3f} s" for r in ladder["ladder"])
          + f"  [{smi}]")
    bad = records["bad_init"]
    print(f"(b) bad init, {bad['maxiter']} EM iterations: {bad['value']:.3f} "
          f"s against {bad['good_init_s']:.3f} s; loss "
          f"{bad['final_loss_bad_init']:.2f} against "
          f"{bad['final_loss_good_init']:.2f}; eps {bad['eps_bad_init']} "
          f"(planted {bad['planted_center']}), crop margin "
          f"{bad['crop_margin_bad_init']}; fallbacks that fired: "
          f"{bad['fallbacks']}; the good arm's: {bad['good_init_fallbacks']}"
          f"  [{smi}]")
    ab = records["ab_active_vs_random_hard"]
    checks = {}
    for arm in ab["arms"]:
        picks, start = arm["picks"], set(arm["start_idx"])
        print(f"(c) seed {arm['seed']} {arm['arm']}: picks {picks}, r2 per "
              f"round {arm['r2_history']}, {arm['wallclock_s']:.3f} s  "
              f"[{smi}]")
        checks[f"(c) {arm['arm']}: {AB_N_ADD} distinct picks outside the "
               f"start set"] = (len(set(picks)) == len(picks) == AB_N_ADD
                                and not set(picks) & start)
        checks[f"(c) {arm['arm']}: r2 finite every round"] = (
            len(arm["r2_history"]) == AB_N_ADD + 1
            and all(v is not None for v in arm["r2_history"]))
    print(f"(c) summary: gap at the last round "
          f"{ab['r2_gap_mean_final']} (SEM {ab['r2_gap_sem_final']})")
    checks["(c) the one-seed summary's SEM is null and the record strict "
           "JSON"] = (ab["r2_gap_sem_final"] is None and all(
               v is None for v in ab["r2_gap_sem_at_round"].values())
               and bool(json.dumps(ab, allow_nan=False)))
    print("phase 17 seconds by module: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; phase 17: {time.perf_counter() - t0:.1f} s")
    for what, passed in checks.items():
        if not passed:
            raise RuntimeError(f"phase 17 check failed: {what}")
    return records


def main():
    if not (HERE / "gaussian_processes_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: gaussian_processes_tpu_torch/ not "
                         "found beside this script; run it from a checkout")
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")

    from gaussian_processes_tpu_torch import bench
    from gaussian_processes_tpu_torch.config import FitConfig, use_full_fp32
    from gaussian_processes_tpu_torch.models.acquisition import (
        score_candidates)
    from gaussian_processes_tpu_torch.models.active import (
        active_loop, active_loop_pipelined)
    from gaussian_processes_tpu_torch.models.fit import fit
    from gaussian_processes_tpu_torch.models.inference import evaluate
    from gaussian_processes_tpu_torch.ops import fparam_search, gram_cuda
    from gaussian_processes_tpu_torch.ops.kernels import (
        crop_window_for_theta, crop_window_from_scalars, gram_matrices,
        gram_matrices_windowed)
    from gaussian_processes_tpu_torch.utils.tracing import (
        collect_spans, objective_counts)

    # ---- 1. set-up -------------------------------------------------------
    t_start = time.perf_counter()

    current = {"phase": "1"}

    def stamp(phase):
        current["phase"] = phase
        print(f"-- phase {phase} at {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f" (CUDA {torch.version.cuda})")
    use_full_fp32()
    # one nvcc for each source, started together
    with ThreadPoolExecutor(2) as pool:
        lib, fp_lib = pool.map(lambda m: m.load_library(),
                               (gram_cuda, fparam_search))
    print(f"kernel build: acos_gram.cu {gram_cuda.build_seconds:.2f} s, "
          f"fparam_lbfgs.cu {fparam_search.build_seconds:.2f} s (in "
          f"parallel); Gram block dynamic shared memory "
          f"{lib.acos_gram_smem_bytes()} B; f-param search block "
          f"{fparam_search.THREADS} threads (carrying a reduction tree of "
          f"1024), dynamic shared memory at nt "
          f"{NT} {fp_lib.fparam_lbfgs_smem_bytes(NT, 0, 4)} B (float32), "
          f"{fp_lib.fparam_lbfgs_smem_bytes(NT, 0, 8)} B (float64)")
    for mod in (gram_cuda, fparam_search):
        for line in mod.build_log.splitlines():
            if any(key in line for key in PTXAS_KEYS):
                print("  ptxas:", line.strip())
    # the f-param kernel keeps its state in registers: no stack, no spill
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads",
                        fparam_search.build_log)
    if any(int(n) for frame in frames for n in frame):
        raise RuntimeError(f"fparam_lbfgs.cu spills or keeps a stack frame: "
                           f"{frames}")

    X, R = bench.make_data()
    Xt, Rt = bench.make_test_data()
    x = torch.as_tensor(X, device=device)
    r = torch.as_tensor(R, device=device)
    idx = np.random.default_rng(0).permutation(NT)[:NTILDE]
    xtilde = x[torch.as_tensor(idx, device=device)]
    theta = {k: torch.tensor(v, dtype=torch.float32, device=device)
             for k, v in THETA0.items()}

    # ---- 2. kernels vs plain at the main path's operands ----------------
    stamp("2")
    xt_test = torch.as_tensor(Xt, device=device)

    crop = crop_window_from_scalars(THETA0["-2log2beta"], THETA0["eps_0x"],
                                    THETA0["eps_0y"], N_PX)

    def main_path_operands(where: str):
        """K_tilde and K at the crop window of the start theta ("crop") or
        on the full grid ("full"), or K* of the prediction that evaluate
        makes (inference.py:37) at the start theta ("predict"; its K_tilde
        is the full grid's)."""
        if where == "crop":
            calls = gram_cuda.recorded_operands(lambda: gram_matrices_windowed(
                theta, x, xtilde, N_PX, False, *crop))
        else:
            calls = gram_cuda.recorded_operands(lambda: gram_matrices(
                theta, xt_test if where == "predict" else x, xtilde, N_PX,
                shared=False))
        if where == "predict":
            return [("K*", calls[1])]
        return list(zip(("K_tilde", "K"), calls))

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    results = {}
    checked = set()
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
            lib_ms = cuda_ms(torch, lambda: torch.matmul(ops[0], ops[1].T))
        bound_ms, bound_by = gram_bound(1, m, n, k)
        finite = bool(torch.all(torch.isfinite(K_kernel)))
        print(f"kernel {name} {m}x{n} k={k}: max|dK|/max|K| = {rel:.3e} "
              f"(max|dK| {max_abs:.3e}), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, cuBLAS FP32 product alone "
              f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})  "
              f"[{smi}]")
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
        checked.add((m, n, k))
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

    # the backward kernels at the M-step's operands: the start theta's
    # 80-px crop window (k 6400) and a 96-px one about it (k 9216)
    w96 = 96
    crop96 = tuple(min(max(c - (w96 - crop[2]) // 2, 0), N_PX - w96)
                   for c in crop[:2]) + (w96,)
    bwd = {}
    for win_ in (crop, crop96):
        calls = gram_cuda.recorded_operands(lambda: gram_matrices_windowed(
            theta, x, xtilde, N_PX, False, *win_))
        for name, ops in zip(("K_tilde", "K"), calls):
            bwd[(name, ops[0].shape[1])] = check_backward(torch, smi, name,
                                                          ops)
        del calls

    # ---- 3. small fit through the kernel vs float64 on the CPU -----------
    stamp("3")
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
    stamp("4")
    # from here on, the backward's operands at shapes no check has held
    bwd_seen = {}
    watch = contextlib.ExitStack()
    watch.enter_context(backward_operands(gram_cuda, bwd_seen, current))
    cfg = FitConfig(ntilde=NTILDE, maxiter=3, n_estep=10, n_mstep=10,
                    n_fparamstep=10, n_px_side=N_PX, track_variational=False)
    totals = {}
    fp_main = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with objective_counts() as evals_full, \
            collect_spans() as spans_full, fparam_operands(fp_main):
        res = fit(x, r, cfg, xtilde=xtilde, theta=THETA0, f_params=F_PARAMS0,
                  profile=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_fit = gram_cuda.launches
    fparam_launches_fit = fparam_search.launches
    _, rates, r2, sigma_r2 = evaluate(
        res, torch.as_tensor(Xt, device=device),
        torch.as_tensor(Rt, device=device), nbootstrap=200)
    r2, sigma_r2 = float(r2), float(sigma_r2)
    torch.cuda.synchronize()
    launches_main = gram_cuda.launches
    split_launches_main = gram_cuda.split_launches
    counts_main = read_counts()
    add_counts(totals, counts_main)

    loss = res.track.logmarginal.double().cpu().numpy()
    print(f"fit init {res.timing['init']:.3f} s; per-iteration s "
          f"{[round(t, 3) for t in res.timing['per_iteration']]}; total "
          f"{fit_s:.3f} s; objective evaluations {evals_full}  [{smi}]")
    print(f"fit spans (host s, utils.tracing.collect_spans): "
          f"{span_line(spans_full)}")
    print(f"logmarginal per iteration: {loss.tolist()}")
    print(f"final theta: { {k: float(v) for k, v in res.theta.items()} }")
    print(f"r2 = {r2:.4f} +/- {sigma_r2:.4f}; rates finite: "
          f"{bool(torch.all(torch.isfinite(rates)))}, shape "
          f"{tuple(rates.shape)}")
    print(f"acos_gram launches: fit {launches_fit}, fit + evaluate "
          f"{launches_main}; split-pass launches {split_launches_main}; "
          f"fparam_lbfgs launches {fparam_launches_fit} (one a search); "
          f"the backward's: acos_gram_bwd {counts_main['bwd']}, "
          f"tf32_split_t {counts_main['split_t']}, nt_product "
          f"{counts_main['product']}; plain backward on the card "
          f"{counts_main['plain_bwd_cuda']}")

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
        "f-param search kernel launched once a search":
            fparam_launches_fit == len(fp_main) > 0,
        "the Gram's backward kernels launched on the main path": min(
            counts_main[key] for key in ("bwd", "split_t", "product")) > 0,
        "the plain backward called on CUDA tensors 0 times":
            counts_main["plain_bwd_cuda"] == 0,
        "log-marginal within 1e-3 of the plain-Gram fit":
            len(loss) == len(loss_plain) and plain_err <= REFERENCE_RTOL,
    }
    for what, ok in checks.items():
        if not ok:
            raise RuntimeError(f"main path check failed: {what}")

    # ---- 5. the kernel at the active loop's shapes -----------------------
    stamp("5")
    x_cap = torch.zeros((CAPACITY, N_PX * N_PX), device=device)
    x_cap[:N_START] = x[:N_START]
    loop_operands = [
        ("K_tilde cap", gram_cuda.recorded_operands(lambda: gram_matrices_windowed(
            theta, x_cap, x_cap, N_PX, True, *crop))[0]),
        ("K* pool", gram_cuda.recorded_operands(lambda: gram_matrices_windowed(
            theta, x, x_cap, N_PX, False, *crop))[1]),
        ("K* pool", gram_cuda.recorded_operands(lambda: gram_matrices(
            theta, x, x_cap, N_PX, shared=False))[1]),
        ("K* test", gram_cuda.recorded_operands(lambda: gram_matrices(
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
    stamp("6")
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
    fp_loop = []
    for arm, (loop, select, extra) in arms.items():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with fparam_operands(fp_loop if arm == "a" else []):
            o = loop(x, r, select=select, **loop_kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_loop[arm] = gram_cuda.launches
        split_launches_loop[arm] = gram_cuda.split_launches
        add_counts(totals, read_counts())
        out[arm] = o
        print(f"loop ({arm}) {loop.__name__}, {select}: {wall:.3f} s, "
              f"{wall / (N_ADD + 1):.3f} s per round over {N_ADD + 1} refits"
              f"  [{smi}]")
        print(f"  picks {o.selected_idx}; utilities {o.utilities}")
        print(f"  final log-marginal "
              f"{float(o.final_fit.track.logmarginal[-1]):.4f}, logA "
              f"{float(o.final_fit.f_params['logA']):.4f}; acos_gram "
              f"launches {launches_loop[arm]}, split-pass launches "
              f"{split_launches_loop[arm]}, fparam_lbfgs launches "
              f"{fparam_search.launches}")
        picks = o.selected_idx
        checks = {
            f"{N_ADD} distinct picks": (len(picks) == N_ADD
                                        and len(set(picks)) == N_ADD),
            "no pick in the start set": not set(picks) & set(start.tolist()),
            "final fit not failed": not o.final_fit.failed,
            "kernel launched": launches_loop[arm] > 0,
            "f-param search kernel launched": fparam_search.launches > 0,
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

    # ---- 6b. the f-param search kernel against its plain version ---------
    stamp("6b")
    fp_found = []
    for name, ops in (("phase 4 first E-step", fp_main[0]),
                      ("phase 4 last E-step", fp_main[-1]),
                      ("loop (a) first refit", fp_loop[0]),
                      ("seeded nt 32", seeded_fparam_operands(
                          torch, device, 32, fp_main[-1][5]))):
        check_fparam(torch, smi, name, ops, fp_found)
    fp_fit_ms = {"phase 4": fparam_fit_ms(torch, smi, "phase 4's fit",
                                          fp_main)}
    del fp_main, fp_loop

    # ---- 7-8. the batched kernel and the population ----------------------
    stamp("7-8")
    batched, bwd_batched = phase8_population(torch, np, device, smi, totals)
    # ---- 9. the large-ntilde path ------------------------------------------
    stamp("9")
    block_ops, large_rec = phase9_large(torch, np, device, smi, totals)
    # ---- 10. the entry points ----------------------------------------------
    stamp("10")
    block_abs, reduced = phase10_entry_points(
        torch, np, device, smi, totals, x, r, xtilde, Xt, Rt, cfg, res,
        (evals_full, spans_full), block_ops, check_kernel, checked)
    del block_ops
    # ---- 11. the other line searches and the gates -------------------------
    stamp("11")
    batched.update({f"ladder {name}": v for name, v in phase11_linesearches(
        torch, np, device, smi, totals, x, r, xtilde, cfg, res,
        evals_full).items()})
    # ---- 12. JAX's default solvers and the projected Gram ------------------
    stamp("12")
    phase12_warm_solvers(torch, np, device, smi, totals, x, r, xtilde,
                         reduced, check_kernel)
    del reduced
    # ---- 13. the mesh at world 1 ----------------------------------------------
    stamp("13")
    phase13_mesh(torch, np, device, smi, totals, x, r, xtilde, cfg, res,
                 fit_s)
    # ---- 14. the functions no fit calls, at bench shape -------------------
    stamp("14")
    phase14_unfitted(torch, np, device, smi, totals, x, r, xtilde, cfg, res)
    # ---- 15. the port's bench at full depth, and its gates ---------------
    stamp("15")
    fp_fit_ms["phase 15"], mstep = phase15_bench(torch, np, device, smi,
                                                 totals, check_kernel, checked)
    # ---- 16. the bench's secondaries and the parity script ---------------
    stamp("16")
    phase16_benchmarks(torch, np, device, smi, totals, check_kernel, checked,
                       large_rec)
    # ---- 17. the quality benchmarks: gate ladder, bad init, A/B ---------
    stamp("17")
    phase17_quality(torch, np, device, smi, totals, check_kernel, checked)

    # ---- the backward kernels at the shapes the main paths handed them ---
    stamp("backward shapes")
    watch.close()
    bwd_more = {}
    for key, (phase, ops) in sorted(bwd_seen.items(), key=str):
        name = "K_tilde" if key[1] == key[2] else "K"
        bwd_more[key] = check_backward(
            torch, smi, f"{name} (phase {phase})",
            [t.to(device) for t in ops], reps=3)
    del bwd_seen
    print(f"backward kernels held at {len(bwd_more)} more (batch, m, n, k) "
          f"that the main paths launched: {sorted(bwd_more, key=str)}")

    stamp("end")
    shapes = totals.pop("shapes", {})
    print(f"launches over the main paths (phases 4, 6, 8, 9, 10, 11, 12, "
          f"13, 14, 15, 16, 17): {totals}")
    print("f-param search kernel against its plain version (phase 6b): "
          + json.dumps(fp_found))
    print("Gram launches on the main paths by (batch, m, n, k): "
          + ", ".join(f"{shape}: {c}" for shape, c in sorted(
              shapes.items(), key=lambda kv: -kv[1])))
    for key, what in (("gram", "2-D Gram"), ("batched", "batched Gram"),
                      ("split", "split pass"), ("fparam", "f-param search"),
                      ("bwd", "backward epilogue"),
                      ("split_t", "transposing split"),
                      ("product", "product")):
        if totals.get(key, 0) <= 0:
            raise RuntimeError(f"the {what} kernel was not launched on the "
                               f"main paths")
    if totals.get("plain_bwd_cuda", 0) != 0:
        raise RuntimeError("the plain backward ran on CUDA tensors on the "
                           "main paths")
    for key in ("bwd_shapes", "split_t_shapes", "product_shapes"):
        print(f"{key} on the main paths: " + ", ".join(
            f"{shape}: {c}" for shape, c in sorted(
                totals.pop(key, {}).items(), key=lambda kv: -kv[1])[:12]))
    max_abs, ms, plain_ms = results[("K", 6400)]
    _, b_ms, b_plain_ms, _, b_bound, b_by, _ = batched["K"]
    source = "gaussian_processes_tpu_torch/csrc/acos_gram.cu"
    replaces = "gaussian_processes_tpu/ops/gram_pallas.py:80"
    gram_ms, gram_by = gram_bound(1, NT, NTILDE, 6400)
    sp_ms, sp_by = split_bound(NT, 6400)
    # the main path's search: phase 4's last E-step, float32, 15 trials
    fp_main_case = next(c for c in fp_found if c["name"] == "phase 4 last "
                        "E-step" and c["dtype"] == "float32"
                        and c["trials"] == 15)
    print(f"M-step evaluation split (phase 15, ms an evaluation): "
          + json.dumps({route: {k: v for k, v in d.items() if k != "grad"}
                        for route, d in mstep.items()}))
    print(json.dumps({"kernels": [{
        "name": "acos_gram",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": totals["gram"],
        "max_abs_err": max([v[0] for v in results.values()] + [block_abs]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": gram_ms,
        "bound_by": gram_by,
        "library_ms": None,
    }, {
        "name": "acos_gram_batched",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": totals["batched"],
        "max_abs_err": max(v[0] for v in batched.values()),
        "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": b_bound,
        "bound_by": b_by,
        "library_ms": None,
        "shapes": {f"{b} x {m}x{n}, k {k}": c
                   for (b, m, n, k), c in sorted(shapes.items()) if b > 1},
    }, {
        "name": "tf32_split",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": totals["split"],
        "max_abs_err": split["err"],
        "ms": split_ms,
        "plain_ms": split_plain_ms,
        "bound_ms": sp_ms,
        "bound_by": sp_by,
        "library_ms": None,
    }, {
        "name": "fparam_lbfgs",
        "route": "cuda",
        "source": "gaussian_processes_tpu_torch/csrc/fparam_lbfgs.cu",
        "replaces": "gaussian_processes_tpu/models/fit.py:331",
        "launches": totals["fparam"],
        "max_abs_err": max(c["dlogA"] for c in fp_found),
        "ms": fp_main_case["ms"],
        "plain_ms": fp_main_case["plain_ms"],
        "bound_ms": fp_main_case["bound_ms"],
        "bound_by": fp_main_case["bound_by"],
        "library_ms": None,
        "us_per_evaluation": fp_main_case["us_per_eval"],
        "device_ms": fp_main_case["device_ms"],
        "fit_device_ms": fp_fit_ms,
    }] + [{
        "name": kname,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": totals[key],
        "max_abs_err": max(r[kname][0] for r in list(bwd.values())
                           + list(bwd_batched.values())
                           + list(bwd_more.values())),
        "ms": bwd[("K", 6400)][kname][1],
        "plain_ms": bwd[("K", 6400)][kname][2],
        "bound_ms": bwd[("K", 6400)][kname][4],
        "bound_by": bwd[("K", 6400)][kname][5],
        "library_ms": bwd[("K", 6400)][kname][3],
        "at": bwd[("K", 6400)][kname][6],
        **bwd[("K", 6400)][kname][7],
    } for kname, key in (("acos_gram_bwd", "bwd"),
                         ("tf32_split_t", "split_t"),
                         ("nt_product", "product"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
