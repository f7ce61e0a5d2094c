"""The E-step's f-param search: L-BFGS with optax's zoom line search on the
scalar logA, with lambda0 at its closed-form optimum (the counterpart of
the search JAX runs inside its compiled E-step,
``gaussian_processes_tpu/models/fit.py:331-337``).

``fparam_search(logA0, r, lambda_m, lambda_var, wt, num_steps,
max_linesearch_steps)`` returns ``(logA, f_best)``, the best iterate and
its value.  On a CUDA tensor it is the hand-written kernel in
``csrc/fparam_lbfgs.cu``: one launch runs the whole search on the card
(every objective evaluation a block reduction, the optimizer's state
machine in the block), with no host transfer and no synchronisation; logA
and f_best are then 0-d tensors on the card.  On a CPU tensor, or with
``backend="torch"``, it is the plain version ``fparam_search_torch``: the
port's host-driven ``optim/lbfgs.lbfgs_minimize`` on
``models/fit._fparam_objective`` through autograd.  There is no fallback
from one to the other: a CUDA tensor the kernel cannot take raises.

``fparam_value_and_grad_torch`` is the closed-form value and logA
derivative that the kernel computes at each evaluation, in plain PyTorch
(the tests hold it against autograd).

The library is built at first use (``ops/cuda_build``), compiled with
``-fmad=false`` so that the state machine's scalars round as the plain
route's do.  ``launches`` counts the kernel's launches (``reset_counts``
sets it to 0).  The kernel adds its objective evaluations to a 64-bit
counter on each device; ``evaluation_counters`` snapshots them and
``evaluations_since`` reads what was added since a snapshot, in one host
transfer (``utils/tracing.objective_counts`` does both around its block).
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Dict, Optional, Tuple

import torch

from ..optim.lbfgs import lbfgs_minimize
from . import cuda_build

_SRC = "fparam_lbfgs.cu"
NVCC_FLAGS = cuda_build.NVCC_FLAGS + ("-fmad=false",)
# the kernel's block (which carries the 1024 threads of its reduction tree)
# and its L-BFGS memory (csrc/fparam_lbfgs.cu)
THREADS = 256
MEMORY_SIZE = 15

# Launches of the kernel since import (or since the caller reset them).
launches = 0
# Seconds the last build took (None until this process built or loaded
# it), and the compiler's register/spill report of that build.
build_seconds: Optional[float] = None
build_log: str = ""
_lib = None
# the running evaluation counter of each device the kernel ran on
_counters: Dict[torch.device, torch.Tensor] = {}


def reset_counts() -> None:
    """Set the launch count to 0."""
    global launches
    launches = 0


def load_library():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = cuda_build.build(_SRC, NVCC_FLAGS)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("fparam_lbfgs_f32", "fparam_lbfgs_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 4 + [i32] + [ptr] * 4 + [i32] * 2 + [f64] * 3 + [
            ptr]
        fn.restype = i32
    lib.fparam_lbfgs_smem_bytes.argtypes = [i32] * 3
    lib.fparam_lbfgs_smem_bytes.restype = i32
    lib.fparam_lbfgs_error_string.argtypes = [i32]
    lib.fparam_lbfgs_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def evaluation_counters() -> Dict[torch.device, torch.Tensor]:
    """A copy of each device's running evaluation counter (device copies:
    no synchronisation)."""
    return {dev: c.clone() for dev, c in _counters.items()}


def evaluations_since(snapshot: Dict[torch.device, torch.Tensor]) -> int:
    """Objective evaluations the kernel ran since ``snapshot`` (from
    ``evaluation_counters``): one host transfer for each device."""
    return sum(int(c - snapshot[dev]) if dev in snapshot else int(c)
               for dev, c in _counters.items())


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def fparam_value_and_grad_torch(logA: torch.Tensor, r: torch.Tensor,
                                lambda_m: torch.Tensor,
                                lambda_var: torch.Tensor,
                                wt: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, d value / d logA) of the profiled objective
    ``models/fit._fparam_objective`` in closed form, as the kernel computes
    them: with A = exp(logA), z = A lambda_m + A^2 lambda_var / 2 and the
    sums over the rows with wt > 0,
    lambda0 = log sum(wt r) - logsumexp(z), f = exp(z + lambda0),
    value = -(A sum(wt r lambda_m) + lambda0 sum(wt r) - sum(wt f)) and,
    with g = dz/dlogA = A lambda_m + A^2 lambda_var and p = softmax(z),
    grad = sum(wt f g) - A sum(wt r lambda_m) + sum(p g) (sum(wt r) -
    sum(wt f)): the full chain through lambda0 (its derivative is
    -sum(p g)), not the envelope shortcut."""
    keep = (torch.ones_like(r, dtype=torch.bool) if wt is None
            else wt > 0)
    w = torch.ones_like(r) if wt is None else wt
    zero = torch.zeros_like(r)
    A = torch.exp(logA)
    z = A * lambda_m + 0.5 * A * A * lambda_var
    g = A * lambda_m + A * A * lambda_var
    rw = torch.where(keep, r * w, zero)
    rl = torch.sum(torch.where(keep, rw * lambda_m, zero))
    R = torch.sum(rw)
    lse = torch.logsumexp(torch.where(keep, z, float("-inf")), dim=-1)
    lam0 = torch.log(R) - lse
    wf = torch.where(keep, torch.exp(z + lam0) * w, zero)
    Sf = torch.sum(wf)
    Sfg = torch.sum(torch.where(keep, wf * g, zero))
    Spg = torch.sum(torch.where(keep, torch.exp(z - lse) * g, zero))
    value = -((A * rl + lam0 * R) - Sf)
    grad = (Sfg - A * rl) + Spg * (R - Sf)
    return value, grad


def fparam_search_torch(logA0: torch.Tensor, r: torch.Tensor,
                        lambda_m: torch.Tensor, lambda_var: torch.Tensor,
                        wt: Optional[torch.Tensor], num_steps: int,
                        max_linesearch_steps: int, gtol: float = 0.0,
                        ftol: float = 0.0, ftol_rel: float = 0.0):
    """The host-driven search: ``lbfgs_minimize`` on ``_fparam_objective``
    through autograd (one value and gradient brought to the host per
    evaluation)."""
    # looked up at call time: models.fit imports this module, and
    # utils.tracing.objective_counts counts the objective by wrapping it there
    from ..models import fit as fit_module
    return lbfgs_minimize(
        partial(fit_module._fparam_objective, r=r, lambda_m=lambda_m,
                lambda_var=lambda_var, wt=wt),
        logA0, num_steps, memory_size=MEMORY_SIZE,
        max_linesearch_steps=max_linesearch_steps, gtol=gtol, ftol=ftol,
        ftol_rel=ftol_rel)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _check(logA0, r, lambda_m, lambda_var, wt, num_steps,
           max_linesearch_steps) -> int:
    """nt of a call the kernel can take; raises on anything else."""
    tensors = [logA0, r, lambda_m, lambda_var] + ([] if wt is None else [wt])
    dev, dtype = r.device, r.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fparam_search kernel takes float32 or float64, got "
                        f"{dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("fparam_search: all inputs must be on one "
                             "device")
        if t.dtype != dtype:
            raise TypeError(f"fparam_search kernel takes one dtype, got "
                            f"{t.dtype} beside {dtype}")
        if not t.is_contiguous():
            raise ValueError("fparam_search kernel takes contiguous tensors")
    nt = r.shape[0] if r.dim() == 1 else -1
    if (logA0.numel() != 1 or nt < 1 or nt >= 2 ** 31
            or any(t.shape != (nt,) for t in tensors[2:])):
        raise ValueError(f"fparam_search: r, lambda_m, lambda_var and wt "
                         f"must be (nt,) and logA0 one value, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if num_steps < 0 or max_linesearch_steps < 0:
        raise ValueError("fparam_search: num_steps and max_linesearch_steps "
                         "must be >= 0")
    return nt


def _launch(logA0, r, lambda_m, lambda_var, wt, num_steps,
            max_linesearch_steps, gtol, ftol, ftol_rel):
    global launches
    nt = _check(logA0, r, lambda_m, lambda_var, wt, num_steps,
                max_linesearch_steps)
    lib = load_library()
    dev = r.device
    counter = _counters.get(dev)
    if counter is None:
        counter = _counters[dev] = torch.zeros((), dtype=torch.int64,
                                               device=dev)
    logA = torch.empty((), dtype=r.dtype, device=dev)
    f_best = torch.empty((), dtype=r.dtype, device=dev)
    fn = (lib.fparam_lbfgs_f32 if r.dtype == torch.float32
          else lib.fparam_lbfgs_f64)
    with torch.cuda.device(dev):
        rc = fn(r.data_ptr(), lambda_m.data_ptr(), lambda_var.data_ptr(),
                None if wt is None else wt.data_ptr(), nt, logA0.data_ptr(),
                logA.data_ptr(), f_best.data_ptr(), counter.data_ptr(),
                num_steps, max_linesearch_steps, gtol, ftol, ftol_rel,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.fparam_lbfgs_error_string(rc).decode()
        raise RuntimeError(f"fparam_lbfgs kernel launch failed: {msg} ({rc})")
    launches += 1
    return logA, f_best


def fparam_search(logA0: torch.Tensor, r: torch.Tensor,
                  lambda_m: torch.Tensor, lambda_var: torch.Tensor,
                  wt: Optional[torch.Tensor], num_steps: int,
                  max_linesearch_steps: int, backend: Optional[str] = None,
                  gtol: float = 0.0, ftol: float = 0.0, ftol_rel: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_steps`` L-BFGS steps (memory 15, optax's zoom search with
    ``max_linesearch_steps`` trials) on logA from ``logA0`` (0-d), with the
    moments ``lambda_m``, ``lambda_var`` and responses ``r`` (nt,) and the
    0/1 row weight ``wt`` (None: every row).  Returns ``(logA, f_best)``:
    the best iterate (0-d, on logA0's device) and its value.  ``backend``:
    "torch" takes the plain version, None or "cuda" the kernel on CUDA
    tensors (the plain version on CPU tensors)."""
    if backend not in (None, "cuda", "torch"):
        raise ValueError(f"backend must be 'cuda' or 'torch', got {backend!r}")
    if backend == "torch" or not r.is_cuda:
        return fparam_search_torch(logA0, r, lambda_m, lambda_var, wt,
                                   num_steps, max_linesearch_steps, gtol,
                                   ftol, ftol_rel)
    return _launch(logA0.detach().reshape(()).contiguous(),
                   r.detach().contiguous(), lambda_m.detach().contiguous(),
                   lambda_var.detach().contiguous(),
                   None if wt is None else wt.detach().contiguous(),
                   num_steps, max_linesearch_steps, gtol, ftol, ftol_rel)
