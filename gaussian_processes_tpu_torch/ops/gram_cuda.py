"""The fused arc-cosine Gram kernel: wrapper, plain version and gradient
(counterpart of ``gaussian_processes_tpu/ops/gram_pallas.py``).

``acos_gram(u1, s2, q11, q22, sigma0)`` returns

    K = X1X2 * J(clip((u1 @ s2.T + s0^2) / (X1X2 + 1e-7), -1, 1))

with X1 = sqrt(q11 + s0^2), X2 = sqrt(q22 + s0^2) and
J(c) = (sqrt(1 - c^2) + (pi - acos c) c) / pi.  On a CUDA tensor the forward
is the hand-written kernel in ``csrc/acos_gram.cu`` (float32 only); on a CPU
tensor it is ``acos_gram_torch``, the plain PyTorch version of the same
function.  There is no fallback from one to the other: a CUDA tensor the
kernel cannot take raises.

The gradient is ``AcosGram.backward``: plain PyTorch on either device.  It
recomputes ``q12 = u1 @ s2.T``, forms dK/dc with the analytic
dJ/dc = (pi - acos c) / pi (autodiff of J gives inf - inf at |c| = 1), and
passes half the gradient where the clip is exactly at a bound, as
``jnp.clip`` and ``torch.maximum`` do.

The kernel is built at first use with ``nvcc`` into ``build/kernels/`` at
the repository root, keyed by a hash of the source, and loaded with
``ctypes``.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from ..config import COSDELTA_JITTER

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "acos_gram.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Kernel launches since import (or since the caller last reset it).
launches = 0
# Seconds the last build took (None until this process built or loaded it),
# and the compiler's register/spill report of that build.
build_seconds: Optional[float] = None
build_log: str = ""
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the acos_gram kernel is built "
                           "with the CUDA toolkit at first use")
    return found


def load_library():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle.  The output name carries a hash of the source and flags, so an
    edited source rebuilds, and the build is written to a temporary name
    and renamed, so concurrent processes never load a half-written file."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"libacos_gram_{key}.so"
    t0 = time.perf_counter()
    if not so_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {_SRC}:\n{proc.stderr}")
            build_log = proc.stderr
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so_path))
    lib.acos_gram_f32.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.acos_gram_f32.restype = ctypes.c_int
    lib.acos_gram_error_string.argtypes = [ctypes.c_int]
    lib.acos_gram_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def acos_gram_torch(u1: torch.Tensor, s2: torch.Tensor, q11: torch.Tensor,
                    q22: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``u1 @ s2.T`` and the same
    epilogue.  The forward reference for the kernel, and the forward of
    ``AcosGram`` on CPU tensors (not differentiated itself)."""
    s02 = sigma0 * sigma0
    X1X2 = torch.sqrt(q11 + s02)[:, None] * torch.sqrt(q22 + s02)[None, :]
    c = torch.clamp((u1 @ s2.T + s02) / (X1X2 + COSDELTA_JITTER), -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    return X1X2 * ((s + (math.pi - torch.acos(c)) * c) / math.pi)


def _check(u1, s2, q11, q22, sigma0):
    tensors = (u1, s2, q11, q22, sigma0)
    dev = u1.device
    for t in tensors:
        if t.device != dev:
            raise ValueError("acos_gram: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"acos_gram kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("acos_gram kernel takes contiguous tensors")
    if u1.dim() != 2 or s2.dim() != 2 or u1.shape[1] != s2.shape[1]:
        raise ValueError(f"acos_gram: u1 {tuple(u1.shape)} and s2 "
                         f"{tuple(s2.shape)} must be (m, k) and (n, k)")
    m, k = u1.shape
    n = s2.shape[0]
    if q11.shape != (m,) or q22.shape != (n,) or sigma0.numel() != 1:
        raise ValueError("acos_gram: q11 must be (m,), q22 (n,), sigma0 one "
                         "element")
    if min(m, n, k) < 1 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"acos_gram: unsupported sizes m={m} n={n} k={k}")
    return m, n, k


def _launch(u1, s2, q11, q22, sigma0) -> torch.Tensor:
    global launches
    m, n, k = _check(u1, s2, q11, q22, sigma0)
    lib = load_library()
    out = torch.empty((m, n), dtype=torch.float32, device=u1.device)
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream(u1.device).cuda_stream
        rc = lib.acos_gram_f32(u1.data_ptr(), s2.data_ptr(), q11.data_ptr(),
                               q22.data_ptr(), sigma0.data_ptr(),
                               out.data_ptr(), m, n, k, stream)
    if rc != 0:
        msg = lib.acos_gram_error_string(rc).decode()
        raise RuntimeError(f"acos_gram kernel launch failed: {msg} ({rc})")
    launches += 1
    return out


class AcosGram(torch.autograd.Function):
    """Differentiable fused Gram: kernel forward on CUDA, plain forward on
    CPU, hand-written plain-PyTorch backward on both."""

    @staticmethod
    def forward(ctx, u1, s2, q11, q22, sigma0):
        ctx.save_for_backward(u1, s2, q11, q22, sigma0)
        if u1.is_cuda:
            return _launch(u1.contiguous(), s2.contiguous(), q11.contiguous(),
                           q22.contiguous(), sigma0.reshape(1).contiguous())
        return acos_gram_torch(u1, s2, q11, q22, sigma0)

    @staticmethod
    def backward(ctx, g):
        u1, s2, q11, q22, sigma0 = ctx.saved_tensors
        s02 = sigma0 * sigma0
        X1 = torch.sqrt(q11 + s02)
        X2 = torch.sqrt(q22 + s02)
        P = X1[:, None] * X2[None, :]
        num = u1 @ s2.T + s02
        den = P + COSDELTA_JITTER
        ratio = num / den
        a = torch.abs(ratio)
        # d clip / d ratio: 1 inside, 1/2 exactly on a bound, 0 beyond
        dclip = torch.where(a < 1.0, 1.0, torch.where(a == 1.0, 0.5, 0.0))
        c = torch.clamp(ratio, -1.0, 1.0)
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
        pi_minus_acos = math.pi - torch.acos(c)
        J = (s + pi_minus_acos * c) / math.pi
        g_ratio = g * P * (pi_minus_acos / math.pi) * dclip
        g_num = g_ratio / den                        # = dL/dq12
        g_P = g * J - g_ratio * ratio / den
        g_a = (g_P * X2[None, :]).sum(1) / (2.0 * X1)    # dL/dq11
        g_b = (g_P * X1[:, None]).sum(0) / (2.0 * X2)    # dL/dq22
        du1 = ds2 = dsig = None
        if ctx.needs_input_grad[0]:
            du1 = g_num @ s2
        if ctx.needs_input_grad[1]:
            ds2 = g_num.T @ u1
        if ctx.needs_input_grad[4]:
            g_s02 = g_a.sum() + g_b.sum() + g_num.sum()
            dsig = (g_s02 * 2.0 * sigma0).reshape(sigma0.shape)
        return du1, ds2, g_a, g_b, dsig


def acos_gram(u1: torch.Tensor, s2: torch.Tensor, q11: torch.Tensor,
              q22: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
    """K (m, n) for u1 (m, k), s2 (n, k), q11 (m,), q22 (n,) and a 0-d
    sigma0, differentiable in all five."""
    return AcosGram.apply(u1, s2, q11, q22, sigma0)
