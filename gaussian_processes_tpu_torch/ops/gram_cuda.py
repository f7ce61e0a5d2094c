"""The fused arc-cosine Gram kernel: wrapper, work planner, plain versions
and gradient (counterpart of ``gaussian_processes_tpu/ops/gram_pallas.py``).

``acos_gram(u1, s2, q11, q22, sigma0)`` returns

    K = X1X2 * J(clip((u1 @ s2.T + s0^2) / (X1X2 + 1e-7), -1, 1))

for u1 (m, k), s2 (n, k), q11 (m,), q22 (n,) and one sigma0, or for each
item of a batch: u1 (B, m, k), s2 (B, n, k), q11 (B, m), q22 (B, n) and
sigma0 (B,) give K (B, m, n) in one launch (the population fit's (cell,
line-search trial) items).  ``out=`` takes a contiguous target of K's shape,
such as a row block ``K[r0:r0 + nb]`` of a row-major (n, n) buffer, and the
kernel writes straight into it (no gradient then).  Here
X1 = sqrt(q11 + s0^2), X2 = sqrt(q22 + s0^2) and
J(c) = (sqrt(1 - c^2) + (pi - acos c) c) / pi.  On a CUDA tensor the forward
is the hand-written kernel in ``csrc/acos_gram.cu`` (float32 only): a split
pass writes each operand as a TF32 "big" part and a float32 remainder
(``tf32_split``), and a TMA + wgmma kernel sums big*big + big*small +
small*big on the tensor cores (3xTF32), over the split of k that
``plan_gram`` picks, with the epilogue fused.  On a CPU tensor the forward is
``acos_gram_torch``, the plain PyTorch version of the same function.  There
is no fallback from one to the other: a CUDA tensor the kernel cannot take
raises.

The gradient is ``AcosGram.backward``, taken at the forward's own q12: when
an input requires a gradient the forward keeps the q12 it computed (the
kernel writes it beside K) and saves it.  The backward forms dq12 = dL/dq12
with the analytic dJ/dc = (pi - acos c) / pi (autodiff of J gives inf - inf
at |c| = 1), passing half the gradient where the clip is exactly at a
bound, as ``jnp.clip`` and ``torch.maximum`` do, and the row and column
sums that give dL/dq11, dL/dq22 and dL/dsigma0; then dU1 = dq12 S2 and
dS2 = dq12^T U1.  On CUDA tensors these are hand-written kernels in the
same source (``acos_gram_bwd``: one launch of the elementwise pass, which
writes dq12 only as the TF32 planes of both products' operands, dq12's and
dq12^T's, and of the sums, in a fixed order; ``tf32_split_t``: the split
pass of an operand whose contraction runs along its rows, transposed;
``nt_product``: the Gram's 3xTF32 main loop with no epilogue, its tiles in
groups of 4 tile rows; every plane in rows of ``_pitch``), and a CUDA
tensor they cannot take raises; on CPU tensors the plain version
``gram_backward_torch`` runs (the plain epilogue ``acos_gram_bwd_torch``,
then ``dq12 @ s2`` and ``dq12.mT @ u1``).

The kernels are built at first use with ``nvcc`` into ``build/kernels/`` at
the repository root, keyed by a hash of the source and flags, and loaded
with ``ctypes`` (``ops/cuda_build``).  ``launches`` counts launches of the Gram kernel (one per
``acos_gram`` call on the card, whatever helper kernels it runs),
``batched_launches`` those of them with a batch axis, ``items`` the Grams
they computed (the batch sizes summed), ``shape_launches`` the launches by
(batch, m, n, k), and ``split_launches`` launches of the split pass;
``bwd_launches``, ``split_t_launches`` and ``product_launches`` count the
backward's kernels (each with its helper kernel), by shape in
``bwd_shapes`` ("BxMxN"), ``split_t_shapes`` ("BxROWSxCOLS") and
``product_shapes`` ("BxMxN kK"), and ``plain_bwd_cuda`` the calls of the
plain backward on CUDA tensors (which no path of the port makes);
``reset_counts`` sets them to 0 and ``read_counts`` reads them.
``recorded_operands`` keeps the operands of the Grams a block of code hands
the wrapper, to hold the kernel against its plain version on them.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from ..config import COSDELTA_JITTER
from . import cuda_build

_SRC = "acos_gram.cu"
NVCC_FLAGS = cuda_build.NVCC_FLAGS

# The kernel's tiling (csrc/acos_gram.cu): one block computes a BM x BN tile
# of K over a range of k in blocks of BK floats, one block per SM.
BM = BN = 128
BK = 32
# The planner splits k until the launched waves are this full ...
TARGET_FILL = 0.85
# ... but into at most MAX_SPLITS ranges of at least MIN_KBLOCKS_PER_SPLIT
# blocks of k each.
MAX_SPLITS = 16
MIN_KBLOCKS_PER_SPLIT = 4
# The grid's z dimension (items x splits) is at most this.
MAX_GRID_Z = 65535

# Launches of the Gram kernel since import (or since the caller reset
# them), those with a batch axis, the Grams they computed, launches of the
# split pass, and the Gram's launches by (batch, m, n, k).
launches = 0
batched_launches = 0
items = 0
split_launches = 0
shape_launches = collections.Counter()
# The backward's kernels: launches and launches by shape, and the plain
# backward's calls on CUDA tensors.
bwd_launches = split_t_launches = product_launches = 0
bwd_shapes = collections.Counter()
split_t_shapes = collections.Counter()
product_shapes = collections.Counter()
plain_bwd_cuda = 0
# Seconds the last build took (None until this process built or loaded it),
# and the compiler's register/spill report of that build.
build_seconds: Optional[float] = None
build_log: str = ""
_lib = None


def reset_counts() -> None:
    """Set every launch count to 0."""
    global launches, batched_launches, items, split_launches
    global bwd_launches, split_t_launches, product_launches, plain_bwd_cuda
    launches = batched_launches = items = split_launches = 0
    bwd_launches = split_t_launches = product_launches = plain_bwd_cuda = 0
    for counter in (shape_launches, bwd_shapes, split_t_shapes,
                    product_shapes):
        counter.clear()


def read_counts() -> dict:
    """Launches of the 2-D Gram, of the batched Gram, the Grams (items) the
    batched launches computed, launches of the split pass, and the Gram's
    launches by (batch, m, n, k); the backward's kernels' launches
    ("bwd", "split_t", "product") and the same by shape (keyed by strings),
    and the plain backward's calls on CUDA tensors."""
    return {"gram": launches - batched_launches,
            "batched": batched_launches, "items": items,
            "split": split_launches, "shapes": dict(shape_launches),
            "bwd": bwd_launches, "split_t": split_t_launches,
            "product": product_launches, "plain_bwd_cuda": plain_bwd_cuda,
            "bwd_shapes": dict(bwd_shapes),
            "split_t_shapes": dict(split_t_shapes),
            "product_shapes": dict(product_shapes)}


def recorded_operands(build) -> list:
    """The (u1, s2, q11, q22, sigma0) of every Gram that ``build()`` hands
    ``acos_gram``, in call order (``build`` runs without a gradient)."""
    global acos_gram
    calls = []
    real = acos_gram

    def record(*args, **kwargs):
        calls.append([a.detach() for a in args])
        return real(*args, **kwargs)

    acos_gram = record
    try:
        with torch.no_grad():
            build()
    finally:
        acos_gram = real
    return calls


def load_library():
    """Build (if needed) and load the kernel library (``ops/cuda_build``);
    returns the ctypes handle."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    lib, build_seconds, build_log = cuda_build.build(_SRC, NVCC_FLAGS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tf32_split_f32.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.tf32_split_f32.restype = i32
    lib.acos_gram_f32.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.acos_gram_f32.restype = i32
    lib.tf32_split_t_f32.argtypes = [ptr, ptr] + [i32] * 4 + [ptr]
    lib.tf32_split_t_f32.restype = i32
    lib.nt_product_f32.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.nt_product_f32.restype = i32
    lib.acos_gram_bwd_f32.argtypes = ([ptr] * 6 + [i32, ptr, i32]
                                      + [ptr] * 5 + [i32] * 3 + [ptr])
    lib.acos_gram_bwd_f32.restype = i32
    lib.acos_gram_error_string.argtypes = [i32]
    lib.acos_gram_error_string.restype = ctypes.c_char_p
    lib.acos_gram_smem_bytes.argtypes = []
    lib.acos_gram_smem_bytes.restype = i32
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# Work decomposition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GramPlan:
    """How the kernel covers K (batch, m, n) over k: for each item a grid of
    BM x BN tiles, each computed by ``splits`` blocks over consecutive
    ranges of k-blocks; with splits > 1 the partial sums meet in a second
    pass."""
    m: int
    n: int
    k: int
    sms: int
    splits: int
    batch: int = 1

    @property
    def tiles_m(self) -> int:
        return -(-self.m // BM)

    @property
    def tiles_n(self) -> int:
        return -(-self.n // BN)

    @property
    def kblocks(self) -> int:
        return -(-self.k // BK)

    @property
    def grid(self) -> Tuple[int, int, int]:
        """The launch grid, (tiles of n, tiles of m, batch x splits)."""
        return self.tiles_n, self.tiles_m, self.batch * self.splits

    @property
    def units(self) -> int:
        return self.batch * self.tiles_m * self.tiles_n * self.splits

    @property
    def waves(self) -> int:
        return -(-self.units // self.sms)

    @property
    def fill(self) -> float:
        """Share of the launched waves' block slots that hold work."""
        return self.units / (self.waves * self.sms)

    def k_range(self, split: int) -> Tuple[int, int]:
        """[lo, hi) of k computed by blocks with this split index (the
        kernel's own integer formula, in whole blocks of BK)."""
        lo = split * self.kblocks // self.splits
        hi = (split + 1) * self.kblocks // self.splits
        return lo * BK, min(hi * BK, self.k)

    def __str__(self) -> str:
        each = f"{self.batch} items of " if self.batch > 1 else ""
        return (f"{each}{self.tiles_m} x {self.tiles_n} tiles of {BM} x {BN}, k "
                f"{self.k} in {self.splits} split(s) of "
                f"{self.kblocks / self.splits:.1f} blocks of {BK}: "
                f"{self.units} blocks in {self.waves} wave(s) of {self.sms} "
                f"({self.fill:.3f} full)")


@functools.lru_cache(maxsize=256)
def plan_gram(m: int, n: int, k: int, sms: int = 132,
              batch: int = 1) -> GramPlan:
    """The smallest split of k whose waves are at least TARGET_FILL full,
    counting all ``batch`` items' tiles, among splits that leave every range
    MIN_KBLOCKS_PER_SPLIT blocks of k (at most MAX_SPLITS, and batch x
    splits within the grid's 65535); where none reaches it, the fullest (the
    smallest of equals)."""
    if min(m, n, k, sms, batch) < 1 or batch > MAX_GRID_Z:
        raise ValueError(f"plan_gram: sizes must be positive (batch at most "
                         f"{MAX_GRID_Z}), got m={m} n={n} k={k} sms={sms} "
                         f"batch={batch}")
    kblocks = -(-k // BK)
    most = max(1, min(MAX_SPLITS, kblocks // MIN_KBLOCKS_PER_SPLIT,
                      MAX_GRID_Z // batch))
    best = GramPlan(m, n, k, sms, 1, batch)
    for s in range(1, most + 1):
        plan = GramPlan(m, n, k, sms, s, batch)
        if plan.fill >= TARGET_FILL:
            return plan
        if plan.fill > best.fill:
            best = plan
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def acos_epilogue_torch(q12: torch.Tensor, q11: torch.Tensor,
                        q22: torch.Tensor, sigma0: torch.Tensor
                        ) -> torch.Tensor:
    """K from the cross form q12 ((B,) m, n) and the norms: the kernel's
    epilogue in plain PyTorch."""
    s02 = (sigma0 * sigma0)[..., None]
    X1X2 = (torch.sqrt(q11 + s02)[..., :, None]
            * torch.sqrt(q22 + s02)[..., None, :])
    c = torch.clamp((q12 + s02[..., None]) / (X1X2 + COSDELTA_JITTER),
                    -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    return X1X2 * ((s + (math.pi - torch.acos(c)) * c) / math.pi)


def acos_gram_torch(u1: torch.Tensor, s2: torch.Tensor, q11: torch.Tensor,
                    q22: torch.Tensor, sigma0: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, 2-D or batched: ``u1 @
    s2.T`` and the same epilogue.  The forward reference for the kernel,
    and the forward of ``AcosGram`` on CPU tensors (not differentiated
    itself)."""
    return acos_epilogue_torch(u1 @ s2.mT, q11, q22, sigma0)


def tf32_split_torch(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the split pass: (big, small) with big = a
    rounded to TF32 (10 mantissa bits; to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``) and small = a - big, exact in float32.  NaN stays
    NaN in both; inf gives big = inf and small = NaN."""
    if a.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {a.dtype}")
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    # add half a TF32 ulp to the magnitude bits, then drop the low 13
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    big = torch.where(torch.isnan(a), a, r.view(torch.float32))
    return big, a - big


def _pad4(n: int) -> int:
    """n rounded up to 4 floats: the forward's split planes' row stride
    (TMA wants 16-byte strides)."""
    return -(-n // 4) * 4


def _pitch(n: int) -> int:
    """n rounded up to 32 floats: the row stride of the backward's planes.
    A row that starts on a 128-byte boundary is one 128-byte line for each
    of TMA's box rows; at an 8400-byte stride every box row straddles two,
    and the product took 1.29 ms against 0.72-0.79 (H100 80GB HBM3,
    PERF.md)."""
    return -(-n // BK) * BK


def tf32_split_t_torch(a: torch.Tensor) -> torch.Tensor:
    """The plain version of the transposing split pass: a ((B,) rows, cols)
    float32 gives one buffer (2, (B,) cols, rowsp) holding the big plane of
    a^T, then its small plane (``tf32_split_torch`` of a^T), with rowsp =
    ``_pitch(rows)`` and zeros in rows [rows, rowsp)."""
    rows = a.shape[-2]
    padded = a.new_zeros(a.shape[:-2] + (a.shape[-1], _pitch(rows)))
    padded[..., :rows] = a.mT
    return torch.stack(tf32_split_torch(padded))


def nt_product_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the product kernel: a @ b^T for a ((B,) m, k)
    and b ((B,) n, k)."""
    return a @ b.mT


def acos_gram_bwd_torch(g: torch.Tensor, q12: torch.Tensor,
                        q11: torch.Tensor, q22: torch.Tensor,
                        sigma0: torch.Tensor):
    """The plain version of the backward epilogue: from g = dL/dK and the
    cross form q12 ((B,) m, n) at which K was computed, (dq12, dq11, dq22,
    dsigma0), the gradients of L with respect to q12, q11 ((B,) m), q22
    ((B,) n) and sigma0 (its shape).  Counts its calls on CUDA tensors in
    ``plain_bwd_cuda``."""
    global plain_bwd_cuda
    plain_bwd_cuda += g.is_cuda
    s02 = (sigma0 * sigma0)[..., None]
    X1 = torch.sqrt(q11 + s02)
    X2 = torch.sqrt(q22 + s02)
    P = X1[..., :, None] * X2[..., None, :]
    num = q12 + s02[..., None]
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
    g_a = (g_P * X2[..., None, :]).sum(-1) / (2.0 * X1)    # dL/dq11
    g_b = (g_P * X1[..., :, None]).sum(-2) / (2.0 * X2)    # dL/dq22
    g_s02 = g_a.sum(-1) + g_b.sum(-1) + g_num.sum((-2, -1))
    dsig = (g_s02 * 2.0 * sigma0).reshape(sigma0.shape)
    return g_num, g_a, g_b, dsig


def gram_backward_torch(g, u1, s2, q11, q22, sigma0, q12, need_u1=True,
                        need_s2=True):
    """The plain version of ``gram_backward``: (du1, ds2, dq11, dq22,
    dsigma0) from ``acos_gram_bwd_torch`` at the given q12 and the two
    products dq12 S2 and dq12^T U1 (du1 / ds2 None where not needed)."""
    dq12, dq11, dq22, dsig = acos_gram_bwd_torch(g, q12, q11, q22, sigma0)
    return (dq12 @ s2 if need_u1 else None,
            dq12.mT @ u1 if need_s2 else None, dq11, dq22, dsig)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

def _check(u1, s2, q11, q22, sigma0):
    """(batch, m, n, k) of a 2-D or batched call the kernel can take;
    raises on anything else."""
    tensors = (u1, s2, q11, q22, sigma0)
    dev = u1.device
    for t in tensors:
        if t.device != dev:
            raise ValueError("acos_gram: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"acos_gram kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("acos_gram kernel takes contiguous tensors")
    nd = u1.dim()
    if (nd not in (2, 3) or s2.dim() != nd or u1.shape[-1] != s2.shape[-1]
            or u1.shape[:-2] != s2.shape[:-2]):
        raise ValueError(f"acos_gram: u1 {tuple(u1.shape)} and s2 "
                         f"{tuple(s2.shape)} must be (m, k) and (n, k), or "
                         f"(B, m, k) and (B, n, k)")
    batch = u1.shape[0] if nd == 3 else 1
    m, k = u1.shape[-2:]
    n = s2.shape[-2]
    lead = tuple(u1.shape[:-2])
    if (q11.shape != lead + (m,) or q22.shape != lead + (n,)
            or sigma0.numel() != batch):
        raise ValueError("acos_gram: q11 must be ((B,) m), q22 ((B,) n), "
                         "sigma0 one element per item")
    if (min(m, n, k, batch) < 1 or max(m * batch, n * batch, k) >= 2 ** 31
            or -(-m // BM) > 65535 or batch > MAX_GRID_Z):
        raise ValueError(f"acos_gram: unsupported sizes batch={batch} m={m} "
                         f"n={n} k={k}")
    return batch, m, n, k


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.acos_gram_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _split_into(lib, a: torch.Tensor, kp: int, stream: int) -> torch.Tensor:
    """Launch the split pass on a (rows, k): returns (2, rows, kp), the big
    plane then the small one, zero in columns [k, kp)."""
    global split_launches
    rows, k = a.shape
    dst = torch.empty((2, rows, kp), dtype=torch.float32, device=a.device)
    _raise_on(lib, lib.tf32_split_f32(a.data_ptr(), dst.data_ptr(), rows, k,
                                      kp, stream), "tf32_split")
    split_launches += 1
    return dst


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of a float32 (rows, k) matrix: on a CUDA tensor the
    split kernel (views into its padded buffer), on a CPU tensor
    ``tf32_split_torch``."""
    if not a.is_cuda:
        return tf32_split_torch(a)
    if a.dtype != torch.float32:
        raise TypeError(f"tf32_split kernel takes float32, got {a.dtype}")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("tf32_split kernel takes a contiguous (rows, k) "
                         "matrix")
    lib = load_library()
    k = a.shape[1]
    with torch.cuda.device(a.device):
        buf = _split_into(lib, a, -(-k // 4) * 4,
                          torch.cuda.current_stream(a.device).cuda_stream)
    return buf[0, :, :k], buf[1, :, :k]


def _run(out, ws, plan: GramPlan, u1, s2, q11, q22, sigma0,
         q12=None) -> torch.Tensor:
    """Split both operands (all items' rows in one pass each) and launch the
    Gram into ``out`` ((B,) m, n), with ``ws`` (B, plan.splits, m, n) for
    the partial sums when plan.splits > 1, and the raw cross form into
    ``q12`` (out's shape) when it is given."""
    global launches, batched_launches, items
    lib = load_library()
    kp = _pad4(plan.k)
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream(u1.device).cuda_stream
        a = _split_into(lib, u1.reshape(-1, plan.k), kp, stream)
        b = _split_into(lib, s2.reshape(-1, plan.k), kp, stream)
        rc = lib.acos_gram_f32(a.data_ptr(), b.data_ptr(), q11.data_ptr(),
                               q22.data_ptr(), sigma0.data_ptr(),
                               out.data_ptr(),
                               None if q12 is None else q12.data_ptr(),
                               ws.data_ptr(), plan.m, plan.n, kp,
                               plan.splits, plan.batch, stream)
    _raise_on(lib, rc, "acos_gram")
    launches += 1
    batched_launches += u1.dim() == 3
    items += plan.batch
    shape_launches[(plan.batch, plan.m, plan.n, plan.k)] += 1
    return out


def _launch(u1, s2, q11, q22, sigma0, out=None, keep_q12=False):
    """K, or (K, q12) with ``keep_q12``, through the kernel."""
    batch, m, n, k = _check(u1, s2, q11, q22, sigma0)
    plan = plan_gram(m, n, k, _sm_count(u1.device), batch)
    shape = tuple(u1.shape[:-2]) + (m, n)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=u1.device)
    elif (out.shape != shape or out.dtype != torch.float32
          or out.device != u1.device or not out.is_contiguous()):
        raise ValueError(f"acos_gram: out must be a contiguous float32 "
                         f"{shape} on {u1.device}")
    ws = out
    if plan.splits > 1:
        # never the target itself: out may be a view into a larger matrix
        ws = torch.empty((batch, plan.splits, m, n), dtype=torch.float32,
                         device=u1.device)
    if not keep_q12:
        return _run(out, ws, plan, u1, s2, q11, q22, sigma0)
    q12 = torch.empty(shape, dtype=torch.float32, device=u1.device)
    return _run(out, ws, plan, u1, s2, q11, q22, sigma0, q12), q12


def _split_t_into(lib, a: torch.Tensor, stream: int) -> torch.Tensor:
    """Launch the transposing split pass on a contiguous (B, rows, cols):
    returns (2, B, cols, rowsp), as ``tf32_split_t_torch``."""
    global split_t_launches
    batch, rows, cols = a.shape
    dst = torch.empty((2, batch, cols, _pitch(rows)), dtype=torch.float32,
                      device=a.device)
    _raise_on(lib, lib.tf32_split_t_f32(a.data_ptr(), dst.data_ptr(), batch,
                                        rows, cols, _pitch(rows), stream),
              "tf32_split_t")
    split_t_launches += 1
    split_t_shapes[f"{batch}x{rows}x{cols}"] += 1
    return dst


def _product(lib, a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
             stream: int) -> torch.Tensor:
    """Launch the product on the split operands a (2, B, m, kp) and b (2, B,
    n, kp), kp = ``_pitch(k)``: returns A B^T (B, m, n), over
    ``plan_gram``'s split of k."""
    global product_launches
    batch, kp = a.shape[1], a.shape[-1]
    if b.shape[-1] != kp or b.shape[1] != batch or kp != _pitch(k):
        raise ValueError(f"nt_product: planes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not hold k={k} at a row "
                         f"stride of {_pitch(k)}")
    plan = plan_gram(m, n, k, _sm_count(a.device), batch)
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    ws = out
    if plan.splits > 1:
        ws = torch.empty((batch, plan.splits, m, n), dtype=torch.float32,
                         device=a.device)
    _raise_on(lib, lib.nt_product_f32(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), ws.data_ptr(), m, n, kp,
                                      plan.splits, batch, stream),
              "nt_product")
    product_launches += 1
    product_shapes[f"{batch}x{m}x{n} k{k}"] += 1
    return out


def _bwd_launch(lib, g, q12, q11, q22, sigma0, stream, transposed=True):
    """The backward epilogue on (B, m, n) g and q12: (the TF32 planes of
    dq12 (2, B, m, _pitch(n)), those of dq12^T (2, B, n, _pitch(m)) or None
    without ``transposed``, dq11, dq22, dsigma0 (B,)).  dq12 itself is
    planes[0] + planes[1] (exactly), in the columns below n."""
    global bwd_launches
    batch, m, n = g.shape
    f32 = dict(dtype=torch.float32, device=g.device)
    tiles_m, tiles_n = -(-m // 32), -(-n // 128)
    planes = torch.empty((2, batch, m, _pitch(n)), **f32)
    planes_t = (torch.empty((2, batch, n, _pitch(m)), **f32) if transposed
                else None)
    part = torch.empty(batch * (tiles_n * m + tiles_m * n + tiles_m * tiles_n),
                       **f32)
    tickets = torch.zeros(batch * (tiles_m + tiles_n + 1), dtype=torch.int32,
                          device=g.device)
    dq11 = torch.empty((batch, m), **f32)
    dq22 = torch.empty((batch, n), **f32)
    dsig = torch.empty(batch, **f32)
    _raise_on(lib, lib.acos_gram_bwd_f32(
        g.data_ptr(), q12.data_ptr(), q11.data_ptr(), q22.data_ptr(),
        sigma0.data_ptr(), planes.data_ptr(), _pitch(n),
        None if planes_t is None else planes_t.data_ptr(), _pitch(m),
        part.data_ptr(), tickets.data_ptr(), dq11.data_ptr(), dq22.data_ptr(),
        dsig.data_ptr(), m, n, batch, stream), "acos_gram_bwd")
    bwd_launches += 1
    bwd_shapes[f"{batch}x{m}x{n}"] += 1
    return planes, planes_t, dq11, dq22, dsig


def _check_bwd(g, q12, q11, q22, sigma0, *rest) -> int:
    """The batch of a backward call the kernels can take (float32 on one
    CUDA device, g and q12 ((B,) m, n), q11 ((B,) m), q22 ((B,) n), one
    sigma0 an item, and ``rest``'s tensors on the same terms); raises on
    anything else."""
    for t in (g, q12, q11, q22, sigma0, *rest):
        if t.dtype != torch.float32 or t.device != g.device:
            raise TypeError(f"the Gram's backward kernels take float32 "
                            f"tensors on {g.device}, got {t.dtype} on "
                            f"{t.device}")
    batch = g.shape[0] if g.dim() == 3 else 1
    if (g.dim() not in (2, 3) or q12.shape != g.shape
            or q11.shape != g.shape[:-1] or q22.shape != g.shape[:-2]
            + g.shape[-1:] or sigma0.numel() != batch):
        raise ValueError(f"acos_gram backward: g and q12 must be ((B,) m, "
                         f"n), q11 ((B,) m), q22 ((B,) n), sigma0 one "
                         f"element per item; got {tuple(g.shape)}, "
                         f"{tuple(q12.shape)}, {tuple(q11.shape)}, "
                         f"{tuple(q22.shape)}, {tuple(sigma0.shape)}")
    return batch


def gram_backward(g, u1, s2, q11, q22, sigma0, q12, need_u1=True,
                  need_s2=True):
    """The Gram's gradients (du1, ds2, dq11, dq22, dsigma0) from g = dL/dK
    and the forward's q12, 2-D or batched (du1 / ds2 None where not
    needed).  On CUDA tensors: the backward epilogue, which writes the
    planes of dq12 and of dq12^T, then ds2 = dq12^T U1 through the product
    kernel on dq12^T's planes and the transposing split of u1, and du1 =
    dq12 S2 on dq12's planes and the transposing split of s2; a CUDA
    tensor the kernels cannot take raises.  On CPU tensors the plain
    versions."""
    if not g.is_cuda:
        return gram_backward_torch(g, u1, s2, q11, q22, sigma0, q12, need_u1,
                                   need_s2)
    batch = _check_bwd(g, q12, q11, q22, sigma0, u1, s2)
    m, n = g.shape[-2:]
    k = u1.shape[-1]
    if u1.shape != g.shape[:-1] + (k,) or s2.shape != g.shape[:-2] + (n, k):
        raise ValueError(f"gram_backward: u1 {tuple(u1.shape)} and s2 "
                         f"{tuple(s2.shape)} do not match g "
                         f"{tuple(g.shape)}")
    lib = load_library()
    items = [t.contiguous().reshape(batch, *t.shape[-2:])
             for t in (g, q12, u1, s2)]
    g3, q3, u3, s3 = items
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        planes, planes_t, dq11, dq22, dsig = _bwd_launch(
            lib, g3, q3, q11.contiguous().reshape(batch, m),
            q22.contiguous().reshape(batch, n),
            sigma0.reshape(batch).contiguous(), stream, need_s2)
        # ds2 first: U1^T's planes (the larger) are freed before du1 (m, k)
        # is allocated
        du1 = ds2 = None
        if need_s2:
            ds2 = _product(lib, planes_t, _split_t_into(lib, u3, stream), n,
                           k, m, stream).reshape(s2.shape)
        del planes_t
        if need_u1:
            du1 = _product(lib, planes, _split_t_into(lib, s3, stream), m, k,
                           n, stream).reshape(u1.shape)
    return (du1, ds2, dq11.reshape(q11.shape), dq22.reshape(q22.shape),
            dsig.reshape(sigma0.shape))


class AcosGram(torch.autograd.Function):
    """Differentiable fused Gram: kernel forward on CUDA, plain forward on
    CPU, each keeping its q12 for the backward (``gram_backward``: the
    backward kernels on CUDA, the plain versions on CPU)."""

    @staticmethod
    def forward(ctx, u1, s2, q11, q22, sigma0):
        K, q12 = _forward(u1, s2, q11, q22, sigma0, keep_q12=True)
        ctx.save_for_backward(u1, s2, q11, q22, sigma0, q12)
        return K

    @staticmethod
    def backward(ctx, g):
        u1, s2, q11, q22, sigma0, q12 = ctx.saved_tensors
        return gram_backward(g, u1, s2, q11, q22, sigma0, q12,
                             ctx.needs_input_grad[0], ctx.needs_input_grad[1])


def _forward(u1, s2, q11, q22, sigma0, out=None, keep_q12=False):
    """The kernel on CUDA tensors, the plain version on CPU tensors; K, or
    (K, q12) with ``keep_q12`` (not with ``out``)."""
    if u1.is_cuda:
        batch = u1.shape[0] if u1.dim() == 3 else 1
        return _launch(u1.contiguous(), s2.contiguous(), q11.contiguous(),
                       q22.contiguous(), sigma0.reshape(batch).contiguous(),
                       out, keep_q12)
    q12 = u1 @ s2.mT
    K = acos_epilogue_torch(q12, q11, q22, sigma0)
    if keep_q12:
        return K, q12
    return K if out is None else out.copy_(K)


def acos_gram(u1: torch.Tensor, s2: torch.Tensor, q11: torch.Tensor,
              q22: torch.Tensor, sigma0: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K (m, n) for u1 (m, k), s2 (n, k), q11 (m,), q22 (n,) and a 0-d
    sigma0, or K (B, m, n) for u1 (B, m, k), s2 (B, n, k), q11 (B, m), q22
    (B, n) and sigma0 (B,); differentiable in all five.  With ``out`` (a
    contiguous tensor of K's shape, which may be a view into a larger one)
    the result is written there and returned, without a gradient."""
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u1, s2, q11, q22, sigma0))
    if out is None:
        if grad:
            return AcosGram.apply(u1, s2, q11, q22, sigma0)
        return _forward(u1, s2, q11, q22, sigma0)
    if grad:
        raise ValueError("acos_gram: out= computes no gradient")
    return _forward(u1, s2, q11, q22, sigma0, out)
