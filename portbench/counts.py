"""The work the benchmark counts, from shapes alone, and the card's peaks.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): float32-accurate
products on the tensor cores as three TF32 products at 495 TFLOP/s, so
165 TFLOP/s; 3.35 TB/s of HBM.  They hold at the card's 700 W limit; the
result's line names the card and the run's notes its power limit.

A Gram K = X1 X2 J(.) of an (m, k) and an (n, k) operand is one product of
2 m n k FLOPs; its bytes are each input read once (both operands and both
diagonals) and the (m, n) output written once, float32.  Its backward is
two products (dU1 and dS2, 2 m n k each) and an epilogue of 12 bytes an
element (g and q12 read, dq12 written).  A bound is the larger of the
FLOPs at the peak rate and the bytes at the peak bandwidth.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

PEAK_FLOPS = 165e12          # float32-accurate tensor-core products
PEAK_BYTES = 3.35e12         # HBM3
F32 = 4


def gram_flops(b: int, m: int, n: int, k: int) -> float:
    return 2.0 * b * m * n * k


def gram_bytes(b: int, m: int, n: int, k: int) -> float:
    return F32 * b * (m * k + n * k + m + n + m * n)


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def gram_forward_bound(shapes: Dict[Tuple[int, int, int, int], int]) -> float:
    """Seconds the forward Grams launched need at least: ``shapes`` maps
    (batch, m, n, k) to launches."""
    return sum(c * bound_seconds(gram_flops(*s), gram_bytes(*s))
               for s, c in shapes.items())


_PRODUCT = re.compile(r"^(\d+)x(\d+)x(\d+) k(\d+)$")
_EPILOGUE = re.compile(r"^(\d+)x(\d+)x(\d+)$")


def parse_product(key: str) -> Tuple[int, int, int, int]:
    """(batch, m, n, k) of a product's "BxMxN kK" key."""
    b, m, n, k = _PRODUCT.match(key).groups()
    return int(b), int(m), int(n), int(k)


def parse_epilogue(key: str) -> Tuple[int, int, int]:
    b, m, n = _EPILOGUE.match(key).groups()
    return int(b), int(m), int(n)


def gram_backward_bound(products: Dict[str, int],
                        epilogues: Dict[str, int]) -> float:
    """Seconds the backward Grams launched need at least: each product
    (an (m, k) by (k, n) contraction keyed "BxMxN kK") at its FLOPs or its
    operands' and output's bytes, each epilogue ("BxMxN") at 12 bytes an
    element."""
    t = 0.0
    for key, c in products.items():
        b, m, n, k = parse_product(key)
        t += c * bound_seconds(gram_flops(b, m, n, k),
                               F32 * b * (m * k + n * k + m * n))
    for key, c in epilogues.items():
        b, m, n = parse_epilogue(key)
        t += c * 12.0 * b * m * n / PEAK_BYTES
    return t


def gram_products_flops(shapes: Dict[Tuple[int, int, int, int], int],
                        products: Dict[str, int]) -> float:
    """FLOPs of every Gram product launched, forward and backward."""
    fwd = sum(c * gram_flops(*s) for s, c in shapes.items())
    bwd = sum(c * gram_flops(*parse_product(key))
              for key, c in products.items())
    return fwd + bwd
