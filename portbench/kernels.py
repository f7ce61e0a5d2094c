"""The program's hand-written kernels by the names the device trace gives
them, grouped as the per-layer metrics read them."""

from __future__ import annotations

import re

GRAM_FORWARD = ("tf32_split_kernel", "tf32_split_vec_kernel",
                "acos_gram_tf32x3_kernel", "acos_gram_reduce_kernel")
GRAM_BACKWARD = ("acos_gram_bwd_kernel", "tf32_split_t_kernel",
                 "nt_product_kernel", "nt_product_reduce_kernel")
FPARAM = ("fparam_lbfgs_kernel",)


def _matcher(names):
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(names)
                      + r")(?![A-Za-z0-9_])")


_FWD, _BWD, _FP = _matcher(GRAM_FORWARD), _matcher(GRAM_BACKWARD), \
    _matcher(FPARAM)


def is_gram_forward(name: str) -> bool:
    return bool(_FWD.search(name))


def is_gram_backward(name: str) -> bool:
    return bool(_BWD.search(name))


def is_gram(name: str) -> bool:
    return is_gram_forward(name) or is_gram_backward(name)


def is_fparam(name: str) -> bool:
    return bool(_FP.search(name))
