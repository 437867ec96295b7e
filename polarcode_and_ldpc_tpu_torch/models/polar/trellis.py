"""SC f/g primitives shared by the polar decoders.

``f(a,b) = sign(a)·sign(b)·min(|a|,|b|)`` (min-sum) and
``g(btm, top, bit) = btm + (1−2·bit)·top``.
"""

from __future__ import annotations

import torch


def f_minsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Upper-branch LLR update ``sign(a)·sign(b)·min(|a|,|b|)``.

    Computed at the bit level for f32/f64: the result's sign bit is the XOR
    of the operand sign bits or'd onto ``min(|a|,|b|)``.  Bitwise identical
    to the two-sign-multiplies form for every finite input (including ±0 and
    subnormals; no product is formed, so nothing can underflow), and the
    form the CUDA kernel uses.  Other dtypes keep the product form."""
    if a.dtype == torch.float32:
        ibits, imask = torch.int32, -(2 ** 31)
    elif a.dtype == torch.float64:
        ibits, imask = torch.int64, -(2 ** 63)
    else:
        return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())
    m = torch.minimum(a.abs(), b.abs()).contiguous()
    sgn = (a.contiguous().view(ibits) ^ b.contiguous().view(ibits)) & imask
    return (m.view(ibits) | sgn).view(a.dtype)


def g_update(btm: torch.Tensor, top: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Lower-branch LLR update ``btm + (1−2·bit)·top``."""
    return btm + (1.0 - 2.0 * bit.to(btm.dtype)) * top
