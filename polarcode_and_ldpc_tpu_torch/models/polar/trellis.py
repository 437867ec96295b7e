"""SC trellis primitives shared by the polar decoders.

``f(a,b) = sign(a)·sign(b)·min(|a|,|b|)`` (min-sum) and
``g(btm, top, bit) = btm + (1−2·bit)·top``.

The trellis decoders (``impl="scan"`` of ``sc.py`` and ``scl.py``) keep an
LLR trellis ``L`` and a bit trellis ``B`` as ``[..., n+1, N]`` tensors
(leading frame / list axes) and update them one leaf at a time, each stage
as one full-width masked vector operation:

* the butterfly partner of position ``j`` at stage ``s`` is ``j XOR 2^s``,
  a reshape + flip;
* which positions a leaf touches is a congruence mask on an iota;
* whether a stage runs at all is a row of the host-side schedule
  (``schedule.py``), so a step runs only its active stages.

The leaf index ``l`` is a Python integer (the schedule is on the host).
``update_llr_columns``, ``propagate_bits`` and ``set_leaf_bit`` write their
trellis in place and return it.
"""

from __future__ import annotations

import functools

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


def xor_shuffle(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Permute the last axis by ``j → j XOR stride`` (stride a power of two)."""
    N = x.shape[-1]
    lead = x.shape[:-1]
    xr = x.reshape(*lead, N // (2 * stride), 2, stride)
    return torch.flip(xr, dims=(-2,)).reshape(*lead, N)


@functools.lru_cache(maxsize=None)
def _iota(N: int, device) -> torch.Tensor:
    """``arange(N)`` int64 on ``device`` (cached; never written)."""
    return torch.arange(N, device=device)


def update_llr_columns(L: torch.Tensor, B: torch.Tensor, l: int, act) -> torch.Tensor:
    """Run the active LLR stages for leaf ``l``.

    Args:
        L: ``[..., n+1, N]`` LLR trellis (column 0 = channel LLRs).
        B: ``[..., n+1, N]`` int8 bit trellis.
        l: leaf index.
        act: ``[n]`` bools — which stages run (a row of the schedule).
    """
    n = L.shape[-2] - 1
    iota = _iota(L.shape[-1], L.device)
    for s in range(n):
        if not act[s]:
            continue
        stride = 1 << s
        blk = (1 << (s + 1)) - 1
        col = L[..., s, :]
        partner = xor_shuffle(col, stride)
        if (l >> s) & 1:
            vals = g_update(col, partner, xor_shuffle(B[..., s + 1, :], stride))
        else:
            vals = f_minsum(col, partner)
        mask = (iota & blk) == (l & blk)
        L[..., s + 1, :] = torch.where(mask, vals, L[..., s + 1, :])
    return L


def propagate_bits(B: torch.Tensor, l: int, act) -> torch.Tensor:
    """Partial-sum back-propagation after deciding leaf ``l``.

    For each active stage s (descending): positions ``q ≤ l`` with
    ``q ≡ l (mod 2^{s−1})`` get ``B[q, s−1] = B[q, s] ⊕ (bit_{s−1}(q)==0 ?
    B[q XOR 2^{s−1}, s] : 0)``.
    """
    n = B.shape[-2] - 1
    iota = _iota(B.shape[-1], B.device)
    for s in range(n, 0, -1):
        if not act[s - 1]:
            continue
        stride = 1 << (s - 1)
        blk = stride - 1
        col = B[..., s, :]
        partner = xor_shuffle(col, stride)
        qbit = ((iota >> (s - 1)) & 1) == 1
        newv = col ^ torch.where(qbit, torch.zeros_like(partner), partner)
        mask = ((iota & blk) == (l & blk)) & (iota <= l)
        B[..., s - 1, :] = torch.where(mask, newv, B[..., s - 1, :])
    return B


def leaf_llr(L: torch.Tensor, l: int) -> torch.Tensor:
    """The decision LLR ``L[..., n, l]`` (shape = leading dims; a copy)."""
    return L[..., -1, l].clone()


def set_leaf_bit(B: torch.Tensor, l: int, bit: torch.Tensor) -> torch.Tensor:
    """Write decision bit(s) into ``B[..., n, l]`` (bit shape = leading dims)."""
    B[..., -1, l] = bit.to(B.dtype)
    return B
