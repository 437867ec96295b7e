"""Unrolled recursive SC decoder — the plain PyTorch version of the
whole-decode SC kernel (``ops/sc_mega_cuda.py``).

True SC work is O(N log N); this module emits it directly by unrolling the SC
recursion into a static program over x-subchannel segments:

* the natural-order code (encoder stage 0 = adjacent pairs) decodes u-even
  indices through ``f(α[2i], α[2i+1])`` and u-odd through ``g`` — so each
  node deinterleaves its α, recurses on the even u-subcode, then the odd,
  and re-interleaves the partial sums;
* frozen structure is static, so constituent nodes collapse (Sarkis et al.,
  "Fast Polar Decoders: Algorithm and Implementation", JSAC 2014):
  **rate-0** (all frozen → β = 0) and **REP** (one trailing info bit →
  β = hard(Σα)) are exact equivalents of min-sum SC under all inputs and
  are always enabled; **rate-1** (no frozen → β = hard(α)) and **SPC** (one
  leading frozen bit → hard(α) + parity-fixing flip of the least-reliable
  position) are exact except on exact-zero LLRs / tied minimum magnitudes
  and are gated behind ``fast_nodes``.

The REP sum is written as the halving adds the g-chain performs (all partial
sums zero: ``α' = α_odd + α_even``), so this version and the kernel add in
one order and agree bit for bit.  SPC flips the *first* position of the
minimum magnitude in natural order, as ``argmin`` does.

``make_sc_decoder_hybrid`` is the plain version of the SC kernel's hybrid
mode for codes whose frame one thread block cannot hold: the top levels of
the recursion over bit-reversed storage, every size-``sub_n`` subtree
decoded on its own contiguous storage slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .construction import bit_reverse_permutation
from .encoder import polar_transform
from .trellis import f_minsum


def _hard(alpha: torch.Tensor) -> torch.Tensor:
    """Hard decision: llr ≥ 0 → 0."""
    return (alpha < 0).to(torch.int8)


def _rep_sum(alpha: torch.Tensor) -> torch.Tensor:
    """Σα over the last axis by halving adds, ``[..., M] → [..., 1]``."""
    while alpha.shape[-1] > 1:
        alpha = alpha[..., 1::2] + alpha[..., 0::2]
    return alpha


def _spc(alpha: torch.Tensor) -> torch.Tensor:
    """SPC (Wagner decode): hard decisions, the first minimum flipped when
    the parity fails."""
    size = alpha.shape[-1]
    bits = _hard(alpha)
    parity = (bits.sum(dim=-1, dtype=torch.int32) & 1).to(torch.int8)
    # first minimum: torch.min(dim) does not promise the first index
    # on ties, so rank (magnitude, position) pairs explicitly
    mag = alpha.abs()
    mmin = mag.min(dim=-1, keepdim=True).values
    iota = torch.arange(size, device=alpha.device)
    worst = torch.where(mag == mmin, iota, size).min(dim=-1, keepdim=True).values
    flip = (iota == worst).to(torch.int8) * parity[..., None]
    return bits ^ flip


def leaf_beta(sub: np.ndarray, fast_nodes: bool):
    """The decoder ``alpha [..., size] -> beta`` (natural order) of a node
    that is decoded whole, given its frozen pattern ``sub``: rate-0, an info
    leaf, REP, and under ``fast_nodes`` rate-1 and SPC; ``None`` for a node
    the recursion splits.  Which kind a node is depends only on the frozen
    count and the two end positions, which bit reversal keeps, so a
    storage-order pattern gives the same answer."""
    size, n_frozen = len(sub), int(sub.sum())
    if n_frozen == size:  # rate-0
        return lambda alpha: torch.zeros(alpha.shape, dtype=torch.int8, device=alpha.device)
    if size == 1 or (fast_nodes and n_frozen == 0):  # info leaf, rate-1: β = hard(α)
        return _hard
    if n_frozen == size - 1 and not sub[-1]:  # REP
        return lambda alpha: _hard(_rep_sum(alpha)).expand(alpha.shape)
    if fast_nodes and n_frozen == 1 and sub[0]:  # SPC
        return _spc
    return None


def make_sc_beta_unrolled(N: int, frozen_mask: np.ndarray,
                          dtype=torch.float32, fast_nodes: bool = True):
    """The unrolled SC recursion without the final butterfly:
    ``beta(llr [..., N]) -> [..., N] int8``, the re-encoded codeword in
    natural order."""
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,)

    def node(alpha, off: int, step: int, size: int):
        """Decode u indices {off + k·step, k < size}; α is the x-subchannel
        vector [..., size].  Returns β (re-encoded x bits) [..., size]."""
        leaf = leaf_beta(frozen_mask[off: off + size * step: step], fast_nodes)
        if leaf is not None:
            return leaf(alpha)
        half = size // 2
        a_even, a_odd = alpha[..., 0::2], alpha[..., 1::2]
        beta_even = node(f_minsum(a_even, a_odd), off, 2 * step, half)
        sgn = 1.0 - 2.0 * beta_even.to(alpha.dtype)
        beta_odd = node(a_odd + sgn * a_even, off + step, 2 * step, half)
        # x[2i] = βe[i] ⊕ βo[i]; x[2i+1] = βo[i]
        return torch.stack([beta_even ^ beta_odd, beta_odd], dim=-1).reshape(
            *alpha.shape[:-1], size)

    def beta(llr):
        return node(torch.as_tensor(llr).to(dtype), 0, 1, N)

    return beta


def make_sc_decoder_unrolled(N: int, frozen_mask: np.ndarray,
                             dtype=torch.float32, fast_nodes: bool = True):
    """Build the unrolled SC decoder.

    Returns ``decode(llr: [..., N]) -> u: [..., N] int8`` (natural order) on
    the device of ``llr``.
    """
    beta = make_sc_beta_unrolled(N, frozen_mask, dtype, fast_nodes)

    def decode(llr):
        # β is the re-encoded codeword; u = β·G (G its own inverse)
        return polar_transform(beta(llr))

    return decode


def make_sc_subtree_plain(frozen_rev: np.ndarray, dtype=torch.float32,
                          fast_nodes: bool = True):
    """The plain decoder of one subtree in bit-reversed storage:
    ``run(alpha [B, n]) -> beta [B, n] int8``, both in the storage order of
    the slice ``frozen_rev`` (True = frozen) describes.  A contiguous storage
    slice is its subtree's own bit-reversed storage, so the slice, reversed,
    is the subtree's natural order."""
    frozen_rev = np.asarray(frozen_rev, bool)
    n = len(frozen_rev)
    rev_np = np.asarray(bit_reverse_permutation(n))
    beta = make_sc_beta_unrolled(n, frozen_rev[rev_np], dtype, fast_nodes)
    rev_on: dict = {}

    def run(alpha):
        rev = rev_on.get(alpha.device)
        if rev is None:
            rev = rev_on[alpha.device] = torch.as_tensor(rev_np, device=alpha.device)
        return beta(alpha[..., rev])[..., rev]

    return run


def make_sc_decoder_hybrid(N: int, frozen_mask: np.ndarray, sub_n: int,
                           dtype=torch.float32, fast_nodes: bool = True,
                           sub_decoders: Optional[dict] = None):
    """SC for a code cut at subtree size ``sub_n`` (the plain version of the
    SC kernel's hybrid mode, and the host side of that mode).

    The LLRs go to bit-reversed storage once; the top levels of the
    recursion run here as the f / g of the kernel (sign-XOR min, ``b +
    sgn·a``) on contiguous halves; an all-frozen subtree is zeros; a subtree
    that is decoded whole (REP, rate-1, SPC) above the cut is decoded here as
    the unrolled decoder decodes it; every other size-``sub_n`` subtree goes
    to ``sub_decoders[offset]`` (``alpha [B, sub_n] -> beta [B, sub_n]
    int8`` in storage order; default: ``make_sc_subtree_plain`` of its
    slice).  The butterfly and the return to natural order come last, so
    the output equals ``make_sc_decoder_unrolled`` bit for bit.

    Returns ``decode(llr [..., N]) -> u [..., N] int8`` (natural order).
    """
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,) and N & (N - 1) == 0
    assert sub_n & (sub_n - 1) == 0 and 1 <= sub_n <= N
    rev_np = np.asarray(bit_reverse_permutation(N))
    frozen_rev = frozen_mask[rev_np]
    if sub_decoders is None:
        sub_decoders = {off: make_sc_subtree_plain(frozen_rev[off:off + sub_n], dtype, fast_nodes)
                        for off in range(0, N, sub_n)
                        if not frozen_rev[off:off + sub_n].all()}
    # (offset, size) -> decoder of each node the top levels do not split
    terminals: dict = {}

    def plan(off: int, size: int) -> None:
        sub = frozen_rev[off:off + size]
        if sub.all():  # zeros in any order
            terminals[off, size] = leaf_beta(sub, fast_nodes)
        elif size == sub_n:
            terminals[off, size] = sub_decoders[off]
        elif leaf_beta(sub, fast_nodes) is not None:
            terminals[off, size] = make_sc_subtree_plain(sub, dtype, fast_nodes)
        else:
            plan(off, size // 2)
            plan(off + size // 2, size // 2)

    plan(0, N)
    rev_on: dict = {}

    def node(alpha, off: int, size: int):
        run = terminals.get((off, size))
        if run is not None:
            return run(alpha.contiguous())
        half = size // 2
        first, second = alpha[..., :half], alpha[..., half:]
        beta_l = node(f_minsum(first, second), off, half)
        sgn = 1.0 - 2.0 * beta_l.to(alpha.dtype)
        beta_r = node(second + sgn * first, off + half, half)
        return torch.cat([beta_l ^ beta_r, beta_r], dim=-1)

    def decode(llr):
        llr = torch.as_tensor(llr).to(dtype)
        lead = llr.shape[:-1]
        rev = rev_on.get(llr.device)
        if rev is None:
            rev = rev_on[llr.device] = torch.as_tensor(rev_np, device=llr.device)
        beta_rev = node(llr.reshape(-1, N)[:, rev], 0, N)
        return polar_transform(beta_rev[:, rev]).reshape(*lead, N)

    return decode
